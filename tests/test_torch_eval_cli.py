"""The PyTorch port's evaluation path against the JAX package's:
`single_device_test`, the `tools.test` CLI, `tools.eval_metric`, the
perfect-detection probe and the demo.

The detector is the shared tiny flagship (`torch_port_common.tiny_detector`)
with a smaller test configuration (`TEST_CFG`: 64 proposals, 32
detections an image) on six synthetic 64 x 128 frames, a StreetDataset whose
test pipeline keeps them at their size (so `Resize` is exact in both
packages).  The JAX reference is that detector's `simple_test`, compiled
once with XLA's backend optimisation level 0 (as `quick_jit`), on the JAX
loader's batches; JAX's own `init_detector` (an eager init of about 100 s)
and `tools/test.py` are left out here.  The ground truth of the evaluated
set is JAX's detections, each box moved by a seeded 0-3 px, so that the
metrics are not all 0.  Tolerances: detections as the detector's own parity
test (equal counts, each with a partner of the same label, box within 1e-3
px and score within 1e-5: random weights give scores that lie within
rounding of each other, so two detections may trade places); the CLI's
metrics within 1e-4 of JAX's `dataset.evaluate` on JAX's detections; the
rest exact.  The perfect-detection probe takes the set's first ground
truth, made by `write_coco_set`.

The slow test at the end is ROADMAP item 15's "done" check: both CLIs on an
80-image set.
"""

import json
import math
import os
import pickle
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.data.loader import DetDataLoader as JaxLoader
from panoswintransformerobjectdetection_tpu.models.detectors import \
    default_test_cfg as jax_test_cfg
from panoswintransformerobjectdetection_torch.apis import inference as tinf
from panoswintransformerobjectdetection_torch.apis.test import (EVAL_STAGES, multi_host_test,
                                                                single_device_test)
from panoswintransformerobjectdetection_torch.apis.tta import aug_test_detector
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.models.detectors import default_test_cfg
from panoswintransformerobjectdetection_torch.tools import eval_metric, image_demo
from panoswintransformerobjectdetection_torch.tools import test as test_cli
from torch_port_common import (STREET_CLASSES, single_torch_thread,  # noqa: F401
                               tiny_detector, write_coco_set)

N_IMAGES, H, W = 6, 64, 128
BATCH = 2
TEST_CFG = {"rpn": {"nms_pre": 256, "max_per_img": 64, "iou_threshold": 0.7, "min_bbox_size": 0},
            "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 32}}
MODEL_CFG = dict(flagship_config(tiny=True), test_cfg=TEST_CFG)
PIPELINE = [{"type": "LoadImageFromFile"},
            {"type": "Resize", "img_scale": (H, 1333), "keep_ratio": True},
            {"type": "Normalize", "mean": [123.675, 116.28, 103.53],
             "std": [58.395, 57.12, 57.375], "to_rgb": True},
            {"type": "Pad", "size_divisor": 32}, {"type": "PanoCheck"}]


def _jax_detections(det, variables, dataset, batch_size):
    """JAX's `single_device_test` loop with `quick_jit`'s compile, made once
    for the loader's one batch shape."""
    loader = JaxLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False)
    compiled, out = None, {}
    for batch in loader:
        args = (variables, *(jnp.asarray(batch[k])
                             for k in ("images", "img_shapes", "scale_factors")))
        if compiled is None:
            compiled = jax.jit(lambda v, x, s, f: det.apply(v, x, s, f, method=det.simple_test)) \
                .lower(*args).compile(compiler_options={"xla_backend_optimization_level": 0})
        res = compiled(*args)
        boxes, scores, labels, mask = (np.asarray(t) for t in res)
        for i, idx in enumerate(batch["indices"]):
            out[int(idx)] = {"boxes": boxes[i][mask[i]], "scores": scores[i][mask[i]],
                             "labels": labels[i][mask[i]]}
    return [out[i] for i in range(len(dataset))]


def _write_cfg(path, ann_file, img_dir, model_cfg, tta=None):
    model = dict(model_cfg, type="PanoFasterRCNN",
                 backbone=dict(model_cfg["backbone"], type="PanoSwinTransformer"),
                 neck=dict(model_cfg["neck"], type="FPN"))
    with open(path, "w") as f:
        f.write(f"classes = {STREET_CLASSES!r}\n")
        f.write(f"model = {model!r}\n")
        f.write("data = dict(samples_per_gpu=2, workers_per_gpu=0,\n"
                f"    test=dict(type='StreetDataset', ann_file={ann_file!r},\n"
                f"              img_prefix={img_dir!r}, pipeline={PIPELINE!r},\n"
                "              test_mode=True))\n")
        if tta:
            f.write(f"tta = {tta!r}\n")
    return path


def _gt_from(dets, ann_file, seed):
    """Rewrite `ann_file` with the detections above 0.05 as its ground
    truth, each box moved by a seeded 0-3 px, and its crowd region kept."""
    rng = np.random.default_rng(seed)
    with open(ann_file) as f:
        ann = json.load(f)
    anns = [a for a in ann["annotations"] if a["iscrowd"]]
    for img, d in enumerate(dets):
        for b, s, label in zip(d["boxes"], d["scores"], d["labels"]):
            if s <= 0.05:
                continue
            x1, y1, x2, y2 = (b + rng.uniform(-3, 3, 4)).tolist()
            if x2 - x1 < 1 or y2 - y1 < 1:
                continue
            anns.append({"id": len(anns) + 100, "image_id": img, "category_id": int(label) + 1,
                         "bbox": [x1, y1, x2 - x1, y2 - y1], "area": (x2 - x1) * (y2 - y1),
                         "iscrowd": 0})
    ann["annotations"] = anns
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return sum(1 for a in anns if not a["iscrowd"])


def _same_detections(got, want):
    """Equal counts an image; each detection has a partner of the same
    label with its box within 1e-3 px and its score within 1e-5."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g["boxes"]) == len(w["boxes"]), i
        free = np.ones(len(w["boxes"]), bool)
        for box, score, label in zip(g["boxes"], g["scores"], g["labels"]):
            near = free & (w["labels"] == label) & (np.abs(w["scores"] - score) <= 1e-5) & \
                (np.abs(w["boxes"] - box).max(1, initial=0) <= 1e-3)
            assert near.any(), (i, label, score, box)
            free[np.argmax(near)] = False


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("eval")
    ann_file, img_dir = write_coco_set(str(root), N_IMAGES, H, W, seed=12)
    first_gt = str(root / "first_gt.json")
    shutil.copy(ann_file, first_gt)
    td = tiny_detector()
    cfg_path = _write_cfg(str(root / "cfg.py"), ann_file, img_dir, MODEL_CFG)
    dataset = jb.build_dataset({"type": "StreetDataset", "ann_file": ann_file,
                                "img_prefix": img_dir, "pipeline": PIPELINE, "test_mode": True})
    jax_dets = _jax_detections(td["det"].clone(test_cfg=TEST_CFG), td["variables"], dataset,
                               BATCH)
    n_gt = _gt_from(jax_dets, ann_file, seed=13)
    pth = str(root / "tiny.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in td["state_dict"].items()}}, pth)
    model = tinf.init_detector(cfg_path, pth, device="cpu")
    return {"root": root, "cfg": cfg_path, "pth": pth, "ann_file": ann_file, "img_dir": img_dir,
            "first_gt": first_gt, "jax_dets": jax_dets, "n_gt": n_gt, "model": model}


def _dataset(module, s):
    return module.build_dataset({"type": "StreetDataset", "ann_file": s["ann_file"],
                                 "img_prefix": s["img_dir"], "pipeline": PIPELINE,
                                 "test_mode": True})


def test_test_cfgs_agree():
    assert default_test_cfg() == jax_test_cfg()


def test_single_device_test_matches_jax(setup):
    calls = []

    def stage(name, fn):
        calls.append(name)
        return fn()

    got = single_device_test(setup["model"], _dataset(tb, setup), batch_size=BATCH,
                             device="cpu", stage=stage)
    _same_detections(got, setup["jax_dets"])
    assert setup["n_gt"] >= N_IMAGES
    assert calls == list(EVAL_STAGES) * (N_IMAGES // BATCH) + ["load"]


def _finite_or_none(metrics):
    return {k: (None if isinstance(v, float) and math.isnan(v) else v) for k, v in metrics.items()}


def test_cli_matches_jax_evaluate(setup, capsys):
    """`tools.test` with bbox and proposal metrics, classwise, against JAX's
    `dataset.evaluate` on JAX's detections; `--out` read back by
    `tools.eval_metric` gives the same bbox metrics."""
    out = str(setup["root"] / "results.pkl")
    metrics = test_cli.main([setup["cfg"], setup["pth"], "--eval", "bbox", "proposal",
                             "--classwise", "--out", out, "--batch-size", "2",
                             "--device", "cpu"])
    printed = capsys.readouterr().out
    want = _dataset(jb, setup).evaluate(setup["jax_dets"], metric=["bbox", "proposal"],
                                        classwise=True)
    assert list(metrics) == list(want)
    for k, v in want.items():
        if math.isnan(v):
            assert math.isnan(metrics[k]), k
        else:
            assert abs(metrics[k] - v) <= 1e-4, (k, metrics[k], v)
    assert 0 < metrics["bbox_mAP"] < metrics["bbox_mAP_50"] < 1
    assert json.loads(printed[printed.index("{"):]) == _finite_or_none(metrics)
    with open(out, "rb") as f:
        _same_detections(pickle.load(f), setup["jax_dets"])
    again = eval_metric.main([setup["cfg"], out])
    assert again == {k: v for k, v in metrics.items()
                     if k.startswith("bbox_") and not k.startswith("bbox_AP_")}


def test_perfect_detections_score_one(setup, tmp_path):
    """The set's first ground truth (crowd region aside) as detections of
    score 1 through `tools.eval_metric`: bbox_mAP and AR@100 are 1."""
    cfg = _write_cfg(str(tmp_path / "first.py"), setup["first_gt"], setup["img_dir"], MODEL_CFG)
    ds = tb.build_dataset({"type": "StreetDataset", "ann_file": setup["first_gt"],
                           "img_prefix": setup["img_dir"], "test_mode": True})
    perfect = [{"boxes": r["bboxes"], "scores": np.ones(len(r["bboxes"]), np.float32),
                "labels": r["labels"]} for r in ds.records]
    path = str(tmp_path / "perfect.pkl")
    with open(path, "wb") as f:
        pickle.dump(perfect, f)
    metrics = eval_metric.main([cfg, path])
    assert metrics["bbox_mAP"] == 1.0 and metrics["bbox_AR@100"] == 1.0
    assert metrics["bbox_AR@1"] < 1


def test_cli_tta_matches_aug_test_detector(setup, tmp_path):
    cfg = _write_cfg(str(tmp_path / "tta.py"), setup["ann_file"], setup["img_dir"], MODEL_CFG,
                     tta={"scales": [(H, 1333)], "flip": True})
    out = str(tmp_path / "tta.pkl")
    metrics = test_cli.main([cfg, setup["pth"], "--tta", "--out", out, "--device", "cpu"])
    with open(out, "rb") as f:
        got = pickle.load(f)
    import cv2
    for i, r in enumerate(got):
        img = cv2.imread(os.path.join(setup["img_dir"], f"{i}.jpg")).astype(np.float32)
        want = aug_test_detector(setup["model"], img, scales=((H, 1333),), flip=True)
        for k in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(r[k], want[k])
    assert sum(len(r["boxes"]) for r in got) > 0 and 0 <= metrics["bbox_mAP"] <= 1


def test_single_device_test_refuses(setup):
    ds = _dataset(tb, setup)
    with pytest.raises(ValueError, match="the model is on cpu"):
        single_device_test(setup["model"], ds, device="meta")
    with pytest.raises(ValueError, match="needs a detector with a mask head"):
        single_device_test(setup["model"], ds, with_masks=True, device="cpu")
    with pytest.raises(ValueError, match="the model is on cpu"):
        multi_host_test(setup["model"], ds, device="meta")

    class Skipping:
        """A dataset whose pipeline drops sample 3."""
        records = ds.records

        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            return None if i == 3 else ds[i]

    with pytest.raises(RuntimeError, match="skipped 2 sample"):
        single_device_test(setup["model"], Skipping(), batch_size=BATCH, device="cpu")


def test_image_demo_draws(setup, tmp_path):
    import cv2
    img = os.path.join(setup["img_dir"], "0.jpg")
    out, dump = str(tmp_path / "demo.jpg"), str(tmp_path / "demo.json")
    records = image_demo.main([img, setup["cfg"], setup["pth"], "--score-thr", "0.0",
                               "--out-file", out, "--dump-json", dump, "--device", "cpu"])
    drawn = cv2.imread(out)
    assert drawn is not None and drawn.shape == (H, W, 3)
    with open(dump) as f:
        assert json.load(f) == sorted(records, key=lambda r: -r["score"])
    per_class = tinf.inference_detector(setup["model"], img)
    assert len(records) == sum(len(r) for r in per_class) > 0
    shown = tinf.show_result_pyplot(setup["model"], img, per_class, score_thr=0.0,
                                    out_file=str(tmp_path / "shown.jpg"))
    assert shown.shape == (H, W, 3) and os.path.exists(tmp_path / "shown.jpg")


@pytest.mark.slow
def test_both_clis_agree_on_80_images(tmp_path):
    """ROADMAP item 15's check: the JAX CLI (`tools/test.py`) and the port's
    on an 80-image synthetic set at 256 x 512 (the eval-protocol rehearsal's
    set and nano model, `test_eval_protocol_parity.py:53, :106`, without its
    `roi_sampling_ratio: 0`, which the port does not build), from one `.pth`,
    scored on ground truth made from a first run's detections (each box moved
    by a seeded 0-3 px): bbox metrics within 1e-4, and not all 0."""
    import importlib.util
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ann_file, img_dir = write_coco_set(str(tmp_path), 80, 256, 512, seed=21)
    model_cfg = {"backbone": {"embed_dim": 24, "depths": (2, 2, 2, 2), "num_heads": (1, 2, 4, 8),
                              "window_size": 7, "ape": True, "drop_path_rate": 0.0},
                 "neck": {"in_channels": (24, 48, 96, 192), "out_channels": 32, "num_outs": 5},
                 "num_classes": 5,
                 "test_cfg": {"rpn": {"nms_pre": 300, "max_per_img": 100,
                                      "iou_threshold": 0.7, "min_bbox_size": 0},
                              "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5,
                                       "max_per_img": 50}}}
    cfg = _write_cfg(str(tmp_path / "cfg.py"), ann_file, img_dir, model_cfg)
    with open(cfg) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace(f"img_scale': ({H}, 1333)", "img_scale': (256, 1333)"))
    model = tinf.init_detector(cfg, seed=3, device="cpu")
    pth = str(tmp_path / "nano.pth")
    torch.save({"state_dict": model.state_dict()}, pth)
    sys.path.insert(0, os.path.join(root, "tools"))
    spec = importlib.util.spec_from_file_location("jax_tools_test",
                                                  os.path.join(root, "tools", "test.py"))
    jax_cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_cli)
    args = [cfg, pth, "--eval", "bbox", "--batch-size", "4"]
    first = str(tmp_path / "first.pkl")
    test_cli.main(args + ["--device", "cpu", "--out", first])
    with open(first, "rb") as f:
        assert _gt_from(pickle.load(f), ann_file, seed=22) > 80
    want = jax_cli.main(args)
    got = test_cli.main(args + ["--device", "cpu"])
    assert list(got) == list(want) and got["bbox_mAP"] > 0
    for k, v in want.items():
        assert abs(got[k] - v) <= 1e-4 or (math.isnan(v) and math.isnan(got[k])), k
