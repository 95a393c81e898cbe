"""Mask R-CNN serving of the PyTorch port against the JAX package: the FCN
mask head, `paste_masks`, `simple_test_masks`, `single_device_test(
with_masks=True)` with `evaluate(["bbox", "segm"])`, the configs and the
reference checkpoint's keys.

The detector is a tiny Swin Mask R-CNN (embed 16, depths 2-2-2-2, window
4, FPN 16, 5 classes; the mask head at the JAX package's fixed 256
channels) with random variables of the JAX init's spread, carried across by
`from_jax_variables` (the reference's keys; the ConvTranspose kernel
flipped).  Tolerances: the mask head's logits 1e-4 (f32 convolutions, sums
in another order); pasted masks equal except at pixels whose value lies
within 1e-5 of the threshold; detections as the detector's own parity
tests (equal counts, each with a partner of the same label, box within
1e-3 px and score within 1e-5); mask probabilities 1e-4; the loop's
bitmaps equal (their probabilities differ by about 1e-6, and no pixel of
this set lies that close to the threshold); metrics within 1e-4.
"""

import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.apis.test import \
    single_device_test as jax_single_device_test
from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.models.mask_head import FCNMaskHead as JaxMaskHead
from panoswintransformerobjectdetection_tpu.models.mask_head import \
    paste_masks as jax_paste_masks
from panoswintransformerobjectdetection_tpu.runtime.checkpoint import convert_detector
from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                     init_detector)
from panoswintransformerobjectdetection_torch.apis.test import (MASK_EVAL_STAGES,
                                                                single_device_test)
from panoswintransformerobjectdetection_torch.core import rle
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.models.detectors import MaskRCNN
from panoswintransformerobjectdetection_torch.models.mask_head import (FCNMaskHead,
                                                                       paste_mask_values)
from panoswintransformerobjectdetection_torch.runtime.checkpoint import _mask_head
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from panoswintransformerobjectdetection_torch.tools import test as test_cli
from torch_port_common import (TINY_MASK_RCNN, quick_jit,  # noqa: F401
                               random_reference_state_dict, random_variables,
                               single_torch_thread, tiny_swin_mask_rcnn, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWIN_MASK_CONFIG = os.path.join(ROOT, "configs/swin/mask_rcnn_swin_tiny_patch4_window7_coco.py")
PANO_MASK_CONFIG = os.path.join(ROOT, "configs/panoswin/mask_rcnn_panoswin_tiny_coco.py")
H, W, N_IMAGES = 64, 96, 4
CLASSES = ("a", "b", "c", "d", "e")
TINY = TINY_MASK_RCNN
PIPELINE = [{"type": "LoadImageFromFile"},
            {"type": "Resize", "img_scale": (H, 1333), "keep_ratio": True},
            {"type": "Normalize", "mean": [123.675, 116.28, 103.53],
             "std": [58.395, 57.12, 57.375], "to_rgb": True},
            {"type": "Pad", "size_divisor": 32},
            {"type": "ImageToTensor", "keys": ["img"]},
            {"type": "Collect", "keys": ["img"]}]


@pytest.fixture(scope="module")
def tiny():
    """The JAX tiny Mask R-CNN, its variables, the port's copy (all built
    once a process, `tiny_swin_mask_rcnn`), and `simple_test_masks` of JAX
    compiled once (`quick_jit`) at the loop's batch shape."""
    shared = tiny_swin_mask_rcnn()
    det, variables = shared["det"], shared["variables"]
    model = build_detector_from_cfg({"model": TINY})
    model.load_state_dict(shared["state_dict"], strict=True)
    model.eval()
    args = (jnp.zeros((2, H, W, 3)), jnp.zeros((2, 2)), jnp.zeros((2, 4)))
    compiled = jax.jit(lambda v, a, b, c: det.apply(v, a, b, c, method=det.simple_test_masks)
                       ).lower(variables, *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return {"det": det, "variables": variables, "model": model,
            "run": lambda *a: compiled(variables, *(jnp.asarray(x) for x in a))}


def _match(got, want, what):
    """Equal counts; each detection of `got` has a partner in `want` of the
    same label, box within 1e-3 px, score within 1e-5.  Returns the partners."""
    assert len(got["boxes"]) == len(want["boxes"]), what
    free = np.ones(len(want["boxes"]), bool)
    partners = []
    for box, score, label in zip(got["boxes"], got["scores"], got["labels"]):
        near = (free & (want["labels"] == label) & (np.abs(want["scores"] - score) <= 1e-5)
                & (np.abs(want["boxes"] - box).max(1, initial=0) <= 1e-3))
        assert near.any(), f"{what}: no partner for {label} {score} {box}"
        j = int(np.argmax(near))
        free[j] = False
        partners.append(j)
    return partners


def test_fcn_mask_head_matches_flax():
    """A random ConvTranspose kernel, bias and convs: the flax kernel (kh, kw,
    in, out) is torch's (in, out, kh, kw) weight flipped in both spatial
    axes; unflipped, the logits differ."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 14, 14, 8)).astype(np.float32)
    jmod = JaxMaskHead(num_classes=5, conv_out_channels=16)
    variables = random_variables(jmod, jnp.zeros((1, 14, 14, 8)), seed=1)
    params = to_numpy(variables["params"])
    params["upsample"]["bias"] = rng.standard_normal(16).astype(np.float32)
    ref = np.asarray(quick_jit(jmod.apply, {"params": params}, jnp.asarray(x)))
    head = FCNMaskHead(8, 5, conv_out_channels=16)
    sd = {}
    _mask_head(sd, "m", params)
    head.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (3, 28, 28, 5)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    k = params["upsample"]["kernel"]
    head.upsample.weight.data = torch.from_numpy(np.ascontiguousarray(k.transpose(2, 3, 0, 1)))
    with torch.no_grad():
        unflipped = head(torch.from_numpy(x)).permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - ref).max() > 1e-2


def test_paste_masks_matches_jax():
    """Boxes inside, across the border, tiny and degenerate, on a 37 x 53
    image: equal bitmaps except where the value lies within 1e-5 of 0.5."""
    rng = np.random.default_rng(3)
    probs = rng.random((6, 28, 28)).astype(np.float32)
    boxes = np.array([[3, 4, 30, 20], [-10, -5, 20, 30], [40, 30, 70, 50], [10, 10, 10.5, 10.4],
                      [5, 5, 5, 5], [0.3, 1.7, 52.2, 36.9]], np.float32)
    ref = np.asarray(jax_paste_masks(jnp.asarray(probs), jnp.asarray(boxes), 37, 53))
    values = paste_mask_values(torch.from_numpy(probs), torch.from_numpy(boxes), 37, 53).numpy()
    got = values >= 0.5
    assert got.shape == ref.shape == (6, 37, 53) and ref.any() and (~ref).any()
    assert np.array_equal(got[np.abs(values - 0.5) > 1e-5], ref[np.abs(values - 0.5) > 1e-5])


def test_simple_test_masks_matches_jax(tiny):
    """Detections and each slot's 28 x 28 probabilities of its own class,
    with non-unit scale factors; the features computed once."""
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    shapes = np.array([[H, W], [60, 90]], np.float32)
    sf = np.array([[1.5, 1.5, 1.5, 1.5], [1.2, 1.25, 1.2, 1.25]], np.float32)
    jd, jp = tiny["run"](imgs, shapes, sf)
    calls = []
    td, tp = tiny["model"].simple_test_masks(
        torch.from_numpy(imgs), torch.from_numpy(shapes), torch.from_numpy(sf),
        stage=lambda name, fn: calls.append(name) or fn())
    assert calls == ["stem", "backbone", "fpn", "proposals", "roi_align", "bbox_head",
                     "detections", "mask_roi_align", "mask_head"]
    assert tp.shape == (2, 8, 28, 28) and np.asarray(jp).shape == tp.shape
    for i in range(2):
        m = np.asarray(jd.mask[i])
        want = {"boxes": np.asarray(jd.boxes[i])[m], "scores": np.asarray(jd.scores[i])[m],
                "labels": np.asarray(jd.labels[i])[m]}
        tm = td.mask[i].numpy()
        got = {k: getattr(td, k)[i].numpy()[tm] for k in ("boxes", "scores", "labels")}
        assert m.sum() > 0
        partners = _match(got, want, f"image {i}")
        np.testing.assert_allclose(tp[i].numpy()[tm], np.asarray(jp[i])[m][partners], atol=1e-4)


def _polygons(rng, n_images):
    anns = []
    for i in range(n_images):
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(15, W - 15), rng.uniform(15, H - 15)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
            rad = rng.uniform(5, 14) * rng.uniform(0.6, 1.0, 6)
            xs = np.clip(cx + rad * np.cos(ang), 0, W - 1)
            ys = np.clip(cy + rad * np.sin(ang), 0, H - 1)
            poly = [float(v) for v in np.stack([xs, ys], 1).reshape(-1)]
            anns.append({"image_id": i, "category_id": int(rng.integers(1, 6)), "iscrowd": 0,
                         "bbox": [float(xs.min()), float(ys.min()), float(np.ptp(xs)),
                                  float(np.ptp(ys))],
                         "area": float(rle.area(rle.polygon_to_rle(poly, H, W))),
                         "segmentation": [poly]})
    return anns


def _write_set(root, name, frames, anns):
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    for i, f in enumerate(frames):
        cv2.imwrite(os.path.join(img_dir, f"{i}.png"), f)
    ann = {"images": [{"id": i, "file_name": f"{i}.png", "width": W, "height": H}
                      for i in range(len(frames))],
           "annotations": [dict(a, id=k + 1) for k, a in enumerate(anns)],
           "categories": [{"id": k + 1, "name": c} for k, c in enumerate(CLASSES)]}
    path = os.path.join(root, name)
    with open(path, "w") as f:
        json.dump(ann, f)
    return {"type": "CocoDataset", "ann_file": path, "img_prefix": img_dir,
            "pipeline": PIPELINE, "test_mode": True, "classes": CLASSES}


def _loop_matches_jax(jax_run, det, variables, model, model_cfg, tmp_path, monkeypatch):
    """The port's `single_device_test(with_masks=True)` of `model` against
    the JAX package's on `det` (its jit replaced by `jax_run`, the module's
    `simple_test_masks` compiled once), then both packages'
    `evaluate(["bbox", "segm"])` on ground truth made from JAX's detections
    and masks (and more polygons): equal detections, bitmaps equal but for
    at most one pixel in 1000 (a pixel whose probability lies within
    rounding of 0.5 flips), metrics within 1e-4; with `model_cfg`,
    `tools.test --eval bbox segm` on the same weights from a `.pth` gives
    the port's metrics."""
    rng = np.random.default_rng(6)
    frames = (rng.random((N_IMAGES, H, W, 3)) * 255).astype(np.uint8)
    empty = _write_set(str(tmp_path), "first.json", frames, [])
    jit = jax.jit
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: (lambda v, *a: jax_run(*a))
                        if fn.__name__ == "run" else jit(fn, **kw))
    want = jax_single_device_test(det, variables, jb.build_dataset(empty), batch_size=2,
                                  with_masks=True)
    monkeypatch.undo()
    calls = []
    got = single_device_test(model, tb.build_dataset(empty), batch_size=2, with_masks=True,
                             device="cpu", stage=lambda name, fn: calls.append(name) or fn())
    assert calls == list(MASK_EVAL_STAGES) * (N_IMAGES // 2) + ["load"]
    pixels = flips = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g["masks"]) == len(g["boxes"]) > 0
        for gm, j in zip(g["masks"], _match(g, w, f"image {i}")):
            a, b = rle.decode(gm), rle.decode(w["masks"][j])
            pixels += int(a.sum())
            flips += int((a != b).sum())
    assert pixels > 0 and flips <= pixels // 1000
    gt = []
    for i, w in enumerate(want):
        for box, label, m in zip(w["boxes"], w["labels"], w["masks"]):
            x1, y1, x2, y2 = (box + rng.uniform(-2, 2, 4)).tolist()
            if x2 - x1 >= 1 and y2 - y1 >= 1 and rle.area(m) > 0:
                seg = dict(m, counts=m["counts"].decode() if isinstance(m["counts"], bytes)
                           else m["counts"])
                gt.append({"image_id": i, "category_id": int(label) + 1, "iscrowd": 0,
                           "bbox": [x1, y1, x2 - x1, y2 - y1], "area": float(rle.area(m)),
                           "segmentation": seg})
    scored = _write_set(str(tmp_path), "gt.json", frames, gt + _polygons(rng, N_IMAGES))
    metrics = ["bbox", "segm"]
    ref = jb.build_dataset(scored).evaluate(want, metric=metrics)
    mine = tb.build_dataset(scored).evaluate(got, metric=metrics)
    assert ref["segm_mAP"] > 0.1 and ref["bbox_mAP"] > 0.1
    for k, v in ref.items():
        assert abs(mine[k] - v) <= 1e-4, (k, mine[k], v)
    if model_cfg is None:
        return
    pth, cfg_file = str(tmp_path / "model.pth"), str(tmp_path / "model_cfg.py")
    torch.save({"state_dict": model.state_dict()}, pth)
    with open(cfg_file, "w") as f:
        f.write(f"model = {model_cfg!r}\ndata = {dict(samples_per_gpu=2, test=scored)!r}\n")
    cli = test_cli.main([cfg_file, pth, "--eval", "bbox", "segm", "--batch-size", "2",
                         "--device", "cpu"])
    assert cli == mine


def test_single_device_test_with_masks_matches_jax(tiny, tmp_path, monkeypatch):
    """The port's loop against the JAX package's own `single_device_test(
    with_masks=True)` (its jit compiled at XLA's backend optimisation level
    0), then both packages' `evaluate(["bbox", "segm"])` on ground truth made
    from JAX's detections and masks (and more polygons): equal detections
    and bitmaps within the stated tolerances, the port's metrics on its own
    results within 1e-4 of JAX's on JAX's, both evaluators exact on the
    same detections, and `tools.test --eval bbox segm` with the same
    weights from a `.pth` giving the port's metrics."""
    rng = np.random.default_rng(6)
    frames = (rng.random((N_IMAGES, H, W, 3)) * 255).astype(np.uint8)
    empty = _write_set(str(tmp_path), "first.json", frames, [])
    jit = jax.jit
    # JAX's loop jits its `run` (simple_test_masks on the variables): hand it
    # the same function compiled once for the module (`tiny`)
    monkeypatch.setattr(jax, "jit", lambda fn, **kw: (lambda v, *a: tiny["run"](*a))
                        if fn.__name__ == "run" else jit(fn, **kw))
    want = jax_single_device_test(tiny["det"], tiny["variables"], jb.build_dataset(empty),
                                  batch_size=2, with_masks=True)
    monkeypatch.undo()
    calls = []
    got = single_device_test(tiny["model"], tb.build_dataset(empty), batch_size=2,
                             with_masks=True, device="cpu",
                             stage=lambda name, fn: calls.append(name) or fn())
    assert calls == list(MASK_EVAL_STAGES) * (N_IMAGES // 2) + ["load"]
    pixels = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert len(g["masks"]) == len(g["boxes"]) > 0
        partners = _match(g, w, f"image {i}")
        for gm, j in zip(g["masks"], partners):
            a, b = rle.decode(gm), rle.decode(w["masks"][j])
            assert gm["size"] == [H, W] and np.array_equal(a, b)
            pixels += int(a.sum())
    assert pixels > 0
    gt = []
    for i, w in enumerate(want):
        for box, label, m in zip(w["boxes"], w["labels"], w["masks"]):
            x1, y1, x2, y2 = (box + rng.uniform(-2, 2, 4)).tolist()
            if x2 - x1 >= 1 and y2 - y1 >= 1 and rle.area(m) > 0:
                seg = dict(m, counts=m["counts"].decode() if isinstance(m["counts"], bytes)
                           else m["counts"])
                gt.append({"image_id": i, "category_id": int(label) + 1, "iscrowd": 0,
                           "bbox": [x1, y1, x2 - x1, y2 - y1], "area": float(rle.area(m)),
                           "segmentation": seg})
    scored = _write_set(str(tmp_path), "gt.json", frames, gt + _polygons(rng, N_IMAGES))
    metrics = ["bbox", "segm"]
    ref = jb.build_dataset(scored).evaluate(want, metric=metrics)
    port_ds = tb.build_dataset(scored)
    mine = port_ds.evaluate(got, metric=metrics)
    assert ref["segm_mAP"] > 0.1 and ref["bbox_mAP"] > 0.1
    for k, v in ref.items():
        assert abs(mine[k] - v) <= 1e-4, (k, mine[k], v)
    same = jb.build_dataset(scored).evaluate(got, metric=metrics)
    assert all(abs(same[k] - v) <= 1e-12 for k, v in mine.items())
    # the CLI: the same weights from a reference `.pth`, the same metrics
    pth, cfg_file = str(tmp_path / "tiny.pth"), str(tmp_path / "tiny_mask_rcnn.py")
    torch.save({"state_dict": tiny["model"].state_dict()}, pth)
    with open(cfg_file, "w") as f:
        f.write(f"model = {TINY!r}\ndata = {dict(samples_per_gpu=2, test=scored)!r}\n")
    cli = test_cli.main([cfg_file, pth, "--eval", "bbox", "segm", "--batch-size", "2",
                         "--device", "cpu", "--out", str(tmp_path / "r.pkl")])
    assert cli == mine


@pytest.mark.parametrize("path,backbone", [(SWIN_MASK_CONFIG, "SwinTransformer"),
                                           (PANO_MASK_CONFIG, "PanoSwinTransformer")],
                         ids=["swin", "panoswin"])
def test_mask_configs_build(path, backbone):
    """Both Mask R-CNN configs build a `MaskRCNN` with the mask head, and
    their COCO-instance test pipelines build; the PanoSwin one (planar) runs
    `simple_test_masks` at a tiny width."""
    cfg = load_config(path)
    model = build_detector_from_cfg(cfg)
    assert isinstance(model, MaskRCNN) and model.with_mask and model.mask_roi_size == 14
    assert type(model.backbone).__name__ == backbone
    assert "roi_head.mask_head.upsample.weight" in model.state_dict()
    assert [type(s).__name__ for s in tb.build_pipeline(cfg["data"]["test"]["pipeline"])] == [
        "LoadImageFromFile", "Resize", "Normalize", "Pad"]
    if backbone == "PanoSwinTransformer":
        assert not model.backbone.pano_mode
        tiny_cfg = {"model": dict(cfg["model"], backbone=dict(
            cfg["model"]["backbone"], embed_dim=6, depths=(2, 2, 2, 2), num_heads=(1, 1, 1, 2),
            window_size=4), neck=dict(cfg["model"]["neck"], in_channels=(6, 12, 24, 48),
                                      out_channels=16),
            test_cfg=dict(TINY["test_cfg"], rcnn=dict(TINY["test_cfg"]["rcnn"], score_thr=0.005)))}
        small = init_detector(tiny_cfg, device="cpu")
        det, probs = small.simple_test_masks(torch.rand(1, 64, 96, 3),
                                             torch.tensor([[64.0, 96.0]]))
        assert probs.shape == (1, 8, 28, 28) and torch.isfinite(probs).all()
        assert det.mask.any()


def test_reference_checkpoint_loads_strictly(tmp_path):
    """A reference-format Swin-T Mask R-CNN `.pth` (random values in every
    key, `module.` prefixes) loads strictly through `init_detector`; the JAX
    package's `convert_detector` drops its mask head (a known divergence:
    the port does not copy it)."""
    model = build_detector_from_cfg(load_config(SWIN_MASK_CONFIG))
    sd = random_reference_state_dict(model, 2)
    assert any(k.startswith("roi_head.mask_head.") for k in sd)
    path = str(tmp_path / "mask_rcnn.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    loaded = init_detector(SWIN_MASK_CONFIG, path, device="cpu").state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in sd.items())
    params, _ = convert_detector({k: v.numpy() for k, v in sd.items()}, (2, 2, 6, 2),
                                 backbone="swin")
    assert "mask_head_m" not in params and "bbox_head_m" in params
