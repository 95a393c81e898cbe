"""The PyTorch port's data layer against the JAX package's: datasets
(COCO, Street, 360-Indoor's BFoV boxes, VOC XML, LVIS), the test
pipelines built from the configs, the loader's batches, the wrappers, the
builders and the BFoV projection.

The same files on disk go through both packages.  Records and `eval_anns`
must be equal, apart from 360-Indoor's boxes (converted from BFoV in
float32 by each package's own projection), which must be within 1e-3
pixels (2e-3 for a width or height), and their areas within 2e-3 times the
box's half perimeter.  Two departures from the JAX package are deliberate:
360-Indoor's `eval_anns` carry the converted pixel box where the JAX
package keeps the BFoV box in radians, and `VOCDataset` reads VOC's own
layout.  The
pipelines must be equal where `Resize` keeps the image at its size; where
it resizes, the port's `F.interpolate` is held to 0.02 of OpenCV's on 0-255
images (ROADMAP.md, Queue 3).  The loader's batches must be equal, with 0
and with 2 worker threads.
"""

import copy
import os
import random

import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.data import datasets as jds
from panoswintransformerobjectdetection_tpu.data import loader as jld
from panoswintransformerobjectdetection_tpu.data import transforms as jtr
from panoswintransformerobjectdetection_tpu.geometry import projection as jproj
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.data import datasets as tds
from panoswintransformerobjectdetection_torch.data import loader as tld
from panoswintransformerobjectdetection_torch.data import transforms as ttr
from panoswintransformerobjectdetection_torch.geometry import projection as tproj
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from torch_port_common import single_torch_thread, write_coco_set  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {"streetwin": "faster_rcnn_panoswin_tiny_patch4_window7_streetwin.py",
           "indoor360": "faster_rcnn_panoswin_tiny_indoor360.py"}
# Each config's test scale (its Resize keeps a frame of this size as it is).
SCALE_ONE = {"streetwin": (800, 1333), "indoor360": (512, 1024)}
NORM_STD = 57.12            # the smallest std of the configs' Normalize
RESIZE_TOL = 0.02           # on 0-255 images


def _config(name):
    return load_config(os.path.join(ROOT, "configs", "panoswin", CONFIGS[name]))


def _equal_records(got, want, box_tol=0.0):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "eval_anns":
                assert len(g[k]) == len(w[k])
                for ga, wa in zip(g[k], w[k]):
                    assert set(ga) == set(wa)
                    for key in wa:
                        if key == "area" and box_tol:
                            x, y, bw, bh = wa["bbox"]
                            assert abs(ga[key] - wa[key]) <= 2 * box_tol * (bw + bh) + 1e-6
                        elif key == "bbox" and box_tol:
                            np.testing.assert_allclose(ga[key], wa[key], atol=2 * box_tol,
                                                       rtol=0)
                        else:
                            assert ga[key] == wa[key], key
            elif isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_allclose(g[k], w[k], atol=box_tol, rtol=0, err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    return write_coco_set(str(tmp_path_factory.mktemp("coco")), 6, 64, 128, seed=1)


@pytest.fixture(scope="module")
def bfov_set(tmp_path_factory):
    return write_coco_set(str(tmp_path_factory.mktemp("bfov")), 6, 64, 128, seed=2,
                          classes=tuple(f"c{i}" for i in range(37)), bfov=True)


@pytest.mark.parametrize("kind", ["CocoDataset", "StreetDataset", "CityscapesDataset"])
@pytest.mark.parametrize("test_mode", [True, False])
def test_coco_datasets_parse_like_jax(coco_set, kind, test_mode):
    ann_file, img_dir = coco_set
    classes = None if kind != "CocoDataset" else ("person", "bicycle", "car", "motorcycle")
    got, want = (getattr(mod, kind)(ann_file, img_dir, test_mode=test_mode, classes=classes)
                 for mod in (tds, jds))
    _equal_records(got.records, want.records)
    np.testing.assert_array_equal(got.flags, want.flags)
    assert got.CLASSES == want.CLASSES and got.cat_id_to_label == want.cat_id_to_label


def test_indoor360_parses_bfov_like_jax(bfov_set):
    """The JAX records, with each BFoV box of `eval_anns` replaced by its
    pixel box (x1, y1, x2 - x1, y2 - y1) through the JAX projection and its
    area by that box's; the pixel box of image 0 stays as it is."""
    ann_file, img_dir = bfov_set
    got, want = (mod.Indoor360Dataset(ann_file, img_dir, test_mode=True) for mod in (tds, jds))
    want_records = copy.deepcopy(want.records)
    converted = 0
    for r in want_records:
        for a in r["eval_anns"]:
            if max(abs(v) for v in a["bbox"]) <= 2 * np.pi:
                x1, y1, x2, y2 = np.asarray(jproj.bfov_to_xyxy(
                    np.asarray([a["bbox"]], np.float32), r["width"], r["height"]))[0].tolist()
                a["bbox"], a["area"] = [x1, y1, x2 - x1, y2 - y1], (x2 - x1) * (y2 - y1)
                converted += 1
    _equal_records(got.records, want_records, box_tol=1e-3)
    assert sum(len(r["bboxes"]) for r in got.records) > 8 and converted > 8
    assert [a["bbox"] for a in got.records[0]["eval_anns"]][-1] == \
        want.records[0]["eval_anns"][-1]["bbox"]


def test_bfov_projection_matches_jax():
    """Boxes across the seam, around both poles and small ones, at 512 x
    1024; and the gnomonic projections both ways."""
    rng = np.random.default_rng(4)
    uvwh = np.stack([rng.uniform(-np.pi, np.pi, 64), rng.uniform(-1.5, 1.5, 64),
                     rng.uniform(0.01, 2.0, 64), rng.uniform(0.01, 2.0, 64)], 1)
    uvwh[:4, 0] = [np.pi - 0.01, -np.pi + 0.02, 3.0, -3.1]
    uvwh = uvwh.astype(np.float32)
    got = tproj.bfov_to_xyxy(torch.from_numpy(uvwh), 1024, 512).numpy()
    want = np.asarray(jproj.bfov_to_xyxy(uvwh, 1024, 512))
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert (got[:, 0] <= 0).any() and (got[:, 2] >= 1024).any()
    xy = rng.uniform(-1, 1, (32, 2)).astype(np.float32)
    uv0 = uvwh[:32, :2]
    uv = tproj.tangent_xy_to_equirect_uv(torch.from_numpy(xy), torch.from_numpy(uv0))
    np.testing.assert_allclose(uv.numpy(), np.asarray(jproj.tangent_xy_to_equirect_uv(xy, uv0)),
                               atol=1e-5)
    back = tproj.equirect_uv_to_tangent_xy(uv, torch.from_numpy(uv0)).numpy()
    np.testing.assert_allclose(back, np.asarray(jproj.equirect_uv_to_tangent_xy(
        np.asarray(uv), uv0)), atol=1e-4)


def _write_voc(root, n, seed):
    """VOC's own layout under `root` (the year's directory): the port's
    split file `ImageSets/Main/test.txt`, and the same list at
    `ImageSets/test.txt`, where the JAX package finds `Annotations/`
    (`VOCDataset._parse` goes two levels up, VOC's layout needs three).
    Returns (the port's split file, the JAX package's)."""
    import cv2
    rng = np.random.default_rng(seed)
    for sub in ("Annotations", "JPEGImages", os.path.join("ImageSets", "Main")):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    ids = []
    for i in range(n):
        img_id = f"{i:06d}"
        ids.append(img_id)
        cv2.imwrite(os.path.join(root, "JPEGImages", img_id + ".jpg"),
                    np.zeros((48, 80, 3), np.uint8))
        objs = []
        for k in range(int(rng.integers(0 if i == 2 else 1, 4))):
            x1, y1 = rng.integers(0, 40, 2)
            name = ("dog", "person", "car", "unknown_thing")[int(rng.integers(0, 4))]
            objs.append(f"<object><name>{name}</name><difficult>{int(k == 2)}</difficult>"
                        f"<bndbox><xmin>{x1}</xmin><ymin>{y1}</ymin><xmax>{x1 + 20}</xmax>"
                        f"<ymax>{y1 + 10}</ymax></bndbox></object>")
        with open(os.path.join(root, "Annotations", img_id + ".xml"), "w") as f:
            f.write(f"<annotation><size><width>80</width><height>48</height></size>"
                    f"{''.join(objs)}</annotation>")
    splits = (os.path.join(root, "ImageSets", "Main", "test.txt"),
              os.path.join(root, "ImageSets", "test.txt"))
    for split in splits:
        with open(split, "w") as f:
            f.write("\n".join(ids) + "\n")
    return splits


def test_voc_and_lvis_parse_like_jax(tmp_path, coco_set):
    year = str(tmp_path / "VOCdevkit" / "VOC2007")
    port_split, jax_split = _write_voc(year, 5, seed=3)
    for test_mode in (True, False):
        got = tds.VOCDataset(port_split, year + "/", test_mode=test_mode)
        want = jds.VOCDataset(jax_split, year + "/", test_mode=test_mode)
        _equal_records(got.records, want.records)
        assert all(os.path.exists(os.path.join(got.img_prefix, r["filename"]))
                   for r in got.records)
    rng = np.random.default_rng(0)
    dets = [{"boxes": r["bboxes"] + rng.normal(0, 1, r["bboxes"].shape).astype(np.float32),
             "scores": rng.random(len(r["bboxes"])).astype(np.float32),
             "labels": r["labels"]} for r in want.records]
    assert got.evaluate(dets) == want.evaluate(dets)
    got, want = (mod.LVISDataset(coco_set[0], coco_set[1], test_mode=True)
                 for mod in (tds, jds))
    _equal_records(got.records, want.records)
    assert got.CLASSES == want.CLASSES


def _dets_for(records, seed):
    """Detections near the ground truth, some off it, some of another class."""
    rng = np.random.default_rng(seed)
    out = []
    for r in records:
        boxes = np.concatenate([r["bboxes"] + rng.normal(0, 2, r["bboxes"].shape),
                                rng.uniform(0, 60, (2, 4)) + [0, 0, 30, 20]]).astype(np.float32)
        n = len(boxes)
        labels = np.concatenate([r["labels"], rng.integers(0, 5, 2)]).astype(np.int64)
        out.append({"boxes": boxes, "scores": rng.random(n).astype(np.float32),
                    "labels": labels, "mask": rng.random(n) < 0.9})
    return out


def test_coco_evaluate_matches_jax(coco_set):
    """`det2anns`, COCOeval through `evaluate` (bbox and proposal, classwise)
    and `evaluate_fast`."""
    got_ds, want_ds = (mod.StreetDataset(*coco_set, test_mode=True) for mod in (tds, jds))
    dets = _dets_for(want_ds.records, 5)
    assert got_ds.det2anns(dets) == want_ds.det2anns(dets)
    kw = {"metric": ["bbox", "proposal"], "classwise": True, "proposal_nums": (1, 10, 100)}
    got, want = got_ds.evaluate(copy.deepcopy(dets), **kw), want_ds.evaluate(dets, **kw)
    np.testing.assert_array_equal(np.array(list(got.values())), np.array(list(want.values())))
    assert list(got) == list(want) and 0 < got["bbox_mAP"] < 1
    np.testing.assert_array_equal(
        np.array(list(got_ds.evaluate_fast(dets, classwise=True).values())),
        np.array(list(want_ds.evaluate_fast(dets, classwise=True).values())))


def _sample(mod, name, img_path):
    builder = tb if mod is ttr else jb
    pipeline = mod.Compose(builder.build_pipeline(_config(name)["test_pipeline"]))
    return pipeline({"img_path": img_path, "img_info": {}})


@pytest.mark.parametrize("resized", [False, True], ids=["scale1", "resized"])
@pytest.mark.parametrize("name", ["streetwin", "indoor360"])
def test_config_test_pipelines_match_jax(tmp_path, name, resized):
    """The configs' test pipelines (LoadImageFromFile, Resize, Normalize,
    Pad, PanoCheck) through `build_pipeline` on a JPEG on disk."""
    import cv2
    h, w = (300, 600) if resized else SCALE_ONE[name]
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, (np.random.default_rng(h).random((h, w, 3)) * 255).astype(np.uint8))
    got, want = (_sample(mod, name, path) for mod in (ttr, jtr))
    for key in ("img_shape", "ori_shape", "pad_shape"):
        assert tuple(got[key]) == tuple(want[key]), key
    for key in ("scale_factor", "pano_ratio_v"):
        np.testing.assert_array_equal(got[key], want[key])
    assert got["img"].dtype == want["img"].dtype == np.float32
    if resized:
        assert tuple(got["img_shape"][:2]) != (h, w)
        np.testing.assert_allclose(got["img"], want["img"], atol=RESIZE_TOL / NORM_STD, rtol=0)
    else:
        np.testing.assert_array_equal(got["img"], want["img"])


@pytest.mark.parametrize("options", [{"img_scale": (96, 160), "keep_ratio": False},
                                     {"img_scale": [(80, 200), (120, 300), (64, 100)]},
                                     {"img_scale": [(60, 200), (120, 300)],
                                      "multiscale_mode": "range"},
                                     {"img_scale": [(60, 200), (120, 300)], "pano": True}],
                         ids=["fixed", "value", "range", "pano"])
def test_resize_options_match_jax(options, monkeypatch):
    """`keep_ratio=False`, scale lists picked with Python's `random` (the
    same seed gives the same picks) and `PanoResize`, boxes included."""
    options = dict(options)
    pano = options.pop("pano", False)
    img = (np.random.default_rng(0).random((50, 110, 3)) * 255).astype(np.float32)
    boxes = np.array([[5, 4, 60, 30], [70, 10, 109, 49]], np.float32)
    out = []
    for mod in (ttr, jtr):
        random.seed(7)
        t = (mod.PanoResize if pano else mod.Resize)(**options)
        out.append([t({"img": img.copy(), "gt_bboxes": boxes.copy()}) for _ in range(4)])
    for got, want in zip(*out):
        assert tuple(got["img_shape"]) == tuple(want["img_shape"])
        np.testing.assert_array_equal(got["scale_factor"], want["scale_factor"])
        np.testing.assert_allclose(got["gt_bboxes"], want["gt_bboxes"], rtol=1e-6)
        np.testing.assert_allclose(got["img"], want["img"], atol=RESIZE_TOL, rtol=0)
    if isinstance(options["img_scale"], list):
        assert len({tuple(r["img_shape"]) for r in out[0]}) > 1


@pytest.fixture(scope="module")
def indoor_frames(tmp_path_factory):
    """Eight 512 x 1024 frames (the indoor360 config's test scale, so the
    pipeline keeps them exact) with BFoV boxes."""
    return write_coco_set(str(tmp_path_factory.mktemp("indoor")), 8, 512, 1024, seed=6,
                          classes=tuple(f"c{i}" for i in range(37)), bfov=True)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True], ids=["eval", "train_order"])
def test_loader_batches_match_jax(indoor_frames, num_workers, shuffle):
    """`DetDataLoader` over the indoor360 config's test dataset with its
    pipeline: every key of every batch, `indices` included."""
    cfg = _config("indoor360")["data"]["test"]
    cfg = dict(cfg, ann_file=indoor_frames[0], img_prefix=indoor_frames[1])
    batches = []
    for builder, loader in ((tb, tld), (jb, jld)):
        ds = builder.build_dataset(cfg)
        batches.append(list(loader.DetDataLoader(ds, batch_size=3, shuffle=shuffle, seed=3,
                                                 num_workers=num_workers, drop_last=False,
                                                 max_gt=6)))
    got, want = batches
    assert len(got) == len(want) == (2 if shuffle else 3)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(tld.DetDataLoader(tb.build_dataset(cfg), 3, shuffle=shuffle)) == \
        len(jld.DetDataLoader(jb.build_dataset(cfg), 3, shuffle=shuffle))


def test_wrappers_and_builder_match_jax(coco_set):
    ann_file, img_dir = coco_set
    base = {"type": "StreetDataset", "ann_file": ann_file, "img_prefix": img_dir}
    cfgs = [{"type": "RepeatDataset", "times": 3, "dataset": base},
            {"type": "ClassBalancedDataset", "oversample_thr": 0.5, "dataset": base},
            {"type": "ConcatDataset", "datasets": [base, base]},
            dict(base, ann_file=[ann_file, ann_file]), [base, base]]
    for cfg in cfgs:
        got, want = tb.build_dataset(cfg), jb.build_dataset(cfg)
        assert type(got).__name__ == type(want).__name__
        assert len(got) == len(want) and got.CLASSES == want.CLASSES
        np.testing.assert_array_equal(got.flags, want.flags)
        assert all(got[i]["img_info"]["id"] == want[i]["img_info"]["id"]
                   for i in range(len(got)))
        if hasattr(want, "indices"):
            assert got.indices == want.indices
    dets = _dets_for(want.datasets[0].records * 2, 8)
    assert got.evaluate(copy.deepcopy(dets)) == want.evaluate(dets)
    pipeline = [{"type": "LoadImageFromFile"}, {"type": "LoadAnnotations", "with_bbox": True},
                {"type": "MultiScaleFlipAug", "transforms": [{"type": "ImageToTensor"}]},
                {"type": "ImageToTensor"}]
    assert tb.replace_ImageToTensor(pipeline) == jb.replace_ImageToTensor(pipeline)
    assert tb.get_loading_pipeline(pipeline) == jb.get_loading_pipeline(pipeline)
    sample = tb.build_dataset(dict(base, pipeline=[{"type": "LoadAnnotations"}]))[1]
    ref = jb.build_dataset(dict(base, pipeline=[{"type": "LoadAnnotations"}]))[1]
    for key in ("gt_bboxes", "gt_labels"):
        np.testing.assert_array_equal(sample[key], ref[key])


@pytest.mark.parametrize("step", tb.UNPORTED_PIPELINES)
def test_unported_pipeline_steps_raise(step):
    assert step in jb.PIPELINES and set(tb.PIPELINES) | set(tb.UNPORTED_PIPELINES) == \
        set(jb.PIPELINES)
    with pytest.raises(NotImplementedError, match=f"{step}.*item 17"):
        tb.build_pipeline([{"type": step}])
    # masks are ported (`test_torch_mask_pipeline.py`)
    assert ttr.LoadAnnotations(with_mask=True).with_mask
