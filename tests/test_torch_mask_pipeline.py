"""Masks through the PyTorch port's training pipeline, against OpenCV and the
JAX package's transforms.

The polygon fill (`data/fill_poly.py`) equals `cv2.fillPoly` bit for bit on
random polygons (hypothesis: concave and self-touching ones, vertices off
the image, several polygons an object, so holes) and on chosen shapes;
`LoadAnnotations(with_mask=True)` equals the JAX package's, which fills
with OpenCV, polygons of fewer than 3 points and the box fallback
included.  The mask `Resize` equals `cv2.INTER_NEAREST` at the 11 scales of
`configs/_base_/datasets/coco_instance.py` from a 480 x 640 frame;
`RandomFlip` and `Pad` carry the masks as JAX's do under one
`random.seed`; `PanoStretch`, `RollAug` and `RandomCrop`, which the JAX
package lets leave the masks behind, refuse them.  The config's whole
`train_pipeline`, dataset and loader: masks, boxes and labels equal,
images within 0.02 of JAX's on the 0-255 scale (the port resizes with
`F.interpolate`, JAX with `cv2.resize`).
"""

import json
import os
import random

import cv2
import numpy as np
import pytest
from hypothesis import example, given, settings
from hypothesis import strategies as st

from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.data import transforms as jtr
from panoswintransformerobjectdetection_tpu.data.loader import DetDataLoader as JaxLoader
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.data import transforms as ttr
from panoswintransformerobjectdetection_torch.data.datasets import CocoDataset
from panoswintransformerobjectdetection_torch.data.fill_poly import fill_poly
from panoswintransformerobjectdetection_torch.data.loader import DetDataLoader
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from torch_port_common import single_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MSTRAIN = os.path.join(ROOT, "configs/swin/"
                       "mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py")
SCALES = [s for s, _ in load_config(MSTRAIN)["data"]["train"]["pipeline"][3]["img_scale"]]

_coord = st.integers(-20, 70)
_polygon = st.lists(st.tuples(_coord, _coord), min_size=3, max_size=10)


def _fill_both(h, w, polys):
    polys = [np.asarray(p, np.int32).reshape(-1, 2) for p in polys]
    ref = np.zeros((h, w), np.uint8)
    cv2.fillPoly(ref, polys, 1)
    got = np.zeros((h, w), np.uint8)
    fill_poly(got, polys, 1)
    return got, ref


@settings(max_examples=400, deadline=None, derandomize=True, database=None)
@given(st.integers(1, 48), st.integers(1, 48), st.lists(_polygon, min_size=1, max_size=4))
@example(30, 30, [[(5, 5), (25, 5), (25, 25), (5, 25)], [(10, 10), (18, 10), (18, 18), (10, 18)]])
@example(30, 30, [[(2, 2), (28, 28), (28, 2), (2, 28)]])                 # a bow tie
@example(30, 30, [[(2, 2), (15, 15), (28, 2), (28, 28), (15, 15), (2, 28)]])   # self-touching
@example(20, 20, [[(-10, -5), (10, 10), (-5, 25)], [(0, 14), (-4, 0), (-5, -4)]])  # off-image
@example(12, 12, [[(5, 5), (5, 5), (5, 5)], [(1, 1), (6, 6), (11, 11)]])  # no area
def test_fill_poly_matches_cv2(h, w, polys):
    got, ref = _fill_both(h, w, polys)
    assert np.array_equal(got, ref)


def test_fill_poly_fills_concave_shapes_and_holes():
    """A U shape (concave) and a ring (one object of two polygons): the
    inside of the U's notch and the ring's hole stay 0, as in OpenCV."""
    u = [(4, 4), (26, 4), (26, 26), (18, 26), (18, 12), (12, 12), (12, 26), (4, 26)]
    got, ref = _fill_both(30, 30, [u])
    assert np.array_equal(got, ref) and got[20, 15] == 0 and got[8, 15] == 1
    ring = [[(2, 2), (27, 2), (27, 27), (2, 27)], [(9, 9), (20, 9), (20, 20), (9, 20)]]
    got, ref = _fill_both(30, 30, ring)
    assert np.array_equal(got, ref) and got[15, 15] == 0 and got[5, 15] == 1


def _ann_results(h, w, boxes, polys):
    return {"img": np.zeros((h, w, 3), np.float32),
            "ann_info": {"bboxes": np.asarray(boxes, np.float32),
                         "labels": np.arange(len(boxes), dtype=np.int64), "polys": polys}}


def test_load_annotations_with_masks_matches_jax():
    """One object a case: a float polygon; two polygons (a hole); a
    polygon of fewer than 3 points beside a good one; only short polygons
    (the box fallback); no polygon (None); a box over the border; and a
    record without `polys` (every object its box)."""
    h, w = 40, 56
    boxes = [[3.5, 2.2, 30.9, 20.7], [1, 1, 50, 38], [10, 10, 40, 30], [5.7, 6.2, 20.9, 30.1],
             [0, 0, 12, 9], [-4.5, 30.2, 60, 50]]
    polys = [[[3.5, 2.2, 30.9, 4.1, 20.2, 20.7, 4.4, 18.3]],
             [[1, 1, 50, 1, 50, 38, 1, 38], [10, 10, 30, 10, 30, 30, 10, 30]],
             [[10, 10, 40, 12], [12, 11, 39.6, 14, 25, 29.9]],
             [[5, 6, 20, 30]],
             None,
             [[-4.5, 30.2, 60, 31, 30, 50]]]
    for p in (polys, None):
        got = ttr.LoadAnnotations(with_mask=True)(_ann_results(h, w, boxes, p))
        ref = jtr.LoadAnnotations(with_mask=True)(_ann_results(h, w, boxes, p))
        assert got["gt_masks"].dtype == np.uint8 and got["gt_masks"].shape == (6, h, w)
        assert np.array_equal(got["gt_masks"], ref["gt_masks"])
        assert np.array_equal(got["gt_bboxes"], ref["gt_bboxes"])
    # the short polygons' object is its box, truncated to integers
    assert got["gt_masks"][3].sum() == (30 - 6) * (20 - 5)


@pytest.mark.parametrize("short", SCALES)
def test_mask_resize_matches_cv2_nearest(short):
    """`Resize((short, 1333))` of a 480 x 640 frame with 3 masks and boxes:
    the masks equal JAX's (`cv2.INTER_NEAREST`), the size, scale factor and
    boxes equal."""
    rng = np.random.default_rng(short)
    masks = (rng.random((3, 480, 640)) > 0.5).astype(np.uint8)
    boxes = np.array([[10, 20, 300, 400], [0, 0, 640, 480], [100.5, 50.2, 101.7, 52.9]],
                     np.float32)
    out = []
    for tr in (ttr, jtr):
        res = {"img": np.ones((480, 640, 3), np.float32),
               "gt_bboxes": boxes.copy(), "gt_masks": masks.copy()}
        out.append(tr.Resize((short, 1333), keep_ratio=True)(res))
    got, ref = out
    assert got["gt_masks"].shape == (3, *ref["img"].shape[:2]) == ref["gt_masks"].shape
    assert np.array_equal(got["gt_masks"], ref["gt_masks"])
    assert np.array_equal(got["scale_factor"], ref["scale_factor"])
    np.testing.assert_array_equal(got["gt_bboxes"], ref["gt_bboxes"])


def test_flip_and_pad_carry_masks_as_jax():
    """`RandomFlip` under one `random.seed` (flips and no flips), then `Pad`
    to 32 of a 50 x 70 frame: masks, boxes and shapes equal JAX's."""
    rng = np.random.default_rng(3)
    masks = (rng.random((2, 50, 70)) > 0.7).astype(np.uint8)
    boxes = np.array([[3, 4, 30, 40], [20, 1, 69, 49]], np.float32)
    flips = set()
    for seed in range(6):
        out = []
        for tr in (ttr, jtr):
            random.seed(seed)
            res = {"img": rng.random((50, 70, 3)).astype(np.float32), "gt_bboxes": boxes.copy(),
                   "gt_masks": masks.copy()}
            res = tr.RandomFlip(0.5)(res)
            out.append(tr.Pad(32)(res))
        got, ref = out
        flips.add(got["flip"])
        assert got["flip"] == ref["flip"] and got["gt_masks"].shape == (2, 64, 96)
        assert np.array_equal(got["gt_masks"], ref["gt_masks"])
        np.testing.assert_array_equal(got["gt_bboxes"], ref["gt_bboxes"])
        assert got["pad_shape"] == ref["pad_shape"]
    assert flips == {True, False}


@pytest.mark.parametrize("step", [ttr.RandomCrop((20, 30)), ttr.PanoStretch(), ttr.RollAug()],
                         ids=["RandomCrop", "PanoStretch", "RollAug"])
def test_augmentations_refuse_masks(step):
    """The JAX transforms move the image (and drop or move boxes) but not
    the masks; the port's refuse them and leave a sample without masks to
    do its work."""
    res = {"img": np.zeros((40, 60, 3), np.float32),
           "gt_bboxes": np.array([[1, 1, 20, 20]], np.float32), "gt_labels": np.zeros(1, np.int64)}
    with pytest.raises(NotImplementedError, match="masks"):
        step(dict(res, gt_masks=np.zeros((1, 40, 60), np.uint8)))
    random.seed(0)
    assert "gt_masks" not in step(res)


def _coco_polygons(root, n, h, w, seed):
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, anns = [], []
    for i in range(n):
        cv2.imwrite(os.path.join(img_dir, f"{i}.png"),
                    (rng.random((h, w, 3)) * 255).astype(np.uint8))
        images.append({"id": i, "file_name": f"{i}.png", "width": w, "height": h})
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
            ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
            rad = rng.uniform(6, 0.3 * min(h, w)) * rng.uniform(0.6, 1.0, 6)
            xs, ys = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
            poly = [float(v) for v in np.stack([xs, ys], 1).reshape(-1)]
            anns.append({"id": len(anns) + 1, "image_id": i, "iscrowd": 0,
                         "category_id": int(rng.integers(1, 81)), "area": 100.0,
                         "bbox": [float(xs.min()), float(ys.min()), float(np.ptp(xs)),
                                  float(np.ptp(ys))], "segmentation": [poly]})
    cats = [{"id": k + 1, "name": c} for k, c in enumerate(CocoDataset.CLASSES)]
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns, "categories": cats}, f)
    return path, img_dir


def test_coco_instance_train_pipeline_matches_jax(tmp_path):
    """The mstrain config's `train_pipeline` (masks, flip, 11-scale resize,
    pad 32) over 4 synthetic 120 x 160 frames with polygons, datasets and
    loaders of both packages under one `random.seed`: each batch's masks,
    boxes, labels and shapes equal, images within 0.02 / 57.12 of JAX's
    after `Normalize` (0.02 on the 0-255 scale, divided by the smallest
    standard deviation)."""
    cfg = load_config(MSTRAIN)
    train = dict(cfg["data"]["train"])
    train["ann_file"], train["img_prefix"] = _coco_polygons(str(tmp_path), 4, 120, 160, 4)
    assert [p["type"] for p in train["pipeline"]] == ["LoadImageFromFile", "LoadAnnotations",
                                                     "RandomFlip", "Resize", "Normalize", "Pad"]
    batches = []
    for builder, loader in ((tb, DetDataLoader), (jb, JaxLoader)):
        random.seed(11)
        ds = builder.build_dataset(train)
        batches.append(list(loader(ds, batch_size=2, max_gt=4, seed=2, num_workers=0)))
    shapes = set()
    for got, ref in zip(*batches):
        for key in ("gt_masks", "gt_boxes", "gt_labels", "gt_valid", "img_shapes"):
            assert np.array_equal(got[key], ref[key]), key
        assert got["gt_masks"].any() and got["gt_masks"].shape[2:] == got["images"].shape[1:3]
        np.testing.assert_allclose(got["images"], ref["images"], atol=0.02 / 57.12)
        shapes.add(got["images"].shape[1:3])
    assert len(batches[0]) == 2 and all(s[0] >= 480 for s in shapes)
