"""The PyTorch port's training augmentations against the JAX package's.

Each transform draws from Python's `random` in the JAX transform's calls and
order, so under the same `random.seed` both packages make the same draws.
Tolerances: images and boxes exact for `RandomFlip`, `RollAug` (seam cases
included), `RandomCrop`, `AutoAugment` and `PanoStretch` (the same numpy and
scipy operations on the same values); the configs' whole training
pipelines, whose multiscale `Resize` is PyTorch's bilinear `F.interpolate`
where the JAX package calls OpenCV, hold boxes and scale factors exact and
pixels within 0.02 of OpenCV's on 0-255 images (as `test_torch_data.py`).
"""

import os
import random

import numpy as np
import pytest

from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.data import transforms as jtr
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.data import transforms as ttr
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from torch_port_common import single_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_CONFIGS = ("faster_rcnn_panoswin_tiny_patch4_window7_streetwin.py",
                 "faster_rcnn_panoswin_tiny_bf16_streetwin.py",
                 "faster_rcnn_panoswin_small_streetwin.py",
                 "faster_rcnn_panoswin_tiny_planar_streetwin.py",
                 "faster_rcnn_panoswin_v2_tiny_streetwin.py",
                 "faster_rcnn_panoswin_tiny_indoor360.py")
NORM_STD = 57.12            # the smallest std of the configs' Normalize
RESIZE_TOL = 0.02           # on 0-255 images
H, W = 48, 96


def _sample(seed=0):
    """A 0-255 frame and boxes, two of them at the right edge, one across
    most of the width, one a sliver."""
    rng = np.random.default_rng(seed)
    img = (rng.random((H, W, 3)) * 255).astype(np.float32)
    boxes = np.array([[2, 3, 20, 30], [70, 5, 95, 40], [88, 10, 96, 20], [5, 1, 90, 47],
                      [40, 20, 41, 21]], np.float32)
    return {"img": img, "img_shape": img.shape, "ori_shape": img.shape,
            "gt_bboxes": boxes, "gt_labels": np.arange(len(boxes), dtype=np.int64)}


def _run(make, n=6, seed=3):
    """`n` samples through the transform that `make(module)` builds in each
    package, after the same `random.seed`; the draws left after them too."""
    out = []
    for mod in (ttr, jtr):
        random.seed(seed)
        t = make(mod)
        out.append(([t(_sample(i)) for i in range(n)], random.random()))
    return out


def _equal(got, want):
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if w is None:
            continue
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("ratio", [0.0, 0.5, 1.0])
def test_random_flip_matches_jax(ratio):
    (got, g_next), (want, w_next) = _run(lambda m: m.RandomFlip(flip_ratio=ratio))
    _equal(got, want)
    assert g_next == w_next
    flips = {r["flip"] for r in got}
    assert flips == ({False}, {False, True}, {True})[int(2 * ratio)]


@pytest.mark.parametrize("chance", [1.0, 0.5])
def test_roll_aug_matches_jax(chance):
    (got, g_next), (want, w_next) = _run(lambda m: m.RollAug(chance=chance), n=10)
    _equal(got, want)
    assert g_next == w_next
    rolled = [r for r, s in zip(got, range(10)) if not np.array_equal(r["img"], _sample(s)["img"])]
    assert rolled and (chance == 1.0 or len(rolled) < 10)


@pytest.mark.parametrize("shift", [0.0, 0.05, 0.3, 0.5, 0.99])
def test_roll_aug_seam_cases_match_jax(shift, monkeypatch):
    """Fixed shifts push the edge boxes across the seam: one mostly past it
    (moved to the left edge), one mostly before it (cut at the seam)."""
    out = []
    for mod in (ttr, jtr):
        draws = iter([0.0, shift])
        monkeypatch.setattr(mod.random, "random", lambda: next(draws))
        out.append(mod.RollAug(chance=1.0)(_sample(1)))
    _equal([out[0]], [out[1]])
    b = out[0]["gt_bboxes"]
    assert (b[:, 2] <= W).all() and (b[:, 0] >= 0).all()


@pytest.mark.parametrize("kxy", [(2.0, 2.0), (1.5, 3.0)])
@pytest.mark.parametrize("chance", [1.0, 0.5])
def test_pano_stretch_matches_jax(kxy, chance):
    (got, g_next), (want, w_next) = _run(lambda m: m.PanoStretch(chance=chance, kxy=kxy), n=4)
    _equal(got, want)
    assert g_next == w_next
    b = got[0]["gt_bboxes"]
    assert (b[:, 0::2] <= W).all() and (b[:, 1::2] <= H).all() and (b >= 0).all()


@pytest.mark.parametrize("k", [(1.0, 1.0), (0.5, 2.0), (1.7, 0.6)])
def test_pano_stretch_function_matches_jax(k):
    s = _sample(2)
    got = ttr.pano_stretch(s["img"], s["gt_bboxes"], *k)
    want = jtr.pano_stretch(s["img"], s["gt_bboxes"], *k)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("options", [{"crop_size": (20, 60)},
                                     {"crop_size": (30, 40), "crop_type": "absolute"},
                                     {"crop_size": (8, 10), "crop_type": "absolute",
                                      "allow_negative_crop": False},
                                     {"crop_size": (60, 200)}],
                         ids=["range", "absolute", "no_negative", "larger"])
def test_random_crop_matches_jax(options):
    (got, g_next), (want, w_next) = _run(lambda m: m.RandomCrop(**options), n=8)
    _equal(got, want)
    assert g_next == w_next


def test_auto_augment_matches_jax():
    policies = [[{"type": "RandomFlip", "flip_ratio": 1.0}],
                [{"type": "RollAug", "chance": 1.0}, {"type": "RandomFlip", "flip_ratio": 0.5}],
                [{"type": "RandomCrop", "crop_size": (20, 40)}]]
    (got, g_next), (want, w_next) = _run(lambda m: m.AutoAugment(policies), n=10)
    _equal(got, want)
    assert g_next == w_next


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_config_train_pipelines_match_jax(tmp_path, config):
    """The config's whole `train_pipeline` through each package's
    `build_pipeline`, from a JPEG on disk, three samples under one seed."""
    import cv2
    cfg = load_config(os.path.join(ROOT, "configs", "panoswin", config))
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, (np.random.default_rng(5).random((H, W, 3)) * 255).astype(np.uint8))
    ann = _sample()
    out = []
    for mod, builder in ((ttr, tb), (jtr, jb)):
        random.seed(11)
        pipeline = mod.Compose(builder.build_pipeline(cfg["train_pipeline"]))
        out.append([pipeline({"img_path": path, "img_info": {},
                              "ann_info": {"bboxes": ann["gt_bboxes"],
                                           "labels": ann["gt_labels"]}}) for _ in range(3)])
    for got, want in zip(*out):
        assert set(got) == set(want)
        for key in ("img_shape", "ori_shape", "pad_shape"):
            assert tuple(got[key]) == tuple(want[key]), key
        for key in ("scale_factor", "pano_ratio_v", "gt_bboxes", "gt_labels"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        assert got["flip"] == want["flip"]
        assert got["img"].dtype == want["img"].dtype == np.float32
        np.testing.assert_allclose(got["img"], want["img"], atol=RESIZE_TOL / NORM_STD, rtol=0)
    if "streetwin" in config:
        assert len({r["img_shape"] for r in out[0]}) > 1      # multiscale


def test_unported_training_steps_name_item_17():
    """What stays unported: OpenCV's HSV jitter and InstaBoost."""
    assert set(tb.UNPORTED_PIPELINES) == {"PhotoMetricDistortion", "InstaBoost"}
    for step in ("RandomFlip", "PanoStretch", "RollAug", "RandomCrop", "AutoAugment"):
        assert tb.PIPELINES[step] is getattr(ttr, step)
