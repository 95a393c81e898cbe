"""The test-time pipeline transforms: `Compose`, `LoadImageFromFile`,
`LoadAnnotations`, `Resize`, `PanoResize`, `Normalize`, `Pad`, `PanoCheck`.

Counterpart of those in `panoswintransformerobjectdetection_tpu/data/
transforms.py`.  Each transform takes and returns a `results` dict: `img`
(H, W, 3) float32 BGR, `img_shape`, `ori_shape`, `scale_factor` (4,),
`pad_shape` after `Pad`, `pano_ratio_v` after `PanoCheck`, and `gt_bboxes`
and `gt_labels` after `LoadAnnotations`.  The card's machine has no OpenCV,
so `Resize` is PyTorch's bilinear `F.interpolate` (half-pixel centres, no
antialias) where the JAX package calls `cv2.resize(INTER_LINEAR)`: same
sizes and scale factors, pixel values within about 0.01 of OpenCV's on
0-255 images.  Only `LoadImageFromFile` reads with OpenCV, imported when it
runs.  The training transforms (flip, stretch, roll, crop, photometric,
masks) are ROADMAP.md, Queue 1, item 16.
"""

import random
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Compose:
    """The transforms in order; a transform that returns None drops the sample."""

    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
            if results is None:
                return None
        return results


class LoadImageFromFile:
    """Read `results["img_path"]` with OpenCV (BGR), float32 unless asked."""

    def __init__(self, to_float32: bool = True):
        self.to_float32 = to_float32

    def __call__(self, results):
        import cv2
        path = results["img_path"]
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        if self.to_float32:
            img = img.astype(np.float32)
        results["img"] = img
        results["img_shape"] = img.shape
        results["ori_shape"] = img.shape
        results.setdefault("scale_factor", np.ones(4, np.float32))
        return results


class LoadAnnotations:
    """The parsed boxes and labels of `results["ann_info"]` as `gt_bboxes`
    and `gt_labels` (the pano variant's BFoV conversion runs when the
    dataset parses).  Masks are not ported (ROADMAP.md, Queue 1, item 16)."""

    def __init__(self, with_bbox: bool = True, with_mask: bool = False, **_):
        if with_mask:
            raise NotImplementedError("LoadAnnotations(with_mask=True) is not ported yet "
                                      "(ROADMAP.md, Queue 1, item 16)")
        self.with_bbox = with_bbox

    def __call__(self, results):
        ann = results["ann_info"]
        results["gt_bboxes"] = ann["bboxes"].astype(np.float32).copy()
        results["gt_labels"] = ann["labels"].astype(np.int64).copy()
        return results


def resize_image(img: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """Bilinear resize of an (H, W, C) image, half-pixel centres, float32."""
    x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).permute(2, 0, 1)
    x = F.interpolate(x[None], size=(new_h, new_w), mode="bilinear", align_corners=False,
                      antialias=False)
    return x[0].permute(1, 2, 0).numpy()


class Resize:
    """mmdet's `Resize`.  `img_scale` is one scale or a list of them; with a
    list, `multiscale_mode` "value" picks one with Python's `random`, and
    "range" draws the short side between the list's extremes, as the JAX
    package does.  `keep_ratio`: factor f = min(long_max / long, short_max /
    short), new sides int(side * f + 0.5); otherwise the scale is (h, w).
    Boxes, when present, are scaled and clipped to the image."""

    def __init__(self, img_scale, keep_ratio: bool = True, multiscale_mode: str = "value"):
        if isinstance(img_scale[0], (int, float)):
            img_scale = [tuple(img_scale)]
        self.img_scale = [tuple(s) for s in img_scale]
        self.keep_ratio = keep_ratio
        self.multiscale_mode = multiscale_mode

    def _pick_scale(self):
        if len(self.img_scale) == 1:
            return self.img_scale[0]
        if self.multiscale_mode == "value":
            return random.choice(self.img_scale)
        shorts = [min(s) for s in self.img_scale]
        longs = [max(s) for s in self.img_scale]
        return (random.randint(min(shorts), max(shorts)), max(longs))

    def __call__(self, results):
        h, w = results["img"].shape[:2]
        scale = self._pick_scale()
        if self.keep_ratio:
            short, long_ = min(scale), max(scale)
            f = min(long_ / max(h, w), short / min(h, w))
            new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
        else:
            new_h, new_w = scale
        return _resized(results, new_w, new_h, clip=True)


class PanoResize(Resize):
    """Resize that keeps a panorama whole: the height goes to the scale's
    short side and the width follows (`transforms.py:347 PanoResize`)."""

    def __call__(self, results):
        h, w = results["img"].shape[:2]
        f = min(self._pick_scale()) / h
        return _resized(results, int(w * f + 0.5), int(h * f + 0.5), clip=False)


def _resized(results, new_w: int, new_h: int, clip: bool):
    h, w = results["img"].shape[:2]
    img = resize_image(results["img"], new_w, new_h)
    w_f, h_f = new_w / w, new_h / h
    results["img"] = img
    results["img_shape"] = img.shape
    results["scale_factor"] = np.array([w_f, h_f, w_f, h_f], np.float32)
    if "gt_bboxes" in results:
        b = results["gt_bboxes"] * results["scale_factor"]
        if clip:
            b[:, 0::2] = b[:, 0::2].clip(0, new_w)
            b[:, 1::2] = b[:, 1::2].clip(0, new_h)
        results["gt_bboxes"] = b
    return results


class Normalize:
    """(img - mean) / std in float32, BGR turned to RGB first (`to_rgb`)."""

    def __init__(self, mean, std, to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, results):
        img = results["img"].astype(np.float32)
        if self.to_rgb:
            img = img[..., ::-1]
        results["img"] = (img - self.mean) / self.std
        return results


class Pad:
    """Zero-pad the bottom and right edges to multiples of `size_divisor`."""

    def __init__(self, size_divisor: int = 32):
        self.size_divisor = size_divisor

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        img = np.pad(img, ((0, -h % self.size_divisor), (0, -w % self.size_divisor), (0, 0)))
        results["img"] = img
        results["pad_shape"] = img.shape
        return results


class PanoCheck:
    """Set the full panorama's `pano_ratio_v` (0, 1) unless one is there
    (`transforms.py:1120`)."""

    def __call__(self, results):
        results.setdefault("pano_ratio_v", np.array([0.0, 1.0], np.float32))
        return results
