"""The pipeline transforms: `Compose`, `LoadImageFromFile`,
`LoadAnnotations`, `Resize`, `PanoResize`, `Normalize`, `Pad`, `PanoCheck`,
`BasketBallExpand`, and the training augmentations `RandomFlip`,
`PanoStretch`, `RollAug`, `RandomCrop` and `AutoAugment`.

Counterpart of those in `panoswintransformerobjectdetection_tpu/data/
transforms.py`.  Each transform takes and returns a `results` dict: `img`
(H, W, 3) float32 BGR, `img_shape`, `ori_shape`, `scale_factor` (4,),
`pad_shape` after `Pad`, `pano_ratio_v` after `PanoCheck`, and `gt_bboxes`
and `gt_labels` (and `gt_masks`, (n, H, W) uint8 bitmaps, with
`with_mask`) after `LoadAnnotations`.  The card's machine has no OpenCV,
so `Resize` is PyTorch's bilinear `F.interpolate` (half-pixel centres, no
antialias) where the JAX package calls `cv2.resize(INTER_LINEAR)`: same
sizes and scale factors, pixel values within about 0.01 of OpenCV's on
0-255 images.  The masks are filled as `cv2.fillPoly` fills them
(`data/fill_poly.py`) and resized as `cv2.INTER_NEAREST` resizes them
(`resize_nearest`), both pixel for pixel; `RandomFlip` and `Pad` carry
them, and the augmentations that the JAX package leaves them behind in
(`PanoStretch`, `RollAug`, `RandomCrop`) refuse them.  Only
`LoadImageFromFile` reads with OpenCV, imported when it runs.  Each
augmentation draws from Python's `random` in the calls and the order of
the JAX transform, so that one seed gives both packages the same
draws; `pano_stretch` resamples with scipy's `map_coordinates`, as the JAX
package does.  The photometric distortion (OpenCV's HSV) and InstaBoost
are ROADMAP.md, Queue 1, item 17.
"""

import random
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.basketball import correct_center
from .fill_poly import fill_poly


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
    dataset parses).  `with_mask`: `gt_masks`, one (H, W) uint8 bitmap an
    object at the image's size, its COCO polygons (those of 3 points or
    more, truncated to integers) filled together as `cv2.fillPoly` fills
    them, or, without such a polygon, its box (corners truncated to
    integers)."""

    def __init__(self, with_bbox: bool = True, with_mask: bool = False, **_):
        self.with_bbox = with_bbox
        self.with_mask = with_mask

    def __call__(self, results):
        ann = results["ann_info"]
        results["gt_bboxes"] = ann["bboxes"].astype(np.float32).copy()
        results["gt_labels"] = ann["labels"].astype(np.int64).copy()
        if self.with_mask:
            h, w = results["img"].shape[:2]
            polys = ann.get("polys") or [None] * len(results["gt_bboxes"])
            masks = np.zeros((len(polys), h, w), np.uint8)
            for i, pl in enumerate(polys):
                pts = [np.asarray(pp, np.float64).reshape(-1, 2).astype(np.int32)
                       for pp in pl or () if len(pp) >= 6]
                if pts:
                    fill_poly(masks[i], pts, 1)
                    continue
                x1, y1, x2, y2 = results["gt_bboxes"][i].astype(int)
                masks[i, max(y1, 0):y2, max(x1, 0):x2] = 1
            results["gt_masks"] = masks
        return results


def resize_nearest(masks: np.ndarray, new_w: int, new_h: int) -> np.ndarray:
    """`cv2.resize(m, (new_w, new_h), interpolation=cv2.INTER_NEAREST)` of
    each (H, W) mask of `masks` (n, H, W): destination pixel x reads source
    floor(x * (1 / (new_w / W))), in double precision, clamped to W - 1
    (OpenCV's `resizeNN`), and so for y."""
    h, w = masks.shape[1:]

    def source(n_dst, n_src):
        inv = 1.0 / (n_dst / n_src)
        return np.minimum(np.floor(np.arange(n_dst) * inv).astype(np.int64), n_src - 1)

    return np.ascontiguousarray(masks[:, source(new_h, h)[:, None], source(new_w, w)[None, :]])


def refuse_masks(results, name: str) -> None:
    """Raise where `results` carries masks that `name` would leave behind
    (the JAX transform moves the image and the boxes but not the masks)."""
    if "gt_masks" in results:
        raise NotImplementedError(f"{name} with masks (LoadAnnotations(with_mask=True)): the "
                                  "JAX package leaves the masks as they are while the image "
                                  "moves; no config pairs them")

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
    if "gt_masks" in results and len(results["gt_masks"]):
        results["gt_masks"] = resize_nearest(results["gt_masks"], new_w, new_h)
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
        ph, pw = -h % self.size_divisor, -w % self.size_divisor
        img = np.pad(img, ((0, ph), (0, pw), (0, 0)))
        if (ph or pw) and "gt_masks" in results and len(results["gt_masks"]):
            results["gt_masks"] = np.pad(results["gt_masks"], ((0, 0), (0, ph), (0, pw)))
        results["img"] = img
        results["pad_shape"] = img.shape
        return results


class BasketBallExpand:
    """The basketball-corrected image appended as three more channels
    (`transforms.py:661`; the reference's own step names an undefined
    `transd`, and the JAX package implements what it meant): the image and
    `geometry/basketball.correct_center` of it at its `pano_ratio_v`
    ((0, 1) by default), (H, W, 6)."""

    def __init__(self, patch_size: int = 20):
        self.patch_size = patch_size

    def __call__(self, results):
        img = results["img"]
        ratio = tuple(results.get("pano_ratio_v", (0.0, 1.0))[:2])
        corrected = correct_center(torch.from_numpy(np.ascontiguousarray(img)),
                                   self.patch_size, ratio_v=ratio).numpy()
        results["img"] = np.concatenate([img, corrected], axis=-1)
        return results


class PanoCheck:
    """Set the full panorama's `pano_ratio_v` (0, 1) unless one is there
    (`transforms.py:1120`)."""

    def __call__(self, results):
        results.setdefault("pano_ratio_v", np.array([0.0, 1.0], np.float32))
        return results


class RandomFlip:
    """Horizontal flip with probability `flip_ratio` (one `random.random()`
    draw); boxes mirrored as w - x, masks mirrored.  Sets `flip`."""

    def __init__(self, flip_ratio: float = 0.5):
        self.flip_ratio = flip_ratio

    def __call__(self, results):
        results["flip"] = random.random() < self.flip_ratio
        if results["flip"]:
            img = np.ascontiguousarray(results["img"][:, ::-1])
            results["img"] = img
            if "gt_bboxes" in results:
                b = results["gt_bboxes"]
                flipped = b.copy()
                flipped[:, 0], flipped[:, 2] = img.shape[1] - b[:, 2], img.shape[1] - b[:, 0]
                results["gt_bboxes"] = flipped
            if "gt_masks" in results and len(results["gt_masks"]):
                results["gt_masks"] = np.ascontiguousarray(results["gt_masks"][:, :, ::-1])
        return results


def _uv_tri(w: int, h: int):
    u = (((np.arange(w) + 0.5) / w) - 0.5) * 2 * np.pi
    v = (((np.arange(h) + 0.5) / h) - 0.5) * np.pi
    uu, vv = np.meshgrid(u, v)
    return np.sin(uu), np.cos(uu), np.tan(vv)


def pano_stretch(img: np.ndarray, boxes, kx: float, ky: float):
    """Stretch the scene along the tangent axes by (kx, ky) and resample
    the equirectangular image bilinearly, wrapping at the borders (scipy's
    `map_coordinates(order=1, mode="wrap")`); boxes map through the
    closed-form warp of their corners (`xzaug.py:98 getAug`)."""
    from scipy.ndimage import map_coordinates
    h, w = img.shape[:2]
    sin_u, cos_u, tan_v = _uv_tri(w, h)
    u0 = np.arctan2(sin_u * kx / ky, cos_u)
    v0 = np.arctan(tan_v * np.sin(u0) / sin_u * ky)
    refx = (u0 / (2 * np.pi) + 0.5) * w - 0.5
    refy = (v0 / np.pi + 0.5) * h - 0.5
    out = np.stack([map_coordinates(img[..., i], [refy, refx], order=1, mode="wrap")
                    for i in range(img.shape[-1])], axis=-1)
    if boxes is not None and len(boxes):
        pts = boxes.reshape(-1, 2)
        cu0 = ((pts[:, 0] + 0.5) / w - 0.5) * 2 * np.pi
        cv0 = ((pts[:, 1] + 0.5) / h - 0.5) * np.pi
        with np.errstate(divide="ignore", invalid="ignore"):
            cu = np.arctan2(np.sin(cu0) * ky / kx, np.cos(cu0))
            cv = np.arctan(np.tan(cv0) * np.sin(cu) / np.sin(cu0) / ky)
        cv = np.where(np.abs(np.sin(cu0)) < 1e-9, np.arctan(np.tan(cv0) / ky), cv)
        px = (cu / (2 * np.pi) + 0.5) * w - 0.5
        py = (cv / np.pi + 0.5) * h - 0.5
        boxes = np.stack([px, py], -1).reshape(-1, 4).astype(np.float32)
        boxes = np.stack([np.minimum(boxes[:, 0], boxes[:, 2]),
                          np.minimum(boxes[:, 1], boxes[:, 3]),
                          np.maximum(boxes[:, 0], boxes[:, 2]),
                          np.maximum(boxes[:, 1], boxes[:, 3])], -1)
    return out, boxes


class PanoStretch:
    """With probability `chance`: kx, ky uniform in [1, kxy], each inverted
    half the time, then `pano_stretch`; boxes clipped to the image
    (`transforms.py:992`)."""

    def __init__(self, chance: float = 1.0, kxy=(2.0, 2.0)):
        self.chance = chance
        self.kxy = kxy

    def __call__(self, results):
        refuse_masks(results, "PanoStretch")
        if random.random() >= self.chance:
            return results
        kx = random.uniform(1.0, self.kxy[0])
        ky = random.uniform(1.0, self.kxy[1])
        if random.random() < 0.5:
            kx = 1.0 / kx
        if random.random() < 0.5:
            ky = 1.0 / ky
        img, boxes = pano_stretch(results["img"], results.get("gt_bboxes"), kx, ky)
        results["img"] = img.astype(np.float32)
        if boxes is not None:
            h, w = img.shape[:2]
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
            results["gt_bboxes"] = boxes
        return results


class RollAug:
    """With probability `chance`: roll the panorama right by int(d * W)
    columns, d uniform in [0, 1) (`rollaug.py:11`).  A box pushed across the
    seam keeps its larger part: with its centre past the seam it moves to
    the left edge, otherwise it is cut at the seam."""

    def __init__(self, chance: float = 1.0, clip01: bool = True):
        self.chance = chance
        self.clip01 = clip01

    def __call__(self, results):
        refuse_masks(results, "RollAug")
        if random.random() >= self.chance:
            return results
        img = results["img"]
        w = img.shape[1]
        shift = int(random.random() * w)
        results["img"] = np.ascontiguousarray(np.roll(img, shift, axis=1))
        if "gt_bboxes" in results and len(results["gt_bboxes"]):
            b = results["gt_bboxes"].copy()
            b[:, 0] += shift
            b[:, 2] += shift
            over = b[:, 2] > w
            center_over = (b[:, 0] + b[:, 2]) * 0.5 > w
            b[:, 0] = np.where(over & center_over, np.maximum(b[:, 0] - w, 0), b[:, 0])
            b[:, 2] = np.where(over & center_over, b[:, 2] - w, b[:, 2])
            b[:, 2] = np.where(over & ~center_over, w, b[:, 2])
            results["gt_bboxes"] = b
        return results


class RandomCrop:
    """mmdet's `RandomCrop`: a crop of size drawn in [crop_size, (h, w)]
    ("absolute_range") or of `crop_size` ("absolute"), at a random corner;
    boxes shifted and clipped, those left empty dropped (with none left and
    `allow_negative_crop=False` the sample stays uncropped)."""

    def __init__(self, crop_size, crop_type: str = "absolute_range",
                 allow_negative_crop: bool = True):
        self.crop_size = tuple(crop_size)
        self.crop_type = crop_type
        self.allow_negative_crop = allow_negative_crop

    def __call__(self, results):
        refuse_masks(results, "RandomCrop")
        img = results["img"]
        h, w = img.shape[:2]
        lo, hi = self.crop_size
        if self.crop_type == "absolute_range":
            ch = min(h, random.randint(min(lo, h), max(lo, min(hi, h))))
            cw = min(w, random.randint(min(lo, w), max(lo, min(hi, w))))
        else:
            ch, cw = min(lo, h), min(hi, w)
        y0 = random.randint(0, h - ch)
        x0 = random.randint(0, w - cw)
        boxes = results.get("gt_bboxes")
        if boxes is not None and len(boxes):
            b = boxes.copy()
            b[:, 0::2] -= x0
            b[:, 1::2] -= y0
            b[:, 0::2] = b[:, 0::2].clip(0, cw)
            b[:, 1::2] = b[:, 1::2].clip(0, ch)
            keep = (b[:, 2] > b[:, 0]) & (b[:, 3] > b[:, 1])
            if not keep.any() and not self.allow_negative_crop:
                return results
            results["gt_bboxes"] = b[keep]
            results["gt_labels"] = results["gt_labels"][keep]
        crop = np.ascontiguousarray(img[y0:y0 + ch, x0:x0 + cw])
        results["img"] = crop
        results["img_shape"] = crop.shape
        return results


class AutoAugment:
    """mmdet's `AutoAugment`: one of `policies` (each a list of transform
    configs, built by `data/builder.build_pipeline`), chosen with
    `random.choice` per sample."""

    def __init__(self, policies):
        from .builder import build_pipeline
        self.policies = [Compose(build_pipeline(p)) for p in policies]

    def __call__(self, results):
        return random.choice(self.policies)(results)
