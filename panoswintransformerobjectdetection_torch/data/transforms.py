"""The test pipeline's transforms: `Compose`, `Resize`, `Normalize`, `Pad`.

Counterpart of those four in
`panoswintransformerobjectdetection_tpu/data/transforms.py`.  Each
transform takes and returns a `results` dict: `img` (H, W, 3) float32 BGR,
`img_shape`, `ori_shape`, `scale_factor` (4,) and, after `Pad`,
`pad_shape`.  The card's machine has no OpenCV, so `Resize` is PyTorch's
bilinear `F.interpolate` (half-pixel centres, no antialias) where the JAX
package calls `cv2.resize(INTER_LINEAR)`: same sizes and scale factors,
pixel values within about 0.01 of OpenCV's on 0-255 images.  Nothing here
imports OpenCV.
"""

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, results):
        for t in self.transforms:
            results = t(results)
        return results


class Resize:
    """Keep-ratio resize to one scale (mmdet's `Resize` at test time):
    factor f = min(long_max / long, short_max / short), new sides
    int(side * f + 0.5)."""

    def __init__(self, img_scale: Sequence[int]):
        self.img_scale = tuple(img_scale)

    def __call__(self, results):
        img = results["img"]
        h, w = img.shape[:2]
        short, long_ = min(self.img_scale), max(self.img_scale)
        f = min(long_ / max(h, w), short / min(h, w))
        new_w, new_h = int(w * f + 0.5), int(h * f + 0.5)
        x = torch.from_numpy(np.ascontiguousarray(img, dtype=np.float32)).permute(2, 0, 1)
        x = F.interpolate(x[None], size=(new_h, new_w), mode="bilinear", align_corners=False,
                          antialias=False)
        img = x[0].permute(1, 2, 0).numpy()
        results["img"] = img
        results["img_shape"] = img.shape
        results["scale_factor"] = np.array([new_w / w, new_h / h, new_w / w, new_h / h],
                                           np.float32)
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
