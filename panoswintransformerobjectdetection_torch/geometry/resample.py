"""Bilinear grid resampling and torch's bicubic weights.

Counterpart of `grid_sample_nhwc` and `_torch_cubic_weights` in
`panoswintransformerobjectdetection_tpu/geometry/resample.py`.  The JAX
package writes out `torch.nn.functional.grid_sample`'s conventions (grid in
[-1, 1], (x, y) order, `align_corners=False`, border or zeros padding) as a
gather and a four-tap blend for XLA; here it is `F.grid_sample` itself.
"""

import numpy as np
import torch
import torch.nn.functional as F


def grid_sample_nhwc(img: torch.Tensor, grid: torch.Tensor, padding_mode: str = "border",
                     align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample of img (B, H, W, C) at grid (B, Hg, Wg, 2) -> (B, Hg, Wg, C)."""
    if padding_mode not in ("border", "zeros"):
        raise ValueError(f"unsupported padding_mode: {padding_mode}")
    out = F.grid_sample(img.permute(0, 3, 1, 2), grid.to(img.dtype), mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    return out.permute(0, 2, 3, 1)


def _torch_cubic_weights(out_size: int, in_size: int, align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) float64 weights of torch's bicubic kernel
    (cubic convolution, A = -0.75; `F.interpolate(mode='bicubic')`), border
    taps clamped and summed as the aten kernels do."""
    A = -0.75

    def k(t):
        t = np.abs(t)
        return np.where(t <= 1, ((A + 2) * t - (A + 3)) * t * t + 1,
                        np.where(t < 2, A * (((t - 5) * t + 8) * t - 4), 0.0))

    i = np.arange(out_size, dtype=np.float64)
    if align_corners and out_size > 1:
        src = i * (in_size - 1) / (out_size - 1)
    else:
        src = (i + 0.5) * in_size / out_size - 0.5
    f = np.floor(src)
    frac = src - f
    W = np.zeros((out_size, in_size), np.float64)
    for tap in (-1, 0, 1, 2):
        idx = np.clip(f.astype(np.int64) + tap, 0, in_size - 1)
        np.add.at(W, (np.arange(out_size), idx), k(frac - tap))
    return W
