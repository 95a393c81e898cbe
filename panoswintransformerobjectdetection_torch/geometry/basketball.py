"""Basketball ("scalp") transform: latitude-dependent per-patch rescaling.

Counterpart of `panoswintransformerobjectdetection_tpu/geometry/basketball.py`
(`patch_latitudes`, `stb_adjacency`, `correct_center_map`, `correct_center`,
`correct_center_traced`).  Each patch-row of an equirectangular image is
shrunk horizontally by cos(latitude), centred in its patch, zero elsewhere:
a target width s = round(cos(v) * p) (half to even), and output local column
t in [start, start + s) reads input local column floor((t - start) * p / s)
(nearest interpolation).  The static map is numpy, for a known ratio (the
data pipeline); `correct_center_traced` builds the same gather from a batch
of ratios held in a tensor (the model's per-image `pano_ratio_v`).
Images are (..., H, W, C).
"""

import math
from typing import Sequence, Tuple

import numpy as np
import torch

PI = math.pi


def patch_latitudes(h: int, patch_size: int,
                    ratio_v: Sequence[float] = (0.0, 1.0)) -> np.ndarray:
    """v of each patch-row centre: gap = patch / H * pi * (v1 - v0),
    v = (i + 0.5) * gap + (v0 - 0.5) * pi."""
    n_py = -(-h // patch_size)
    gap_uv = patch_size / h * PI * (ratio_v[1] - ratio_v[0])
    return (np.arange(n_py) + 0.5) * gap_uv + (ratio_v[0] - 0.5) * PI


def stb_adjacency(shape_hw: Tuple[int, int], patch_size: int,
                  ratio_v: Sequence[float] = (0.0, 1.0)) -> Tuple[bool, bool, bool]:
    """(side, top, bottom) sphere adjacency: does the pano wrap at the seam,
    touch the north pole, touch the south pole?"""
    h, w = shape_hw
    gap_uv = patch_size / h * PI * (ratio_v[1] - ratio_v[0])
    u_len = w / patch_size * gap_uv
    return (u_len + 0.5 * gap_uv > 2 * PI,
            ratio_v[0] < 1e-5,
            ratio_v[1] + 1e-5 > 1.0)


def correct_center_map(h: int, w: int, patch_size: int,
                       ratio_v: Sequence[float] = (0.0, 1.0)):
    """The (H, W) column-gather map and validity mask of the rescale, numpy
    (they depend on the shape, the patch and the ratio only)."""
    p = patch_size
    vs = patch_latitudes(h, p, ratio_v)
    n_py = len(vs)
    sizes = np.round(np.cos(vs) * p).astype(int)

    local = np.arange(p)
    src_local = np.zeros((n_py, p), np.int64)
    valid = np.zeros((n_py, p), bool)
    for i, s in enumerate(sizes):
        if s < 1:
            continue
        start = (p - s) // 2
        t = local - start
        ok = (t >= 0) & (t < s)
        src = np.clip((t * p) // s, 0, p - 1)
        src_local[i] = np.where(ok, src, 0)
        valid[i] = ok

    rows = np.minimum(np.arange(h) // p, n_py - 1)
    cols = np.arange(w)
    gx = np.minimum((cols // p) * p + src_local[rows][:, cols % p], w - 1)
    return gx.astype(np.int64), valid[rows][:, cols % p]


def _gather_columns(img: torch.Tensor, gx: torch.Tensor, ok: torch.Tensor,
                    padding_value: float) -> torch.Tensor:
    """img (..., H, W, C) read at columns gx (..., H, W), `padding_value`
    where `ok` is false."""
    idx = gx[..., None].expand(*img.shape[:-1], img.shape[-1])
    out = torch.gather(img, -2, idx)
    return torch.where(ok[..., None], out, padding_value)


def correct_center(img: torch.Tensor, patch_size: int,
                   ratio_v: Sequence[float] = (0.0, 1.0),
                   padding_value: float = 0.0) -> torch.Tensor:
    """The basketball rescale of img (..., H, W, C) at a known ratio."""
    h, w = img.shape[-3], img.shape[-2]
    gx, vmask = correct_center_map(h, w, patch_size, ratio_v)
    lead = img.shape[:-3]
    gx = torch.from_numpy(gx).to(img.device).expand(*lead, h, w)
    ok = torch.from_numpy(vmask).to(img.device).expand(*lead, h, w)
    return _gather_columns(img, gx, ok, padding_value)


def correct_center_traced(img: torch.Tensor, patch_size: int,
                          pano_ratio_v: torch.Tensor,
                          padding_value: float = 0.0) -> torch.Tensor:
    """The basketball rescale of a batch img (B, H, W, C), image b at its
    own ratio pano_ratio_v[b] = (v0, v1, ori_h), on the device.

    The gap is measured against ori_h, the original height, not H (the
    reference model path's `length=pano_ratio_v[i][2]`), and the target
    widths round half to even (`torch.round`).  A row past the last whole
    patch-row takes the last one's widths; W is a multiple of the patch
    where the model calls it (after its pad)."""
    B, h, w, _ = img.shape
    p = patch_size
    n_py = h // p
    r = pano_ratio_v.to(device=img.device, dtype=torch.float32)
    v0, v1, ori_h = r[:, 0:1], r[:, 1:2], r[:, 2:3]
    gap = p / ori_h * PI * (v1 - v0)                                   # (B, 1)
    v_rows = (torch.arange(n_py, dtype=torch.float32, device=img.device) + 0.5) * gap \
        + (v0 - 0.5) * PI                                              # (B, n_py)
    sizes = torch.round(torch.cos(v_rows) * p).to(torch.int64)
    ys = (torch.arange(h, device=img.device) // p).clamp(max=n_py - 1)
    s = sizes[:, ys][:, :, None]                                       # (B, h, 1)
    cols = torch.arange(w, device=img.device)
    t = (cols % p)[None, None, :] - torch.div(p - s, 2, rounding_mode="floor")
    ok = (t >= 0) & (t < s) & (s >= 1)
    src = torch.div(t * p, s.clamp(min=1), rounding_mode="floor").clamp(0, p - 1)
    gx = ((cols // p) * p + src).clamp(max=w - 1)                      # (B, h, w)
    return _gather_columns(img, gx, ok, padding_value)
