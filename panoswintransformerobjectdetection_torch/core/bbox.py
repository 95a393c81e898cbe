"""DeltaXYWH box decoding and clipping (mmdet v2 numerics).

Counterpart of `delta_decode` and `clip_boxes` in
`panoswintransformerobjectdetection_tpu/core/bbox.py`.
"""

import math
from typing import Sequence

import torch


def delta_decode(rois: torch.Tensor, deltas: torch.Tensor,
                 means: Sequence[float] = (0., 0., 0., 0.),
                 stds: Sequence[float] = (1., 1., 1., 1.),
                 wh_ratio_clip: float = 16 / 1000) -> torch.Tensor:
    """Apply (..., 4k) deltas to (..., 4) boxes; returns (..., 4k) xyxy."""
    k = deltas.shape[-1] // 4
    means = torch.tensor(means, dtype=deltas.dtype, device=deltas.device).repeat(k)
    stds = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device).repeat(k)
    d = deltas * stds + means
    max_ratio = abs(math.log(wh_ratio_clip))
    dx, dy = d[..., 0::4], d[..., 1::4]
    dw = d[..., 2::4].clamp(-max_ratio, max_ratio)
    dh = d[..., 3::4].clamp(-max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    return out.reshape(deltas.shape)


def clip_boxes(boxes: torch.Tensor, h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Clip (B, N, 4k) xyxy boxes to [0, w] x [0, h]; h, w are (B, 1, 1)."""
    flat = boxes.reshape(boxes.shape[:-1] + (-1, 4))
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x1 = torch.minimum(torch.maximum(flat[..., 0], zero), w)
    y1 = torch.minimum(torch.maximum(flat[..., 1], zero), h)
    x2 = torch.minimum(torch.maximum(flat[..., 2], zero), w)
    y2 = torch.minimum(torch.maximum(flat[..., 3], zero), h)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(boxes.shape)
