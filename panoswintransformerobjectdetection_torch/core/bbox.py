"""Box overlaps, DeltaXYWH encoding and decoding, clipping (mmdet v2 numerics).

Counterpart of `bbox_overlaps`, `delta_encode`, `delta_decode`,
`clip_boxes` and `flip_boxes` in
`panoswintransformerobjectdetection_tpu/core/bbox.py`.
"""

import math
from typing import Sequence

import torch


def bbox_overlaps(a: torch.Tensor, b: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """All-pairs IoU: (..., N, 4), (..., M, 4) -> (..., N, M); areas are not
    clamped, the union is clamped at `eps`."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    overlap = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - overlap
    return overlap / union.clamp(min=eps)


def delta_encode(proposals: torch.Tensor, gt: torch.Tensor,
                 means: Sequence[float] = (0., 0., 0., 0.),
                 stds: Sequence[float] = (1., 1., 1., 1.)) -> torch.Tensor:
    """(..., 4) xyxy boxes and their targets -> normalised (dx, dy, dw, dh).
    Widths and heights are clamped at 1e-6, so a padded or degenerate box
    stays finite."""
    eps = 1e-6
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = (proposals[..., 2] - proposals[..., 0]).clamp(min=eps)
    ph = (proposals[..., 3] - proposals[..., 1]).clamp(min=eps)
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = (gt[..., 2] - gt[..., 0]).clamp(min=eps)
    gh = (gt[..., 3] - gt[..., 1]).clamp(min=eps)
    d = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw), torch.log(gh / ph)],
                    dim=-1)
    means = torch.tensor(means, dtype=d.dtype, device=d.device)
    stds = torch.tensor(stds, dtype=d.dtype, device=d.device)
    return (d - means) / stds


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


def flip_boxes(boxes: torch.Tensor, img_w: float) -> torch.Tensor:
    """Horizontal flip of (..., 4) xyxy boxes in an image of width `img_w`."""
    return torch.stack([img_w - boxes[..., 2], boxes[..., 1], img_w - boxes[..., 0],
                        boxes[..., 3]], dim=-1)
