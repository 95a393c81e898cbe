"""Fixed-shape greedy NMS, batched over independent problems.

Counterpart of `nms`, `batched_nms`, `multiclass_nms` and `DetResult` in
`panoswintransformerobjectdetection_tpu/ops/nms.py`.  Plain PyTorch: the
JAX package runs NMS through XLA, not through a Pallas kernel.  Greedy
survivorship is the fixed point of `alive = valid & ~any_{j<i}(over[j, i] &
alive[j])` over the score-sorted IoU matrix; iterating from `valid` fixes
one more leading candidate per step, so the loop ends at the exact greedy
result.  Ties keep the input order, as `jnp.argsort(-s)` and `lax.top_k` do.
"""

from typing import NamedTuple

import torch

NEG_INF = -1e10
_SYNC_EVERY = 8   # fixed-point steps between checks on the host


class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (N_b, K, 4)
    scores: torch.Tensor   # (N_b, K), NEG_INF on padded slots
    idx: torch.Tensor      # (N_b, K) indices into the input
    mask: torch.Tensor     # (N_b, K) bool


class DetResult(NamedTuple):
    boxes: torch.Tensor    # (B, K, 4)
    scores: torch.Tensor   # (B, K)
    labels: torch.Tensor   # (B, K) int32, -1 on padded slots
    mask: torch.Tensor     # (B, K) bool


def top_k_stable(x: torch.Tensor, k: int):
    """Largest k along the last dim, ties to the lower index (`lax.top_k`)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4), (..., M, 4) -> (..., N, M), areas clamped at 0."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    ab = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    return inter / torch.clamp(aa[..., :, None] + ab[..., None, :] - inter, min=1e-6)


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int, valid: torch.Tensor = None) -> NMSResult:
    """Exact greedy NMS for each row: boxes (N_b, N, 4), scores (N_b, N)."""
    Nb, N = scores.shape
    if valid is not None:
        scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    s, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    b = torch.gather(boxes, 1, order[..., None].expand(Nb, N, 4))
    ok = s > NEG_INF / 2
    earlier = torch.ones((N, N), dtype=torch.bool, device=boxes.device).triu(1)
    over = (pairwise_iou(b, b) > iou_threshold) & earlier     # over[j, i]: j < i
    alive = ok
    while True:
        for _ in range(_SYNC_EVERY):
            prev = alive
            killed = (over & alive[:, :, None]).any(dim=1)
            alive = ok & ~killed
        if torch.equal(alive, prev):
            break
    # kept candidates first, each group in score order
    k = min(max_out, N)
    top = torch.sort((~alive).to(torch.uint8), dim=-1, stable=True).indices[:, :k]
    mask = torch.gather(alive, 1, top)
    out_scores = torch.where(mask, torch.gather(s, 1, top), torch.full_like(s[:, :k], NEG_INF))
    res = NMSResult(torch.gather(b, 1, top[..., None].expand(Nb, k, 4)), out_scores,
                    torch.gather(order, 1, top), mask)
    if k < max_out:
        pad = max_out - k
        res = NMSResult(
            torch.cat([res.boxes, res.boxes.new_zeros((Nb, pad, 4))], 1),
            torch.cat([res.scores, res.scores.new_full((Nb, pad), NEG_INF)], 1),
            torch.cat([res.idx, res.idx.new_zeros((Nb, pad))], 1),
            torch.cat([res.mask, res.mask.new_zeros((Nb, pad))], 1))
    return res


def batched_nms(boxes, scores, idxs, iou_threshold: float, max_out: int,
                valid: torch.Tensor) -> NMSResult:
    """Category-aware NMS by the coordinate-offset trick; returns the
    original boxes.  boxes (N_b, N, 4), scores/idxs/valid (N_b, N)."""
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    max_coord = torch.where(valid[..., None], boxes, zero).amax(dim=(1, 2)) + 1.0
    shifted = boxes + (idxs.to(boxes.dtype) * max_coord[:, None])[..., None]
    r = nms(shifted, scores, iou_threshold, max_out, valid)
    orig = torch.gather(boxes, 1, r.idx[..., None].expand(-1, -1, 4))
    return NMSResult(orig, r.scores, r.idx, r.mask)


def multiclass_nms(multi_boxes: torch.Tensor, multi_scores: torch.Tensor,
                   score_thr: float, iou_threshold: float, max_per_img: int,
                   pre_nms: int = 2000, valid: torch.Tensor = None) -> DetResult:
    """Class-wise NMS per image.  multi_boxes (B, N, 4C), or (B, N, 4) class-
    agnostic boxes that every class shares; multi_scores (B, N, C+1) with
    background last; valid (B, N)."""
    B, N, Cp1 = multi_scores.shape
    C = Cp1 - 1
    flat_scores = multi_scores[..., :C].reshape(B, N * C)
    if multi_boxes.shape[-1] == 4:
        multi_boxes = multi_boxes[:, :, None, :].expand(B, N, C, 4)
    flat_boxes = multi_boxes.reshape(B, N * C, 4)
    flat_labels = torch.arange(C, dtype=torch.int32, device=multi_scores.device).repeat(N)
    ok = flat_scores > score_thr
    if valid is not None:
        ok = ok & valid.repeat_interleave(C, dim=1)
    cand = torch.where(ok, flat_scores, torch.full_like(flat_scores, NEG_INF))
    top_scores, top_idx = top_k_stable(cand, min(pre_nms, N * C))
    top_boxes = torch.gather(flat_boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_labels = flat_labels[top_idx]
    r = batched_nms(top_boxes, top_scores, top_labels, iou_threshold, max_per_img,
                    top_scores > NEG_INF / 2)
    labels = torch.gather(top_labels, 1, r.idx)
    return DetResult(r.boxes, torch.where(r.mask, r.scores, torch.full_like(r.scores, NEG_INF)),
                     torch.where(r.mask, labels, torch.full_like(labels, -1)), r.mask)
