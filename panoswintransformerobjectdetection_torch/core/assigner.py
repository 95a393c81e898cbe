"""Fixed-shape MaxIoU assignment.

Counterpart of `max_iou_assign` in
`panoswintransformerobjectdetection_tpu/core/assigner.py` (mmdet
`MaxIoUAssigner.assign_wrt_overlaps`): -1 = ignore, 0 = negative, g + 1 =
assigned to ground truth g.  Leading dimensions are batch dimensions, where
the JAX package uses `vmap`.
"""

from typing import Tuple

import torch


def max_iou_assign(ious: torch.Tensor, gt_valid: torch.Tensor, pos_iou_thr: float,
                   neg_iou_thr: float, min_pos_iou: float = 0.0,
                   match_low_quality: bool = True,
                   eps: float = 1e-7) -> Tuple[torch.Tensor, torch.Tensor]:
    """ious (..., G, N) overlaps of N candidates (rows of padded ground
    truths are arbitrary); gt_valid (..., G) bool.  Returns (assigned
    (..., N) int64, max_overlaps (..., N)).

    Negative if 0 <= max overlap < neg_iou_thr; positive to the argmax
    ground truth if max overlap >= pos_iou_thr.  With `match_low_quality`,
    every candidate that ties a ground truth's best overlap is assigned to
    it when that overlap >= min_pos_iou; among several, the highest index.
    """
    G = ious.shape[-2]
    valid = gt_valid[..., :, None]
    ious = torch.where(valid, ious, torch.full_like(ious, -1.0))
    max_overlaps, argmax_gt = ious.max(dim=-2)
    assigned = torch.full_like(argmax_gt, -1)
    assigned = torch.where((max_overlaps >= 0) & (max_overlaps < neg_iou_thr),
                           torch.zeros_like(assigned), assigned)
    assigned = torch.where(max_overlaps >= pos_iou_thr, argmax_gt + 1, assigned)
    if match_low_quality:
        gt_max = ious.amax(dim=-1, keepdim=True)
        is_cand = ((ious - gt_max).abs() < eps) & (gt_max >= min_pos_iou) & valid
        gt_ids = torch.arange(1, G + 1, device=ious.device)[:, None]
        lowq = torch.where(is_cand, gt_ids, torch.zeros_like(gt_ids)).amax(dim=-2)
        assigned = torch.where(lowq > 0, lowq, assigned)
    return assigned, max_overlaps
