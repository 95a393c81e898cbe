"""Fixed-shape random sampling of positives and negatives.

Counterpart of `SampleResult` and `random_sample` in
`panoswintransformerobjectdetection_tpu/core/sampler.py` (mmdet
`RandomSampler`): up to num * pos_fraction positives chosen uniformly, the
rest of the quota filled with negatives.  The uniform noise is an argument,
so that two frameworks, or the card and the CPU, can be handed the same
draw; `sampler_noise` draws it from an explicit generator.  Leading
dimensions are batch dimensions.
"""

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..ops.nms import top_k_stable


class SampleResult(NamedTuple):
    pos_inds: torch.Tensor    # (..., pos_cap) candidate indices (padded arbitrary)
    pos_mask: torch.Tensor    # (..., pos_cap) bool
    neg_inds: torch.Tensor    # (..., num)
    neg_mask: torch.Tensor    # (..., num) bool


def sampler_noise(shape: Sequence[int], generator: Optional[torch.Generator] = None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two uniform [0, 1) float32 tensors of `shape` (for the positives and
    the negatives), drawn on the generator's own device and moved to
    `device`: one CPU generator gives the card and the CPU the same noise."""
    where = generator.device if generator is not None else device
    pos = torch.rand(tuple(shape), generator=generator, device=where)
    neg = torch.rand(tuple(shape), generator=generator, device=where)
    return pos.to(device), neg.to(device)


def random_sample(noise: Tuple[torch.Tensor, torch.Tensor], assigned: torch.Tensor, num: int,
                  pos_fraction: float, neg_pos_ub: int = -1) -> SampleResult:
    """noise: two (..., N) uniform tensors; assigned (..., N) from
    `max_iou_assign`.  A candidate's score is its noise plus 2 if it is of
    the wanted kind; the top scores are taken, ties to the lower index, and
    a running count caps the negatives at num - n_pos (and, with neg_pos_ub
    >= 0, at neg_pos_ub * max(1, n_pos))."""
    pos_cap = int(num * pos_fraction)
    is_pos = assigned > 0
    is_neg = assigned == 0
    _, pos_inds = top_k_stable(noise[0] + is_pos * 2.0, pos_cap)
    pos_mask = torch.gather(is_pos, -1, pos_inds)
    n_pos = pos_mask.sum(-1, keepdim=True)
    _, neg_inds = top_k_stable(noise[1] + is_neg * 2.0, num)
    neg_avail = torch.gather(is_neg, -1, neg_inds)
    neg_quota = num - n_pos
    if neg_pos_ub >= 0:
        neg_quota = torch.minimum(neg_quota, neg_pos_ub * n_pos.clamp(min=1))
    neg_mask = neg_avail & (neg_avail.long().cumsum(-1) <= neg_quota)
    return SampleResult(pos_inds, pos_mask, neg_inds, neg_mask)
