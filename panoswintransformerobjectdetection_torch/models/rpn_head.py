"""RPN head, its training loss and proposal generation.

Counterpart of `RPNHead`, `flatten_levels`, `rpn_loss` and `rpn_proposals`
in `panoswintransformerobjectdetection_tpu/models/rpn_head.py`.  Proposals:
per level the top `nms_pre` anchors by objectness, decode and clip, NMS per
(image, level), then the top `max_per_img` of the union.  Loss: anchors
assigned by MaxIoU, sampled at random, sigmoid cross entropy and L1; the
batch is a leading dimension where the JAX package uses `vmap`.
"""

from typing import Dict, NamedTuple, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core import losses
from ..core.assigner import max_iou_assign
from ..core.bbox import bbox_overlaps, clip_boxes, delta_decode, delta_encode
from ..core.sampler import random_sample
from ..ops.nms import NEG_INF, nms, top_k_stable
from ..parallel.dist import all_reduce_sum
from .layers import conv


class RPNHead(nn.Module):
    """3x3 shared conv -> ReLU -> 1x1 objectness and 1x1 deltas per anchor.
    Returns NHWC float32 maps: cls (B, H, W, A), reg (B, H, W, 4A)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_anchors: int = 3, dtype=None):
        super().__init__()
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1)
        self.rpn_cls = nn.Conv2d(feat_channels, num_anchors, 1)
        self.rpn_reg = nn.Conv2d(feat_channels, num_anchors * 4, 1)
        self.dtype = dtype

    def forward(self, feats):
        cls_out, reg_out = [], []
        for f in feats:
            t = torch.relu(conv(self.rpn_conv, f.permute(0, 3, 1, 2), self.dtype))
            cls_out.append(conv(self.rpn_cls, t, self.dtype).float().permute(0, 2, 3, 1))
            reg_out.append(conv(self.rpn_reg, t, self.dtype).float().permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)


def flatten_levels(cls_scores, bbox_preds):
    """Per-level NHWC maps -> (B, N) logits and (B, N, 4) deltas over all levels."""
    B = cls_scores[0].shape[0]
    return (torch.cat([c.reshape(B, -1) for c in cls_scores], dim=1),
            torch.cat([r.reshape(B, -1, 4) for r in bbox_preds], dim=1))


def rpn_loss(cls_scores, bbox_preds, anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_valid: torch.Tensor, noise: Tuple[torch.Tensor, torch.Tensor],
             *, pos_iou_thr: float = 0.7, neg_iou_thr: float = 0.3, min_pos_iou: float = 0.3,
             num_samples: int = 256, pos_fraction: float = 0.5, neg_pos_ub: int = -1,
             target_means: Sequence[float] = (0., 0., 0., 0.),
             target_stds: Sequence[float] = (1., 1., 1., 1.),
             loss_cls_weight: float = 1.0,
             loss_bbox_weight: float = 1.0) -> Dict[str, torch.Tensor]:
    """anchors (N, 4) of all levels; gt_boxes (B, G, 4); gt_valid (B, G);
    noise: two (B, N) uniform tensors for the sampler (`core/sampler.py`).
    Targets are built without gradient; both losses are divided by the
    number of sampled anchors, of the global batch under a process group
    (`parallel/dist.all_reduce_sum`)."""
    cls_flat, reg_flat = flatten_levels(cls_scores, bbox_preds)
    with torch.no_grad():
        ious = bbox_overlaps(gt_boxes, anchors)                          # (B, G, N)
        assigned, _ = max_iou_assign(ious, gt_valid, pos_iou_thr, neg_iou_thr, min_pos_iou,
                                     match_low_quality=True)
        s = random_sample(noise, assigned, num_samples, pos_fraction, neg_pos_ub=neg_pos_ub)
        gt_idx = (torch.gather(assigned, 1, s.pos_inds) - 1).clamp(min=0)
        pos_gts = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
        pos_targets = delta_encode(anchors[s.pos_inds], pos_gts, target_means, target_stds)
        pos_w = s.pos_mask.float()
        neg_w = s.neg_mask.float()
        num_total = all_reduce_sum(pos_w.sum() + neg_w.sum())
    pos_logits = torch.gather(cls_flat, 1, s.pos_inds)
    neg_logits = torch.gather(cls_flat, 1, s.neg_inds)
    loss_cls = (losses.binary_cross_entropy(pos_logits, torch.ones_like(pos_logits),
                                            weight=pos_w, avg_factor=num_total)
                + losses.binary_cross_entropy(neg_logits, torch.zeros_like(neg_logits),
                                              weight=neg_w, avg_factor=num_total))
    pos_deltas = torch.gather(reg_flat, 1, s.pos_inds[..., None].expand(-1, -1, 4))
    loss_bbox = losses.l1_loss(pos_deltas, pos_targets, weight=pos_w[..., None],
                               avg_factor=num_total)
    return {"loss_rpn_cls": loss_cls * loss_cls_weight,
            "loss_rpn_bbox": loss_bbox * loss_bbox_weight}


class Proposals(NamedTuple):
    boxes: torch.Tensor    # (B, P, 4)
    scores: torch.Tensor   # (B, P), 0 on padded slots
    mask: torch.Tensor     # (B, P) bool


def rpn_proposals(cls_scores, bbox_preds, level_anchors, img_shapes: torch.Tensor,
                  *, nms_pre: int = 1000, max_per_img: int = 1000,
                  iou_threshold: float = 0.7, min_bbox_size: float = 0,
                  target_means: Sequence[float] = (0., 0., 0., 0.),
                  target_stds: Sequence[float] = (1., 1., 1., 1.)) -> Proposals:
    """cls_scores/bbox_preds: per-level NHWC maps; level_anchors: per-level
    (n, 4); img_shapes: (B, 2) (h, w) used for clipping."""
    B = cls_scores[0].shape[0]
    h = img_shapes[:, 0][:, None, None]
    w = img_shapes[:, 1][:, None, None]
    lvl_scores, lvl_boxes = [], []
    for c, r, a in zip(cls_scores, bbox_preds, level_anchors):
        sc = torch.sigmoid(c.reshape(B, -1))
        rg = r.reshape(B, -1, 4)
        top_sc, top_i = top_k_stable(sc, min(nms_pre, sc.shape[1]))
        top_rg = torch.gather(rg, 1, top_i[..., None].expand(-1, -1, 4))
        boxes = delta_decode(a[top_i], top_rg, target_means, target_stds)
        lvl_scores.append(top_sc)
        lvl_boxes.append(clip_boxes(boxes, h, w))

    kmax = max(s.shape[1] for s in lvl_scores)
    scores_l = torch.stack([F.pad(s, (0, kmax - s.shape[1]), value=NEG_INF)
                            for s in lvl_scores])                     # (L, B, k)
    boxes_l = torch.stack([F.pad(b, (0, 0, 0, kmax - b.shape[1])) for b in lvl_boxes])
    L = scores_l.shape[0]
    valid_l = scores_l > NEG_INF / 2
    if min_bbox_size > 0:
        valid_l = valid_l & ((boxes_l[..., 2] - boxes_l[..., 0]) > min_bbox_size) & \
            ((boxes_l[..., 3] - boxes_l[..., 1]) > min_bbox_size)
    keep_out = min(max_per_img, kmax)
    r = nms(boxes_l.reshape(L * B, kmax, 4), scores_l.reshape(L * B, kmax), iou_threshold,
            keep_out, valid_l.reshape(L * B, kmax))
    pb = r.boxes.reshape(L, B, keep_out, 4).transpose(0, 1).reshape(B, -1, 4)
    ps = r.scores.reshape(L, B, keep_out).transpose(0, 1).reshape(B, -1)
    pm = r.mask.reshape(L, B, keep_out).transpose(0, 1).reshape(B, -1)
    ps = torch.where(pm, ps, torch.full_like(ps, NEG_INF))
    top_s, top_i = top_k_stable(ps, min(max_per_img, ps.shape[1]))
    top_b = torch.gather(pb, 1, top_i[..., None].expand(-1, -1, 4))
    top_m = top_s > NEG_INF / 2
    return Proposals(top_b, torch.where(top_m, top_s, torch.zeros_like(top_s)), top_m)
