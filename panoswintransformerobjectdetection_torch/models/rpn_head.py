"""RPN head and proposal generation.

Counterpart of `RPNHead` and `rpn_proposals` in
`panoswintransformerobjectdetection_tpu/models/rpn_head.py`: per level the
top `nms_pre` anchors by objectness, decode and clip, NMS per (image, level),
then the top `max_per_img` of the union.
"""

from typing import NamedTuple, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.bbox import clip_boxes, delta_decode
from ..ops.nms import NEG_INF, nms, top_k_stable
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
