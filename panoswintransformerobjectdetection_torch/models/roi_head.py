"""The bbox heads (Shared2FC, and Shared4Conv1FC with GroupNorm), their
training targets and loss, and the test-time detection step.

Counterpart of `Shared2FCBBoxHead`, `Shared4Conv1FCBBoxHead`, `RoISamples`,
`sample_rois_for_training`, `bbox_head_loss` (the random sampler; L1, GIoU
or IoU box losses, class-agnostic or per class) and `bbox_head_detections` in
`panoswintransformerobjectdetection_tpu/models/roi_head.py`.  `shared_fcs.0`
keeps the reference's weight layout, which reads the RoI feature (or the
last conv's output) flattened channel-first (C, h, w); the JAX heads flatten
(h, w, C) with a permuted weight (`runtime/checkpoint.py:219 _fc_from_chw`).
"""

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..core import losses
from ..core.assigner import max_iou_assign
from ..core.bbox import bbox_overlaps, clip_boxes, delta_decode, delta_encode
from ..core.sampler import random_sample
from ..ops.nms import DetResult, multiclass_nms
from ..parallel.dist import all_reduce_sum
from .layers import conv, dense

# flax's `nn.GroupNorm` epsilon (the reference's mmcv GN uses 1e-5)
GN_EPS = 1e-6


class Shared2FCBBoxHead(nn.Module):
    """flatten -> fc -> ReLU -> fc -> ReLU -> {cls, reg}; logits in f32.
    `reg` has 4 outputs a class, or 4 with `reg_class_agnostic`."""

    def __init__(self, in_channels: int = 256, roi_size: int = 7, num_classes: int = 80,
                 fc_out_channels: int = 1024, reg_class_agnostic: bool = False, dtype=None):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4 if reg_class_agnostic else 4 * num_classes)
        self.dtype = dtype

    def forward(self, roi_feats):
        """roi_feats (R, o, o, C) -> cls (R, C+1), reg (R, 4 * classes or 4)."""
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = torch.relu(dense(fc, x, self.dtype))
        return (dense(self.fc_cls, x, self.dtype).float(),
                dense(self.fc_reg, x, self.dtype).float())


def group_norm(x: torch.Tensor, gn: nn.GroupNorm) -> torch.Tensor:
    """`gn` as flax 0.12's `nn.GroupNorm` computes it on NCHW `x`: statistics
    in float32 with the fast variance max(E[x^2] - E[x]^2, 0), (x - mean) *
    (rsqrt(var + eps) * scale) + bias, in float32 whatever the type of `x`."""
    R, C = x.shape[:2]
    G = gn.num_groups
    g = x.float().reshape(R, G, -1)
    mean = g.mean(-1, keepdim=True)
    var = ((g * g).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + gn.eps).expand(-1, -1, C // G).reshape(R, C, 1, 1)
    mul = mul * gn.weight.float()[:, None, None]
    mean = mean.expand(-1, -1, C // G).reshape(R, C, 1, 1)
    return (x.float() - mean) * mul + gn.bias.float()[:, None, None]


class _ConvGN(nn.Module):
    """A 3 x 3 conv without bias under `.conv` and its GroupNorm under `.gn`,
    as the reference's `ConvModule` with `norm_cfg=dict(type="GN")` keeps
    them."""

    def __init__(self, in_channels: int, out_channels: int, num_groups: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.gn = nn.GroupNorm(num_groups, out_channels, eps=GN_EPS)


class Shared4Conv1FCBBoxHead(nn.Module):
    """4 x (3 x 3 conv -> GroupNorm -> ReLU) -> flatten -> fc -> ReLU -> {cls,
    reg} (the reference's `convfc_bbox_head.py` head of the GN recipes).
    With a compute type the convs and fcs run in it and each GroupNorm
    returns float32, as flax's does (its statistics and parameters are
    float32); logits in f32."""

    def __init__(self, in_channels: int = 256, roi_size: int = 7, num_classes: int = 80,
                 conv_out_channels: int = 256, fc_out_channels: int = 1024,
                 norm_groups: int = 32, reg_class_agnostic: bool = False, dtype=None):
        super().__init__()
        self.shared_convs = nn.ModuleList(
            _ConvGN(in_channels if i == 0 else conv_out_channels, conv_out_channels,
                    norm_groups) for i in range(4))
        self.shared_fcs = nn.ModuleList([
            nn.Linear(conv_out_channels * roi_size * roi_size, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4 if reg_class_agnostic else 4 * num_classes)
        self.dtype = dtype

    def forward(self, roi_feats):
        """roi_feats (R, o, o, C) -> cls (R, C+1), reg (R, 4 * classes or 4)."""
        x = roi_feats.permute(0, 3, 1, 2)
        for m in self.shared_convs:
            x = torch.relu(group_norm(conv(m.conv, x, self.dtype), m.gn))
        x = torch.relu(dense(self.shared_fcs[0], x.reshape(x.shape[0], -1), self.dtype))
        return (dense(self.fc_cls, x, self.dtype).float(),
                dense(self.fc_reg, x, self.dtype).float())


BBOX_HEADS = {"Shared2FCBBoxHead": Shared2FCBBoxHead,
              "Shared4Conv1FCBBoxHead": Shared4Conv1FCBBoxHead}


def build_bbox_head(cfg: Optional[dict], in_channels: int, num_classes: int,
                    dtype: Optional[torch.dtype] = None, **defaults) -> nn.Module:
    """A bbox head from its config (`type` one of `BBOX_HEADS`, Shared2FC when
    `cfg` is None) on 7 x 7 RoIs of `in_channels`, with the defaults that the
    JAX registry applies: `num_classes`, the detector's compute type, and
    `defaults` (e.g. `reg_class_agnostic`) where the config leaves them."""
    cfg = dict(cfg or {})
    kind = cfg.pop("type", "Shared2FCBBoxHead")
    kwargs = {"num_classes": num_classes, "dtype": dtype, **defaults, **cfg}
    return BBOX_HEADS[kind](in_channels, 7, **kwargs)


class RoISamples(NamedTuple):
    rois: torch.Tensor           # (B, S, 5) sampled rois (batch index in column 0)
    labels: torch.Tensor         # (B, S) int64: class, or num_classes for background
    label_weights: torch.Tensor  # (B, S)
    bbox_targets: torch.Tensor   # (B, S, 4)
    bbox_weights: torch.Tensor   # (B, S)


@torch.no_grad()
def sample_rois_for_training(noise: Tuple[torch.Tensor, torch.Tensor], proposals, prop_mask,
                             gt_boxes, gt_labels, gt_valid, num_classes: int,
                             *, pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.5,
                             min_pos_iou: float = 0.5, num_samples: int = 512,
                             pos_fraction: float = 0.25,
                             target_means: Sequence[float] = (0., 0., 0., 0.),
                             target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2)) -> RoISamples:
    """Assign and sample the RCNN's rois of each image, with the ground
    truth appended as proposals.  proposals (B, P, 4); prop_mask (B, P);
    gt_boxes (B, G, 4); noise: two (B, G + P) uniform tensors.  Every image
    gets int(num_samples * pos_fraction) + num_samples slots: positives
    first, then negatives; `label_weights` marks the slots that are filled.
    """
    B = proposals.shape[0]
    cand = torch.cat([gt_boxes, proposals], dim=1)                       # (B, G+P, 4)
    cand_valid = torch.cat([gt_valid, prop_mask], dim=1)
    ious = bbox_overlaps(gt_boxes, cand)                                 # (B, G, G+P)
    ious = torch.where(cand_valid[:, None, :], ious, torch.full_like(ious, -1.0))
    assigned, _ = max_iou_assign(ious, gt_valid, pos_iou_thr, neg_iou_thr, min_pos_iou,
                                 match_low_quality=False)
    assigned = torch.where(cand_valid, assigned, torch.full_like(assigned, -1))
    s = random_sample(noise, assigned, num_samples, pos_fraction)

    inds = torch.cat([s.pos_inds, s.neg_inds], dim=1)                    # (B, pos_cap+num)
    pos_m = torch.cat([s.pos_mask, torch.zeros_like(s.neg_mask)], dim=1)
    sel_m = torch.cat([s.pos_mask, s.neg_mask], dim=1)
    boxes = torch.gather(cand, 1, inds[..., None].expand(-1, -1, 4))
    gt_idx = (torch.gather(assigned, 1, inds) - 1).clamp(min=0)
    labels = torch.where(pos_m, torch.gather(gt_labels.long(), 1, gt_idx),
                         torch.full_like(gt_idx, num_classes))
    matched = torch.gather(gt_boxes, 1, gt_idx[..., None].expand(-1, -1, 4))
    targets = delta_encode(boxes, matched, target_means, target_stds)
    targets = torch.where(pos_m[..., None], targets, torch.zeros_like(targets))
    bidx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)[:, None, None]
    rois = torch.cat([bidx.expand(B, boxes.shape[1], 1), boxes], dim=-1)
    return RoISamples(rois, labels, sel_m.float(), targets, pos_m.float())


# The box losses of `bbox_head_loss`; the JAX package's others raise.
REG_LOSSES = ("l1", "giou", "iou")
UNPORTED_LOSS = ("is not ported yet (ROADMAP.md, Queue 1, item 17d: Libra R-CNN's balanced "
                 "L1, the bounded IoU loss and PISA)")


def bbox_head_loss(cls_logits, bbox_pred, samples: RoISamples, num_classes: int,
                   reg_class_agnostic: bool = False, pisa: Optional[dict] = None,
                   reg_loss: str = "l1", reg_loss_weight: float = 1.0,
                   target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2)
                   ) -> Dict[str, torch.Tensor]:
    """Softmax cross entropy over the sampled rois and a box loss on the
    positive rows, both divided by the number of sampled rois; `acc` is the
    share of sampled rois classified right (JAX `bbox_head_loss` without
    PISA).  Under a process group the count is the global batch's
    (`parallel/dist.all_reduce_sum`): each process returns its share, and
    the shares sum to the global batch's values.

    The prediction of a row is its own class's deltas, or with
    `reg_class_agnostic` the row's one (B, S, 4).  `reg_loss` "l1" is L1 on
    the deltas (and, as in JAX, does not read `reg_loss_weight`); "giou" and
    "iou" decode the prediction and the stored target deltas from the
    sampled rois with `target_stds` (`core/bbox.delta_decode`) and take
    `losses.giou_loss` or `losses.iou_loss` of the boxes, times
    `reg_loss_weight`.  A slot of weight 0 decodes some candidate's box; its
    loss term is finite, and so its gradient is 0."""
    if pisa:
        raise NotImplementedError(f"bbox_head_loss: pisa={pisa!r} {UNPORTED_LOSS}")
    if reg_loss not in REG_LOSSES:
        raise NotImplementedError(f"bbox_head_loss: reg_loss={reg_loss!r} {UNPORTED_LOSS}")
    B, S = samples.labels.shape
    cls_logits = cls_logits.reshape(B, S, -1)
    num_sampled = all_reduce_sum(samples.label_weights.sum())
    loss_cls = losses.cross_entropy(cls_logits, samples.labels, weight=samples.label_weights,
                                    avg_factor=num_sampled)
    acc = losses.accuracy(cls_logits, samples.labels, samples.label_weights,
                          avg_factor=num_sampled)
    if reg_class_agnostic:
        pred = bbox_pred.reshape(B, S, 4)
    else:
        lab = samples.labels.clamp(0, num_classes - 1)
        pred = bbox_pred.reshape(B, S, num_classes, 4)
        pred = torch.gather(pred, 2, lab[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    if reg_loss == "l1":
        loss_bbox = losses.l1_loss(pred, samples.bbox_targets,
                                   weight=samples.bbox_weights[..., None],
                                   avg_factor=num_sampled)
    else:
        rois = samples.rois[..., 1:]
        pred_boxes = delta_decode(rois, pred, stds=target_stds)
        tgt_boxes = delta_decode(rois, samples.bbox_targets, stds=target_stds)
        fn = losses.giou_loss if reg_loss == "giou" else losses.iou_loss
        loss_bbox = fn(pred_boxes, tgt_boxes, weight=samples.bbox_weights,
                       avg_factor=num_sampled) * reg_loss_weight
    return {"loss_cls": loss_cls, "loss_bbox": loss_bbox, "acc": acc}


def bbox_head_detections(cls_logits, bbox_pred, rois, img_shapes, *, score_thr=0.05,
                         iou_threshold=0.5, max_per_img=100,
                         target_means: Sequence[float] = (0., 0., 0., 0.),
                         target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                         roi_mask=None, scale_factors=None) -> DetResult:
    """cls_logits (B, P, C+1); bbox_pred (B, P, 4C); rois (B, P, 5);
    img_shapes (B, 2); scale_factors (B, 4) or None."""
    B, P, _ = cls_logits.shape
    scores = torch.softmax(cls_logits, dim=-1)
    boxes = delta_decode(rois[..., 1:5], bbox_pred, target_means, target_stds)
    boxes = clip_boxes(boxes, img_shapes[:, 0][:, None, None], img_shapes[:, 1][:, None, None])
    if scale_factors is not None:
        k = boxes.shape[-1] // 4
        boxes = boxes / scale_factors.repeat(1, k)[:, None, :]
    mask = roi_mask if roi_mask is not None else torch.ones(
        (B, P), dtype=torch.bool, device=cls_logits.device)
    return multiclass_nms(boxes, scores, score_thr, iou_threshold, max_per_img, valid=mask)
