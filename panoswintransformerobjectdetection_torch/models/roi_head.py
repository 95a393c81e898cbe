"""Shared2FC bbox head and the test-time detection step.

Counterpart of `Shared2FCBBoxHead` and `bbox_head_detections` in
`panoswintransformerobjectdetection_tpu/models/roi_head.py`.  `shared_fcs.0`
keeps the reference's weight layout, which reads the RoI feature flattened
channel-first (C, h, w); the JAX head flattens (h, w, C) with a permuted
weight (`runtime/checkpoint.py:219 _fc_from_chw`).
"""

from typing import Sequence

import torch
import torch.nn as nn

from ..core.bbox import clip_boxes, delta_decode
from ..ops.nms import DetResult, multiclass_nms
from .layers import dense


class Shared2FCBBoxHead(nn.Module):
    """flatten -> fc -> ReLU -> fc -> ReLU -> {cls, reg}; logits in f32."""

    def __init__(self, in_channels: int = 256, roi_size: int = 7, num_classes: int = 80,
                 fc_out_channels: int = 1024, dtype=None):
        super().__init__()
        self.shared_fcs = nn.ModuleList([
            nn.Linear(in_channels * roi_size * roi_size, fc_out_channels),
            nn.Linear(fc_out_channels, fc_out_channels)])
        self.fc_cls = nn.Linear(fc_out_channels, num_classes + 1)
        self.fc_reg = nn.Linear(fc_out_channels, 4 * num_classes)
        self.dtype = dtype

    def forward(self, roi_feats):
        """roi_feats (R, o, o, C) -> cls (R, C+1), reg (R, 4 * classes)."""
        x = roi_feats.permute(0, 3, 1, 2).reshape(roi_feats.shape[0], -1)
        for fc in self.shared_fcs:
            x = torch.relu(dense(fc, x, self.dtype))
        return (dense(self.fc_cls, x, self.dtype).float(),
                dense(self.fc_reg, x, self.dtype).float())


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
