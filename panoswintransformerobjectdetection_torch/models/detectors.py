"""Two-stage detector, inference: backbone -> FPN -> RPN -> RoIAlign -> head.

Counterpart of the `TwoStageDetector` subset that the flagship uses in
`panoswintransformerobjectdetection_tpu/models/detectors.py` (registered
there as `PanoFasterRCNN`): `extract_feat` and `simple_test` with the
default test configuration.  Submodule names follow the reference's
state-dict keys (`backbone.`, `neck.`, `rpn_head.`, `roi_head.bbox_head.`).
"""

from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn

from ..core.anchors import AnchorGenerator
from ..ops.nms import DetResult
from ..ops.roi_align import roi_align
from .fpn import FPN
from .panoswin import PanoSwinTransformer
from .roi_head import Shared2FCBBoxHead, bbox_head_detections
from .rpn_head import RPNHead, rpn_proposals


def default_test_cfg() -> dict:
    """`configs/_base_/models/faster_rcnn_panoswin_fpn.py:102-115`."""
    return {
        "rpn": {"nms_pre": 1000, "max_per_img": 1000, "iou_threshold": 0.7,
                "min_bbox_size": 0},
        "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 100},
    }


# The stages of one `simple_test` request, in order.
STAGES = ("stem", "backbone", "fpn", "proposals", "roi_align", "bbox_head", "detections")


def _run_stage(name: str, fn: Callable):
    return fn()


class RoIHead(nn.Module):
    """Holds the bbox head under `roi_head.bbox_head`, as the reference does."""

    def __init__(self, bbox_head: Shared2FCBBoxHead):
        super().__init__()
        self.bbox_head = bbox_head


class PanoFasterRCNN(nn.Module):
    def __init__(self, backbone: dict, num_classes: int = 80, neck: Optional[dict] = None,
                 anchor_scales: Sequence[float] = (8.0,),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 rpn_target_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 rcnn_target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 test_cfg: Optional[dict] = None, compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.backbone = PanoSwinTransformer(**backbone, dtype=compute_dtype)
        neck = dict(neck or {"in_channels": (96, 192, 384, 768), "out_channels": 256,
                             "num_outs": 5})
        self.neck = FPN(**neck, dtype=compute_dtype)
        out_ch = neck["out_channels"]
        self.rpn_head = RPNHead(out_ch, 256, len(anchor_scales) * len(anchor_ratios),
                                compute_dtype)
        self.roi_head = RoIHead(Shared2FCBBoxHead(out_ch, 7, num_classes,
                                                  dtype=compute_dtype))
        self.anchor_gen = AnchorGenerator(anchor_strides, anchor_ratios, anchor_scales)
        self.featmap_strides = tuple(featmap_strides)
        self.rpn_target_stds = tuple(rpn_target_stds)
        self.rcnn_target_stds = tuple(rcnn_target_stds)
        self.test_cfg = test_cfg or default_test_cfg()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def extract_feat(self, images):
        return self.neck(self.backbone(images))

    def proposals(self, feats, img_shapes):
        cls_scores, bbox_preds = self.rpn_head(feats)
        anchors = self.anchor_gen.grid_anchors([tuple(c.shape[1:3]) for c in cls_scores],
                                               device=feats[0].device)
        return rpn_proposals(cls_scores, bbox_preds, anchors, img_shapes,
                             target_stds=self.rpn_target_stds, **self.test_cfg["rpn"])

    @staticmethod
    def rois(props) -> torch.Tensor:
        """(B, P, 4) proposals -> (B * P, 5) rois (batch index, x1, y1, x2, y2)."""
        B, P, _ = props.boxes.shape
        bidx = torch.arange(B, dtype=props.boxes.dtype, device=props.boxes.device)
        return torch.cat([bidx[:, None, None].expand(B, P, 1), props.boxes],
                         dim=-1).reshape(B * P, 5)

    def roi_features(self, feats, rois):
        nlvl = min(len(self.featmap_strides), len(feats))
        return roi_align(feats[:nlvl], rois, self.featmap_strides)

    @torch.no_grad()
    def simple_test(self, images, img_shapes, scale_factors=None,
                    stage: Callable = _run_stage) -> DetResult:
        """images (B, H, W, 3) float; img_shapes (B, 2) (h, w); scale_factors
        (B, 4) or None.  Inputs are moved to the model's device.  Returns a
        DetResult of (B, K) slots; only `mask`ed slots hold detections.

        Each of the request's stages (`STAGES`, in order) runs as
        `stage(name, fn)`, which calls `fn()` and returns its result; a
        profiler passes one that also times it.
        """
        dev = self.device
        images = torch.as_tensor(images, device=dev)
        img_shapes = torch.as_tensor(img_shapes, dtype=torch.float32, device=dev)
        if scale_factors is not None:
            scale_factors = torch.as_tensor(scale_factors, dtype=torch.float32, device=dev)
        x = stage("stem", lambda: self.backbone.patch_embed(images))
        feats = stage("backbone", lambda: self.backbone.forward_from_embed(x))
        feats = stage("fpn", lambda: self.neck(feats))
        props = stage("proposals", lambda: self.proposals(feats, img_shapes))
        B, P, _ = props.boxes.shape
        rois = self.rois(props)
        roi_feats = stage("roi_align", lambda: self.roi_features(feats, rois))
        cls, reg = stage("bbox_head", lambda: self.roi_head.bbox_head(roi_feats))
        return stage("detections", lambda: bbox_head_detections(
            cls.reshape(B, P, -1), reg.reshape(B, P, -1), rois.reshape(B, P, 5), img_shapes,
            target_stds=self.rcnn_target_stds, roi_mask=props.mask,
            scale_factors=scale_factors, **self.test_cfg["rcnn"]))
