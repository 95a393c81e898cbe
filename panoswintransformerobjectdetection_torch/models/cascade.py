"""Cascade (Mask) R-CNN at test time: three bbox stages that refine the
boxes one after the other, class scores averaged over the stages.

Counterpart of `CascadeRCNN.simple_test` and `CascadeMaskRCNN` in
`panoswintransformerobjectdetection_tpu/models/cascade.py` (the reference's
`CascadeRCNN` with its `CascadeRoIHead`, as the
`configs/swin/cascade_mask_rcnn_swin_*` configs use it).  The three heads
sit under `roi_head.bbox_head.{0,1,2}`, the reference's keys; each regresses
class-agnostically with its stage's target stds.  Every stage pools every
proposal slot, padded ones included, with kernel K3 at 7 x 7; a padded
slot's boxes matter only through the proposals' mask.  The mask detector
keeps one FCN mask head (`roi_head.mask_head`), as the JAX package does
where the reference keeps one a stage (`runtime/checkpoint.py` refuses such
a checkpoint), and inherits `simple_test_masks`.  Training is not ported.
"""

from typing import Optional

import torch
import torch.nn as nn

from ..core.bbox import clip_boxes, delta_decode
from ..ops.nms import DetResult
from .detectors import MASK_STAGES, STAGES, PanoFasterRCNN
from .roi_head import bbox_head_detections, build_bbox_head

# each stage's IoU threshold in training and its regression target stds
STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
NUM_STAGES = len(STAGE_STDS)

# The stages of one cascade `simple_test`: those of `STAGES` up to the
# proposals, then each bbox stage's RoIAlign, head and refinement (softmax,
# decode, clip), then the detections.
CASCADE_STAGES = STAGES[:4] + tuple(
    f"{name}.{t}" for t in range(NUM_STAGES) for name in ("roi_align", "bbox_head", "refine")
) + ("detections",)
# The stages of one `simple_test_masks` of the cascade with a mask head.
CASCADE_MASK_STAGES = CASCADE_STAGES + MASK_STAGES[len(STAGES):]
_TRAINING = ("cascade training is not ported yet (ROADMAP.md, Queue 1, item 17b: first a "
             "test of what the JAX forward_train does with gt_masks)")
# The JAX `aug_test_detector` scores a cascade's RoIs with `bbox_for_rois`,
# which runs `bbox_head_m`: a head that the JAX cascade builds, loads from no
# stage and trains in none.
TTA_REFUSAL = ("test-time augmentation of a cascade is not ported: the JAX package's "
               "aug_test_detector scores it with bbox_head_m, a head that no cascade stage "
               "trains (ROADMAP.md, Queue 3)")


class CascadeRCNN(PanoFasterRCNN):
    """`PanoFasterRCNN` with three class-agnostic bbox stages."""

    def _make_bbox_head(self, cfg: Optional[dict], in_channels: int, num_classes: int,
                        dtype: Optional[torch.dtype]) -> nn.Module:
        return nn.ModuleList(build_bbox_head(cfg, in_channels, num_classes, dtype,
                                             reg_class_agnostic=True)
                             for _ in range(NUM_STAGES))

    def _roi_detections(self, feats, props, img_shapes, scale_factors, stage) -> DetResult:
        """Each stage pools the current boxes (K3 at 7), runs its head, and
        refines: softmax of the logits, the deltas decoded with zero means
        and the stage's stds, the boxes clipped to each image.  The stages'
        probabilities are averaged; their log, zero deltas and the last
        boxes go through `bbox_head_detections` (whose softmax
        renormalises, as JAX's does)."""
        B, P, _ = props.boxes.shape
        boxes = props.boxes
        bidx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)[:, None, None]
        bidx = bidx.expand(B, P, 1)
        h, w = img_shapes[:, 0, None, None], img_shapes[:, 1, None, None]
        scores = []
        for t, head in enumerate(self.roi_head.bbox_head):
            rois = torch.cat([bidx, boxes], dim=-1).reshape(B * P, 5)
            roi_feats = stage(f"roi_align.{t}", lambda: self.roi_features(feats, rois))
            cls, reg = stage(f"bbox_head.{t}", lambda: head(roi_feats))

            def refine():
                dec = delta_decode(boxes.reshape(B * P, 4), reg, stds=STAGE_STDS[t])
                return (torch.softmax(cls.reshape(B, P, -1), dim=-1),
                        clip_boxes(dec.reshape(B, P, 4), h, w))

            probs, boxes = stage(f"refine.{t}", refine)
            scores.append(probs)
        avg = sum(scores) / NUM_STAGES
        rois = torch.cat([bidx, boxes], dim=-1)
        return stage("detections", lambda: bbox_head_detections(
            torch.log(avg.clamp(min=1e-9)), torch.zeros_like(boxes), rois, img_shapes,
            target_stds=(1.0, 1.0, 1.0, 1.0), roi_mask=props.mask,
            scale_factors=scale_factors, **self.test_cfg["rcnn"]))

    def forward_train(self, *args, **kwargs):
        raise NotImplementedError(_TRAINING)

    def bbox_for_rois(self, images, boxes, img_shapes):
        raise NotImplementedError(TTA_REFUSAL)


class CascadeMaskRCNN(CascadeRCNN):
    """The cascade with the FCN mask head: `with_mask` is on by default."""

    def __init__(self, *args, with_mask: bool = True, **kwargs):
        super().__init__(*args, with_mask=with_mask, **kwargs)
