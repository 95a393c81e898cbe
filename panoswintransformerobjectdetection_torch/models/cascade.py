"""Cascade (Mask) R-CNN: three bbox stages that refine the boxes one after
the other; at test time the class scores are averaged over the stages, in
training each stage samples its own RoIs and adds its weighted losses.

Counterpart of `CascadeRCNN.simple_test`, `CascadeRCNN.forward_train` and
`CascadeMaskRCNN` in `panoswintransformerobjectdetection_tpu/models/
cascade.py` (the reference's `CascadeRCNN` with its `CascadeRoIHead`, as the
`configs/swin/cascade_mask_rcnn_swin_*` configs use it).  The three heads
sit under `roi_head.bbox_head.{0,1,2}`, the reference's keys; each regresses
class-agnostically with its stage's target stds.  At test time every stage
pools every proposal slot, padded ones included, with kernel K3 at 7 x 7; a
padded slot's boxes matter only through the proposals' mask.  In training
each stage pools its sampled slots with K3 at 7 x 7, forward and backward.

The mask detector keeps one FCN mask head (`roi_head.mask_head`), as the
JAX package does where the reference keeps one a stage
(`runtime/checkpoint.py` refuses such a checkpoint), and inherits
`simple_test_masks`.  Training takes `gt_masks` and reads none, as the JAX
`forward_train` does: no mask loss, so the mask head gets no gradient and
AdamW only decays it (ROADMAP.md, Queue 3, known divergences).
"""

from typing import Optional

import torch
import torch.nn as nn

from ..core.bbox import clip_boxes, delta_decode
from ..ops.nms import DetResult
from .detectors import MASK_STAGES, STAGES, TRAIN_STAGES, PanoFasterRCNN, split_rcnn_cfg
from .roi_head import (bbox_head_detections, bbox_head_loss, build_bbox_head,
                       sample_rois_for_training)

# each stage's IoU threshold in training and its regression target stds
STAGE_IOUS = (0.5, 0.6, 0.7)
STAGE_STDS = ((0.1, 0.1, 0.2, 0.2), (0.05, 0.05, 0.1, 0.1),
              (0.033, 0.033, 0.067, 0.067))
# each stage's weight on its losses
STAGE_WEIGHTS = (1.0, 0.5, 0.25)
NUM_STAGES = len(STAGE_STDS)

# The stages of one cascade `simple_test`: those of `STAGES` up to the
# proposals, then each bbox stage's RoIAlign, head and refinement (softmax,
# decode, clip), then the detections.
CASCADE_STAGES = STAGES[:4] + tuple(
    f"{name}.{t}" for t in range(NUM_STAGES) for name in ("roi_align", "bbox_head", "refine")
) + ("detections",)
# The stages of one `simple_test_masks` of the cascade with a mask head.
CASCADE_MASK_STAGES = CASCADE_STAGES + MASK_STAGES[len(STAGES):]
# The stages of one cascade `forward_train`: those of `TRAIN_STAGES` up to
# the proposals, then each bbox stage's sampling, RoIAlign, head and loss,
# and the refinement that hands the next stage its proposals.
CASCADE_TRAIN_STAGES = TRAIN_STAGES[:6] + tuple(
    f"{name}.{t}" for t in range(NUM_STAGES)
    for name in ("sampling", "roi_align", "bbox_head", "bbox_loss")
    + (("refine",) if t < NUM_STAGES - 1 else ()))
# The JAX `aug_test_detector` scores a cascade's RoIs with `bbox_for_rois`,
# which runs `bbox_head_m`: a head that the JAX cascade builds, loads from no
# stage and trains in none.
TTA_REFUSAL = ("test-time augmentation of a cascade is not ported: the JAX package's "
               "aug_test_detector scores it with bbox_head_m, a head that no cascade stage "
               "trains (ROADMAP.md, Queue 3)")


class CascadeRCNN(PanoFasterRCNN):
    """`PanoFasterRCNN` with three class-agnostic bbox stages.

    Its `forward_train` returns `loss_rpn_cls`, `loss_rpn_bbox` and, for
    each stage t, `s{t}.loss_cls`, `s{t}.loss_bbox` and `s{t}.acc`
    (`_roi_losses`); its stages are `CASCADE_TRAIN_STAGES`.  The samplers'
    noise is `noise["rpn"]` and `noise["rcnn.{t}"]`, two (B, G + n) tensors
    each, n the proposals' `max_per_img` at stage 0 and `int(num_samples *
    pos_fraction) + num_samples` after it; what is not handed in is drawn
    from `generator` in that order.  `gt_masks` are taken and not read."""

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

    def _roi_losses(self, feats, props, gt_boxes, gt_labels, gt_valid, gt_masks, draw,
                    stage):
        """JAX `CascadeRCNN.forward_train`'s stages: stage t samples from the
        current boxes at IoU threshold `STAGE_IOUS[t]` with its `STAGE_STDS`
        (the ground truth appended again), pools them with K3 at 7, runs its
        head and its class-agnostic loss (`reg_loss`, `reg_loss_weight`),
        whose entries with "loss" in their key it weighs by
        `STAGE_WEIGHTS[t]`.  The refinement decodes every slot, unfilled ones
        included, with zero means and the stage's stds, in float32 (the heads
        return float32 deltas whatever their compute type, as JAX's
        promotion gives), without clipping to the image (serving clips), and
        without gradient; the next stage's proposal mask is the slots that
        were filled."""
        rcnn_cfg, reg_loss = split_rcnn_cfg(self.train_cfg["rcnn"])
        boxes, mask = props.boxes, props.mask
        B, G = gt_boxes.shape[:2]
        out = {}
        for t, head in enumerate(self.roi_head.bbox_head):
            rcnn_cfg.update(pos_iou_thr=STAGE_IOUS[t], neg_iou_thr=STAGE_IOUS[t],
                            min_pos_iou=STAGE_IOUS[t])
            samples = stage(f"sampling.{t}", lambda: sample_rois_for_training(
                draw(f"rcnn.{t}", G + boxes.shape[1]), boxes, mask, gt_boxes, gt_labels,
                gt_valid, self.num_classes, target_stds=STAGE_STDS[t], **rcnn_cfg))
            flat = samples.rois.reshape(-1, 5)
            roi_feats = stage(f"roi_align.{t}", lambda: self.roi_features(feats, flat))
            cls, reg = stage(f"bbox_head.{t}", lambda: head(roi_feats))
            losses = stage(f"bbox_loss.{t}", lambda: bbox_head_loss(
                cls, reg, samples, self.num_classes, reg_class_agnostic=True,
                target_stds=STAGE_STDS[t], **reg_loss))
            for k, v in losses.items():
                out[f"s{t}.{k}"] = v * STAGE_WEIGHTS[t] if "loss" in k else v
            if t < NUM_STAGES - 1:
                def refine():
                    with torch.no_grad():
                        dec = delta_decode(flat[:, 1:5], reg.reshape(-1, 4),
                                           stds=STAGE_STDS[t])
                    return dec.reshape(B, -1, 4), samples.label_weights > 0

                boxes, mask = stage(f"refine.{t}", refine)
        return out

    def bbox_for_rois(self, images, boxes, img_shapes):
        raise NotImplementedError(TTA_REFUSAL)


class CascadeMaskRCNN(CascadeRCNN):
    """The cascade with the FCN mask head: `with_mask` is on by default.

    `forward_train` accepts `gt_masks`, as the JAX `CascadeMaskRCNN` does,
    and returns no `loss_mask`: the JAX `CascadeRCNN.forward_train` reads no
    mask, and the port holds itself to it.  The mask head is not called in
    training (K3 does not run at 14 there), gets no gradient, and AdamW only
    decays its weights, as optax decays JAX's.  The reference's
    `CascadeRoIHead` trains a mask head at every stage: ROADMAP.md, Queue 3,
    known divergences."""

    def __init__(self, *args, with_mask: bool = True, **kwargs):
        super().__init__(*args, with_mask=with_mask, **kwargs)
