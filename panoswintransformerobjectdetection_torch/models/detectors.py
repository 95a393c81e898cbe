"""Two-stage detector: backbone -> FPN -> RPN -> RoIAlign -> head [-> masks].

Counterpart of the `TwoStageDetector` subset that the flagship uses in
`panoswintransformerobjectdetection_tpu/models/detectors.py` (registered
there as `PanoFasterRCNN`): `extract_feat`, `simple_test` with the default
test configuration, the two steps of test-time augmentation
(`extract_proposals`, `bbox_for_rois`) and `forward_train` (the random
sampler and the L1, GIoU or IoU box loss; `check_train_cfg` refuses the
other training options); and `MaskRCNN`'s mask branch, at test time
(`simple_test_masks`) and in training (the mask loss of `forward_train`);
and `MaskScoringRCNN`, which adds the mask-IoU head to both.
The backbone is a PanoSwin
(`models/panoswin.py`; the v-variant `models/panoswin_v2.py`, which takes
each image's `pano_ratio_v`, and its v1 revision), a stock Swin
(`models/swin.py`), a ResNet, ResNeXt
(`models/resnet.py`), RegNet, Res2Net, ResNeSt or TridentResNet
(`models/backbones_extra.py`) or HRNet (`models/hrnet.py`), at test time
and in training; the neck an FPN or, for HRNet, an HRFPN.  Submodule names
follow the reference's state-dict keys (`backbone.`, `neck.`, `rpn_head.`,
`roi_head.bbox_head.`, `roi_head.mask_head.`, `roi_head.mask_iou_head.`).
"""

from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn

from ..core.anchors import AnchorGenerator
from ..core.bbox import bbox_overlaps, clip_boxes, delta_decode
from ..core.sampler import sampler_noise
from ..ops.nms import DetResult
from ..ops.roi_align import multilevel_roi_align_dense, roi_align
from ..parallel.dist import shard_rows, world
from .backbones_extra import RegNet, Res2Net, ResNeSt, TridentResNet
from .fpn import FPN
from .hrnet import HRFPN, HRNet
from .mask_head import (FCNMaskHead, MaskIoUHead, mask_head_loss, mask_iou_loss,
                        mask_iou_targets, mask_targets)
from .panoswin import PanoSwinTransformer
from .panoswin_v1 import PanoSwinTransformerV1
from .panoswin_v2 import PanoSwinTransformerV2
from .resnet import ResNet, ResNeXt
from .roi_head import (REG_LOSSES, UNPORTED_LOSS, bbox_head_detections, bbox_head_loss,
                       build_bbox_head, sample_rois_for_training)
from .rpn_head import RPNHead, rpn_loss, rpn_proposals
from .swin import SwinTransformer

BACKBONES = {"PanoSwinTransformer": PanoSwinTransformer,
             "PanoSwinTransformerV2": PanoSwinTransformerV2,
             "PanoSwinTransformerV1": PanoSwinTransformerV1, "SwinTransformer": SwinTransformer,
             "ResNet": ResNet, "ResNeXt": ResNeXt, "RegNet": RegNet, "Res2Net": Res2Net,
             "ResNeSt": ResNeSt, "TridentResNet": TridentResNet, "HRNet": HRNet}
NECKS = {"FPN": FPN, "HRFPN": HRFPN}


def default_train_cfg() -> dict:
    """`configs/_base_/models/faster_rcnn_panoswin_fpn.py:64-101`."""
    return {
        "rpn": {"pos_iou_thr": 0.7, "neg_iou_thr": 0.3, "min_pos_iou": 0.3,
                "num_samples": 256, "pos_fraction": 0.5},
        "rpn_proposal": {"nms_pre": 2000, "max_per_img": 1000, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
        "rcnn": {"pos_iou_thr": 0.5, "neg_iou_thr": 0.5, "min_pos_iou": 0.5,
                 "num_samples": 512, "pos_fraction": 0.25},
    }


def default_test_cfg() -> dict:
    """`configs/_base_/models/faster_rcnn_panoswin_fpn.py:102-115`."""
    return {
        "rpn": {"nms_pre": 1000, "max_per_img": 1000, "iou_threshold": 0.7,
                "min_bbox_size": 0},
        "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 100},
    }


# The stages of one `simple_test` request, in order.
STAGES = ("stem", "backbone", "fpn", "proposals", "roi_align", "bbox_head", "detections")
# The stages of one `simple_test_masks` request: those of `simple_test`,
# then the mask branch.
MASK_STAGES = STAGES + ("mask_roi_align", "mask_head")
# The stages of one `forward_train`, in order.
TRAIN_STAGES = ("stem", "backbone", "fpn", "rpn_head", "rpn_loss", "proposals", "sampling",
                "roi_align", "bbox_head", "bbox_loss")
# The stages of one `forward_train` of a detector with a mask head, given
# `gt_masks`: those of `TRAIN_STAGES`, then the mask branch.
MASK_TRAIN_STAGES = TRAIN_STAGES + ("mask_roi_align", "mask_head", "mask_targets", "mask_loss")
# Mask Scoring R-CNN's: those of `MASK_STAGES` and `MASK_TRAIN_STAGES`, then
# the mask-IoU head (with its rescoring at test time, its target and loss in
# training).
MASK_SCORING_STAGES = MASK_STAGES + ("mask_iou",)
MASK_SCORING_TRAIN_STAGES = MASK_TRAIN_STAGES + ("mask_iou",)


def check_train_cfg(train_cfg: Optional[dict]) -> None:
    """Raise `NotImplementedError` for a training configuration whose RoI
    options the port does not train: a `sampler` (OHEM, ScoreHLR, combined)
    or a `reg_loss` outside `roi_head.REG_LOSSES`, both ROADMAP.md item 17d.
    `reg_loss` "l1", "giou" or "iou" and `reg_loss_weight` are trained."""
    rcnn = (train_cfg or default_train_cfg())["rcnn"]
    if "sampler" in rcnn:
        raise NotImplementedError(
            f"train_cfg['rcnn']['sampler']={rcnn['sampler']!r}: the OHEM, ScoreHLR and "
            "combined samplers are not ported yet (ROADMAP.md, Queue 1, item 17d)")
    if rcnn.get("reg_loss", "l1") not in REG_LOSSES:
        raise NotImplementedError(f"train_cfg['rcnn']['reg_loss']={rcnn['reg_loss']!r} "
                                  f"{UNPORTED_LOSS}")


def split_rcnn_cfg(rcnn: dict) -> Tuple[dict, dict]:
    """`train_cfg["rcnn"]` -> the sampler's arguments and `bbox_head_loss`'s
    (`reg_loss`, `reg_loss_weight`), popped as the JAX detectors pop them."""
    sampling = dict(rcnn)
    return sampling, {"reg_loss": sampling.pop("reg_loss", "l1"),
                      "reg_loss_weight": sampling.pop("reg_loss_weight", 1.0)}


def run_stage(name: str, fn: Callable):
    return fn()


class RoIHead(nn.Module):
    """Holds the bbox head under `roi_head.bbox_head` and any mask head under
    `roi_head.mask_head`, as the reference does."""

    def __init__(self, bbox_head: nn.Module, mask_head: Optional[FCNMaskHead] = None):
        super().__init__()
        self.bbox_head = bbox_head
        if mask_head is not None:
            self.mask_head = mask_head


class PanoFasterRCNN(nn.Module):
    def __init__(self, backbone: dict, num_classes: int = 80, neck: Optional[dict] = None,
                 anchor_scales: Sequence[float] = (8.0,),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 anchor_strides: Sequence[int] = (4, 8, 16, 32, 64),
                 featmap_strides: Sequence[int] = (4, 8, 16, 32),
                 rpn_target_stds: Sequence[float] = (1.0, 1.0, 1.0, 1.0),
                 rcnn_target_stds: Sequence[float] = (0.1, 0.1, 0.2, 0.2),
                 train_cfg: Optional[dict] = None, test_cfg: Optional[dict] = None,
                 compute_dtype: Optional[torch.dtype] = None, roi_align: str = "direct",
                 with_mask: bool = False, mask_roi_size: int = 14,
                 bbox_head: Optional[dict] = None):
        """`backbone`: the backbone's arguments, with its `type` (one of
        `BACKBONES`; PanoSwinTransformer when absent).  `roi_align`:
        "direct" pools the RoIs with kernel K3, "dense" with the
        interpolation-matrix route and kernel K4 on each level
        (`ops/roi_align.py`); both compute the same function.  `with_mask`
        adds the FCN mask head (`roi_head.mask_head`), which
        `simple_test_masks` runs on `mask_roi_size` bins a side.
        `bbox_head`: the bbox head's config (`roi_head.build_bbox_head`;
        Shared2FC when None).  `neck`: the neck's arguments, with its `type`
        (one of `NECKS`; FPN when absent)."""
        super().__init__()
        if roi_align not in ("direct", "dense"):
            raise ValueError(f"roi_align must be 'direct' or 'dense', got {roi_align!r}")
        backbone = dict(backbone)
        self.backbone = BACKBONES[backbone.pop("type", "PanoSwinTransformer")](
            **backbone, dtype=compute_dtype)
        neck = dict(neck or {"in_channels": (96, 192, 384, 768), "out_channels": 256,
                             "num_outs": 5})
        self.neck = NECKS[neck.pop("type", "FPN")](**neck, dtype=compute_dtype)
        out_ch = neck["out_channels"]
        self.rpn_head = RPNHead(out_ch, 256, len(anchor_scales) * len(anchor_ratios),
                                compute_dtype)
        self.roi_head = RoIHead(self._make_bbox_head(bbox_head, out_ch, num_classes,
                                                     compute_dtype),
                                FCNMaskHead(out_ch, num_classes) if with_mask else None)
        self.with_mask = with_mask
        self.mask_roi_size = mask_roi_size
        self.anchor_gen = AnchorGenerator(anchor_strides, anchor_ratios, anchor_scales)
        self.featmap_strides = tuple(featmap_strides)
        self.rpn_target_stds = tuple(rpn_target_stds)
        self.rcnn_target_stds = tuple(rcnn_target_stds)
        self.num_classes = num_classes
        self.train_cfg = train_cfg or default_train_cfg()
        self.test_cfg = test_cfg or default_test_cfg()
        self.roi_align = roi_align

    def _make_bbox_head(self, cfg: Optional[dict], in_channels: int, num_classes: int,
                        dtype: Optional[torch.dtype]) -> nn.Module:
        """The module under `roi_head.bbox_head` (a subclass's hook)."""
        return build_bbox_head(cfg, in_channels, num_classes, dtype)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def extract_feat(self, images, pano_ratio_v=None):
        """The FPN maps of `images` (the JAX `extract_feat`): a
        `PanoSwinTransformerV2` backbone gets `pano_ratio_v`, any other none."""
        return self.neck(self._backbone(images, pano_ratio_v))

    def _backbone(self, images, pano_ratio_v=None, stage: Callable = run_stage):
        """The backbone's maps: its stem and the rest as two stages.  The
        v-variant and v1 take the batch's (B, 3) ratios and the input's
        width; only the v-variant (`takes_ratio`) gets `pano_ratio_v`, as
        the JAX `extract_feat` hands it to that type alone; v1 and a
        v-variant given none run at (0, 1, H0), H0 the input's height."""
        bb = self.backbone
        if not isinstance(bb, PanoSwinTransformerV2):
            x = stage("stem", lambda: bb.patch_embed(images))
            return stage("backbone", lambda: bb.forward_from_embed(x))
        ratio = bb.pano_ratio(images, pano_ratio_v if bb.takes_ratio else None)
        x = stage("stem", lambda: bb.patch_embed(images, ratio))
        return stage("backbone", lambda: bb.forward_from_embed(x, ratio, images.shape[2]))

    def _anchors(self, cls_scores):
        return self.anchor_gen.grid_anchors([tuple(c.shape[1:3]) for c in cls_scores],
                                            device=cls_scores[0].device)

    def proposals(self, feats, img_shapes):
        cls_scores, bbox_preds = self.rpn_head(feats)
        return rpn_proposals(cls_scores, bbox_preds, self._anchors(cls_scores), img_shapes,
                             target_stds=self.rpn_target_stds, **self.test_cfg["rpn"])

    @staticmethod
    def rois(props) -> torch.Tensor:
        """(B, P, 4) proposals -> (B * P, 5) rois (batch index, x1, y1, x2, y2)."""
        B, P, _ = props.boxes.shape
        bidx = torch.arange(B, dtype=props.boxes.dtype, device=props.boxes.device)
        return torch.cat([bidx[:, None, None].expand(B, P, 1), props.boxes],
                         dim=-1).reshape(B * P, 5)

    def roi_features(self, feats, rois, out_size: int = 7):
        """rois (B * P, 5), grouped by image -> (B * P, o, o, C), o = `out_size`."""
        nlvl = min(len(self.featmap_strides), len(feats))
        if self.roi_align == "dense":
            return multilevel_roi_align_dense(feats[:nlvl], rois, self.featmap_strides, out_size)
        return roi_align(feats[:nlvl], rois, self.featmap_strides, out_size)

    def forward(self, *args, **kwargs) -> Dict[str, torch.Tensor]:
        """`forward_train`: what `DistributedDataParallel` calls
        (`runtime/train.ddp_wrap`).  Serving calls `simple_test`."""
        return self.forward_train(*args, **kwargs)

    def forward_train(self, images, img_shapes, gt_boxes, gt_labels, gt_valid, gt_masks=None,
                      pano_ratio_v=None,
                      noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None,
                      generator: Optional[torch.Generator] = None,
                      stage: Callable = run_stage) -> Dict[str, torch.Tensor]:
        """images (B, H, W, 3); img_shapes (B, 2) unpadded (h, w); gt_boxes
        (B, G, 4) xyxy; gt_labels (B, G); gt_valid (B, G) bool; gt_masks
        (B, G, H', W') {0, 1} bitmaps, read only by a detector with a mask
        head; pano_ratio_v (B, 3), read only by a `PanoSwinTransformerV2`
        backbone (`_backbone`).  Inputs are moved to the model's device.
        Returns `loss_rpn_cls`, `loss_rpn_bbox`, `loss_cls`, `loss_bbox` and `acc`,
        and `loss_mask` where there is a mask head and `gt_masks`
        (`_mask_train_outputs`), and `loss_mask_iou` for a `MaskScoringRCNN`.

        The two samplers' uniform noise is `noise["rpn"]`, two (B, anchors)
        tensors, and `noise["rcnn"]`, two (B, G + proposals) tensors; what is
        not handed in is drawn from `generator` (`core/sampler.sampler_noise`),
        under a process group for the global batch, of which this process
        keeps its rows (`parallel/dist.shard_rows`).
        The proposals are constants of the RoI stage: the RPN gets gradient
        from its own loss alone.  The module must be in train mode: the
        PanoSwin stem then runs with live BatchNorm, whereas the eval stem
        runs kernel K1, which has no backward; a CNN backbone's BatchNorms
        run live unless its `norm_eval` is set.  Each stage (`TRAIN_STAGES`)
        runs as `stage(name, fn)`, as in `simple_test` (`MASK_TRAIN_STAGES`
        with the mask branch).
        """
        if not self.training:
            raise RuntimeError("forward_train needs train mode (call .train()): the eval "
                               "stem runs kernel K1, which has no backward")
        check_train_cfg(self.train_cfg)
        dev = self.device
        noise = dict(noise or {})
        images = torch.as_tensor(images, device=dev)
        img_shapes = torch.as_tensor(img_shapes, dtype=torch.float32, device=dev)
        gt_boxes = torch.as_tensor(gt_boxes, dtype=torch.float32, device=dev)
        gt_labels = torch.as_tensor(gt_labels, device=dev).long()
        gt_valid = torch.as_tensor(gt_valid, device=dev).bool()
        tc = self.train_cfg
        B = images.shape[0]

        def draw(name, n):
            if name not in noise:
                noise[name] = tuple(shard_rows(t, B) for t in
                                    sampler_noise((world() * B, n), generator, dev))
            return tuple(t.to(dev) for t in noise[name])

        feats = self._backbone(images, pano_ratio_v, stage)
        feats = stage("fpn", lambda: self.neck(feats))
        cls_scores, bbox_preds = stage("rpn_head", lambda: self.rpn_head(feats))
        level_anchors = self._anchors(cls_scores)
        anchors = torch.cat(level_anchors)
        out = stage("rpn_loss", lambda: rpn_loss(
            cls_scores, bbox_preds, anchors, gt_boxes, gt_valid, draw("rpn", anchors.shape[0]),
            target_stds=self.rpn_target_stds, **tc["rpn"]))

        def proposals():
            with torch.no_grad():
                return rpn_proposals(cls_scores, bbox_preds, level_anchors, img_shapes,
                                     target_stds=self.rpn_target_stds, **tc["rpn_proposal"])

        props = stage("proposals", proposals)
        out.update(self._roi_losses(feats, props, gt_boxes, gt_labels, gt_valid, gt_masks,
                                    draw, stage))
        return out

    def _roi_losses(self, feats, props, gt_boxes, gt_labels, gt_valid, gt_masks, draw,
                    stage) -> Dict[str, torch.Tensor]:
        """The RoI part of `forward_train` (a subclass's hook): sampling with
        `noise["rcnn"]`, K3, the bbox head and its loss (`split_rcnn_cfg`),
        and the mask loss where there is a mask head and `gt_masks`."""
        rcnn_cfg, reg_loss = split_rcnn_cfg(self.train_cfg["rcnn"])
        samples = stage("sampling", lambda: sample_rois_for_training(
            draw("rcnn", gt_boxes.shape[1] + props.boxes.shape[1]), props.boxes, props.mask,
            gt_boxes, gt_labels, gt_valid, self.num_classes,
            target_stds=self.rcnn_target_stds, **rcnn_cfg))
        flat_rois = samples.rois.reshape(-1, 5)
        roi_feats = stage("roi_align", lambda: self.roi_features(feats, flat_rois))
        cls, reg = stage("bbox_head", lambda: self.roi_head.bbox_head(roi_feats))
        out = stage("bbox_loss", lambda: bbox_head_loss(
            cls, reg, samples, self.num_classes, target_stds=self.rcnn_target_stds,
            **reg_loss))
        if self.with_mask and gt_masks is not None:
            mask_out = self._mask_train_outputs(feats, samples, torch.as_tensor(
                gt_masks, device=self.device), gt_boxes, gt_valid, stage)
            out["loss_mask"] = mask_out["loss_mask"]
            self._extra_mask_losses(out, mask_out, stage)
        return out

    def _mask_train_outputs(self, feats, samples, gt_masks, gt_boxes, gt_valid, stage):
        """The mask branch's loss and what a subclass needs besides (JAX
        `_mask_train_outputs`): the positives are the first `num_samples *
        pos_fraction` slots of each image; their features (`mfeats`) are
        pooled with kernel K3 at `mask_roi_size` bins, whose backward is K3's
        backward; each slot's target (`targets`) is its ground truth of
        largest IoU among the valid ones, cropped from `gt_masks`.  Returns
        `loss_mask`, `mfeats`, `mlogits`, `targets`, `labels` and
        `weights` (the slots' bbox weights)."""
        rc = self.train_cfg["rcnn"]
        pos_cap = int(rc["num_samples"] * rc["pos_fraction"])
        pos_rois = samples.rois[:, :pos_cap]                          # (B, Pc, 5)
        flat = pos_rois.reshape(-1, 5)
        mfeats = stage("mask_roi_align", lambda: self.roi_features(feats, flat,
                                                                  self.mask_roi_size))
        logits = stage("mask_head", lambda: self.roi_head.mask_head(mfeats))

        def targets():
            ious = bbox_overlaps(gt_boxes, pos_rois[..., 1:5])         # (B, G, Pc)
            ious = torch.where(gt_valid[:, :, None], ious, torch.full_like(ious, -1.0))
            return mask_targets(gt_masks, flat, ious.argmax(1).reshape(-1),
                                2 * self.mask_roi_size)

        tgts = stage("mask_targets", targets)
        labels = samples.labels[:, :pos_cap].reshape(-1)
        weights = samples.bbox_weights[:, :pos_cap].reshape(-1)
        loss = stage("mask_loss", lambda: mask_head_loss(logits, tgts, labels, weights))
        return {"loss_mask": loss, "mfeats": mfeats, "mlogits": logits, "targets": tgts,
                "labels": labels, "weights": weights}

    def _extra_mask_losses(self, out, mask_out, stage) -> None:
        """A subclass's losses from the mask branch's outputs (JAX
        `_extra_mask_losses`), added to `out`."""

    @torch.no_grad()
    def simple_test(self, images, img_shapes, scale_factors=None, pano_ratio_v=None,
                    stage: Callable = run_stage) -> DetResult:
        """images (B, H, W, 3) float; img_shapes (B, 2) (h, w); scale_factors
        (B, 4) or None; pano_ratio_v (B, 3) or None, for a
        `PanoSwinTransformerV2` backbone (`_backbone`).  Inputs are moved to
        the model's device.  Returns a DetResult of (B, K) slots; only
        `mask`ed slots hold detections.

        Each of the request's stages (`STAGES`, in order) runs as
        `stage(name, fn)`, which calls `fn()` and returns its result; a
        profiler passes one that also times it.
        """
        return self._detect(images, img_shapes, scale_factors, stage, pano_ratio_v)[0]

    def _detect(self, images, img_shapes, scale_factors, stage, pano_ratio_v=None):
        """`simple_test`'s DetResult, with the FPN maps and the scale
        factors on the device (None where not given)."""
        dev = self.device
        images = torch.as_tensor(images, device=dev)
        img_shapes = torch.as_tensor(img_shapes, dtype=torch.float32, device=dev)
        if scale_factors is not None:
            scale_factors = torch.as_tensor(scale_factors, dtype=torch.float32, device=dev)
        feats = self._backbone(images, pano_ratio_v, stage)
        feats = stage("fpn", lambda: self.neck(feats))
        props = stage("proposals", lambda: self.proposals(feats, img_shapes))
        return self._roi_detections(feats, props, img_shapes, scale_factors, stage), feats, \
            scale_factors

    def _roi_detections(self, feats, props, img_shapes, scale_factors, stage) -> DetResult:
        """The RoI part of `simple_test`: the proposals pooled with K3, the
        bbox head, the detections (a subclass's hook)."""
        B, P, _ = props.boxes.shape
        rois = self.rois(props)
        roi_feats = stage("roi_align", lambda: self.roi_features(feats, rois))
        cls, reg = stage("bbox_head", lambda: self.roi_head.bbox_head(roi_feats))
        return stage("detections", lambda: bbox_head_detections(
            cls.reshape(B, P, -1), reg.reshape(B, P, -1), rois.reshape(B, P, 5), img_shapes,
            target_stds=self.rcnn_target_stds, roi_mask=props.mask,
            scale_factors=scale_factors, **self.test_cfg["rcnn"]))

    @torch.no_grad()
    def simple_test_masks(self, images, img_shapes, scale_factors=None, pano_ratio_v=None,
                          stage: Callable = run_stage):
        """`simple_test`'s DetResult and each detection slot's mask
        probabilities (B, K, 2s, 2s) of its own class, s = `mask_roi_size`
        (the JAX `simple_test_masks`): every slot, padded ones included, is
        a mask RoI (its box scaled back to the network's input), pooled with
        kernel K3 at s x s bins from the FPN maps of the detection pass.
        Paste them into the image with `mask_head.paste_masks`.  The stages
        are `MASK_STAGES`."""
        if not self.with_mask:
            raise ValueError("simple_test_masks needs a detector with a mask head "
                             "(with_mask=True)")
        det, feats, scale_factors = self._detect(images, img_shapes, scale_factors, stage,
                                                 pano_ratio_v)
        B, K, _ = det.boxes.shape
        boxes = det.boxes if scale_factors is None else det.boxes * scale_factors[:, None, :]
        bidx = torch.arange(B, dtype=boxes.dtype, device=boxes.device)
        rois = torch.cat([bidx[:, None, None].expand(B, K, 1), boxes], dim=-1).reshape(B * K, 5)
        mfeats = stage("mask_roi_align",
                       lambda: self.roi_features(feats, rois, self.mask_roi_size))

        def mask_head():
            logits = self.roi_head.mask_head(mfeats)                  # (B*K, classes, 2s, 2s)
            lab = det.labels.reshape(-1).long().clamp(0, self.num_classes - 1)
            sel = logits[torch.arange(B * K, device=logits.device), lab]
            return torch.sigmoid(sel).reshape(B, K, *sel.shape[1:])

        return self._score_masks(det, mfeats, stage("mask_head", mask_head), stage)

    def _score_masks(self, det, mfeats, probs, stage):
        """`simple_test_masks`'s result from the detections, the mask RoIs'
        features and the probabilities (a subclass's hook)."""
        return det, probs

    @torch.no_grad()
    def extract_proposals(self, images, img_shapes):
        """The RPN's proposals alone (the first step of `apis/tta.py`)."""
        dev = self.device
        images = torch.as_tensor(images, device=dev)
        img_shapes = torch.as_tensor(img_shapes, dtype=torch.float32, device=dev)
        return self.proposals(self.extract_feat(images), img_shapes)

    @torch.no_grad()
    def bbox_for_rois(self, images, boxes, img_shapes):
        """Class probabilities (B, P, C + 1) and per-class boxes (B, P, 4C)
        for given proposal boxes (B, P, 4): softmax of the head's logits,
        the deltas decoded with zero means, each coordinate clipped to the
        image (the per-augmentation step of `apis/tta.py`)."""
        dev = self.device
        images = torch.as_tensor(images, device=dev)
        boxes = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
        img_shapes = torch.as_tensor(img_shapes, dtype=torch.float32, device=dev)
        feats = self.extract_feat(images)
        B, P, _ = boxes.shape
        bidx = torch.arange(B, dtype=boxes.dtype, device=dev)[:, None, None].expand(B, P, 1)
        rois = torch.cat([bidx, boxes], dim=-1).reshape(B * P, 5)
        cls, reg = self.roi_head.bbox_head(self.roi_features(feats, rois))
        scores = torch.softmax(cls.reshape(B, P, -1), dim=-1)
        dec = delta_decode(boxes.reshape(B * P, 4), reg.reshape(B * P, -1),
                           stds=self.rcnn_target_stds).reshape(B, P, -1)
        return scores, clip_boxes(dec, img_shapes[:, 0, None, None],
                                  img_shapes[:, 1, None, None])


class MaskRCNN(PanoFasterRCNN):
    """Faster R-CNN with the FCN mask branch (the reference's `MaskRCNN`, the
    JAX package's `detectors.py:441`): `with_mask` is on by default."""

    def __init__(self, *args, with_mask: bool = True, **kwargs):
        super().__init__(*args, with_mask=with_mask, **kwargs)


class MaskScoringRCNN(MaskRCNN):
    """Mask R-CNN with the mask-IoU head (the reference's and the JAX
    package's `MaskScoringRCNN`, JAX `detectors.py:599-647`) under
    `roi_head.mask_iou_head`.

    Training (`_extra_mask_losses`): the head reads the mask branch's RoI
    features and the sigmoid of each slot's own class's mask logits, neither
    detached, so `loss_mask_iou`'s gradient reaches the mask head and,
    through K3's backward at the mask size, the backbone: the crop's
    cotangent is the sum of the two heads', one launch of K3's backward.
    Its target, the IoU of the binarised prediction and target
    (`mask_iou_targets`), is a constant; the loss is `mask_iou_loss`, the
    slots weighted by their bbox weights.  The stages are
    `MASK_SCORING_TRAIN_STAGES`.

    Serving (`_score_masks`): the head reads the features and probabilities
    of `simple_test_masks`'s own crop (the JAX function crops the same RoIs
    again: the same values, and K3 at 14 runs once a batch here); each
    valid slot's score becomes score * clip(IoU of its class, 0, 1), the
    padded slots keep theirs.  The stages are `MASK_SCORING_STAGES`.  The
    reference's `MaskScoringRoIHead` rescores only the segm results, and
    measures the target's area in the whole gt mask (known divergences of
    the JAX package, ROADMAP.md)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.roi_head.mask_iou_head = MaskIoUHead(
            self.num_classes, self.roi_head.mask_head.convs[0].conv.in_channels,
            roi_feat_size=self.mask_roi_size)

    def _extra_mask_losses(self, out, mask_out, stage) -> None:
        def loss():
            R = mask_out["mlogits"].shape[0]
            lab = mask_out["labels"].long().clamp(0, self.num_classes - 1)
            probs = torch.sigmoid(mask_out["mlogits"][torch.arange(R, device=lab.device), lab])
            pred = self.roi_head.mask_iou_head(mask_out["mfeats"], probs)
            return mask_iou_loss(pred, mask_iou_targets(probs, mask_out["targets"]), lab,
                                 mask_out["weights"])

        out["loss_mask_iou"] = stage("mask_iou", loss)

    def _score_masks(self, det, mfeats, probs, stage):
        def rescore():
            B, K = det.scores.shape
            pred = self.roi_head.mask_iou_head(mfeats, probs.reshape(B * K, *probs.shape[2:]))
            lab = det.labels.reshape(-1).long().clamp(0, self.num_classes - 1)
            miou = pred[torch.arange(B * K, device=pred.device), lab].reshape(B, K)
            scores = torch.where(det.mask, det.scores * miou.clamp(0.0, 1.0), det.scores)
            return DetResult(det.boxes, scores, det.labels, det.mask), probs

        return stage("mask_iou", rescore)
