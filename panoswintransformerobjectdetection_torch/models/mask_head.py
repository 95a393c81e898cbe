"""FCN mask head, its training targets and loss, and the paste of its masks
into the image (Mask R-CNN's mask branch).

Counterpart of `FCNMaskHead`, `mask_targets_from_bitmaps`,
`mask_head_loss` and `paste_masks` in
`panoswintransformerobjectdetection_tpu/models/mask_head.py` (the
reference's `mask_heads/fcn_mask_head.py`): 4 x (3 x 3 conv + ReLU), a 2 x 2
stride-2 transposed conv + ReLU and a 1 x 1 conv to per-class logits on the
14 x 14 RoI features; `mask_targets` crops each positive RoI's matched
ground-truth bitmap to 28 x 28 with aligned RoIAlign; `mask_head_loss` is
the per-pixel BCE on the matched class's channel; `paste_masks` is the
inverse bilinear resample of each detection's 28 x 28 probabilities into
the image, thresholded.  Module
names are the reference checkpoint's (`roi_head.mask_head.convs.{i}.conv`,
`.upsample`, `.conv_logits`).  The head has no compute type, as the JAX
head has none: with float32 parameters it computes in float32 whatever the
features' type.

Mask Scoring R-CNN's head, its targets and its loss (`MaskIoUHead`,
`mask_iou_targets`, `mask_iou_loss`, the JAX module's and the reference's
`maskiou_head.py`): the selected class's 2s x 2s mask probabilities
max-pooled 2 x 2 to s x s and concatenated after the s x s RoI features,
4 x (3 x 3 conv + ReLU) of 256 channels, the last of stride 2, then `fcs.0`
and `fcs.1` (1024, ReLU) and `fc_mask_iou` (a predicted mask IoU a class,
no activation), under `roi_head.mask_iou_head.convs.{i}.conv`, `.fcs.{0,1}`
and `.fc_mask_iou`, the reference's keys.  `fcs.0` reads the convs' output
flattened as (C, h, w), the reference's order (the JAX head flattens (h, w,
C); `runtime/checkpoint.from_jax_variables` reorders its kernel).  No
compute type either: float32.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.roi_align import _axis_taps, _div
from ..parallel.dist import all_reduce_sum
from .layers import conv, dense


class _ConvModule(nn.Module):
    """Holds a conv under `.conv`, as the reference's `ConvModule` does."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride, padding=1)


class FCNMaskHead(nn.Module):
    def __init__(self, in_channels: int = 256, num_classes: int = 80, num_convs: int = 4,
                 conv_out_channels: int = 256):
        super().__init__()
        self.convs = nn.ModuleList(
            _ConvModule(in_channels if i == 0 else conv_out_channels, conv_out_channels)
            for i in range(num_convs))
        self.upsample = nn.ConvTranspose2d(conv_out_channels, conv_out_channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(conv_out_channels, num_classes, 1)

    def forward(self, roi_feats: torch.Tensor) -> torch.Tensor:
        """roi_feats (R, s, s, C) -> mask logits (R, num_classes, 2s, 2s), f32."""
        x = roi_feats.permute(0, 3, 1, 2)
        for m in self.convs:
            x = torch.relu(conv(m.conv, x, None))
        up = self.upsample
        x = torch.relu(F.conv_transpose2d(x.to(up.weight.dtype), up.weight, up.bias,
                                          stride=up.stride))
        return conv(self.conv_logits, x, None)


@torch.no_grad()
def mask_targets(gt_masks: torch.Tensor, rois: torch.Tensor, gt_idx: torch.Tensor,
                 out_size: int = 28) -> torch.Tensor:
    """Each RoI's matched ground-truth bitmap cropped and resized to (out_size,
    out_size): single-level aligned RoIAlign at scale 1 with 2 x 2 samples a
    bin, clipped to [0, 1] (JAX `mask_targets_from_bitmaps`, per image).

    gt_masks (B, G, H, W) {0, 1} (uint8 or float), padded as the loader pads
    them; rois (R, 5) (image index, x1, y1, x2, y2); gt_idx (R,) the matched
    ground truth of each RoI in its image.  Returns (R, out_size, out_size)
    float32.  Where the JAX function gathers whole bitmaps for dense
    interpolation matrices, this reads only each bin's taps: per axis and bin
    the merged taps of K3's twin (`ops/roi_align._axis_taps`), at most 4
    rows and 4 columns, in float32.
    """
    B, G, H, W = gt_masks.shape
    R = rois.shape[0]
    rois = rois.float()
    dev = rois.device
    hs = torch.full((R,), float(H), device=dev)
    ws = torch.full((R,), float(W), device=dev)
    ys, yw = _axis_taps(rois[:, 2] - 0.5, _div(rois[:, 4] - rois[:, 2], out_size), hs,
                        torch.float32, out_size)
    xs, xw = _axis_taps(rois[:, 1] - 0.5, _div(rois[:, 3] - rois[:, 1], out_size), ws,
                        torch.float32, out_size)
    plane = rois[:, 0].long() * G + gt_idx.long()                   # (R,)
    rows = (plane[:, None, None] * H + ys) * W                      # (R, o, 4)
    taps = gt_masks.reshape(-1)[rows[:, :, :, None, None] + xs[:, None, None]].float()
    t = (yw[:, :, :, None, None] * taps).sum(2)                     # (R, o, o, 4)
    out = (xw[:, None] * t).sum(-1)
    return out.clamp(0.0, 1.0)


def mask_head_loss(mask_logits: torch.Tensor, targets: torch.Tensor, labels: torch.Tensor,
                   weights: torch.Tensor) -> torch.Tensor:
    """Per-pixel binary cross entropy on the channel of each RoI's class
    (labels clipped to the classes), targets thresholded at 0.5, averaged
    over each RoI, then weighted by `weights` (1 for the positives) and
    divided by their sum (at least 1), the global batch's under a process
    group (`parallel/dist.all_reduce_sum`).  mask_logits (R, classes, m, m);
    targets (R, m, m); labels, weights (R,)."""
    R = mask_logits.shape[0]
    lab = labels.long().clamp(0, mask_logits.shape[1] - 1)
    logits = mask_logits[torch.arange(R, device=mask_logits.device), lab]
    t = (targets >= 0.5).to(logits.dtype)
    bce = logits.clamp(min=0) - logits * t + torch.log1p(torch.exp(-logits.abs()))
    w = weights.to(logits.dtype)
    return (bce.mean(dim=(1, 2)) * w).sum() / all_reduce_sum(w.sum()).clamp(min=1.0)


def paste_masks(mask_probs: torch.Tensor, boxes: torch.Tensor, img_h: int, img_w: int,
                thr: float = 0.5) -> torch.Tensor:
    """Paste (K, m, m) RoI mask probabilities into (K, img_h, img_w) bool
    maps: `paste_mask_values` >= thr."""
    return paste_mask_values(mask_probs, boxes, img_h, img_w) >= thr


def paste_mask_values(mask_probs: torch.Tensor, boxes: torch.Tensor, img_h: int,
                      img_w: int) -> torch.Tensor:
    """(K, img_h, img_w) float32 probabilities of (K, m, m) RoI masks in the
    image, boxes (K, 4) xyxy: pixel centre (x + 0.5, y + 0.5) maps to (x +
    0.5 - x1) / w * m - 0.5 on the mask's grid (w, h at least 1e-3), where
    the four neighbours' bilinear blend (their indices clamped to the mask)
    is taken in the JAX function's order; a pixel outside (-1, m) on either
    axis is 0.  A gather on the tensors' device."""
    K, m, _ = mask_probs.shape
    dev = mask_probs.device
    ys = torch.arange(img_h, dtype=torch.float32, device=dev)[None, :, None]
    xs = torch.arange(img_w, dtype=torch.float32, device=dev)[None, None, :]
    boxes = boxes.float()
    x1 = boxes[:, 0, None, None]
    y1 = boxes[:, 1, None, None]
    w = torch.clamp(boxes[:, 2, None, None] - x1, min=1e-3)
    h = torch.clamp(boxes[:, 3, None, None] - y1, min=1e-3)
    gx = (xs + 0.5 - x1) / w * m - 0.5                       # (K, 1, W)
    gy = (ys + 0.5 - y1) / h * m - 0.5                       # (K, H, 1)
    x0, y0 = torch.floor(gx), torch.floor(gy)
    wx, wy = gx - x0, gy - y0
    flat = mask_probs.float().reshape(K, m * m)

    def g(yi, xi):
        yi = yi.long().clamp(0, m - 1)
        xi = xi.long().clamp(0, m - 1)
        idx = (yi * m + xi).reshape(K, img_h * img_w)
        return torch.gather(flat, 1, idx).reshape(K, img_h, img_w)

    val = (g(y0, x0) * (1 - wx) * (1 - wy) + g(y0, x0 + 1) * wx * (1 - wy)
           + g(y0 + 1, x0) * (1 - wx) * wy + g(y0 + 1, x0 + 1) * wx * wy)
    inside = (gx > -1) & (gx < m) & (gy > -1) & (gy < m)
    return torch.where(inside, val, torch.zeros((), device=dev))


class MaskIoUHead(nn.Module):
    NUM_CONVS, CONV_OUT, FC_OUT = 4, 256, 1024     # the JAX head's fixed widths

    def __init__(self, num_classes: int = 80, in_channels: int = 256, roi_feat_size: int = 14):
        super().__init__()
        n, c = self.NUM_CONVS, self.CONV_OUT
        self.convs = nn.ModuleList(_ConvModule(in_channels + 1 if i == 0 else c, c,
                                               2 if i == n - 1 else 1) for i in range(n))
        pooled = ((roi_feat_size + 1) // 2) ** 2
        self.fcs = nn.ModuleList([nn.Linear(c * pooled, self.FC_OUT),
                                  nn.Linear(self.FC_OUT, self.FC_OUT)])
        self.fc_mask_iou = nn.Linear(self.FC_OUT, num_classes)

    def forward(self, roi_feats: torch.Tensor, mask_probs: torch.Tensor) -> torch.Tensor:
        """roi_feats (R, s, s, C); mask_probs (R, 2s, 2s), the selected
        class's probabilities -> (R, num_classes) predicted mask IoU, f32."""
        dt = torch.promote_types(roi_feats.dtype, mask_probs.dtype)
        pooled = F.max_pool2d(mask_probs[:, None].to(dt), 2, 2)
        x = torch.cat([roi_feats.permute(0, 3, 1, 2).to(dt), pooled], dim=1)
        for m in self.convs:
            x = torch.relu(conv(m.conv, x, None))
        x = x.flatten(1)
        for fc in self.fcs:
            x = torch.relu(dense(fc, x, None))
        return dense(self.fc_mask_iou, x, None)


@torch.no_grad()
def mask_iou_targets(mask_probs: torch.Tensor, mask_targets: torch.Tensor) -> torch.Tensor:
    """The IoU, inside each RoI, of the predicted mask (probabilities > 0.5)
    and the RoI-cropped ground truth (> 0.5), the union at least 1e-6: (R,
    m, m) each -> (R,) float32.  A constant of the step (no gradient)."""
    p = (mask_probs > 0.5).float()
    t = (mask_targets > 0.5).float()
    inter = (p * t).sum((-2, -1))
    union = (p.sum((-2, -1)) + t.sum((-2, -1)) - inter).clamp(min=1e-6)
    return inter / union


def mask_iou_loss(iou_pred: torch.Tensor, iou_target: torch.Tensor, labels: torch.Tensor,
                  weights: torch.Tensor) -> torch.Tensor:
    """0.5 * (the predicted IoU of each RoI's class - its target)^2 (labels
    clipped to the classes: a padded slot carries the background label),
    weighted by `weights` and divided by their sum (at least 1), the global
    batch's under a process group, as `mask_head_loss` divides.  iou_pred
    (R, classes); iou_target, labels, weights (R,)."""
    R = iou_pred.shape[0]
    lab = labels.long().clamp(0, iou_pred.shape[1] - 1)
    sel = iou_pred[torch.arange(R, device=iou_pred.device), lab]
    w = weights.to(sel.dtype)
    per = 0.5 * (sel - iou_target.to(sel.dtype)) ** 2
    return (per * w).sum() / all_reduce_sum(w.sum()).clamp(min=1.0)


__all__ = ["FCNMaskHead", "mask_targets", "mask_head_loss", "paste_masks",
           "paste_mask_values", "MaskIoUHead", "mask_iou_targets", "mask_iou_loss"]
