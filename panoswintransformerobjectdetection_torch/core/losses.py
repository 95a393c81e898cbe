"""Detection losses of the default training configuration.

Counterpart of `_reduce`, `cross_entropy`, `binary_cross_entropy`, `l1_loss`,
`giou_loss`, `iou_loss` and `accuracy` in
`panoswintransformerobjectdetection_tpu/core/losses.py`.  Each takes
elementwise weights and an `avg_factor`.  Under a process group the
training heads pass the global batch's count as `avg_factor`
(`parallel/dist.all_reduce_sum`), so that each process's loss is its share
of the global batch's loss.
"""

import torch
import torch.nn.functional as F


def _reduce(loss, weight, avg_factor):
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        return loss.mean()
    if not torch.is_tensor(avg_factor):
        avg_factor = torch.tensor(float(avg_factor), device=loss.device)
    return loss.sum() / avg_factor.clamp(min=1e-12)


def cross_entropy(logits, labels, weight=None, avg_factor=None):
    """Softmax cross entropy; labels (...,) int64, logits (..., C)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    return _reduce(nll, weight, avg_factor)


def binary_cross_entropy(logits, targets, weight=None, avg_factor=None):
    """Sigmoid cross entropy; targets float of the logits' shape."""
    loss = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return _reduce(loss, weight, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None):
    return _reduce((pred - target).abs(), weight, avg_factor)


def _clip(x, lo=None, hi=None):
    """`jnp.clip`: maximum, then minimum, whose gradient at a tie is half."""
    if lo is not None:
        x = torch.maximum(x, torch.full_like(x, lo))
    if hi is not None:
        x = torch.minimum(x, torch.full_like(x, hi))
    return x


def _overlap_and_areas(pred, target):
    """The intersection's area of matched xyxy box pairs (..., 4), and each
    box's area."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = _clip(rb - lt, 0.0)
    ap = (pred[..., 2] - pred[..., 0]) * (pred[..., 3] - pred[..., 1])
    ag = (target[..., 2] - target[..., 0]) * (target[..., 3] - target[..., 1])
    return wh[..., 0] * wh[..., 1], ap, ag


def giou_loss(pred, target, weight=None, avg_factor=None, eps=1e-7):
    """1 - GIoU over matched xyxy box pairs (..., 4)."""
    overlap, ap, ag = _overlap_and_areas(pred, target)
    union = ap + ag - overlap + eps
    iou = overlap / union
    elt = torch.minimum(pred[..., :2], target[..., :2])
    erb = torch.maximum(pred[..., 2:], target[..., 2:])
    ewh = _clip(erb - elt, 0.0)
    enclose = ewh[..., 0] * ewh[..., 1] + eps
    giou = iou - (enclose - union) / enclose
    return _reduce(1.0 - giou, weight, avg_factor)


def iou_loss(pred, target, weight=None, avg_factor=None, eps=1e-6):
    """-log(IoU) over matched xyxy box pairs (..., 4), the IoU clipped to
    [eps, 1]."""
    overlap, ap, ag = _overlap_and_areas(pred, target)
    iou = overlap / _clip(ap + ag - overlap, eps)
    return _reduce(-torch.log(_clip(iou, eps, 1.0)), weight, avg_factor)


def accuracy(logits, labels, mask=None, avg_factor=None):
    """The share of `mask`ed rows classified right: their count over
    `avg_factor` (the mask's sum when None), at least 1."""
    correct = (logits.argmax(-1) == labels).float()
    if mask is not None:
        total = mask.sum() if avg_factor is None else avg_factor
        return (correct * mask).sum() / total.clamp(min=1.0)
    return correct.mean()
