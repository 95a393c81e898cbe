"""Detection losses of the default training configuration.

Counterpart of `_reduce`, `cross_entropy`, `binary_cross_entropy`, `l1_loss`
and `accuracy` in `panoswintransformerobjectdetection_tpu/core/losses.py`.
Each takes elementwise weights and an `avg_factor`.
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


def accuracy(logits, labels, mask=None):
    correct = (logits.argmax(-1) == labels).float()
    if mask is not None:
        return (correct * mask).sum() / mask.sum().clamp(min=1.0)
    return correct.mean()
