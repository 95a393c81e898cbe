"""Shared building blocks: dtype-following Linear/Conv, LayerNorm, Mlp,
DropPath, the conv stem, Swin's single-conv patch embed and PatchMerging.

Counterpart of `panoswintransformerobjectdetection_tpu/models/layers.py`.
Parameters are kept in float32; `dtype` is the compute type of a layer, as
flax's `dtype=` is: input, weight and bias are cast to it and the result is
in it.  With no compute type the result follows the input and the float32
parameters (float32 here).  LayerNorm always returns float32, as flax's
does with float32 parameters.  In train mode the stem runs its two 3x3
convs with live BatchNorm and DropPath drops residual branches; in eval
mode a 3-channel stem goes through kernel K1 and DropPath is the identity.
"""

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stem_conv import (BN_EPS, StemWeights, fold_bn, patch_projection, stem_conv,
                              stem_weights)
from ..parallel.dist import all_reduce_sum, shard_rows, world


def dense(layer: nn.Linear, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)` semantics for a torch Linear."""
    dt = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x.to(dt), layer.weight.to(dt), bias)


def conv(layer: nn.Conv2d, x: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax `nn.Conv(dtype=dtype)` semantics for a torch Conv2d on NCHW `x`."""
    dt = dtype or torch.promote_types(x.dtype, layer.weight.dtype)
    bias = None if layer.bias is None else layer.bias.to(dt)
    return F.conv2d(x.to(dt), layer.weight.to(dt), bias, stride=layer.stride,
                    padding=layer.padding, dilation=layer.dilation, groups=layer.groups)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with torch defaults (eps 1e-5), computed and returned in f32."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class Mlp(nn.Module):
    """fc1 -> exact (erf) GELU -> fc2."""

    def __init__(self, dim: int, hidden_dim: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)
        self.dtype = dtype

    def forward(self, x):
        x = F.gelu(dense(self.fc1, x, self.dtype), approximate="none")
        return dense(self.fc2, x, self.dtype)


class DropPath(nn.Module):
    """Per-sample stochastic depth: in train mode a sample's branch is kept
    with probability 1 - rate and scaled by 1 / (1 - rate); the identity in
    eval mode or at rate 0.  The keep mask is drawn from `generator` (the
    default generator of the input's device when None) on the generator's
    own device, unless the caller hands one in (`keep_mask`, drawn ahead of
    an activation-checkpointed block so that its recompute sees the same
    mask)."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def keep_mask(self, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The (B, 1, ...) bool mask that `forward` would draw for `x`;
        None where `forward` is the identity."""
        if self.rate == 0.0 or not self.training:
            return None
        shape = (world() * x.shape[0],) + (1,) * (x.dim() - 1)
        where = self.generator.device if self.generator is not None else x.device
        keep = torch.rand(shape, generator=self.generator, device=where) < 1.0 - self.rate
        return shard_rows(keep, x.shape[0]).to(x.device)

    def forward(self, x, keep_mask: Optional[torch.Tensor] = None):
        if self.rate == 0.0 or not self.training:
            return x
        if keep_mask is None:
            keep_mask = self.keep_mask(x)
        keep = 1.0 - self.rate
        return torch.where(keep_mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def batch_norm_train(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """Train-mode BatchNorm on `x` of channels in dim 1 (NCHW, or (B, C))
    with flax's numerics: statistics in float32 (float64 for a float64 `x`)
    over every other dim, the variance as mean(x^2) - mean(x)^2, the result
    in that type, and the running statistics moved by `bn.momentum` towards
    the batch's mean and its *biased* variance (`torch.nn.BatchNorm2d`
    would store the unbiased one).  The running statistics are updated in
    place.

    Under a process group of W > 1 processes, each holding its rows of the
    global batch, the statistics are the global batch's, as flax's mean over
    a sharded batch is: the per-channel sum(x), sum(x * x) and the count are
    summed over the processes (`parallel/dist.all_reduce_sum`, in the
    statistics' type) before the mean and the variance are taken, and every
    process moves its running statistics alike.  The sum's backward sums
    the gradients of those sums over the processes, so each input's
    gradient reaches through every process's loss.  With no process group,
    or a group of one, the statistics are the local means."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = (0,) + tuple(range(2, x.dim()))
    if world() > 1:
        C = xf.shape[1]
        sums = all_reduce_sum(torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims),
                                         xf.new_full((1,), xf.numel() // C)]))
        mean = sums[:C] / sums[2 * C]
        var = (sums[C:2 * C] / sums[2 * C] - mean * mean).clamp(min=0.0)
    else:
        mean = xf.mean(dim=dims)
        var = ((xf * xf).mean(dim=dims) - mean * mean).clamp(min=0.0)
    with torch.no_grad():
        bn.running_mean.mul_(1.0 - bn.momentum).add_(mean, alpha=bn.momentum)
        bn.running_var.mul_(1.0 - bn.momentum).add_(var, alpha=bn.momentum)
        bn.num_batches_tracked.add_(1)
    shape = (-1,) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + bn.eps) * bn.weight
    return (xf - mean.view(shape)) * scale.view(shape) + bn.bias.view(shape)


class ConvStemPatchEmbed(nn.Module):
    """3-conv patch stem: (3x3 conv, BN, ReLU) x 2, then the patch-stride conv,
    then LayerNorm (`use_norm`).  `proj` is the reference's Sequential, so its
    state-dict keys are `proj.{0,1,3,4,6}`.  The two 3x3 convs have
    `stem_channels` outputs: (embed_dim // 3, 2 * (embed_dim // 3)) by
    default (the simple PanoSwin's), (32, 64) in the v-variant's stem.

    Eval path with 3 input channels: BatchNorm's running statistics are
    folded into the two 3x3 convs, once (`kernel_weights`), and both run
    through kernel K1 (`ops/stem_conv.py`) at any H, W.  Any other channel
    count takes the three convs with eval BatchNorm, as the JAX module does
    (its fused stem takes 3 channels only).  Train path: the three convs in
    the compute type with live BatchNorm (`batch_norm_train`), as the JAX
    module does with `train=True`; K1 is not on it and needs no backward.
    `fuse_bn=True`: the checkpoint's convs have BatchNorm folded in already,
    so the BatchNorm modules (kept for the state dict's keys) are not
    applied in either mode.
    Input (B, H, W, in_chans) NHWC; output (B, H/ps, W/ps, embed_dim).
    """

    def __init__(self, patch_size: int = 4, embed_dim: int = 96, dtype=None,
                 use_norm: bool = True, in_chans: int = 3, fuse_bn: bool = False,
                 stem_channels: Optional[Tuple[int, int]] = None):
        super().__init__()
        c0, c1 = stem_channels or (embed_dim // 3, 2 * (embed_dim // 3))
        self.patch_size = patch_size
        self.proj = nn.Sequential(
            nn.Conv2d(in_chans, c0, 3, padding=1), nn.BatchNorm2d(c0, eps=BN_EPS), nn.ReLU(),
            nn.Conv2d(c0, c1, 3, padding=1), nn.BatchNorm2d(c1, eps=BN_EPS), nn.ReLU(),
            nn.Conv2d(c1, embed_dim, patch_size, stride=patch_size))
        self.norm = LayerNorm(embed_dim) if use_norm else None
        self.dtype = dtype
        self.fuse_bn = fuse_bn
        self._kernel_key = self._kernel_weights = None

    def kernel_weights(self, dtype: torch.dtype) -> StemWeights:
        """The two 3x3 convs with BatchNorm's running statistics folded in
        (unless `fuse_bn`), laid out for K1 at compute type `dtype`.  Made at
        the first eval call and kept until a stem parameter or statistic
        changes in place (`load_state_dict`, an optimiser step) or the module
        is moved."""
        pairs = [(self.proj[ci], self.proj[bi]) for ci, bi in ((0, 1), (3, 4))]
        tensors = [[conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
                    bn.running_var] for conv, bn in pairs]
        key = (dtype, *(t._version for ts in tensors for t in ts))
        if self._kernel_key != key:
            with torch.no_grad():
                if self.fuse_bn:
                    folded = [t for ts in tensors for t in ts[:2]]
                else:
                    folded = [t for ts, (_, bn) in zip(tensors, pairs)
                              for t in fold_bn(*ts, bn.eps)]
                self._kernel_weights = stem_weights(*folded, dtype)
            self._kernel_key = key
        return self._kernel_weights

    def _apply(self, *args, **kwargs):
        self._kernel_key = self._kernel_weights = None     # moved or cast: lay out again
        return super()._apply(*args, **kwargs)

    def _batch_norm(self, bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
        if self.fuse_bn:
            return x
        if self.training:
            return batch_norm_train(bn, x)
        return F.batch_norm(x.float(), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                            eps=bn.eps)

    def forward(self, x):
        ps = self.patch_size
        x = x.to(self.dtype or x.dtype)
        B, H, W, _ = x.shape
        x = F.pad(x, (0, 0, 0, (-W) % ps, 0, (-H) % ps))
        if self.training or x.shape[-1] != 3:
            x = x.permute(0, 3, 1, 2)
            x = torch.relu(self._batch_norm(self.proj[1], conv(self.proj[0], x, self.dtype)))
            x = torch.relu(self._batch_norm(self.proj[4], conv(self.proj[3], x, self.dtype)))
            x = conv(self.proj[6], x, self.dtype).permute(0, 2, 3, 1)
        else:
            h1 = stem_conv(x, self.kernel_weights(x.dtype))
            x = patch_projection(h1, self.proj[6].weight, self.proj[6].bias)
        if self.norm is not None:
            x = self.norm(x)
        return x.to(self.dtype or x.dtype)


class SingleConvPatchEmbed(nn.Module):
    """Stock Swin patch embed: one patch-stride conv (`proj`), then LayerNorm
    (`norm`, with `use_norm`), the input zero-padded on the right and the
    bottom to a multiple of the patch.  Input (B, H, W, in_chans) NHWC;
    output (B, ceil(H/ps), ceil(W/ps), embed_dim), in the compute type."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96, in_chans: int = 3,
                 use_norm: bool = True, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size, stride=patch_size)
        self.norm = LayerNorm(embed_dim) if use_norm else None
        self.dtype = dtype

    def forward(self, x):
        ps = self.patch_size
        x = x.to(self.dtype or x.dtype)
        H, W = x.shape[1], x.shape[2]
        x = F.pad(x, (0, 0, 0, (-W) % ps, 0, (-H) % ps))
        x = conv(self.proj, x.permute(0, 3, 1, 2), self.dtype).permute(0, 2, 3, 1)
        if self.norm is not None:
            x = self.norm(x)
        return x.to(self.dtype or x.dtype)


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat -> LayerNorm -> Linear(4C, 2C), no bias.
    (B, H, W, C) -> (B, ceil(H/2), ceil(W/2), 2C); odd sides zero-padded."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.dtype = dtype

    def forward(self, x):
        B, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                       x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return dense(self.reduction, self.norm(x), self.dtype)
