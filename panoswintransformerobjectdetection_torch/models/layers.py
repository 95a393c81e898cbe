"""Shared building blocks: dtype-following Linear/Conv, LayerNorm, Mlp, the
conv stem and PatchMerging.

Counterpart of `panoswintransformerobjectdetection_tpu/models/layers.py`.
Parameters are kept in float32; `dtype` is the compute type of a layer, as
flax's `dtype=` is: input, weight and bias are cast to it and the result is
in it.  With no compute type the result follows the input and the float32
parameters (float32 here).  LayerNorm always returns float32, as flax's
does with float32 parameters.  This slice is inference only: modules run
their eval path.
"""

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.stem_conv import (BN_EPS, StemWeights, fold_bn, patch_projection, stem_conv,
                              stem_weights)


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
                    padding=layer.padding)


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


class ConvStemPatchEmbed(nn.Module):
    """3-conv patch stem: (3x3 conv, BN, ReLU) x 2, then the patch-stride conv,
    then LayerNorm.  `proj` is the reference's Sequential, so its state-dict
    keys are `proj.{0,1,3,4,6}`.

    Eval path: BatchNorm's running statistics are folded into the two 3x3
    convs, once (`kernel_weights`), and both run through kernel K1
    (`ops/stem_conv.py`) at any H, W.
    Input (B, H, W, 3) NHWC; output (B, H/ps, W/ps, embed_dim).
    """

    def __init__(self, patch_size: int = 4, embed_dim: int = 96, dtype=None):
        super().__init__()
        d3 = embed_dim // 3
        self.patch_size = patch_size
        self.proj = nn.Sequential(
            nn.Conv2d(3, d3, 3, padding=1), nn.BatchNorm2d(d3, eps=BN_EPS), nn.ReLU(),
            nn.Conv2d(d3, 2 * d3, 3, padding=1), nn.BatchNorm2d(2 * d3, eps=BN_EPS),
            nn.ReLU(),
            nn.Conv2d(2 * d3, embed_dim, patch_size, stride=patch_size))
        self.norm = LayerNorm(embed_dim)
        self.dtype = dtype
        self._kernel_key = self._kernel_weights = None

    def kernel_weights(self, dtype: torch.dtype) -> StemWeights:
        """The two 3x3 convs with BatchNorm's running statistics folded in,
        laid out for K1 at compute type `dtype`.  Made at the first eval
        call and kept until a stem parameter or statistic changes in place
        (`load_state_dict`, an optimiser step) or the module is moved."""
        pairs = [(self.proj[ci], self.proj[bi]) for ci, bi in ((0, 1), (3, 4))]
        tensors = [[conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
                    bn.running_var] for conv, bn in pairs]
        key = (dtype, *(t._version for ts in tensors for t in ts))
        if self._kernel_key != key:
            with torch.no_grad():
                folded = [t for ts, (_, bn) in zip(tensors, pairs)
                          for t in fold_bn(*ts, bn.eps)]
                self._kernel_weights = stem_weights(*folded, dtype)
            self._kernel_key = key
        return self._kernel_weights

    def _apply(self, *args, **kwargs):
        self._kernel_key = self._kernel_weights = None     # moved or cast: lay out again
        return super()._apply(*args, **kwargs)

    def forward(self, x):
        if self.training:
            raise NotImplementedError("ConvStemPatchEmbed: only the eval path is ported")
        ps = self.patch_size
        x = x.to(self.dtype or x.dtype)
        B, H, W, _ = x.shape
        x = F.pad(x, (0, 0, 0, (-W) % ps, 0, (-H) % ps))
        h1 = stem_conv(x, self.kernel_weights(x.dtype))
        x = patch_projection(h1, self.proj[6].weight, self.proj[6].bias)
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
