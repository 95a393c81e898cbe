"""ResNet and ResNeXt backbones, as the model zoo's Faster, Mask and Cascade
R-CNN configs use them, at test time and in training.

Counterpart of `panoswintransformerobjectdetection_tpu/models/resnet.py`
(`BasicBlock`, `Bottleneck`, `ARCH`, `ResNet`, `ResNeXt`): the 7 x 7 / 2
stem conv with BatchNorm and ReLU, the 3 x 3 / 2 max-pool padded with -inf,
then four stages of blocks whose first block carries the stage's stride
and, where the JAX rule (`need_ds`) asks for one, a 1 x 1 downsample.
`style` "pytorch" puts a bottleneck's stride on its 3 x 3, "caffe" on its
first 1 x 1; the 3 x 3 is grouped (`groups`) at JAX's width
`int(planes * base_width / 64) * groups` and dilated (`dilations`, padding
= dilation).  Module names are the reference's (torchvision's) state-dict
keys: `conv1`, `bn1`, `layer{i}.{j}.conv{1,2,3}`, `bn{1,2,3}`,
`downsample.0` (conv) and `downsample.1` (BatchNorm), so a reference
`.pth`, `num_batches_tracked` included, loads with `load_state_dict`.

The convolutions are cuDNN's, as XLA runs the JAX package's: no Pallas
kernel is on this path.  Parameters stay float32; `dtype` is the compute
type of the convolutions, as in the port's other backbones (the JAX
`ResNet` takes no `dtype`, so JAX cannot build the bf16 configs).  Inputs
and outputs are NHWC; the convolutions run on channels-last NCHW views.

BatchNorm: with the backbone in train mode and `norm_eval` False, every
BatchNorm normalises with the batch's statistics and moves its running
ones (`layers.batch_norm_train`, flax's numerics: JAX's `bn_train = train
and not norm_eval`); otherwise with its running statistics, which then do
not move.  Either way in float32, the result in the compute type, and the
affine parameters get gradients.  `nn.BatchNorm2d`'s own forward is never
called.  `frozen_stages` >= 0 detaches the stem's output, >= i + 1 stage
i's (JAX's `stop_gradient`): the frozen parameters get no gradient, but
they stay parameters that the optimizer decays, and their BatchNorms
follow `norm_eval` as the others do, as in JAX (the reference instead
sets `requires_grad=False` and keeps them in eval mode).  The DCN, GCB
and GeneralizedAttention options and DetectoRS's `rfp_feats` raise
(`UNPORTED_OPS`).
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import batch_norm_train, conv

UNPORTED_OPS = ("is not ported yet (ROADMAP.md, Queue 1, item 17d: the ops deform_conv and "
                "gen_attention)")


def batch_norm(bn: nn.modules.batchnorm._BatchNorm, x: torch.Tensor,
               dtype: Optional[torch.dtype], live: bool = False) -> torch.Tensor:
    """flax's BatchNorm with float32 parameters, computed in float32 (in
    float64 for a float64 `x`, which the CPU tests use), the result in
    `dtype` (float32 when None): with `live`, the batch's statistics, the
    running ones moved (`layers.batch_norm_train`); else the running
    statistics."""
    if live:
        return batch_norm_train(bn, x).to(dtype or torch.float32)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    y = F.batch_norm(xf, *(t.to(xf.dtype) for t in (bn.running_mean, bn.running_var)),
                     *(t.to(xf.dtype) for t in (bn.weight, bn.bias)), eps=bn.eps)
    return y.to(dtype or torch.float32)


def max_pool_stem(x: torch.Tensor) -> torch.Tensor:
    """The stem's 3 x 3 / 2 max-pool of NCHW `x`, its border padded with
    -inf (the JAX stem pads with -inf, then pools without padding)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def downsample(cin: int, cout: int, stride: int) -> nn.Sequential:
    """The 1 x 1 strided conv and BatchNorm of a block's identity path."""
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), nn.BatchNorm2d(cout))


class ResidualBlock(nn.Module):
    """The residual sum: relu(branch + identity), the identity through
    `downsample` (its last two modules: the conv, the BatchNorm) where there
    is one.  `live`: BatchNorm with the batch's statistics."""

    def conv_bn(self, conv_layer, bn, x, live):
        return batch_norm(bn, conv(conv_layer, x, self.dtype), self.dtype, live)

    def identity(self, x, live):
        if self.downsample is None:
            return x.to(self.dtype or torch.float32)
        return self.conv_bn(self.downsample[-2], self.downsample[-1], x, live)

    def forward(self, x, live: bool = False):
        return torch.relu(self.branch(x, live) + self.identity(x, live))


class BasicBlock(ResidualBlock):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 with_downsample: bool = False, dtype=None, **_):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, padding=dilation, dilation=dilation,
                               bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(planes)
        self.downsample = downsample(inplanes, planes, stride) if with_downsample else None
        self.dtype = dtype

    def branch(self, x, live):
        y = torch.relu(self.conv_bn(self.conv1, self.bn1, x, live))
        return self.conv_bn(self.conv2, self.bn2, y, live)


class Bottleneck(ResidualBlock):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 with_downsample: bool = False, groups: int = 1, base_width: int = 64,
                 style: str = "pytorch", dtype=None):
        super().__init__()
        if style not in ("pytorch", "caffe"):
            raise ValueError(f"style must be 'pytorch' or 'caffe', got {style!r}")
        width = int(planes * (base_width / 64.0)) * groups
        s1, s2 = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = nn.Conv2d(inplanes, width, 1, s1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, s2, padding=dilation, dilation=dilation,
                               groups=groups, bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = (downsample(inplanes, planes * self.expansion, stride)
                           if with_downsample else None)
        self.dtype = dtype

    def branch(self, x, live):
        y = torch.relu(self.conv_bn(self.conv1, self.bn1, x, live))
        y = torch.relu(self.conv_bn(self.conv2, self.bn2, y, live))
        return self.conv_bn(self.conv3, self.bn3, y, live)


ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


def check_plugins(**options) -> None:
    """Raise for a DCN, GCB or GeneralizedAttention option that some stage
    would run (`name=(config, stage_with)` pairs)."""
    for name, (cfg, stages) in options.items():
        if cfg and any(stages):
            raise NotImplementedError(f"backbone option {name}={cfg!r} {UNPORTED_OPS}")


class CNNBackbone(nn.Module):
    """What the CNN backbones share: the detector's two hooks, the stem
    (`patch_embed`, the name of the Swin backbones' stem: `stem_layers`,
    then `pool`) and the stages after it (`forward_from_embed`, over
    `self.stages`), BatchNorm live in train mode unless `norm_eval`, and
    `frozen_stages` (-1 where a backbone takes none)."""

    frozen_stages = -1

    def live_bn(self) -> bool:
        """Whether the BatchNorms use the batch's statistics (JAX's
        `bn_train = train and not self.norm_eval`)."""
        return self.training and not self.norm_eval

    def set_drop_path_generator(self, generator) -> None:
        """The training loop's hook for the Swin backbones' DropPath; a CNN
        backbone draws nothing."""

    def forward(self, images):
        return self.forward_from_embed(self.patch_embed(images))

    def stem_layers(self):
        """The stem's (conv, BatchNorm) pairs, each followed by a ReLU."""
        return ((self.conv1, self.bn1),)

    def patch_embed(self, images):
        """images (B, H, W, 3) -> the stem's output, NHWC."""
        live = self.live_bn()
        x = images.permute(0, 3, 1, 2)
        for conv_layer, bn in self.stem_layers():
            x = torch.relu(batch_norm(bn, conv(conv_layer, x, self.dtype), self.dtype, live))
        x = self.pool(x).permute(0, 2, 3, 1)
        return x.detach() if self.frozen_stages >= 0 else x

    def forward_from_embed(self, x):
        """The stages after the stem -> NHWC maps in the compute type, one
        for each of `out_indices`."""
        live = self.live_bn()
        x = x.permute(0, 3, 1, 2)
        outs = []
        for i, stage in enumerate(self.stages):
            for block in stage:
                x = block(x, live)
            if self.frozen_stages >= i + 1:
                x = x.detach()
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)

    @staticmethod
    def pool(x):
        return x


class ResNet(CNNBackbone):
    """ResNet-18/34/50/101/152 (ResNeXt with `groups` > 1): stage i gives
    `64 * 2**i * expansion` channels at stride `4 * prod(strides[:i + 1])`."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1), groups: int = 1, base_width: int = 64,
                 style: str = "pytorch", norm_eval: bool = True, dcn: Optional[dict] = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4, gcb: Optional[dict] = None,
                 stage_with_gcb: Sequence[bool] = (False,) * 4,
                 gen_attention: Optional[dict] = None,
                 stage_with_gen_attention: Sequence[bool] = (False,) * 4, dtype=None):
        super().__init__()
        if depth not in ARCH:
            raise ValueError(f"ResNet depth must be one of {sorted(ARCH)}, got {depth}")
        check_plugins(dcn=(dcn, stage_with_dcn), gcb=(gcb, stage_with_gcb),
                      gen_attention=(gen_attention, stage_with_gen_attention))
        block, depths = ARCH[depth]
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes, layers = 64, []
        for i, d in enumerate(depths):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(d):
                stride = strides[i] if j == 0 else 1
                need_ds = j == 0 and (stride != 1 or i > 0 or block is Bottleneck)
                blocks.append(block(inplanes, planes, stride, dilations[i], need_ds,
                                    groups=groups, base_width=base_width, style=style,
                                    dtype=dtype))
                inplanes = planes * block.expansion
            layers.append(nn.Sequential(*blocks))
            self.add_module(f"layer{i + 1}", layers[-1])
        self.stages = layers
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.dtype = dtype

    pool = staticmethod(max_pool_stem)

    def forward(self, images, rfp_feats=None):
        if rfp_feats is not None:
            raise NotImplementedError(f"DetectoRS's rfp_feats {UNPORTED_OPS}")
        return super().forward(images)


class ResNeXt(ResNet):
    """ResNet with 32 groups of base width 4 unless told otherwise."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)


__all__ = ["batch_norm", "max_pool_stem", "ResidualBlock", "BasicBlock", "Bottleneck", "ARCH",
           "CNNBackbone", "ResNet", "ResNeXt", "UNPORTED_OPS"]
