"""The RegNetX, Res2Net and ResNeSt backbones, as the model zoo's
`configs/regnet`, `configs/res2net` and `configs/resnest` two-stage
detectors use them, at test time and in training.

Counterparts of `panoswintransformerobjectdetection_tpu/models/
backbones_extra.py`:

- `REGNET_ARCH`, `RegBlock`, `RegNet`: a 3 x 3 / 2 stem of 32 channels with
  BatchNorm and ReLU (no max-pool), then four stages of bottleneck blocks
  of ratio 1 (1 x 1, grouped 3 x 3, 1 x 1), the first block of each with
  stride 2 and a 1 x 1 downsample.  The 3 x 3 has `width // groups` groups
  where `groups` (the presets' group width) divides the stage's width, else
  1, exactly as JAX computes it.
- `Res2Block`, `Res2Net` (depth 50 or 101): the ResNet stem, then
  bottlenecks whose 3 x 3 is `scales - 1` convs of `width / scales`
  channels over the splits of the 1 x 1's output.  Split 0 passes through,
  or through a 3 x 3 / s average pool (padding 1, the border's zeros
  counted, as flax's `avg_pool` counts them) in a strided block; split i
  goes through conv i - 1, after the previous conv's output is added to it
  in a block of stride 1 only.  Stage i > 0 strides in its first block;
  every first block has a downsample.
- `SplitAttentionConv`, `ResNeStBlock`, `ResNeSt` (depth 50 or 101): a deep
  stem of three 3 x 3 convs (32, 32, 64 channels, the first of stride 2)
  with BatchNorm and ReLU and the -inf padded max-pool; each bottleneck's
  3 x 3 is a split-attention conv: one ungrouped conv to `planes * radix`
  channels, BatchNorm and ReLU, the radix groups summed and pooled over
  the map, `fc1` (with bias) to max(planes * radix / 4, 32), a BatchNorm
  over (B, inter) and ReLU, `fc2` to `planes * radix`, a softmax over the
  radix groups weighting them; a strided block average-pools 3 x 3 / s
  after it (ResNeSt-D) and its identity 2 x 2 / 2 before the 1 x 1
  downsample.

Module names are the reference's where the structure matches:
`conv1`, `bn1`, `layer{i}.{j}.conv{1,2,3}`, `bn{1,2,3}`, `downsample.*`;
Res2Net's `convs.{i}` and `bns.{i}`; ResNeSt's `stem.{0,1,3,4,6,7}`,
`conv2.conv`, `conv2.bn0`, `conv2.fc1`, `conv2.bn1`, `conv2.fc2`, and
`downsample.1` and `.2` after the (parameter-free) average pool.  The JAX
package's Res2Net and ResNeSt are simpler than the reference's (no deep
stem or average-pool downsample in Res2Net, its pass-through split the
first, not the last; no radix groups in ResNeSt's conv, its `fc1` and
`fc2` dense layers, not 1 x 1 convs), and the port computes what JAX
computes: a reference Res2Net or ResNeSt `.pth` loads into neither (a
known divergence, ROADMAP.md).  Compute types, BatchNorm (live in train
mode unless `norm_eval`) and layout as `models/resnet.py`; none of these
backbones takes `frozen_stages`, as in JAX.

- `TridentBlock`, `TridentResNet` (depth 50 or 101): a ResNet whose res4
  is tridented, as the JAX package's is: its first block is a plain
  stride-2 `Bottleneck` with a downsample, whose output feeds three
  branches; every later res4 block shares `conv1`, `conv3` and one 3 x 3
  kernel (`conv2.weight`) across the branches, which run it at dilations
  1, 2 and 3 (padding = dilation), each with BatchNorms of its own
  (`bn{1,2,3}.{b}`), no downsample.  Only the middle branch goes on to
  res5, in training too.  The other two change nothing but their
  BatchNorms' running statistics, and only where BatchNorm is live: there
  they are computed, without gradient (JAX's gradient of them is zero);
  otherwise the middle branch runs alone.  `num_trident_blocks` is taken
  and not read, as in JAX: every res4 block after the first is a trident
  block.  The reference's `TridentResNet` makes res4's first block a
  trident block too and shares one norm a layer across the branches, so
  its res4 norms' keys lack the branch index (a known divergence,
  ROADMAP.md); the first block's keys, and every other stage's, are the
  reference's.
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import conv, dense
from .resnet import (Bottleneck, CNNBackbone, ResidualBlock, batch_norm, check_plugins,
                     downsample, max_pool_stem)

REGNET_ARCH: Dict[str, dict] = {
    # widths / depths per stage and the group width of the RegNetX presets
    "regnetx_400mf": {"widths": (32, 64, 160, 384), "depths": (1, 2, 7, 12), "groups": 16},
    "regnetx_800mf": {"widths": (64, 128, 288, 672), "depths": (1, 3, 7, 5), "groups": 16},
    "regnetx_1.6gf": {"widths": (72, 168, 408, 912), "depths": (2, 4, 10, 2), "groups": 24},
    "regnetx_3.2gf": {"widths": (96, 192, 432, 1008), "depths": (2, 6, 15, 2), "groups": 48},
    "regnetx_4.0gf": {"widths": (80, 240, 560, 1360), "depths": (2, 5, 14, 2), "groups": 40},
    "regnetx_6.4gf": {"widths": (168, 392, 784, 1624), "depths": (2, 4, 10, 1), "groups": 56},
    "regnetx_8.0gf": {"widths": (80, 240, 720, 1920), "depths": (2, 5, 15, 1), "groups": 120},
    "regnetx_12gf": {"widths": (224, 448, 896, 2240), "depths": (2, 5, 11, 1), "groups": 112},
}


def conv_groups(width: int, group_width: int) -> int:
    """The 3 x 3's number of groups: `width // group_width` where that
    divides, else 1 (JAX's `feature_group_count`)."""
    return width // group_width if width % group_width == 0 else 1


class RegBlock(ResidualBlock):
    def __init__(self, inplanes: int, width: int, stride: int = 1, group_width: int = 16,
                 with_downsample: bool = False, dtype=None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride, padding=1,
                               groups=conv_groups(width, group_width), bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, width, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(width)
        self.downsample = downsample(inplanes, width, stride) if with_downsample else None
        self.dtype = dtype

    def branch(self, x, live):
        y = torch.relu(self.conv_bn(self.conv1, self.bn1, x, live))
        y = torch.relu(self.conv_bn(self.conv2, self.bn2, y, live))
        return self.conv_bn(self.conv3, self.bn3, y, live)


class RegNet(CNNBackbone):
    """RegNetX of `arch` (a `REGNET_ARCH` key): stage i gives `widths[i]`
    channels at stride 2**(i + 2)."""

    def __init__(self, arch: str = "regnetx_3.2gf", out_indices: Sequence[int] = (0, 1, 2, 3),
                 norm_eval: bool = True, dcn: Optional[dict] = None,
                 stage_with_dcn: Sequence[bool] = (False,) * 4, dtype=None):
        super().__init__()
        if arch not in REGNET_ARCH:
            raise ValueError(f"RegNet arch must be one of {sorted(REGNET_ARCH)}, got {arch!r}")
        check_plugins(dcn=(dcn, stage_with_dcn))
        cfg = REGNET_ARCH[arch]
        self.conv1 = nn.Conv2d(3, 32, 3, 2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(32)
        inplanes, layers = 32, []
        for i, (w, d) in enumerate(zip(cfg["widths"], cfg["depths"])):
            blocks = [RegBlock(inplanes if j == 0 else w, w, 2 if j == 0 else 1, cfg["groups"],
                               j == 0, dtype) for j in range(d)]
            inplanes = w
            layers.append(nn.Sequential(*blocks))
            self.add_module(f"layer{i + 1}", layers[-1])
        self.stages = layers
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.dtype = dtype


RES2NET_DEPTHS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


def avg_pool_3x3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """flax's `avg_pool(x, (3, 3), (s, s), padding=((1, 1), (1, 1)))` on NCHW
    `x`: the padded zeros count in the mean."""
    return F.avg_pool2d(x, 3, stride, padding=1, count_include_pad=True)


class Res2Block(ResidualBlock):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, scales: int = 4,
                 base_width: int = 26, with_downsample: bool = False, dtype=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * scales
        self.split = width // scales
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.convs = nn.ModuleList(nn.Conv2d(self.split, self.split, 3, stride, padding=1,
                                             bias=False) for _ in range(scales - 1))
        self.bns = nn.ModuleList(nn.BatchNorm2d(self.split) for _ in range(scales - 1))
        self.conv3 = nn.Conv2d(width, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = (downsample(inplanes, planes * self.expansion, stride)
                           if with_downsample else None)
        self.dtype = dtype

    def branch(self, x, live):
        y = torch.relu(self.conv_bn(self.conv1, self.bn1, x, live))
        splits = torch.split(y, self.split, dim=1)
        outs = [splits[0] if self.stride == 1 else avg_pool_3x3(splits[0], self.stride)]
        prev = None
        for s, conv_layer, bn in zip(splits[1:], self.convs, self.bns):
            if prev is not None and self.stride == 1:
                s = s + prev
            prev = torch.relu(self.conv_bn(conv_layer, bn, s, live))
            outs.append(prev)
        return self.conv_bn(self.conv3, self.bn3, torch.cat(outs, dim=1), live)


class Res2Net(CNNBackbone):
    """Res2Net-50/101 of `scales` splits of base width `base_width`: stage i
    gives `256 * 2**i` channels at stride `4 * 2**i`."""

    def __init__(self, depth: int = 50, scales: int = 4, base_width: int = 26,
                 out_indices: Sequence[int] = (0, 1, 2, 3), norm_eval: bool = True,
                 dcn: Optional[dict] = None, stage_with_dcn: Sequence[bool] = (False,) * 4,
                 dtype=None):
        super().__init__()
        if depth not in RES2NET_DEPTHS:
            raise ValueError(f"Res2Net depth must be one of {sorted(RES2NET_DEPTHS)}, "
                             f"got {depth}")
        check_plugins(dcn=(dcn, stage_with_dcn))
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes, layers = 64, []
        for i, d in enumerate(RES2NET_DEPTHS[depth]):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(d):
                blocks.append(Res2Block(inplanes, planes, 2 if j == 0 and i > 0 else 1, scales,
                                        base_width, j == 0, dtype))
                inplanes = planes * Res2Block.expansion
            layers.append(nn.Sequential(*blocks))
            self.add_module(f"layer{i + 1}", layers[-1])
        self.stages = layers
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.dtype = dtype

    pool = staticmethod(max_pool_stem)


class SplitAttentionConv(nn.Module):
    """ResNeSt's split-attention 3 x 3 (JAX `SplitAttentionConv`): `radix`
    groups of `channels` reweighted by a softmax over the groups, computed
    from their pooled sum.  `live`: BatchNorm with the batch's statistics
    (`bn1`'s over the B pooled vectors)."""

    def __init__(self, channels: int, radix: int = 2, reduction: int = 4, dtype=None):
        super().__init__()
        inter = max(channels * radix // reduction, 32)
        self.channels, self.radix = channels, radix
        self.conv = nn.Conv2d(channels, channels * radix, 3, padding=1, bias=False)
        self.bn0 = nn.BatchNorm2d(channels * radix)
        self.fc1 = nn.Linear(channels, inter)
        self.bn1 = nn.BatchNorm1d(inter)
        self.fc2 = nn.Linear(inter, channels * radix)
        self.dtype = dtype

    def forward(self, x, live: bool = False):
        y = torch.relu(batch_norm(self.bn0, conv(self.conv, x, self.dtype), self.dtype, live))
        B, _, H, W = y.shape
        y = y.view(B, self.radix, self.channels, H, W)
        f32 = torch.promote_types(y.dtype, torch.float32)
        gap = y.to(f32).sum(1).mean(dim=(2, 3))                       # (B, channels)
        a = torch.relu(batch_norm(self.bn1, dense(self.fc1, gap, self.dtype), self.dtype, live))
        a = dense(self.fc2, a, self.dtype).view(B, self.radix, self.channels)
        a = torch.softmax(a.to(f32), dim=1).to(y.dtype)
        return (y * a[:, :, :, None, None]).sum(1)


class ResNeStBlock(ResidualBlock):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, radix: int = 2,
                 with_downsample: bool = False, dtype=None):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(planes)
        self.conv2 = SplitAttentionConv(planes, radix, dtype=dtype)
        self.conv3 = nn.Conv2d(planes, planes * self.expansion, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(planes * self.expansion)
        self.downsample = None
        if with_downsample:
            self.downsample = nn.Sequential(
                nn.AvgPool2d(stride, stride) if stride > 1 else nn.Identity(),
                *downsample(inplanes, planes * self.expansion, 1))
        self.dtype = dtype

    def branch(self, x, live):
        y = torch.relu(self.conv_bn(self.conv1, self.bn1, x, live))
        y = self.conv2(y, live)
        if self.stride > 1:
            y = avg_pool_3x3(y, self.stride)
        return self.conv_bn(self.conv3, self.bn3, y, live)

    def identity(self, x, live):
        if self.downsample is not None:
            x = self.downsample[0](x)
        return super().identity(x, live)


class ResNeSt(CNNBackbone):
    """ResNeSt-50/101 of `radix` groups: stage i gives `256 * 2**i` channels
    at stride `4 * 2**i`."""

    def __init__(self, depth: int = 50, radix: int = 2, out_indices: Sequence[int] = (0, 1, 2, 3),
                 norm_eval: bool = True, dtype=None):
        super().__init__()
        if depth not in RES2NET_DEPTHS:
            raise ValueError(f"ResNeSt depth must be one of {sorted(RES2NET_DEPTHS)}, "
                             f"got {depth}")
        self.stem = nn.Sequential(
            nn.Conv2d(3, 32, 3, 2, padding=1, bias=False), nn.BatchNorm2d(32), nn.ReLU(),
            nn.Conv2d(32, 32, 3, padding=1, bias=False), nn.BatchNorm2d(32), nn.ReLU(),
            nn.Conv2d(32, 64, 3, padding=1, bias=False), nn.BatchNorm2d(64), nn.ReLU())
        inplanes, layers = 64, []
        for i, d in enumerate(RES2NET_DEPTHS[depth]):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(d):
                blocks.append(ResNeStBlock(inplanes, planes, 2 if j == 0 and i > 0 else 1, radix,
                                           j == 0, dtype))
                inplanes = planes * ResNeStBlock.expansion
            layers.append(nn.Sequential(*blocks))
            self.add_module(f"layer{i + 1}", layers[-1])
        self.stages = layers
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.dtype = dtype

    def stem_layers(self):
        return tuple((self.stem[k], self.stem[k + 1]) for k in (0, 3, 6))

    pool = staticmethod(max_pool_stem)


TRIDENT_DILATIONS = (1, 2, 3)
# the branch that goes on to res5, and the others
TRIDENT_TEST_BRANCH = 1
OUTER_BRANCHES = tuple(b for b in range(len(TRIDENT_DILATIONS)) if b != TRIDENT_TEST_BRANCH)


class TridentBlock(nn.Module):
    """A trident bottleneck of `planes` (4 * planes channels in and out):
    `branch(x, b, live)` runs branch b, of dilation `TRIDENT_DILATIONS[b]`."""

    expansion = 4

    def __init__(self, planes: int, dtype=None):
        super().__init__()
        inplanes = planes * self.expansion
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.conv3 = nn.Conv2d(planes, inplanes, 1, bias=False)
        for n, c in ((1, planes), (2, planes), (3, inplanes)):
            self.add_module(f"bn{n}", nn.ModuleList(nn.BatchNorm2d(c) for _ in TRIDENT_DILATIONS))
        self.dtype = dtype

    def branch(self, x, b: int, live: bool = False):
        dt, d = self.dtype, TRIDENT_DILATIONS[b]
        y = torch.relu(batch_norm(self.bn1[b], conv(self.conv1, x, dt), dt, live))
        ct = dt or torch.promote_types(y.dtype, self.conv2.weight.dtype)
        y = F.conv2d(y.to(ct), self.conv2.weight.to(ct), padding=d, dilation=d)
        y = torch.relu(batch_norm(self.bn2[b], y, dt, live))
        y = batch_norm(self.bn3[b], conv(self.conv3, y, dt), dt, live)
        return torch.relu(y + x.to(dt or torch.float32))


class TridentResNet(CNNBackbone):
    """ResNet-50/101 with a tridented res4: stage i gives `256 * 2**i`
    channels at stride `4 * 2**i`."""

    def __init__(self, depth: int = 50, num_trident_blocks: int = 3,
                 out_indices: Sequence[int] = (0, 1, 2, 3), norm_eval: bool = True, dtype=None):
        super().__init__()
        if depth not in RES2NET_DEPTHS:
            raise ValueError(f"TridentResNet depth must be one of {sorted(RES2NET_DEPTHS)}, "
                             f"got {depth}")
        self.conv1 = nn.Conv2d(3, 64, 7, 2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        inplanes, layers = 64, []
        for i, d in enumerate(RES2NET_DEPTHS[depth]):
            planes = 64 * 2 ** i
            blocks = [Bottleneck(inplanes, planes, 2 if i > 0 else 1, with_downsample=True,
                                 dtype=dtype)]
            blocks += [TridentBlock(planes, dtype=dtype) if i == 2 else
                       Bottleneck(planes * 4, planes, dtype=dtype) for _ in range(d - 1)]
            inplanes = planes * 4
            layers.append(nn.Sequential(*blocks))
            self.add_module(f"layer{i + 1}", layers[-1])
        self.stages = layers
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.dtype = dtype

    pool = staticmethod(max_pool_stem)

    def forward_from_embed(self, x):
        live = self.live_bn()
        x = x.permute(0, 3, 1, 2)
        outs = []
        for i, stage in enumerate(self.stages):
            x = stage[0](x, live)
            if i == 2:
                side = [x, x] if live else []
                for block in stage[1:]:
                    with torch.no_grad():
                        side = [block.branch(y, b, live) for y, b in zip(side, OUTER_BRANCHES)]
                    x = block.branch(x, TRIDENT_TEST_BRANCH, live)
            else:
                for block in stage[1:]:
                    x = block(x, live)
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


__all__ = ["REGNET_ARCH", "conv_groups", "RegBlock", "RegNet", "RES2NET_DEPTHS", "Res2Block",
           "Res2Net", "SplitAttentionConv", "ResNeStBlock", "ResNeSt", "TRIDENT_DILATIONS",
           "TRIDENT_TEST_BRANCH", "OUTER_BRANCHES", "TridentBlock", "TridentResNet"]
