"""HRNet backbone and HRFPN neck, as the model zoo's `configs/hrnet` Faster,
Mask and Cascade (Mask) R-CNN detectors use them, at test time and in
training.

Counterpart of `panoswintransformerobjectdetection_tpu/models/hrnet.py`
(`HRNET_CFG`, `STAGE_MODULES`, `FuseLayer`, `HRModule`, `HRNet`, `HRFPN`):

- the stem is two 3 x 3 / 2 convs of 64 channels, each with BatchNorm and
  ReLU, then `layer1`, four bottlenecks of 64 planes (256 channels out),
  the first with a 1 x 1 downsample;
- stages 2-4 run 1, 4 and 3 `HRModule`s over 2, 3 and 4 parallel branches
  of the `HRNET_CFG` widths; before each stage a transition gives a branch
  whose width changes a 3 x 3 conv with BatchNorm and ReLU, and the new
  branch a 3 x 3 / 2 conv with BatchNorm and ReLU from the last branch;
- an `HRModule` runs four `BasicBlock`s a branch, then `FuseLayer`: output
  branch i sums, from every branch j, the map itself (j = i), a 1 x 1 conv
  and BatchNorm upsampled (nearest) to branch i's exact size (j > i), or a
  chain of i - j 3 x 3 / 2 convs with BatchNorm, ReLU after every one but
  the last, the last to branch i's width (j < i); then ReLU;
- the backbone returns the four branches (strides 4, 8, 16, 32);
- `HRFPN` upsamples branches 1-3 to branch 0's size (nearest), concatenates
  the four, reduces them with a 1 x 1 conv with bias, and gives `num_outs`
  maps: output i is a 3 x 3 conv with bias on the reduced map average-pooled
  2 x 2 / 2 (floor) i times.  No activation.

Module names are the reference's (mmdet v2.11) state-dict keys: `conv1`,
`bn1`, `conv2`, `bn2`, `layer1.{k}.*`; `transition{s}.{b}.0` (conv) and
`.1` (BatchNorm) for a branch whose width changes, `.{b}.0.0` and `.0.1`
for the new branch; `stage{n}.{m}.branches.{b}.{k}.*`;
`stage{n}.{m}.fuse_layers.{i}.{j}.0` and `.1` for j > i, `.{i}.{j}.{s}.0`
and `.1` for j < i; `reduction_conv.conv`, `fpn_convs.{i}.conv`.  A
reference `.pth`, `num_batches_tracked` included, loads with
`load_state_dict`.  The reference's HRFPN upsamples bilinearly; the JAX
package's, and so the port's, nearest (a known divergence, ROADMAP.md).

Convolutions are cuDNN's; parameters stay float32 and `dtype` is the
compute type of the convolutions, as in `models/resnet.py` (the JAX
`HRNet` and `HRFPN` take no `dtype`, so JAX cannot build the bf16 cascade
configs); BatchNorm is computed in float32 from its statistics, live in
train mode unless `norm_eval` (`resnet.batch_norm`).  Inputs and outputs
are NHWC; the convolutions run on NCHW views.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .fpn import ConvModule
from .layers import conv
from .resnet import BasicBlock, Bottleneck, CNNBackbone, batch_norm

HRNET_CFG = {
    18: ((18, 36), (18, 36, 72), (18, 36, 72, 144)),
    32: ((32, 64), (32, 64, 128), (32, 64, 128, 256)),
    40: ((40, 80), (40, 80, 160), (40, 80, 160, 320)),
}
STAGE_MODULES = (1, 4, 3)   # modules a stage, stages 2-4
BLOCKS_PER_BRANCH = 4


def conv_bn(pair: nn.Sequential, x: torch.Tensor, dtype: Optional[torch.dtype],
            live: bool) -> torch.Tensor:
    """The conv `pair[0]` and the BatchNorm `pair[1]` on NCHW `x`."""
    return batch_norm(pair[1], conv(pair[0], x, dtype), dtype, live)


def conv_bn_pair(cin: int, cout: int, k: int, stride: int = 1) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False),
                         nn.BatchNorm2d(cout))


def nearest(x: torch.Tensor, size) -> torch.Tensor:
    """NCHW `x` resized to `size` (h, w) by torch's nearest rule, which the
    JAX `fpn.nearest_upsample` reproduces at any ratio."""
    return F.interpolate(x, size=tuple(size), mode="nearest")


class FuseLayer(nn.ModuleList):
    """Row i holds, for each input branch j, the 1 x 1 conv and BatchNorm
    (j > i), None (j = i) or the chain of strided (conv, BatchNorm) pairs
    (j < i) of output branch i."""

    def __init__(self, widths: Sequence[int]):
        rows = []
        for i, wi in enumerate(widths):
            row = []
            for j, wj in enumerate(widths):
                if j > i:
                    row.append(conv_bn_pair(wj, wi, 1))
                elif j < i:
                    row.append(nn.Sequential(*(conv_bn_pair(wj, wi if s == i - j - 1 else wj, 3, 2)
                                               for s in range(i - j))))
                else:
                    row.append(None)
            rows.append(nn.ModuleList(row))
        super().__init__(rows)

    def forward(self, xs, dtype: Optional[torch.dtype], live: bool):
        outs = []
        for i, row in enumerate(self):
            acc = None
            for j, (x, step) in enumerate(zip(xs, row)):
                if j > i:
                    x = nearest(conv_bn(step, x, dtype, live), xs[i].shape[2:])
                elif j < i:
                    for s, pair in enumerate(step):
                        x = conv_bn(pair, x, dtype, live)
                        if s < len(step) - 1:
                            x = torch.relu(x)
                acc = x if acc is None else acc + x
            outs.append(torch.relu(acc))
        return outs


class HRModule(nn.Module):
    """`BLOCKS_PER_BRANCH` basic blocks on each branch, then `FuseLayer`."""

    def __init__(self, widths: Sequence[int], dtype=None):
        super().__init__()
        self.branches = nn.ModuleList(
            nn.Sequential(*(BasicBlock(w, w, dtype=dtype) for _ in range(BLOCKS_PER_BRANCH)))
            for w in widths)
        self.fuse_layers = FuseLayer(widths)
        self.dtype = dtype

    def forward(self, xs, live: bool = False):
        ys = []
        for x, branch in zip(xs, self.branches):
            for block in branch:
                x = block(x, live)
            ys.append(x)
        return self.fuse_layers(ys, self.dtype, live)


class HRNet(CNNBackbone):
    """HRNetV2 of `width` (an `HRNET_CFG` key): four NHWC maps of `width * 2**i`
    channels at stride `4 * 2**i`."""

    def __init__(self, width: int = 32, norm_eval: bool = True, dtype=None):
        super().__init__()
        if width not in HRNET_CFG:
            raise ValueError(f"HRNet width must be one of {sorted(HRNET_CFG)}, got {width}")
        self.conv1 = nn.Conv2d(3, 64, 3, 2, padding=1, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = nn.Conv2d(64, 64, 3, 2, padding=1, bias=False)
        self.bn2 = nn.BatchNorm2d(64)
        self.layer1 = nn.Sequential(*(Bottleneck(64 if k == 0 else 256, 64, with_downsample=k == 0,
                                                 dtype=dtype) for k in range(4)))
        prev, self.transitions, self.stages = [256], [], []
        for si, widths in enumerate(HRNET_CFG[width]):
            transition = nn.ModuleList(
                (None if w == prev[b] else conv_bn_pair(prev[b], w, 3)) if b < len(prev)
                else nn.Sequential(conv_bn_pair(prev[-1], w, 3, 2)) for b, w in enumerate(widths))
            stage = nn.Sequential(*(HRModule(widths, dtype) for _ in range(STAGE_MODULES[si])))
            self.add_module(f"transition{si + 1}", transition)
            self.add_module(f"stage{si + 2}", stage)
            self.transitions.append(transition)
            self.stages.append(stage)
            prev = widths
        self.norm_eval = norm_eval
        self.dtype = dtype

    def stem_layers(self):
        return ((self.conv1, self.bn1), (self.conv2, self.bn2))

    def forward_from_embed(self, x):
        """The stem's NHWC output -> the four branches, NHWC, in the compute
        type."""
        live = self.live_bn()
        x = x.permute(0, 3, 1, 2)
        for block in self.layer1:
            x = block(x, live)
        xs = [x]
        for transition, stage in zip(self.transitions, self.stages):
            new = []
            for b, t in enumerate(transition):
                if b >= len(xs):                       # the new branch, from the last
                    new.append(torch.relu(conv_bn(t[0], xs[-1], self.dtype, live)))
                else:
                    new.append(xs[b] if t is None
                               else torch.relu(conv_bn(t, xs[b], self.dtype, live)))
            xs = new
            for module in stage:
                xs = module(xs, live)
        return tuple(x.permute(0, 2, 3, 1) for x in xs)


class HRFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (32, 64, 128, 256), out_channels: int = 256,
                 num_outs: int = 5, dtype=None):
        super().__init__()
        self.reduction_conv = ConvModule(sum(in_channels), out_channels, 1)
        self.fpn_convs = nn.ModuleList(ConvModule(out_channels, out_channels, 3)
                                       for _ in range(num_outs))
        self.dtype = dtype

    def forward(self, feats):
        """feats: the backbone's NHWC branches -> `num_outs` NHWC maps."""
        nchw = [f.permute(0, 3, 1, 2) for f in feats]
        size = nchw[0].shape[2:]
        x = conv(self.reduction_conv.conv,
                 torch.cat([nchw[0]] + [nearest(f, size) for f in nchw[1:]], dim=1), self.dtype)
        outs = []
        for i, m in enumerate(self.fpn_convs):
            outs.append(conv(m.conv, x, self.dtype).permute(0, 2, 3, 1))
            if i < len(self.fpn_convs) - 1:
                x = F.avg_pool2d(x, 2, 2)
        return tuple(outs)


__all__ = ["HRNET_CFG", "STAGE_MODULES", "BLOCKS_PER_BRANCH", "FuseLayer", "HRModule", "HRNet",
           "HRFPN"]
