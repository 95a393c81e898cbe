"""The RegNetX backbone, as the model zoo's `configs/regnet` Faster and Mask
R-CNN configs use it, at test time.

Counterpart of `REGNET_ARCH`, `RegBlock` and `RegNet` in
`panoswintransformerobjectdetection_tpu/models/backbones_extra.py`: a 3 x 3
/ 2 stem of 32 channels with BatchNorm and ReLU (no max-pool), then four
stages of bottleneck blocks of ratio 1 (1 x 1, grouped 3 x 3, 1 x 1), the
first block of each with stride 2 and a 1 x 1 downsample.  The 3 x 3 has
`width // groups` groups where `groups` (the presets' group width) divides
the stage's width, else 1, exactly as JAX computes it.  Module names are
the reference's (`conv1`, `bn1`, `layer{i}.{j}.conv{1,2,3}`, `bn{1,2,3}`,
`downsample.{0,1}`).  Compute types, BatchNorm and layout as
`models/resnet.py`; training is refused there too.  Res2Net, ResNeSt and
TridentResNet are not ported (ROADMAP.md, Queue 1, item 17c).
"""

from typing import Dict, Optional, Sequence

import torch
import torch.nn as nn

from .layers import conv
from .resnet import CNNBackbone, ResidualBlock, batch_norm, check_plugins, downsample

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

    def branch(self, x):
        y = torch.relu(batch_norm(self.bn1, conv(self.conv1, x, self.dtype), self.dtype))
        y = torch.relu(batch_norm(self.bn2, conv(self.conv2, y, self.dtype), self.dtype))
        return batch_norm(self.bn3, conv(self.conv3, y, self.dtype), self.dtype)


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


__all__ = ["REGNET_ARCH", "conv_groups", "RegBlock", "RegNet"]
