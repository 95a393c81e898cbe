"""Feature Pyramid Network: lateral 1x1 convs, top-down nearest upsample and
add, 3x3 output convs, extra levels by stride-2 subsampling of the last.

Counterpart of `FPN` in `panoswintransformerobjectdetection_tpu/models/fpn.py`
(`num_outs=5`, `add_extra_convs=False`).  The JAX package builds the nearest
upsample from one-hot matmuls for the TPU; here it is `F.interpolate`.
Inputs and outputs are NHWC; the convs run on channels-last NCHW views.
"""

from typing import Sequence

import torch.nn as nn
import torch.nn.functional as F

from .layers import conv


class ConvModule(nn.Module):
    """Holds one conv under `.conv`, the reference's state-dict layout."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, padding=k // 2)


class FPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (96, 192, 384, 768),
                 out_channels: int = 256, num_outs: int = 5, dtype=None):
        super().__init__()
        self.lateral_convs = nn.ModuleList(ConvModule(c, out_channels, 1) for c in in_channels)
        self.fpn_convs = nn.ModuleList(ConvModule(out_channels, out_channels, 3)
                                       for _ in in_channels)
        self.num_outs = num_outs
        self.dtype = dtype

    def forward(self, feats):
        """feats: NHWC maps, one per input level -> num_outs NHWC maps."""
        nchw = [f.permute(0, 3, 1, 2) for f in feats]
        laterals = [conv(m.conv, f, self.dtype) for m, f in zip(self.lateral_convs, nchw)]
        for i in range(len(laterals) - 1, 0, -1):
            size = laterals[i - 1].shape[2:]
            laterals[i - 1] = laterals[i - 1] + F.interpolate(laterals[i], size=size,
                                                              mode="nearest")
        outs = [conv(m.conv, x, self.dtype) for m, x in zip(self.fpn_convs, laterals)]
        while len(outs) < self.num_outs:
            outs.append(outs[-1][:, :, ::2, ::2])
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
