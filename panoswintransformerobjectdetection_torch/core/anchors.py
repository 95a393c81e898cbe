"""Multi-level grid anchors (mmdet v2 `AnchorGenerator` numerics).

Counterpart of `panoswintransformerobjectdetection_tpu/core/anchors.py`
(`AnchorGenerator`, `grid_anchors`), reduced to what the detector uses:
base size = stride, centre offset 0, anchors ordered (y, x, anchor).
Computed in numpy float32 as the JAX package does, then moved to the device.
"""

from typing import List, Sequence, Tuple

import numpy as np
import torch


class AnchorGenerator:
    def __init__(self, strides: Sequence[int], ratios: Sequence[float],
                 scales: Sequence[float]):
        self.strides = list(strides)
        scales = np.asarray(scales, np.float32)
        ratios = np.asarray(ratios, np.float32)
        self.num_base_anchors = len(ratios) * len(scales)
        self.base_anchors = [self._base_anchors(s, scales, ratios) for s in self.strides]

    @staticmethod
    def _base_anchors(base_size, scales, ratios) -> np.ndarray:
        w = h = float(base_size)
        h_ratios = np.sqrt(ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * w_ratios[:, None] * scales[None, :]).reshape(-1)
        hs = (h * h_ratios[:, None] * scales[None, :]).reshape(-1)
        return np.stack([-0.5 * ws, -0.5 * hs, 0.5 * ws, 0.5 * hs], axis=-1).astype(np.float32)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]],
                     device=None) -> List[torch.Tensor]:
        """Per level: (H*W*A, 4) float32 anchors."""
        out = []
        for (fh, fw), s, base in zip(featmap_sizes, self.strides, self.base_anchors):
            sx = np.arange(fw, dtype=np.float32) * s
            sy = np.arange(fh, dtype=np.float32) * s
            shift = np.stack([np.tile(sx, fh), np.repeat(sy, fw)], axis=-1)
            shift = np.concatenate([shift, shift], axis=-1)
            anchors = (base[None, :, :] + shift[:, None, :]).reshape(-1, 4)
            out.append(torch.from_numpy(anchors).to(device))
        return out
