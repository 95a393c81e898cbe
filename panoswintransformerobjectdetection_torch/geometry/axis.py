"""Pole-centred recomposition of equirectangular maps (flip and concat).

Counterpart of `panoswintransformerobjectdetection_tpu/geometry/axis.py`.
Maps are (..., H, W, C): H is dimension -3, W is dimension -2.
"""

import torch


def ew2ns(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (..., 2H, W/2, C): the right half, flipped in both
    spatial axes, goes above the left half.  W must be even."""
    W = x.shape[-2]
    if W % 2:
        raise ValueError(f"ew2ns needs an even width, got {W}")
    ms = W // 2
    right = torch.flip(x[..., :, ms:, :], dims=(-3, -2))
    return torch.cat([right, x[..., :, :ms, :]], dim=-3)


def ns2we(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `ew2ns`: (..., 2H, W, C) -> (..., H, 2W, C)."""
    H = x.shape[-3]
    if H % 2:
        raise ValueError(f"ns2we needs an even height, got {H}")
    ms = H // 2
    top = torch.flip(x[..., :ms, :, :], dims=(-3, -2))
    return torch.cat([x[..., ms:, :, :], top], dim=-2)
