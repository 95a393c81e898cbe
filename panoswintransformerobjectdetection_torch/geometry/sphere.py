"""Spherical coordinates of an equirectangular grid and great-circle distances.

Counterpart of `panoswintransformerobjectdetection_tpu/geometry/sphere.py`
(`make_uv_grid`, `uv_to_xyz`, `wrap_u`, `haversine`).  u (longitude) lies in [-pi, pi) and grows to
the right; v (latitude) lies in [-pi/2, pi/2) and grows downwards.  The last
dimension of a uv tensor is (u, v).
"""

import math

import torch

PI = math.pi


def make_uv_grid(H: int, W: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """(H, W, 2) uv of the pixel centres; both axes use the gap pi / H."""
    gap = PI / H
    u = (torch.arange(W, device=device, dtype=dtype) + 0.5) * gap - PI
    v = (torch.arange(H, device=device, dtype=dtype) + 0.5) * gap - 0.5 * PI
    uu = u[None, :].expand(H, W)
    vv = v[:, None].expand(H, W)
    return torch.stack([uu, vv], dim=-1)


def uv_to_xyz(uv: torch.Tensor) -> torch.Tensor:
    """(..., 2) uv on the unit sphere, (..., 3): x = sin(u) sin(v + pi/2),
    y = cos(u) sin(v + pi/2), z = cos(v + pi/2).  The (v + pi/2) form is
    kept as the reference writes it: near a pole the rotation's azimuth
    frame rests on the float residues of exactly these terms."""
    u = uv[..., 0]
    v2 = uv[..., 1] + 0.5 * PI
    sv = torch.sin(v2)
    return torch.stack([torch.sin(u) * sv, torch.cos(u) * sv, torch.cos(v2)], dim=-1)


def wrap_u(u: torch.Tensor) -> torch.Tensor:
    """Longitudes wrapped into (-pi, pi]."""
    u = torch.where(u > PI, u - 2.0 * PI, u)
    return torch.where(u <= -PI, u + 2.0 * PI, u)


def haversine(uv1: torch.Tensor, uv2: torch.Tensor) -> torch.Tensor:
    """All-pairs haversine distance: (..., N, 2), (..., M, 2) -> (..., N, M)."""
    v1 = uv1[..., 1][..., :, None]
    u1 = uv1[..., 0][..., :, None]
    v2 = uv2[..., 1][..., None, :]
    u2 = uv2[..., 0][..., None, :]
    h = torch.sin(0.5 * torch.abs(v2 - v1)) ** 2 + \
        torch.cos(v2) * torch.cos(v1) * torch.sin(0.5 * (u2 - u1)) ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))
