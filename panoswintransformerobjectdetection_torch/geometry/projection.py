"""Gnomonic (tangent-plane) <-> equirectangular projection and BFoV boxes.

Counterpart of `panoswintransformerobjectdetection_tpu/geometry/
projection.py` (`tangent_xy_to_equirect_uv`, `equirect_uv_to_tangent_xy`,
`bfov_to_xyxy`), in float32 tensors as JAX computes it.  `Indoor360Dataset`
turns its BFoV annotations into equirectangular pixel boxes with
`bfov_to_xyxy` when it parses them, on the CPU.
"""

import math

import torch

from .sphere import wrap_u

PI = math.pi


def tangent_xy_to_equirect_uv(xy: torch.Tensor, uv0: torch.Tensor) -> torch.Tensor:
    """Inverse gnomonic projection about the tangent point uv0.
    xy: (..., 2) tangent-plane coordinates; uv0: (..., 2) or (2,)."""
    uv0 = torch.broadcast_to(uv0, xy.shape[:-1] + (2,))
    u0, v0 = uv0[..., 0], uv0[..., 1]
    x, y = xy[..., 0], xy[..., 1]
    rho = torch.clamp(torch.sqrt(x * x + y * y), min=1e-8)
    t = torch.arctan(rho)
    st, ct = torch.sin(t), torch.cos(t)
    u = u0 + torch.arctan2(x * st, rho * torch.cos(v0) * ct - y * torch.sin(v0) * st)
    v = torch.arcsin(torch.clamp(ct * torch.sin(v0) + y * st * torch.cos(v0) / rho, -1.0, 1.0))
    return torch.stack([u, v], dim=-1)


def equirect_uv_to_tangent_xy(uv: torch.Tensor, uv0: torch.Tensor) -> torch.Tensor:
    """Forward gnomonic projection about the tangent point uv0."""
    uv0 = torch.broadcast_to(uv0, uv.shape[:-1] + (2,))
    u0, v0 = uv0[..., 0], uv0[..., 1]
    u, v = uv[..., 0], uv[..., 1]
    cosc = torch.sin(v0) * torch.sin(v) + torch.cos(v0) * torch.cos(v) * torch.cos(u - u0)
    x = torch.cos(v) * torch.sin(u - u0) / cosc
    y = (torch.cos(v0) * torch.sin(v) - torch.sin(v0) * torch.cos(v) * torch.cos(u - u0)) / cosc
    return torch.stack([x, y], dim=-1)


def _edge_samples(n: int, dtype=torch.float32) -> torch.Tensor:
    """(4n, 2) samples of the boundary of [-1, 1]^2: top, bottom, left, right."""
    t = torch.linspace(-1.0, 1.0, n, dtype=dtype)
    ones = torch.ones_like(t)
    return torch.cat([torch.stack([t, -ones], -1), torch.stack([t, ones], -1),
                      torch.stack([-ones, t], -1), torch.stack([ones, t], -1)], 0)


def bfov_to_xyxy(uvwh: torch.Tensor, img_w: int, img_h: int,
                 n_samples: int = 10) -> torch.Tensor:
    """BFoV boxes (N, 4): tangent point (u, v) in radians and the tangent
    plane's extent (w, h) -> equirectangular pixel boxes (N, 4) xyxy.  The
    rectangle's edge points are projected back to the sphere, longitudes are
    unwrapped about each box's centre (so a box across the seam stays whole),
    and a box that holds a pole spans every longitude."""
    uvwh = torch.as_tensor(uvwh, dtype=torch.float32)
    uv0 = uvwh[:, :2]
    wh = uvwh[:, 2:4]
    edge = _edge_samples(n_samples, uvwh.dtype)
    xy = edge[None, :, :] * (0.5 * wh)[:, None, :]
    uv = tangent_xy_to_equirect_uv(xy, uv0[:, None, :])
    u = uv0[:, None, 0] + wrap_u(uv[..., 0] - uv0[:, None, 0])
    v = uv[..., 1]
    u_min, u_max = u.min(1).values, u.max(1).values
    v_min, v_max = v.min(1).values, v.max(1).values
    pole = (v_min <= -0.5 * PI + 1e-6) | (v_max >= 0.5 * PI - 1e-6)
    u_min = torch.where(pole, torch.full_like(u_min, -PI), u_min)
    u_max = torch.where(pole, torch.full_like(u_max, PI), u_max)
    sx = img_w / (2.0 * PI)
    sy = img_h / PI
    return torch.stack([(u_min + PI) * sx, (v_min + 0.5 * PI) * sy,
                        (u_max + PI) * sx, (v_max + 0.5 * PI) * sy], dim=-1)
