"""Great-circle rotation of equirectangular coordinates and images.

Counterpart of `rotate_to_pole`, `pano_rotate` and `pano_rotate_image` in
`panoswintransformerobjectdetection_tpu/geometry/rotate.py` (the reference's
`lzx/pano_rotate.py`), with the same numerics: the 1e-12 floor of
`_normalize`, the arccos clip at 1 - 1e-15 (a no-op in float32, kept as the
reference has it), the identity select for a south-pole axis, and
`pano_rotate_image`'s mesh u = (j / H - 1) pi, v = (i / H - 0.5) pi, which
has no half-pixel offset and assumes W = 2H even where the map is not 2:1.
"""

import math

import torch

from .resample import grid_sample_nhwc
from .sphere import uv_to_xyz, wrap_u

PI = math.pi

# `lzx/pano_rotate.py:13`: the north pole (0, -pi/2), the top of the pano.
NORTH_POLE = (0.0, -0.5 * PI)

_EPS = 1e-15
# Sample grids stay this far inside [-1, 1] (`lzx/pano_rotate.py:186`).
_GRID_EPS = 5e-4


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp(min=eps)


def rotate_to_pole(np_uv: torch.Tensor, s_uv: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Rotate the sphere so that `np_uv` (2,) becomes the north pole:
    s_uv (..., 2) -> (..., 2).  The new latitude comes from the chord to the
    pole, the new longitude from the tangent frame at the old north pole's
    image."""
    np_xyz = uv_to_xyz(np_uv)
    s_xyz = uv_to_xyz(s_uv)
    sp_xyz = uv_to_xyz(torch.tensor(NORTH_POLE, dtype=s_uv.dtype, device=s_uv.device))
    d = torch.linalg.vector_norm(np_xyz - s_xyz, dim=-1)
    v_new = 2.0 * torch.arcsin(torch.clamp(0.5 * d, -1.0, 1.0)) - 0.5 * PI
    directions = _normalize(torch.linalg.cross(s_xyz, np_xyz.expand_as(s_xyz), dim=-1))
    x_dir = _normalize(torch.linalg.cross(sp_xyz, np_xyz, dim=-1))
    y_dir = torch.linalg.cross(x_dir, np_xyz, dim=-1)
    cosu = torch.clamp((directions * x_dir).sum(-1), -1.0 + eps, 1.0 - eps)
    u_new = torch.arccos(cosu)
    u_new = torch.where((directions * y_dir).sum(-1) < 0, -u_new, u_new)
    return torch.stack([u_new, v_new], dim=-1)


def pano_rotate(np_uv, s_uv: torch.Tensor, reverse: bool = False,
                eps: float = _EPS) -> torch.Tensor:
    """Rotate pano coordinates s_uv (..., 2) about the axis `np_uv` (2,);
    `reverse=True` is the exact inverse.  A south-pole axis is the identity."""
    np_uv = torch.as_tensor(np_uv, dtype=torch.promote_types(s_uv.dtype, torch.float32),
                            device=s_uv.device)
    is_identity = torch.abs(np_uv[1] + 0.5 * PI) < eps
    if not reverse:
        out = rotate_to_pole(np_uv, s_uv, eps)
    else:
        north = torch.tensor([NORTH_POLE], dtype=s_uv.dtype, device=s_uv.device)
        pole = rotate_to_pole(np_uv, north, eps)[0]
        out = rotate_to_pole(pole, s_uv, eps)
        out = torch.stack([wrap_u(out[..., 0] + np_uv[0]), out[..., 1]], dim=-1)
    return torch.where(is_identity, s_uv, out)


def rotation_grid(H: int, W: int, np_uv, device=None) -> torch.Tensor:
    """(H, W, 2) grid_sample grid of `pano_rotate_image`: each output
    pixel's uv rotated by `np_uv`, over pi (x) and pi / 2 (y), clipped at
    +-(1 - 5e-4)."""
    i = torch.arange(H, dtype=torch.float32, device=device) / H - 0.5
    j = torch.arange(W, dtype=torch.float32, device=device) / H - 1.0
    s_uv = torch.stack([(j[None, :] * PI).expand(H, W), (i[:, None] * PI).expand(H, W)], -1)
    rot = pano_rotate(np_uv, s_uv.reshape(-1, 2))
    gx = torch.clamp(rot[:, 0] / PI, _GRID_EPS - 1.0, 1.0 - _GRID_EPS)
    gy = torch.clamp(rot[:, 1] / PI * 2.0, _GRID_EPS - 1.0, 1.0 - _GRID_EPS)
    return torch.stack([gx, gy], dim=-1).reshape(H, W, 2)


def pano_rotate_image(img_bchw: torch.Tensor, np_uv):
    """Warp an equirectangular batch (B, C, H, W) by a great-circle rotation:
    bilinear, border padding, `align_corners=False`.  Returns (rotated
    (B, C, H, W), its sample grid (H, W, 2)), so that a caller can resample
    side-band maps through the same grid."""
    B, C, H, W = img_bchw.shape
    grid = rotation_grid(H, W, np_uv, img_bchw.device)
    out = grid_sample_nhwc(img_bchw.permute(0, 2, 3, 1), grid.expand(B, H, W, 2))
    return out.permute(0, 3, 1, 2), grid
