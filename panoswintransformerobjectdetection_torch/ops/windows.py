"""Window partition, the window transitions and the planar shift mask for
PanoSwin attention.

Counterpart of `panoswintransformerobjectdetection_tpu/ops/windows.py`
(`window_partition`, `window_reverse`, `make_relative_position_index`,
`swin_attention_mask`, `window_transition`, `window_transition_reverse`).
The JAX package's one-hot `table_lookup` exists only because the TPU
serialises gathers; here a table is indexed directly (`table[rel_index]`).
"""

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry.axis import ew2ns, ns2we


def window_partition(x: torch.Tensor, window_size: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * H/ws * W/ws, ws, ws, C); H, W divisible by ws."""
    B, H, W, C = x.shape
    ws = window_size
    x = x.reshape(B, H // ws, ws, W // ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws, ws, C)


def window_reverse(windows: torch.Tensor, window_size: int, H: int, W: int) -> torch.Tensor:
    """Inverse of `window_partition`: (nW*B, ws, ws, C) -> (B, H, W, C)."""
    ws = window_size
    C = windows.shape[-1]
    B = windows.shape[0] // ((H // ws) * (W // ws))
    x = windows.reshape(B, H // ws, W // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)


def make_relative_position_index(window_size: int) -> np.ndarray:
    """(O, O) int64 index into the (2ws-1)^2 relative-bias table."""
    wh = ww = window_size
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)


def swin_attention_mask(Hp: int, Wp: int, window_size: int, shift_size: int,
                        neg: float = -100.0, device=None) -> torch.Tensor:
    """Planar shifted-window mask: (nW, O, O) float32 with 0 / `neg` entries.

    The stock Swin construction: the padded Hp x Wp map is cut into 3 x 3
    regions at -ws and -shift along each axis, and a query and a key of one
    window see each other only if they lie in the same region.
    """
    ws, ss = window_size, shift_size

    def region(n):
        r = torch.zeros(n, dtype=torch.int64, device=device)
        r[n - ws:] = 1
        r[n - ss:] = 2
        return r

    img = region(Hp)[:, None] * 3 + region(Wp)[None, :]
    m = window_partition(img[None, :, :, None], ws).reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return torch.where(diff != 0, neg, 0.0).float()


def window_transition(x: torch.Tensor, shift_size: int, pano_mode: bool) -> torch.Tensor:
    """Forward shift of a (..., H, W, C) map.

    planar: 2-D roll by -shift (stock Swin cyclic shift).
    pano: roll W by +shift, pad an odd width by one zero column, ew2ns pole
    rotation, roll H by +shift.
    """
    if not pano_mode:
        return torch.roll(x, shifts=(-shift_size, -shift_size), dims=(-3, -2))
    x = torch.roll(x, shifts=shift_size, dims=-2)
    if x.shape[-2] % 2:
        x = F.pad(x, (0, 0, 0, 1))
    x = ew2ns(x)
    return torch.roll(x, shifts=shift_size, dims=-3)


def window_transition_reverse(x: torch.Tensor, shift_size: int, pano_mode: bool,
                              width_was_odd: bool = False) -> torch.Tensor:
    """Inverse of `window_transition`; `width_was_odd` drops the pano pad column."""
    if not pano_mode:
        return torch.roll(x, shifts=(shift_size, shift_size), dims=(-3, -2))
    x = torch.roll(x, shifts=-shift_size, dims=-3)
    x = ns2we(x)
    if width_was_odd:
        x = x[..., :, :-1, :]
    return torch.roll(x, shifts=-shift_size, dims=-2)
