"""PanoSwin v1: the reference's earlier revision of the v-variant
(`panoswin_transformer_v1.py`).

Counterpart of `panoswintransformerobjectdetection_tpu/models/panoswin_v1.py`
(`WindowAttentionV1`, `PanoSwinBlockV1`, `PanoSwinTransformerV1`).  It shares
the v-variant's parameters and keys, its stem, `coord_encoder`, masks and
latitude map (`models/panoswin_v2.py`); where it differs:

- the side band is one channel, v, appended after the pad to whole windows
  (edge-replicated into the pad) in the compute type; the attention rebuilds
  u from the flattened window, u = column * |v[ws] - v[ws - 1]|;
- the sphere bias is the one product hav * alpha[index] * beta[index], with
  the reference's `transpose(1, 3)`, and in pano mode it replaces the Swin
  table instead of being added to it; there is no hemisphere flag;
- every shifted block takes the stage's Swin mask, in both layouts (in the
  pano layout its windows pair with the transitioned windows in another
  order: kept as the reference has it), unless the transitioned window count
  differs from the mask's;
- the map is padded before the pano transition, not after it.
"""

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..geometry.axis import ew2ns, ns2we
from ..geometry.sphere import haversine
from ..ops.windows import window_partition, window_reverse
from .panoswin_v2 import PanoSwinBlockV2, PanoSwinTransformerV2, WindowAttentionV2


class WindowAttentionV1(WindowAttentionV2):
    """`WindowAttentionV2`'s layers and tables with v1's bias: the second
    argument is the windows' latitudes (n, O), not uv and a flag."""

    def sphere_bias(self, v_win: torch.Tensor) -> torch.Tensor:
        """v_win (n, O) -> (n, heads, O, O): hav * alpha[index] *
        beta[index] of (u, v), its (query, key) axes swapped."""
        ws = self.window_size
        gap = torch.abs(v_win[:, ws] - v_win[:, ws - 1])
        col = torch.arange(ws, dtype=v_win.dtype, device=v_win.device).repeat(ws)
        uv = torch.stack([col[None, :] * gap[:, None], v_win], -1)
        hav = haversine(uv, uv)[:, None]                                  # (n, 1, O, O)
        alpha = self.sphere_position_alpha_table.t()[:, self.rel_index]   # (h, O, O)
        beta = self.sphere_position_beta_table.t()[:, self.rel_index]
        return (hav * alpha * beta).transpose(2, 3)


class PanoSwinBlockV1(PanoSwinBlockV2):
    """One (shifted) window block of v1 (module docstring)."""

    attention = WindowAttentionV1

    def mix(self, xn: torch.Tensor, v: torch.Tensor, mask) -> torch.Tensor:
        B, H, W, c = xn.shape
        ws, s = self.window_size, self.shift_size
        ph, pw = (-H) % ws, (-W) % ws
        vp = v
        if ph:
            vp = torch.cat([vp, vp[:, -1:].expand(B, ph, vp.shape[2])], 1)
        if pw:
            vp = torch.cat([vp, vp[:, :, -1:].expand(B, vp.shape[1], pw)], 2)
        xv = torch.cat([F.pad(xn, (0, 0, 0, pw, 0, ph)), vp[..., None].to(xn.dtype)], -1)
        if s:
            if self.win_trans_type == 0:
                xv = torch.roll(xv, (-s, -s), (1, 2))
            else:
                xv = torch.roll(xv, s, dims=2)
                if xv.shape[2] % 2:
                    xv = F.pad(xv, (0, 0, 0, 1))
                xv = torch.roll(ew2ns(xv), s, dims=1)
        SH, SW = xv.shape[1], xv.shape[2]
        xv = F.pad(xv, (0, 0, 0, (-SW) % ws, 0, (-SH) % ws))
        Hq, Wq = xv.shape[1], xv.shape[2]
        m = mask if s else None
        if m is not None and m.shape[1] != (Hq // ws) * (Wq // ws):
            m = None
        wins = window_partition(xv, ws).reshape(-1, ws * ws, c + 1)
        out = self.attn(wins[..., :-1], wins[..., -1], m)
        y = window_reverse(out.reshape(-1, ws, ws, c), ws, Hq, Wq)[:, :SH, :SW]
        if s:
            if self.win_trans_type == 0:
                y = torch.roll(y, (s, s), (1, 2))
            else:
                y = torch.roll(y, -s, dims=1)
                if y.shape[1] % 2:
                    y = F.pad(y, (0, 0, 0, 0, 0, 1))
                y = torch.roll(ns2we(y), -s, dims=2)
        return y[:, :H, :W]


class PanoSwinTransformerV1(PanoSwinTransformerV2):
    """The v1 backbone: the v-variant's stem (`'cnn'`, no basketball warp),
    encoder, stages and latitude maps with `PanoSwinBlockV1`, every shifted
    block masked.  A detector hands it no ratio (`takes_ratio`): it runs at
    (0, 1, H0), as in the JAX detector, whose `extract_feat` passes the
    ratio to the v-variant only."""

    block = PanoSwinBlockV1
    takes_ratio = False

    def __init__(self, patch_size: int = 4, in_chans: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.2,
                 ape: bool = False, patch_norm: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3), win_trans_type: int = 1,
                 use_checkpoint: bool = False, dtype=None):
        super().__init__(patch_size, in_chans, embed_dim, depths, num_heads, window_size,
                         mlp_ratio, qkv_bias, qk_scale, drop_path_rate, ape, patch_norm,
                         out_indices, win_trans_type, "cnn", False, use_checkpoint, dtype)

    def masks_needed(self, shift: int) -> bool:
        return shift > 0


__all__ = ["WindowAttentionV1", "PanoSwinBlockV1", "PanoSwinTransformerV1"]
