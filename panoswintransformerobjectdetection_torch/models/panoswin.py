"""PanoSwin Transformer backbone, inference, pano and planar modes.

Counterpart of `panoswintransformerobjectdetection_tpu/models/panoswin.py`
(`sphere_bias`, `prepare_window_uv`, `WindowAttention`, `PanoSwinBlock`,
`BasicLayer`, `PanoSwinTransformer`).  Tokens stay (B, H, W, C) between
blocks.  The uv grid is side-band data, shared by the batch, and the
haversine couplings (pano) or the shifted-window mask (planar) are computed
once per stage and shift.  Window attention takes one of two routes, as in
the JAX package:
  - plain (the default, `_attention_core_hip`): q * scale in the compute
    type, q.k in f32, plus the batch-shared bias (nW, h, O, O) and then any
    mask, f32 softmax, then @ v in the compute type;
  - fused (`fused_attention=True`): the mask folded into the bias, then
    kernel K2 (`ops/fused_attention.packed_window_attention`), which scales
    the f32 product.
Only even depths are ported: an odd depth ends its stage with a
PitchAttention block, which is a later slice.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.sphere import haversine, make_uv_grid
from ..ops.fused_attention import packed_window_attention
from ..ops.windows import (make_relative_position_index, swin_attention_mask,
                           window_partition, window_reverse, window_transition,
                           window_transition_reverse)
from .layers import ConvStemPatchEmbed, LayerNorm, Mlp, PatchMerging, dense


def sphere_bias(alpha_table, beta_table, rel_index, hav: Optional[torch.Tensor]):
    """pano: haversine * alpha[rel] + beta[rel], (nW, O, O) -> (nW, heads, O, O);
    planar (`hav` None): beta[rel], (1, heads, O, O).  Contiguous either way."""
    beta = beta_table.t()[:, rel_index]              # (heads, O, O)
    if hav is None:
        return beta[None]
    return hav[:, None] * alpha_table.t()[:, rel_index] + beta


def prepare_window_uv(uv, shift_size: int, ws: int):
    """Haversine couplings of the windowed uv grid for one pano shift:
    (nW, O, O).  Planar mode has none (its bias is the beta table alone)."""
    uvt = window_transition(uv, shift_size, True)
    SH, SW = uvt.shape[0], uvt.shape[1]
    uvt = F.pad(uvt, (0, 0, 0, (-SW) % ws, 0, (-SH) % ws))
    uv_wins = window_partition(uvt[None], ws).reshape(-1, ws * ws, 2)
    return haversine(uv_wins, uv_wins)


class WindowAttention(nn.Module):
    """Window attention with the dual-table spherical bias."""

    def __init__(self, dim: int, window_size: int, num_heads: int, dtype=None,
                 fused: bool = False):
        super().__init__()
        t = (2 * window_size - 1) ** 2
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.sphere_position_alpha_table_Te = nn.Parameter(torch.zeros(t, num_heads))
        self.sphere_position_beta_table_Te = nn.Parameter(torch.zeros(t, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            make_relative_position_index(window_size)), persistent=False)
        self.dtype = dtype
        self.fused = fused

    def forward(self, x, nW: int, hav=None, mask=None):
        """x: (B*nW, O, c) windows; hav: (nW, O, O) in pano mode, None in
        planar mode; mask: the planar shift mask (nW, O, O) or None."""
        n, O, c = x.shape
        h = self.num_heads
        hd = c // h
        scale = hd ** -0.5
        qkv = dense(self.qkv, x, self.dtype).reshape(n, O, 3, h, hd)
        bias = sphere_bias(self.sphere_position_alpha_table_Te,
                           self.sphere_position_beta_table_Te, self.rel_index, hav)
        bias = bias.expand(nW, h, O, O)
        if self.fused:
            if mask is not None:
                bias = bias + mask[:, None]
            q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
            out = packed_window_attention(q, k, v, bias, scale).transpose(1, 2)
        else:
            q = qkv[:, :, 0] * scale
            k, v = qkv[:, :, 1], qkv[:, :, 2]
            attn = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
            attn = attn.reshape(n // nW, nW, h, O, O) + bias[None]
            if mask is not None:
                attn = attn + mask[None, :, None]
            attn = torch.softmax(attn.reshape(n, h, O, O), dim=-1)
            out = torch.einsum("nhqk,nkhd->nqhd", attn.to(v.dtype), v)
        return dense(self.proj, out.reshape(n, O, c), self.dtype)


class PanoSwinBlock(nn.Module):
    """One (shifted) window block.  Pano mode applies the pano transition on
    every block, shift 0 included, before padding; planar mode pads first,
    then rolls by -shift and masks across the roll's seams."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, dtype=None, pano_mode: bool = True,
                 fused: bool = False):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.pano_mode = pano_mode
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype, fused)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.dtype = dtype

    def forward(self, x, hav=None, mask=None):
        """hav: pano couplings (nW, O, O); mask: planar shift mask or None."""
        B, H, W, c = x.shape
        ws, shift, pano = self.window_size, self.shift_size, self.pano_mode
        xn = self.norm1(x).to(self.dtype or torch.float32)
        if pano:
            xn = window_transition(xn, shift, True)
        SH, SW = xn.shape[1], xn.shape[2]
        xn = F.pad(xn, (0, 0, 0, (-SW) % ws, 0, (-SH) % ws))
        if not pano and shift:
            xn = window_transition(xn, shift, False)
        Hp, Wp = xn.shape[1], xn.shape[2]
        wins = window_partition(xn, ws).reshape(-1, ws * ws, c)
        y = self.attn(wins, (Hp // ws) * (Wp // ws), hav, mask)
        y = window_reverse(y.reshape(-1, ws, ws, c), ws, Hp, Wp)
        if not pano and shift:
            y = window_transition_reverse(y, shift, False)
        y = y[:, :SH, :SW]
        if pano:
            y = window_transition_reverse(y, shift, True, width_was_odd=bool(W % 2))
        x = x + y[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """One stage: alternating shift-0 and shift-ws/2 blocks, then PatchMerging."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, downsample: bool = True, dtype=None,
                 pano_mode: bool = True, fused: bool = False):
        super().__init__()
        if depth % 2:
            raise NotImplementedError(
                "odd stage depths end in a PitchAttention block, which is not "
                "ported yet (ROADMAP.md, Queue 1, item 11)")
        self.window_size = window_size
        self.pano_mode = pano_mode
        self.blocks = nn.ModuleList(
            PanoSwinBlock(dim, num_heads, window_size,
                          0 if i % 2 == 0 else window_size // 2, mlp_ratio, dtype,
                          pano_mode, fused)
            for i in range(depth))
        self.downsample = PatchMerging(dim, dtype) if downsample else None

    def _window_context(self, uv, shift: int, H: int, W: int):
        """(hav, mask) of one shift, shared by the stage's blocks."""
        ws = self.window_size
        if self.pano_mode:
            return prepare_window_uv(uv, shift, ws), None
        if not shift:
            return None, None
        return None, swin_attention_mask(H + (-H) % ws, W + (-W) % ws, ws, shift,
                                         device=uv.device)

    def forward(self, x, uv):
        ctx = {}
        for blk in self.blocks:
            if blk.shift_size not in ctx:
                ctx[blk.shift_size] = self._window_context(uv, blk.shift_size, x.shape[1],
                                                           x.shape[2])
            x = blk(x, *ctx[blk.shift_size])
        if self.downsample is None:
            return x, x, uv
        x_down = self.downsample(x)
        H2, W2 = x_down.shape[1], x_down.shape[2]
        if self.pano_mode:
            return x, x_down, make_uv_grid(H2, W2, device=x.device)
        return x, x_down, torch.zeros((H2, W2, 2), device=x.device)


class PanoSwinTransformer(nn.Module):
    """PanoSwin backbone: stem, optional absolute encoder, 4 stages, f32
    out-norms.  Returns NHWC maps (B, Hi, Wi, embed_dim * 2**i).

    `pano_mode=False` gives planar Swin semantics (beta table only, cyclic
    shift, shifted-window mask, a zero uv grid); `ape`'s encoder then stays
    in the state dict but is not applied.  `fused_attention=True` runs every
    block's attention through kernel K2.
    """

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, ape: bool = False,
                 out_indices: Sequence[int] = (0, 1, 2, 3), pano_mode: bool = True,
                 fused_attention: bool = False, dtype=None):
        super().__init__()
        self.patch_embed = ConvStemPatchEmbed(patch_size, embed_dim, dtype)
        self.abs_encoder = nn.Linear(5, embed_dim) if ape else None
        self.pano_mode = pano_mode
        n = len(depths)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depths[i], num_heads[i], window_size,
                       mlp_ratio, downsample=i < n - 1, dtype=dtype, pano_mode=pano_mode,
                       fused=fused_attention)
            for i in range(n))
        self.out_indices = tuple(out_indices)
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    def forward(self, images):
        return self.forward_from_embed(self.patch_embed(images))

    def forward_from_embed(self, x):
        """Everything after the stem: x (B, H/4, W/4, embed_dim)."""
        B, H, W, C = x.shape
        if self.pano_mode:
            uv = make_uv_grid(H, W, device=x.device)
            if self.abs_encoder is not None:
                u, v = uv[..., 0], uv[..., 1]
                xyz = torch.stack([torch.sin(u) * torch.sin(v), torch.cos(u) * torch.sin(v),
                                   torch.cos(v)], -1)
                x = x + dense(self.abs_encoder, torch.cat([xyz, uv], -1), None)[None]
        else:
            uv = torch.zeros((H, W, 2), device=x.device)
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x, uv = layer(x, uv)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x_out))
        return tuple(outs)


__all__ = ["sphere_bias", "prepare_window_uv", "WindowAttention", "PanoSwinBlock",
           "BasicLayer", "PanoSwinTransformer"]
