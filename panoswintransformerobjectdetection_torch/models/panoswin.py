"""PanoSwin Transformer backbone, pano mode, inference.

Counterpart of `panoswintransformerobjectdetection_tpu/models/panoswin.py`
(`sphere_bias`, `prepare_window_uv`, `WindowAttention`, `PanoSwinBlock`,
`BasicLayer`, `PanoSwinTransformer`).  Tokens stay (B, H, W, C) between
blocks.  The uv grid is side-band data, shared by the batch, and the
haversine couplings are computed once per stage and shift.  Window attention
is the JAX default `_attention_core_hip`, written as plain PyTorch: q * scale,
q.k in f32, plus the batch-shared bias (nW, h, O, O), f32 softmax, then @ v
in the compute type.  Only even depths are ported: an odd depth ends its
stage with a PitchAttention block, which is a later slice.
"""

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..geometry.sphere import haversine, make_uv_grid
from ..ops.windows import (make_relative_position_index, window_partition,
                           window_reverse, window_transition, window_transition_reverse)
from .layers import ConvStemPatchEmbed, LayerNorm, Mlp, PatchMerging, dense


def sphere_bias(alpha_table, beta_table, rel_index, hav):
    """haversine * alpha[rel] + beta[rel]: (nW, O, O) -> (nW, heads, O, O)."""
    alpha = alpha_table[rel_index]                   # (O, O, heads)
    beta = beta_table[rel_index]
    bias = hav[..., None] * alpha[None] + beta[None]
    return bias.permute(0, 3, 1, 2)


def prepare_window_uv(uv, shift_size: int, ws: int):
    """Haversine couplings of the windowed uv grid for one shift: (nW, O, O)."""
    uvt = window_transition(uv, shift_size)
    SH, SW = uvt.shape[0], uvt.shape[1]
    uvt = F.pad(uvt, (0, 0, 0, (-SW) % ws, 0, (-SH) % ws))
    uv_wins = window_partition(uvt[None], ws).reshape(-1, ws * ws, 2)
    return haversine(uv_wins, uv_wins)


class WindowAttention(nn.Module):
    """Window attention with the dual-table spherical bias."""

    def __init__(self, dim: int, window_size: int, num_heads: int, dtype=None):
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

    def forward(self, x, hav):
        """x: (B*nW, O, c) windows; hav: (nW, O, O)."""
        n, O, c = x.shape
        h = self.num_heads
        hd = c // h
        qkv = dense(self.qkv, x, self.dtype).reshape(n, O, 3, h, hd)
        q = qkv[:, :, 0] * hd ** -0.5
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
        bias = sphere_bias(self.sphere_position_alpha_table_Te,
                           self.sphere_position_beta_table_Te, self.rel_index, hav)
        nW = bias.shape[0]
        attn = (attn.reshape(n // nW, nW, h, O, O) + bias[None]).reshape(n, h, O, O)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("nhqk,nkhd->nqhd", attn.to(v.dtype), v)
        return dense(self.proj, out.reshape(n, O, c), self.dtype)


class PanoSwinBlock(nn.Module):
    """One (shifted) window block with the pano transition on every block."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, dtype=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.dtype = dtype

    def forward(self, x, hav):
        B, H, W, c = x.shape
        ws = self.window_size
        xn = self.norm1(x).to(self.dtype or torch.float32)
        xn = window_transition(xn, self.shift_size)
        SH, SW = xn.shape[1], xn.shape[2]
        xn = F.pad(xn, (0, 0, 0, (-SW) % ws, 0, (-SH) % ws))
        Hp, Wp = xn.shape[1], xn.shape[2]
        wins = window_partition(xn, ws).reshape(-1, ws * ws, c)
        y = self.attn(wins, hav)
        y = window_reverse(y.reshape(-1, ws, ws, c), ws, Hp, Wp)[:, :SH, :SW]
        y = window_transition_reverse(y, self.shift_size, width_was_odd=bool(W % 2))
        x = x + y[:, :H, :W]
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """One stage: alternating shift-0 and shift-ws/2 blocks, then PatchMerging."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, downsample: bool = True, dtype=None):
        super().__init__()
        if depth % 2:
            raise NotImplementedError(
                "odd stage depths end in a PitchAttention block, which is not "
                "ported yet (ROADMAP.md, Queue 1, item 11)")
        self.window_size = window_size
        self.blocks = nn.ModuleList(
            PanoSwinBlock(dim, num_heads, window_size,
                          0 if i % 2 == 0 else window_size // 2, mlp_ratio, dtype)
            for i in range(depth))
        self.downsample = PatchMerging(dim, dtype) if downsample else None

    def forward(self, x, uv):
        havs = {}
        for blk in self.blocks:
            if blk.shift_size not in havs:
                havs[blk.shift_size] = prepare_window_uv(uv, blk.shift_size, self.window_size)
            x = blk(x, havs[blk.shift_size])
        if self.downsample is None:
            return x, x, uv
        x_down = self.downsample(x)
        H2, W2 = x_down.shape[1], x_down.shape[2]
        return x, x_down, make_uv_grid(H2, W2, device=x.device)


class PanoSwinTransformer(nn.Module):
    """PanoSwin backbone: stem, optional absolute encoder, 4 stages, f32
    out-norms.  Returns NHWC maps (B, Hi, Wi, embed_dim * 2**i)."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, ape: bool = False,
                 out_indices: Sequence[int] = (0, 1, 2, 3), dtype=None):
        super().__init__()
        self.patch_embed = ConvStemPatchEmbed(patch_size, embed_dim, dtype)
        self.abs_encoder = nn.Linear(5, embed_dim) if ape else None
        n = len(depths)
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depths[i], num_heads[i], window_size,
                       mlp_ratio, downsample=i < n - 1, dtype=dtype)
            for i in range(n))
        self.out_indices = tuple(out_indices)
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    def forward(self, images):
        return self.forward_from_embed(self.patch_embed(images))

    def forward_from_embed(self, x):
        """Everything after the stem: x (B, H/4, W/4, embed_dim)."""
        B, H, W, C = x.shape
        uv = make_uv_grid(H, W, device=x.device)
        if self.abs_encoder is not None:
            u, v = uv[..., 0], uv[..., 1]
            xyz = torch.stack([torch.sin(u) * torch.sin(v), torch.cos(u) * torch.sin(v),
                               torch.cos(v)], -1)
            x = x + dense(self.abs_encoder, torch.cat([xyz, uv], -1), None)[None]
        outs = []
        for i, layer in enumerate(self.layers):
            x_out, x, uv = layer(x, uv)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x_out))
        return tuple(outs)


__all__ = ["sphere_bias", "prepare_window_uv", "WindowAttention", "PanoSwinBlock",
           "BasicLayer", "PanoSwinTransformer"]
