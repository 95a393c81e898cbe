"""PanoSwin v-variant: the backbone that the reference's detection configs
build (`panoswin_transformer.py`, wired by
`configs/_base_/models/faster_rcnn_panoswin_fpn.py:5`).

Counterpart of `panoswintransformerobjectdetection_tpu/models/panoswin_v2.py`
(`patch_v_map`, `make_uv_from_v`, `right_u_flag`, `pano_transition_v2`,
`WindowAttentionV2`, `PanoSwinBlockV2`, `seam_stitched_mask`,
`PixelTransformerV2`, `PatchEmbedV2`, `PanoSwinTransformerV2`).  What sets it
apart from the simple variant (`models/panoswin.py`):

- per-image partial panoramas: `pano_ratio_v` (B, 3) = (v0, v1, ori_h) gives
  each image its latitude map v (B, H, W), carried beside the tokens and
  averaged 2 x 2 at each PatchMerging; a block rebuilds uv from v, with
  u = column * |v[1] - v[0]|;
- the sphere bias is the product hav * alpha * beta, for the relative index
  and for its transpose, blended by the "right_u" hemisphere flag of each
  window's centre token, and added through the reference's literal
  `transpose(1, 3)`, which indexes it (key, query): kept as it is, so that a
  reference checkpoint computes what it computed there;
- a pano block with shift 0 makes no spatial transform; a shifted one rolls
  W, appends uv and the flag, pads an odd W, turns the map pole-centred
  (`ew2ns`), rolls H, and pads to whole windows after that;
- planar blocks (`win_trans_type=0`) keep a Swin mask per image, whose
  regions are stitched across the seam where the image wraps round; in a
  shifted planar block the blend weight is the v channel, not the flag (the
  reference appends no flag there): kept as well;
- the stem is fixed at 3 -> 32 -> 64 -> embed (`'cnn'`, kernel K1 at eval
  time, as the simple stem's) or a one-layer transformer a patch (`'tf'`),
  optionally after the basketball warp; `ape` adds `coord_encoder(xyz)`.

This attention is plain PyTorch, as the JAX package's is XLA einsums (its
per-image bias does not take the fused kernel K2's batch-shared one).  Maps
are (B, H, W, C); the out-norms return float32.
"""

import functools
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..geometry.axis import ew2ns, ns2we
from ..geometry.basketball import correct_center_traced
from ..geometry.sphere import haversine
from ..ops.windows import (make_relative_position_index, swin_attention_mask,
                           window_partition, window_reverse)
from .layers import ConvStemPatchEmbed, DropPath, LayerNorm, Mlp, PatchMerging, dense

PI = math.pi


def patch_v_map(H: int, W: int, pano_ratio_v: torch.Tensor, patch: int) -> torch.Tensor:
    """Per-token latitudes (B, H, W) of the rows of a (B, 3) ratio batch:
    gap = patch / ori_h * pi * (v1 - v0), v[i] = (i + 0.5) * gap +
    (v0 - 0.5) * pi."""
    r = pano_ratio_v.float()
    v0, v1, ori_h = r[:, 0:1], r[:, 1:2], r[:, 2:3]
    gap = patch / ori_h * PI * (v1 - v0)
    v = (torch.arange(H, dtype=torch.float32, device=r.device) + 0.5) * gap + (v0 - 0.5) * PI
    return v[:, :, None].expand(-1, H, W)


def make_uv_from_v(v: torch.Tensor) -> torch.Tensor:
    """(B, H, W) latitudes -> (B, H, W, 2) uv: gap = |v[:, 1, 0] - v[:, 0, 0]|
    per image (row 0 twice, so gap 0, when H is 1, as JAX's clamped index
    reads it), u = column * gap."""
    B, H, W = v.shape
    gap = torch.abs(v[:, min(1, H - 1), 0] - v[:, 0, 0])
    u = torch.arange(W, dtype=torch.float32, device=v.device)[None, None, :] * gap[:, None, None]
    return torch.stack([u.expand(B, H, W), v], dim=-1)


def right_u_flag(H: int, W: int, device=None) -> torch.Tensor:
    """(H, W) hemisphere flag: 1 on the left (W + 1) // 2 columns, else 0."""
    f = torch.zeros((H, W), dtype=torch.float32, device=device)
    f[:, :(W + 1) // 2] = 1.0
    return f


def _ew2ns_roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Pad an odd W by one zero column, turn the map pole-centred, roll H."""
    if x.shape[2] % 2:
        x = F.pad(x, (0, 0, 0, 1))
    return torch.roll(ew2ns(x), shift, dims=1)


def pano_transition_v2(xu: torch.Tensor, shift: int, reverse: bool = False) -> torch.Tensor:
    """The spatial part of the v-variant's pano transition of (B, H, W, C):
    roll W by shift, pad an odd W, `ew2ns`, roll H by shift; the reverse
    rolls H back, pads an odd H, `ns2we`, rolls W back.  The reverse rolls
    the width that still holds the forward's pad column and leaves the crop
    to the caller, as the JAX function does."""
    if not reverse:
        return _ew2ns_roll(torch.roll(xu, shift, dims=2), shift)
    xu = torch.roll(xu, -shift, dims=1)
    if xu.shape[1] % 2:
        xu = F.pad(xu, (0, 0, 0, 0, 0, 1))
    return torch.roll(ns2we(xu), -shift, dims=2)


@functools.lru_cache(maxsize=None)
def seam_stitched_mask(Hp: int, Wp: int, ws: int, shift: int) -> np.ndarray:
    """The Swin mask (nW, O, O) whose first-row region ids are replaced by
    the last row's, so that the regions join across the seam; numpy."""
    img = np.zeros((Hp, Wp), np.int32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    first = np.unique(img[0])
    last = np.unique(img[-1])
    stitched = img.copy()
    for k, vv in zip(first, last):
        stitched[img == k] = vv
    m = stitched.reshape(Hp // ws, ws, Wp // ws, ws).transpose(0, 2, 1, 3)
    m = m.reshape(-1, ws * ws)
    diff = m[:, None, :] - m[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def stage_masks(pano_ratio_v: torch.Tensor, width: int, patch: int, Hp: int, Wp: int,
                ws: int, shift: int) -> torch.Tensor:
    """Each image's shifted-window mask (B, nW, O, O): the seam-stitched one
    where the image wraps round (u_len + gap / 2 > 2 pi, u_len = width /
    patch * gap, gap = patch / ori_h * pi * (v1 - v0); `width` is the
    network input's), else the Swin mask."""
    r = pano_ratio_v.float()
    gap = patch / r[:, 2] * PI * (r[:, 1] - r[:, 0])
    side = (width / patch) * gap + 0.5 * gap > 2 * PI
    base = swin_attention_mask(Hp, Wp, ws, shift, device=r.device)
    stitched = torch.from_numpy(seam_stitched_mask(Hp, Wp, ws, shift)).to(r.device)
    return torch.where(side[:, None, None, None], stitched[None], base[None])


def downsample_v(v: torch.Tensor) -> torch.Tensor:
    """The latitude map at PatchMerging: odd sides edge-replicated, then the
    2 x 2 mean."""
    if v.shape[1] % 2:
        v = torch.cat([v, v[:, -1:]], 1)
    if v.shape[2] % 2:
        v = torch.cat([v, v[:, :, -1:]], 2)
    return (v[:, 0::2, 0::2] + v[:, 1::2, 0::2] + v[:, 0::2, 1::2] + v[:, 1::2, 1::2]) * 0.25


class WindowAttentionV2(nn.Module):
    """qkv -> q.k in f32 + the sphere bias (or, with no uv, the Swin table)
    + any per-image mask -> f32 softmax -> @ v -> proj.  Parameters under
    the reference's keys."""

    def __init__(self, dim: int, window_size: int, num_heads: int, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, dtype=None):
        super().__init__()
        t = (2 * window_size - 1) ** 2
        self.window_size = window_size
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.dtype = dtype
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(t, num_heads))
        self.sphere_position_alpha_table = nn.Parameter(torch.zeros(t, num_heads))
        self.sphere_position_beta_table = nn.Parameter(torch.zeros(t, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            make_relative_position_index(window_size)), persistent=False)

    def sphere_bias(self, uvr: torch.Tensor) -> torch.Tensor:
        """uvr (n, O, 3) = (u, v, blend weight) of each window's tokens ->
        (n, heads, O, O).  For t in (index, index transposed): P_t = hav *
        alpha[t] * beta[t]; the centre token's weight r blends r P_0 +
        (1 - r) P_1, whose (query, key) axes are then swapped."""
        O = uvr.shape[1]
        hav = haversine(uvr[..., :2], uvr[..., :2])[:, None]             # (n, 1, O, O)
        right = uvr[:, O // 2, 2][:, None, None, None]
        alpha = self.sphere_position_alpha_table.t()[:, self.rel_index]  # (h, O, O)
        beta = self.sphere_position_beta_table.t()[:, self.rel_index]
        p0 = hav * alpha * beta
        p1 = hav * alpha.transpose(1, 2) * beta.transpose(1, 2)
        return (right * p0 + (1 - right) * p1).transpose(2, 3)

    def forward(self, x: torch.Tensor, uvr: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B * nW, O, c); uvr (B * nW, O, 3) or None; mask (B, nW, O, O)
        or None."""
        n, O, c = x.shape
        h = self.num_heads
        hd = c // h
        scale = self.qk_scale or hd ** -0.5
        qkv = dense(self.qkv, x, self.dtype).reshape(n, O, 3, h, hd)
        q = qkv[:, :, 0] * scale
        k, v = qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float())
        if uvr is None:
            attn = attn + self.relative_position_bias_table.t()[:, self.rel_index][None]
        else:
            attn = attn + self.sphere_bias(uvr)
        if mask is not None:
            B, nW = mask.shape[:2]
            attn = (attn.reshape(B, nW, h, O, O) + mask[:, :, None]).reshape(n, h, O, O)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("nhqk,nkhd->nqhd", attn.to(v.dtype), v)
        return dense(self.proj, out.reshape(n, O, c), self.dtype)


class PanoSwinBlockV2(nn.Module):
    """One (shifted) window block of the v-variant (module docstring);
    `win_trans_type` 1 is the pano layout, 0 the planar one."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path: float = 0.0,
                 win_trans_type: int = 1, dtype=None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.win_trans_type = win_trans_type
        self.dtype = dtype
        self.norm1 = LayerNorm(dim)
        self.attn = self.attention(dim, window_size, num_heads, qkv_bias, qk_scale, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    attention = WindowAttentionV2

    def _windows(self, x: torch.Tensor, side: torch.Tensor, mask) -> torch.Tensor:
        """Attention over the whole windows of x (B, Hp, Wp, c) with its side
        band (B, Hp, Wp, k); returns (B, Hp, Wp, c)."""
        ws = self.window_size
        B, Hp, Wp, c = x.shape
        wins = window_partition(x, ws).reshape(-1, ws * ws, c)
        sides = window_partition(side, ws).reshape(-1, ws * ws, side.shape[-1])
        out = self.attn(wins, sides, mask)
        return window_reverse(out.reshape(-1, ws, ws, c), ws, Hp, Wp)

    def mix(self, xn: torch.Tensor, v: torch.Tensor, mask) -> torch.Tensor:
        """The attention branch of the normed map xn (B, H, W, c)."""
        B, H, W, _ = xn.shape
        ws, s = self.window_size, self.shift_size
        uv = make_uv_from_v(v)
        if self.win_trans_type == 0:
            pad = (0, 0, 0, (-W) % ws, 0, (-H) % ws)
            xp, uvp = F.pad(xn, pad), F.pad(uv, pad)
            Hp, Wp = xp.shape[1], xp.shape[2]
            # a shifted block blends on v: the reference appends no flag there
            third = uvp[..., 1:2] if s else right_u_flag(Hp, Wp, xn.device)[None, :, :, None] \
                .expand(B, Hp, Wp, 1)
            side = torch.cat([uvp, third], -1)
            if s:
                xp = torch.roll(xp, (-s, -s), (1, 2))
                side = torch.roll(side, (-s, -s), (1, 2))
            y = self._windows(xp, side, mask if s else None)
            if s:
                y = torch.roll(y, (s, s), (1, 2))
            return y[:, :H, :W]
        flag = right_u_flag(H, W, xn.device)[None, :, :, None].expand(B, H, W, 1)
        if s:
            xt = pano_transition_v2(xn, s)
            side = _ew2ns_roll(torch.cat([torch.roll(uv, s, dims=2), flag], -1), s)
        else:
            xt, side = xn, torch.cat([uv, flag], -1)
        SH, SW = xt.shape[1], xt.shape[2]
        pad = (0, 0, 0, (-SW) % ws, 0, (-SH) % ws)
        y = self._windows(F.pad(xt, pad), F.pad(side, pad), None)[:, :SH, :SW]
        if s:
            y = pano_transition_v2(y, s, reverse=True)
        return y[:, :H, :W]

    def forward(self, x, v, mask=None, keep_masks=(None, None)):
        """x (B, H, W, c); v (B, H, W) latitudes; mask (B, nW, O, O) for the
        shifted blocks that take one; keep_masks: the two DropPaths' masks
        when drawn by the caller."""
        xn = self.norm1(x).to(self.dtype or torch.float32)
        x = x + self.drop_path1(self.mix(xn, v, mask), keep_masks[0])
        return x + self.drop_path2(self.mlp(self.norm2(x)), keep_masks[1])


class _SelfAttention(nn.Module):
    """The parameters of `torch.nn.MultiheadAttention`, under its names."""

    def __init__(self, d: int):
        super().__init__()
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d))
        self.out_proj = nn.Linear(d, d)
        nn.init.xavier_uniform_(self.in_proj_weight)


class _EncoderLayer(nn.Module):
    """The parameters of a `torch.nn.TransformerEncoderLayer`, under its names."""

    def __init__(self, d: int):
        super().__init__()
        self.self_attn = _SelfAttention(d)
        self.linear1 = nn.Linear(d, d)
        self.linear2 = nn.Linear(d, d)
        self.norm1 = LayerNorm(d)
        self.norm2 = LayerNorm(d)


class _Encoder(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.layers = nn.ModuleList([_EncoderLayer(d)])


class PixelTransformerV2(nn.Module):
    """The `'tf'` patch embed: each patch's p * p pixels as a sequence,
    Linear(in_chans -> d) (`preprocess_nouv`) + a learned position table,
    one post-norm encoder layer (8 heads, ReLU FFN of width d), then the sum
    over the sequence.  A patch's pixels are strided by the patch count (the
    reference's `(p1 w) (p2 h)` split, p outer), not a contiguous block: kept
    as it is.  (B, H, W, C) -> (B, H / p, W / p, d)."""

    def __init__(self, embed_dim: int = 96, patch_size: int = 4, in_chans: int = 3,
                 num_heads: int = 8, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.num_heads = num_heads
        self.dtype = dtype
        self.preprocess_nouv = nn.Sequential(nn.Linear(in_chans, embed_dim))
        self.pos_embedding = nn.Parameter(torch.randn(1, patch_size * patch_size, embed_dim))
        self.encoder = _Encoder(embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p, nh, dt = self.patch_size, self.num_heads, self.dtype
        B, H, W, C = x.shape
        nH, nW = H // p, W // p
        x = x.reshape(B, p, nH, p, nW, C).permute(0, 2, 4, 1, 3, 5).reshape(-1, p * p, C)
        x = dense(self.preprocess_nouv[0], x, dt)
        x = x + self.pos_embedding.to(x.dtype)
        layer = self.encoder.layers[0]
        sa = layer.self_attn
        N, L, d = x.shape
        hd = d // nh
        qkv = x @ sa.in_proj_weight.t().to(x.dtype) + sa.in_proj_bias.to(x.dtype)
        q, k, v = (t.reshape(N, L, nh, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
        attn = torch.softmax((q * hd ** -0.5 @ k.transpose(2, 3)).float(), dim=-1).to(x.dtype)
        o = (attn @ v).transpose(1, 2).reshape(N, L, d)
        x = layer.norm1(x + dense(sa.out_proj, o, dt))
        f = dense(layer.linear2, torch.relu(dense(layer.linear1, x, dt)), dt)
        x = layer.norm2(x + f)
        return x.sum(dim=1).reshape(B, nH, nW, d)


class PatchEmbedV2(ConvStemPatchEmbed):
    """The v-variant's patch embed: the input zero-padded to whole patches,
    the optional basketball warp (`basketball_trans`, each image at its own
    ratio; (0, 1, H) by default), then `'cnn'`, the stem 3 -> 32 -> 64 ->
    embed of `ConvStemPatchEmbed` (kernel K1 at eval time, live BatchNorm in
    training), or `'tf'`, `PixelTransformerV2` under `proj`; then the
    LayerNorm (`use_norm`)."""

    def __init__(self, patch_size: int = 4, embed_dim: int = 96, use_norm: bool = True,
                 emb_conv_type: str = "cnn", basketball_trans: bool = False, dtype=None,
                 in_chans: int = 3):
        if emb_conv_type not in ("cnn", "tf"):
            raise ValueError(f"emb_conv_type must be 'cnn' or 'tf', got {emb_conv_type!r}")
        super().__init__(patch_size, embed_dim, dtype, use_norm, in_chans,
                         stem_channels=(32, 64))
        self.emb_conv_type = emb_conv_type
        self.basketball_trans = basketball_trans
        if emb_conv_type == "tf":
            self.proj = PixelTransformerV2(embed_dim, patch_size, in_chans, dtype=dtype)

    def forward(self, x, pano_ratio_v: Optional[torch.Tensor] = None):
        ps = self.patch_size
        x = x.to(self.dtype or x.dtype)
        B, H, W, _ = x.shape
        x = F.pad(x, (0, 0, 0, (-W) % ps, 0, (-H) % ps))
        if self.basketball_trans:
            if pano_ratio_v is None:
                pano_ratio_v = torch.tensor([[0.0, 1.0, float(H)]], device=x.device).expand(B, 3)
            x = correct_center_traced(x, ps, pano_ratio_v)
        if self.emb_conv_type == "cnn":
            return super().forward(x)
        x = self.proj(x)
        if self.norm is not None:
            x = self.norm(x)
        return x.to(self.dtype or x.dtype)


class _Stage(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class PanoSwinTransformerV2(nn.Module):
    """The v-variant backbone: `PatchEmbedV2`, the optional `coord_encoder`
    on the xyz of a latitude map at patch size 1 over the embed's grid, four
    stages of `PanoSwinBlockV2` (shift 0, then ws // 2, ...), each image's
    latitude map averaged down at every PatchMerging, float32 out-norms.

    `pano_ratio_v` (B, 3) = (v0, v1, ori_h) per image; (0, 1, H0) by default,
    H0 the input's height.  A planar stage's shifted blocks take each image's
    mask (`stage_masks`, from the input's width).  `use_checkpoint`
    recomputes every block in the backward pass, its DropPath masks drawn
    before it; `set_drop_path_generator` gives every DropPath one explicit
    generator.  `takes_ratio`: a detector hands this backbone its batch's
    ratios (the JAX `extract_feat` does so for this type only)."""

    block = PanoSwinBlockV2
    takes_ratio = True

    def __init__(self, patch_size: int = 4, in_chans: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.2,
                 ape: bool = False, patch_norm: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3), win_trans_type: int = 1,
                 emb_conv_type: str = "cnn", basketball_trans: bool = False,
                 use_checkpoint: bool = False, dtype=None):
        super().__init__()
        if win_trans_type not in (0, 1):
            raise ValueError(f"win_trans_type must be 0 or 1, got {win_trans_type!r}")
        self.patch_size = patch_size
        self.window_size = window_size
        self.win_trans_type = win_trans_type
        self.use_checkpoint = use_checkpoint
        self.patch_embed = PatchEmbedV2(patch_size, embed_dim, patch_norm, emb_conv_type,
                                        basketball_trans, dtype, in_chans)
        self.coord_encoder = nn.Linear(3, embed_dim) if ape else None
        n = len(depths)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        stages = []
        for i in range(n):
            dim, start = embed_dim * 2 ** i, sum(depths[:i])
            blocks = [self.block(dim, num_heads[i], window_size,
                                 0 if d % 2 == 0 else window_size // 2, mlp_ratio, qkv_bias,
                                 qk_scale, dpr[start + d], win_trans_type, dtype)
                      for d in range(depths[i])]
            stages.append(_Stage(blocks, PatchMerging(dim, dtype) if i < n - 1 else None))
        self.layers = nn.ModuleList(stages)
        self.out_indices = tuple(out_indices)
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    def set_drop_path_generator(self, generator: Optional[torch.Generator]) -> None:
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = generator

    @staticmethod
    def pano_ratio(images: torch.Tensor,
                   pano_ratio_v: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The (B, 3) float32 ratios on the images' device: the given ones,
        or (0, 1, H0) for every image."""
        if pano_ratio_v is None:
            return torch.tensor([[0.0, 1.0, float(images.shape[1])]],
                                device=images.device).expand(images.shape[0], 3)
        return torch.as_tensor(pano_ratio_v, dtype=torch.float32, device=images.device)

    def masks_needed(self, shift: int) -> bool:
        """Whether the shifted blocks take the per-image mask."""
        return shift > 0 and self.win_trans_type == 0

    def forward(self, images, pano_ratio_v=None):
        ratio = self.pano_ratio(images, pano_ratio_v)
        return self.forward_from_embed(self.patch_embed(images, ratio), ratio, images.shape[2])

    def forward_from_embed(self, x, pano_ratio_v, width: int):
        """Everything after the stem: x (B, H0/p, W0/p, embed_dim), the
        batch's (B, 3) ratios and the input's width W0."""
        B, H, W, _ = x.shape
        p, ws = self.patch_size, self.window_size
        v = patch_v_map(H, W, pano_ratio_v, p)
        if self.coord_encoder is not None:
            uv = make_uv_from_v(patch_v_map(H, W, pano_ratio_v, 1))
            u, lat = uv[..., 0], uv[..., 1]
            xyz = torch.stack([torch.sin(u) * torch.sin(lat), torch.cos(u) * torch.sin(lat),
                               torch.cos(lat)], -1)
            x = x + dense(self.coord_encoder, xyz, None)
        outs = []
        for i, layer in enumerate(self.layers):
            mask = None
            if self.masks_needed(ws // 2):
                mask = stage_masks(pano_ratio_v, width, p, -(-H // ws) * ws, -(-W // ws) * ws,
                                   ws, ws // 2)
            for blk in layer.blocks:
                m = mask if blk.shift_size else None
                if self.use_checkpoint and torch.is_grad_enabled():
                    keep = (blk.drop_path1.keep_mask(x), blk.drop_path2.keep_mask(x))
                    x = checkpoint(blk, x, v, m, keep, use_reentrant=False,
                                   preserve_rng_state=False)
                else:
                    x = blk(x, v, m)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
            if layer.downsample is not None:
                x = layer.downsample(x)
                v = downsample_v(v)
                H, W = x.shape[1], x.shape[2]
        return tuple(outs)


__all__ = ["patch_v_map", "make_uv_from_v", "right_u_flag", "pano_transition_v2",
           "seam_stitched_mask", "stage_masks", "downsample_v", "WindowAttentionV2",
           "PanoSwinBlockV2", "PixelTransformerV2", "PatchEmbedV2", "PanoSwinTransformerV2"]
