"""PanoSwin Transformer backbone, pano and planar modes.

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
In train mode the stem runs with live BatchNorm and every block's two
residual branches go through DropPath, whose rate rises linearly over the
blocks to `drop_path_rate`.  A stage of odd depth ends with a
`PitchAttention` block (queries and values from the map's windows, keys
from the same windows of the map rotated about a great circle), which has
no DropPath and no compute type: it runs in float32 whatever the detector's
type, as the JAX block does.
"""

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..geometry.resample import grid_sample_nhwc
from ..geometry.rotate import pano_rotate, rotation_grid
from ..geometry.sphere import haversine, make_uv_grid
from ..ops.fused_attention import packed_window_attention
from ..ops.windows import (make_relative_position_index, swin_attention_mask,
                           window_partition, window_reverse, window_transition,
                           window_transition_reverse)
from .layers import ConvStemPatchEmbed, DropPath, LayerNorm, Mlp, PatchMerging, dense

PI = math.pi
# PitchAttention's rotation axis (u, v): the reference's `np_v = -0.0001`.
PITCH_AXIS = (PI, -0.0001 * PI)


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


class _WindowAttentionBase(nn.Module):
    """qkv -> attention with a per-window bias and any mask -> proj; a
    subclass holds the bias tables and makes the bias (`bias`)."""

    def __init__(self, dim: int, window_size: int, num_heads: int, dtype=None,
                 fused: bool = False, qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qk_scale = qk_scale
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.dtype = dtype
        self.fused = fused

    def bias(self, hav) -> torch.Tensor:
        """(nW or 1, heads, O, O) attention bias."""
        raise NotImplementedError

    def forward(self, x, nW: int, hav=None, mask=None):
        """x: (B*nW, O, c) windows; hav: (nW, O, O) in pano mode, None in
        planar mode; mask: the planar shift mask (nW, O, O) or None."""
        n, O, c = x.shape
        h = self.num_heads
        hd = c // h
        scale = self.qk_scale or hd ** -0.5
        qkv = dense(self.qkv, x, self.dtype).reshape(n, O, 3, h, hd)
        bias = self.bias(hav).expand(nW, h, O, O)
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


class WindowAttention(_WindowAttentionBase):
    """Window attention with the dual-table spherical bias."""

    def __init__(self, dim: int, window_size: int, num_heads: int, dtype=None,
                 fused: bool = False, qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__(dim, window_size, num_heads, dtype, fused, qkv_bias, qk_scale)
        t = (2 * window_size - 1) ** 2
        self.sphere_position_alpha_table_Te = nn.Parameter(torch.zeros(t, num_heads))
        self.sphere_position_beta_table_Te = nn.Parameter(torch.zeros(t, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            make_relative_position_index(window_size)), persistent=False)

    def bias(self, hav) -> torch.Tensor:
        return sphere_bias(self.sphere_position_alpha_table_Te,
                           self.sphere_position_beta_table_Te, self.rel_index, hav)


class PanoSwinBlock(nn.Module):
    """One (shifted) window block.  Pano mode applies the pano transition on
    every block, shift 0 included, before padding; planar mode pads first,
    then rolls by -shift and masks across the roll's seams."""

    attention = WindowAttention

    def __init__(self, dim: int, num_heads: int, window_size: int, shift_size: int,
                 mlp_ratio: float = 4.0, dtype=None, pano_mode: bool = True,
                 fused: bool = False, drop_path: float = 0.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.pano_mode = pano_mode
        self.norm1 = LayerNorm(dim)
        self.attn = self.attention(dim, window_size, num_heads, dtype, fused, qkv_bias, qk_scale)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dtype)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        self.dtype = dtype

    def forward(self, x, hav=None, mask=None, keep_masks=(None, None)):
        """hav: pano couplings (nW, O, O); mask: planar shift mask or None;
        keep_masks: the two DropPaths' masks when drawn by the caller."""
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
        x = x + self.drop_path1(y[:, :H, :W], keep_masks[0])
        return x + self.drop_path2(self.mlp(self.norm2(x)), keep_masks[1])


class PitchAttention(nn.Module):
    """The block that ends a stage of odd depth (`PitchAttentionModule:990`
    of the reference): attention from the map's windows (queries, values)
    to the same windows of the map rotated about a great circle (keys).

    Kept from the JAX block: the residual is the post-norm features (the
    reference overwrites its shortcut in place with norm1); the uv grid goes
    through the same rotation and window resampling as the features, and
    the pano bias couples each window's uv with its rotated uv; planar mode
    keys the windows themselves, with the beta-only bias.  The attention is
    the plain one of the JAX `_attention_core` (never kernel K2), and every
    layer runs in float32 with no DropPath.  Parameters sit flat on the
    block, under the reference's keys.
    """

    def __init__(self, dim: int, num_heads: int, window_size: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 pano_mode: bool = True):
        super().__init__()
        t = (2 * window_size - 1) ** 2
        self.num_heads = num_heads
        self.window_size = window_size
        self.qk_scale = qk_scale
        self.pano_mode = pano_mode
        self.q_linear = nn.Linear(dim, dim, bias=qkv_bias)
        self.k_linear = nn.Linear(dim, dim, bias=qkv_bias)
        self.v_linear = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        self.sphere_position_alpha_table_Te = nn.Parameter(torch.zeros(t, num_heads))
        self.sphere_position_beta_table_Te = nn.Parameter(torch.zeros(t, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            make_relative_position_index(window_size)), persistent=False)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def window_grids(self, Hp: int, Wp: int, pad_r: int, pad_b: int, device) -> tuple:
        """The two grids of `PitchAttentionModule.get_rotated:1024`: the
        rotation of the whole padded map, (Hp, Wp, 2), and for each window
        the ws x ws samples of the rotated map around its rotated centre,
        (nH * nW, O, 2).  The centres ignore the pad (pad_r, pad_b); the
        rotated ones are flipped upside down, and wrapped at +-1."""
        ws = self.window_size
        nH, nW = Hp // ws, Wp // ws
        us = ((torch.arange(nW, dtype=torch.float32, device=device) + 0.5) / nW * 2.0
              * (1.0 - pad_r / Wp) - 1.0) * PI
        vs = ((torch.arange(nH, dtype=torch.float32, device=device) + 0.5) / nH
              * (1.0 - pad_b / Hp) - 0.5) * PI
        centers = torch.stack([us[None, :].expand(nH, nW), vs[:, None].expand(nH, nW)], -1)
        rc = pano_rotate(PITCH_AXIS, centers.reshape(-1, 2)).reshape(nH, nW, 2) / PI
        rc = torch.flip(rc * torch.tensor([1.0, -1.0], device=device), dims=(0,))
        rc = rc * torch.tensor([1.0, 2.0], device=device)
        ar = (torch.arange(ws, dtype=torch.float32, device=device) + 0.5 - 0.5 * ws) / Hp
        offsets = torch.stack([ar[:, None].expand(ws, ws), 2.0 * ar[None, :].expand(ws, ws)], -1)
        grids = (rc[:, :, None, None, :] + offsets).reshape(nH * nW, ws * ws, 2)
        grids = torch.where(grids <= -1.0, grids + 2.0, grids)
        grids = torch.where(grids >= 1.0, grids - 2.0, grids)
        return rotation_grid(Hp, Wp, PITCH_AXIS, device), grids

    def rotated_windows(self, x: torch.Tensor, grids: tuple) -> torch.Tensor:
        """x (B, Hp, Wp, C) rotated, then resampled window by window, laid out
        as a (B, Hp, Wp, C) map of windows."""
        B, Hp, Wp, C = x.shape
        ws = self.window_size
        image_grid, window_grids = grids
        rotated = grid_sample_nhwc(x, image_grid.expand(B, Hp, Wp, 2))
        s, O, _ = window_grids.shape
        sampled = grid_sample_nhwc(rotated, window_grids.expand(B, s, O, 2))
        sampled = sampled.reshape(B, Hp // ws, Wp // ws, ws, ws, C).permute(0, 1, 3, 2, 4, 5)
        return sampled.reshape(B, Hp, Wp, C)

    def forward(self, x, uv):
        """x (B, H, W, c) in any type; uv (H, W, 2).  Returns float32."""
        B, H, W, c = x.shape
        ws = self.window_size
        xn = self.norm1(x)
        shortcut = xn
        pad_b, pad_r = (-H) % ws, (-W) % ws
        xn = F.pad(xn, (0, 0, 0, pad_r, 0, pad_b))
        uvp = F.pad(uv, (0, 0, 0, pad_r, 0, pad_b))[None]
        Hp, Wp = xn.shape[1], xn.shape[2]
        if self.pano_mode:
            grids = self.window_grids(Hp, Wp, pad_r, pad_b, x.device)
            rotated, rot_uv = self.rotated_windows(xn, grids), self.rotated_windows(uvp, grids)
        else:
            rotated, rot_uv = xn, uvp
        O = ws * ws
        wins = window_partition(xn, ws).reshape(-1, O, c)
        rwins = window_partition(rotated, ws).reshape(-1, O, c)
        n = wins.shape[0]
        h = self.num_heads
        hd = c // h
        scale = self.qk_scale or hd ** -0.5
        q = dense(self.q_linear, wins, None).reshape(n, O, h, hd).transpose(1, 2)
        k = dense(self.k_linear, rwins, None).reshape(n, O, h, hd).transpose(1, 2)
        v = dense(self.v_linear, wins, None).reshape(n, O, h, hd).transpose(1, 2)
        nW = (Hp // ws) * (Wp // ws)
        hav = None
        if self.pano_mode:
            hav = haversine(window_partition(uvp, ws).reshape(nW, O, 2),
                            window_partition(rot_uv, ws).reshape(nW, O, 2))
        bias = sphere_bias(self.sphere_position_alpha_table_Te,
                           self.sphere_position_beta_table_Te, self.rel_index, hav)
        attn = torch.einsum("nhqd,nhkd->nhqk", q * scale, k)
        attn = attn.reshape(n // nW, nW, h, O, O) + bias.expand(nW, h, O, O)[None]
        attn = torch.softmax(attn.reshape(n, h, O, O), dim=-1)
        out = torch.einsum("nhqk,nhkd->nhqd", attn, v).transpose(1, 2).reshape(n, O, c)
        out = dense(self.proj, out, None)
        y = window_reverse(out.reshape(-1, ws, ws, c), ws, Hp, Wp)[:, :H, :W]
        x = shortcut + y
        return x + self.mlp(self.norm2(x))


class BasicLayer(nn.Module):
    """One stage: alternating shift-0 and shift-ws/2 blocks, a PitchAttention
    block after them when the depth is odd, then PatchMerging.

    `use_checkpoint`: while gradients are recorded, each window block runs
    under `torch.utils.checkpoint` (its activations are recomputed in the
    backward pass), as the JAX stage wraps it in `nn.remat`; PitchAttention
    is not wrapped, as in JAX.  The block's two DropPath masks are drawn
    before the checkpointed call, in the order the plain path draws them,
    and handed in: the recompute then sees the same masks, whatever
    generator they come from, and the gradients are the plain path's."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float = 4.0, downsample: bool = True, dtype=None,
                 pano_mode: bool = True, fused: bool = False,
                 drop_path: Sequence[float] = (), qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, use_checkpoint: bool = False):
        super().__init__()
        self.window_size = window_size
        self.pano_mode = pano_mode
        self.use_checkpoint = use_checkpoint
        depth_swin = depth - depth % 2
        blocks = [PanoSwinBlock(dim, num_heads, window_size,
                                0 if i % 2 == 0 else window_size // 2, mlp_ratio, dtype,
                                pano_mode, fused, drop_path[i] if drop_path else 0.0,
                                qkv_bias, qk_scale)
                  for i in range(depth_swin)]
        if depth % 2:
            blocks.append(PitchAttention(dim, num_heads, window_size, mlp_ratio, qkv_bias,
                                         qk_scale, pano_mode))
        self.blocks = nn.ModuleList(blocks)
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
            if isinstance(blk, PitchAttention):
                x = blk(x, uv)
                continue
            if blk.shift_size not in ctx:
                ctx[blk.shift_size] = self._window_context(uv, blk.shift_size, x.shape[1],
                                                           x.shape[2])
            if self.use_checkpoint and torch.is_grad_enabled():
                # nothing inside the block draws random numbers, so no RNG
                # state needs saving for the recompute
                keep = (blk.drop_path1.keep_mask(x), blk.drop_path2.keep_mask(x))
                x = checkpoint(blk, x, *ctx[blk.shift_size], keep, use_reentrant=False,
                               preserve_rng_state=False)
            else:
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
    window block's attention through kernel K2.  `drop_path_rate` is the last
    block's DropPath rate (train mode only); `set_drop_path_generator` gives
    every DropPath one explicit generator.  The options of the JAX module
    that a config may set: `qkv_bias` and `qk_scale` (window and pitch
    attention), `patch_norm` (the stem's LayerNorm), `in_chans` (the stem's
    input channels; only 3 channels run kernel K1, as in the JAX module),
    `fuse_bn` (the checkpoint's stem has its BatchNorm folded into the
    convs: the BatchNorm modules stay, for the state dict's keys, and are
    not applied); `use_checkpoint` (activation checkpointing of every window
    block, `BasicLayer`).
    """

    def __init__(self, patch_size: int = 4, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, ape: bool = False,
                 out_indices: Sequence[int] = (0, 1, 2, 3), pano_mode: bool = True,
                 fused_attention: bool = False, drop_path_rate: float = 0.2, dtype=None,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None,
                 patch_norm: bool = True, in_chans: int = 3, fuse_bn: bool = False,
                 use_checkpoint: bool = False):
        super().__init__()
        self.patch_embed = ConvStemPatchEmbed(patch_size, embed_dim, dtype, use_norm=patch_norm,
                                              in_chans=in_chans, fuse_bn=fuse_bn)
        self.abs_encoder = nn.Linear(5, embed_dim) if ape else None
        self.pano_mode = pano_mode
        n = len(depths)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        starts = [sum(depths[:i]) for i in range(n)]
        self.layers = nn.ModuleList(
            BasicLayer(embed_dim * 2 ** i, depths[i], num_heads[i], window_size,
                       mlp_ratio, downsample=i < n - 1, dtype=dtype, pano_mode=pano_mode,
                       fused=fused_attention, drop_path=dpr[starts[i]:starts[i] + depths[i]],
                       qkv_bias=qkv_bias, qk_scale=qk_scale, use_checkpoint=use_checkpoint)
            for i in range(n))
        self.out_indices = tuple(out_indices)
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    def set_drop_path_generator(self, generator: Optional[torch.Generator]) -> None:
        for m in self.modules():
            if isinstance(m, DropPath):
                m.generator = generator

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
           "PitchAttention", "BasicLayer", "PanoSwinTransformer"]
