"""Stock Swin Transformer backbone (planar), as the COCO model zoo's Swin-T/S/B.

Counterpart of `panoswintransformerobjectdetection_tpu/models/swin.py`
(`SwinWindowAttention`, `SwinBlock`, `SwinTransformer`): a single 4 x 4
stride-4 conv with LayerNorm as the patch embed (`SingleConvPatchEmbed`),
one learned relative-position bias table a block, the cyclic shift with
the 9-region mask, PatchMerging between stages, and each stage's output
through its `norm{i}` in float32.  Module names are the reference
checkpoint's (`layers.{i}.blocks.{j}.attn.relative_position_bias_table`,
...), so a reference `.pth` loads with `load_state_dict`.

A Swin block is the planar PanoSwin block (pad, roll by -shift, mask
across the roll's seams, window attention, roll back, crop) with one bias
table in place of the spherical pair; its bias is the table gathered by
the relative-position index (the JAX package's one-hot `table_lookup` is a
TPU workaround).  Attention is plain PyTorch, as the JAX module's einsums
are: no Pallas kernel is on this path.
"""

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.windows import make_relative_position_index, swin_attention_mask
from .layers import LayerNorm, PatchMerging, SingleConvPatchEmbed
from .panoswin import PanoSwinBlock, PanoSwinTransformer, _WindowAttentionBase


class SwinWindowAttention(_WindowAttentionBase):
    """W-MSA with a single learned relative-position bias table."""

    def __init__(self, dim: int, window_size: int, num_heads: int, dtype=None,
                 fused: bool = False, qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__(dim, window_size, num_heads, dtype, fused, qkv_bias, qk_scale)
        t = (2 * window_size - 1) ** 2
        self.relative_position_bias_table = nn.Parameter(torch.zeros(t, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(
            make_relative_position_index(window_size)), persistent=False)

    def bias(self, hav=None) -> torch.Tensor:
        """(1, heads, O, O): table[rel_index], heads first."""
        return self.relative_position_bias_table[self.rel_index].permute(2, 0, 1)[None]


class SwinBlock(PanoSwinBlock):
    """One (shifted) Swin window block: the planar block with Swin's table."""

    attention = SwinWindowAttention

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift_size: int = 0,
                 mlp_ratio: float = 4.0, dtype=None, drop_path: float = 0.0,
                 qkv_bias: bool = True, qk_scale: Optional[float] = None):
        super().__init__(dim, num_heads, window_size, shift_size, mlp_ratio, dtype,
                         pano_mode=False, drop_path=drop_path, qkv_bias=qkv_bias,
                         qk_scale=qk_scale)


class SwinLayer(nn.Module):
    """One stage: blocks with shift 0 and window_size // 2 in turn, then
    PatchMerging (all stages but the last).

    `use_checkpoint`: while gradients are recorded, each block runs under
    `torch.utils.checkpoint`, as the JAX stage wraps it in `nn.remat`, with
    its two DropPath masks drawn before the call and handed in, as the
    PanoSwin stage does (`models/panoswin.BasicLayer`)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window_size: int,
                 mlp_ratio: float, downsample: bool, dtype, drop_path: Sequence[float],
                 qkv_bias: bool, qk_scale: Optional[float], use_checkpoint: bool = False):
        super().__init__()
        self.window_size = window_size
        self.use_checkpoint = use_checkpoint
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window_size, 0 if d % 2 == 0 else window_size // 2,
                      mlp_ratio, dtype, drop_path[d], qkv_bias, qk_scale)
            for d in range(depth))
        self.downsample = PatchMerging(dim, dtype) if downsample else None

    def forward(self, x):
        """(B, H, W, C) -> the stage's output, before its downsample."""
        ws = self.window_size
        H, W = x.shape[1], x.shape[2]
        masks = {}
        for blk in self.blocks:
            shift = blk.shift_size
            if shift and shift not in masks:
                masks[shift] = swin_attention_mask(H + (-H) % ws, W + (-W) % ws, ws, shift,
                                                   device=x.device)
            if self.use_checkpoint and torch.is_grad_enabled():
                keep = (blk.drop_path1.keep_mask(x), blk.drop_path2.keep_mask(x))
                x = checkpoint(blk, x, None, masks.get(shift), keep, use_reentrant=False,
                               preserve_rng_state=False)
            else:
                x = blk(x, None, masks.get(shift))
        return x


class SwinTransformer(nn.Module):
    """Swin-T/S/B/L backbone: NHWC maps (B, Hi, Wi, embed_dim * 2**i), float32,
    one for each of `out_indices`.

    `ape` adds the learned absolute position table of the pretraining size,
    resized to the patch grid by torch's bicubic `F.interpolate`, as the
    reference resizes it.  `drop_path_rate` is the last block's DropPath
    rate (train mode only); `set_drop_path_generator` gives every DropPath
    one explicit generator.  `use_checkpoint`: activation checkpointing of
    every block (`SwinLayer`).
    """

    def __init__(self, patch_size: int = 4, in_chans: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 mlp_ratio: float = 4.0, qkv_bias: bool = True,
                 qk_scale: Optional[float] = None, drop_path_rate: float = 0.2,
                 ape: bool = False, patch_norm: bool = True,
                 out_indices: Sequence[int] = (0, 1, 2, 3), pretrain_img_size: int = 224,
                 use_checkpoint: bool = False, dtype=None):
        super().__init__()
        self.patch_embed = SingleConvPatchEmbed(patch_size, embed_dim, in_chans, patch_norm,
                                                dtype)
        if ape:
            side = pretrain_img_size // patch_size
            self.absolute_pos_embed = nn.Parameter(torch.zeros(1, embed_dim, side, side))
        else:
            self.absolute_pos_embed = None
        n = len(depths)
        total = sum(depths)
        dpr = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        starts = [sum(depths[:i]) for i in range(n)]
        self.layers = nn.ModuleList(
            SwinLayer(embed_dim * 2 ** i, depths[i], num_heads[i], window_size, mlp_ratio,
                      i < n - 1, dtype, dpr[starts[i]:starts[i] + depths[i]], qkv_bias,
                      qk_scale, use_checkpoint)
            for i in range(n))
        self.out_indices = tuple(out_indices)
        for i in self.out_indices:
            self.add_module(f"norm{i}", LayerNorm(embed_dim * 2 ** i))

    set_drop_path_generator = PanoSwinTransformer.set_drop_path_generator

    def forward(self, images):
        return self.forward_from_embed(self.patch_embed(images))

    def forward_from_embed(self, x):
        """Everything after the patch embed: x (B, H/4, W/4, embed_dim)."""
        if self.absolute_pos_embed is not None:
            table = F.interpolate(self.absolute_pos_embed, size=tuple(x.shape[1:3]),
                                  mode="bicubic")
            x = x + table.permute(0, 2, 3, 1).to(x.dtype)
        outs = []
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i in self.out_indices:
                outs.append(getattr(self, f"norm{i}")(x))
            if layer.downsample is not None:
                x = layer.downsample(x)
        return tuple(outs)


__all__ = ["SwinWindowAttention", "SwinBlock", "SwinLayer", "SwinTransformer"]
