"""Parameters between the JAX package's variable trees and the port's
state dicts, reference-format `.pth` files, training checkpoints, and
BatchNorm folding for inference.

`from_jax_variables` is the inverse of `convert_detector` in
`panoswintransformerobjectdetection_tpu/runtime/checkpoint.py`: it takes the
(params, batch_stats) trees of a JAX `PanoFasterRCNN` or `MaskRCNN`, with a
PanoSwin (the simple variant, or the v-variant and its v1 revision,
`from_jax_panoswin_v2_backbone`), a stock Swin, or a ResNet, ResNeXt,
RegNet, Res2Net, ResNeSt, TridentResNet or HRNet backbone
(`from_jax_cnn_backbone`), an FPN or HRFPN neck, and the mask-IoU head of
a `MaskScoringRCNN`, as numpy arrays and returns a state dict
in the reference's key layout, which the port's detector loads with
`load_state_dict`.  Layouts: conv HWIO -> OIHW, Dense (in, out) -> Linear
(out, in), LayerNorm scale -> weight, `shared_fc0`'s input reordered from
the JAX (h, w, C) flatten to the reference's (C, h, w), and the mask head's
`nn.ConvTranspose` kernel (kh, kw, in, out) flipped in both spatial axes to
`ConvTranspose2d`'s (in, out, kh, kw) (flax's transposed conv does not flip
its kernel; torch's does).  A cascade's `cascade_head_{t}` goes to
`roi_head.bbox_head.{t}`; its `bbox_head_m`, which no cascade stage runs, is
left out.  The JAX `convert_detector` converts no mask
head key, so the JAX package cannot load a reference Mask R-CNN `.pth`
whole, and its `load_weights` reads every backbone but PanoSwin's with the
Swin keys, so it cannot load a reference ResNet (or HRNet) detector `.pth`
either, and it has no HRNet or trident converter; the port loads each with
`load_state_dict`.

A reference checkpoint loads without a converter, since the port's keys
are the reference's (`load_torch_state_dict`, `load_reference_weights`,
`load_backbone_weights` for a backbone's own checkpoint: a Swin or
PanoSwin one, a torchvision or mmdet ResNet(-eXt) one, or a pycls RegNet
one through `regnet_from_pycls`, the mapping that
`tools/regnet2pytorch.py` writes out);
`save_checkpoint` and `load_checkpoint` keep a training run's model,
optimizer, schedule, step and host random states (the JAX package's orbax
state, here through `torch.save`).
"""

import math
import os
import re
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn as nn

from ..geometry.resample import _torch_cubic_weights
from ..ops.stem_conv import BN_EPS, fold_bn
from ..parallel.dist import rank, world

# The file names behind the `torchvision://` names of the reference's
# checkpoint loader (`mmcv_custom/checkpoint.py`); the port downloads none.
TORCHVISION_FILES = {"resnet18": "resnet18-f37072fd.pth", "resnet50": "resnet50-0676ba61.pth",
                     "resnet101": "resnet101-63fe2227.pth",
                     "resnext101_32x8d": "resnext101_32x8d-8ba56ff5.pth"}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, key, p):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _conv(sd, key, p):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _ln(sd, key, p):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def _bn(sd, key, p, s, channels: int):
    """A BatchNorm's entries; the identity where the JAX stem has none
    (`fuse_bn=True`: the port keeps the module for its keys)."""
    if p is None:
        p = {"scale": np.ones(channels), "bias": np.zeros(channels)}
        s = {"mean": np.zeros(channels), "var": np.ones(channels)}
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])
    sd[key + ".running_mean"] = _t(s["mean"])
    sd[key + ".running_var"] = _t(s["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0)


def from_jax_backbone(params: Dict[str, Any],
                      batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `PanoSwinTransformer` variables -> the port backbone's state dict.
    A stage's last block is a PitchAttention block when it has `q_linear`."""
    sd: Dict[str, torch.Tensor] = {}
    pe, pe_stats = params["patch_embed"], batch_stats.get("patch_embed", {})
    for conv, bn, conv_key, bn_key in (("conv0", "bn0", "proj.0", "proj.1"),
                                       ("conv1", "bn1", "proj.3", "proj.4")):
        _conv(sd, "patch_embed." + conv_key, pe[conv])
        _bn(sd, "patch_embed." + bn_key, pe.get(bn), pe_stats.get(bn),
            np.shape(pe[conv]["kernel"])[-1])
    _conv(sd, "patch_embed.proj.6", pe["proj"])
    if "norm" in pe:
        _ln(sd, "patch_embed.norm", pe["norm"])
    if "abs_encoder" in params:
        _linear(sd, "abs_encoder", params["abs_encoder"])
    i = 0
    while f"layers_{i}" in params:
        layer = params[f"layers_{i}"]
        j = 0
        while f"blocks_{j}" in layer:
            blk, key = layer[f"blocks_{j}"], f"layers.{i}.blocks.{j}"
            _ln(sd, key + ".norm1", blk["norm1"])
            _ln(sd, key + ".norm2", blk["norm2"])
            if "q_linear" in blk:
                attn, prefix = blk, key
                for name in ("q_linear", "k_linear", "v_linear"):
                    _linear(sd, f"{key}.{name}", blk[name])
            else:
                attn, prefix = blk["attn"], key + ".attn"
                _linear(sd, prefix + ".qkv", attn["qkv"])
            _linear(sd, prefix + ".proj", attn["proj"])
            sd[prefix + ".sphere_position_alpha_table_Te"] = _t(attn["alpha_table"])
            sd[prefix + ".sphere_position_beta_table_Te"] = _t(attn["beta_table"])
            _linear(sd, key + ".mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, key + ".mlp.fc2", blk["mlp"]["fc2"])
            j += 1
        if "downsample" in layer:
            _ln(sd, f"layers.{i}.downsample.norm", layer["downsample"]["norm"])
            _linear(sd, f"layers.{i}.downsample.reduction", layer["downsample"]["reduction"])
        if f"norm{i}" in params:
            _ln(sd, f"norm{i}", params[f"norm{i}"])
        i += 1
    return sd


def from_jax_swin_backbone(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `SwinTransformer` variables -> the port backbone's state dict (the
    reference's keys, as `convert_swin_backbone` reads them)."""
    sd: Dict[str, torch.Tensor] = {}
    pe = params["patch_embed"]
    _conv(sd, "patch_embed.proj", pe["proj"])
    if "norm" in pe:
        _ln(sd, "patch_embed.norm", pe["norm"])
    if "absolute_pos_embed" in params:           # (1, s, s, C) -> (1, C, s, s)
        sd["absolute_pos_embed"] = _t(np.asarray(params["absolute_pos_embed"])
                                      .transpose(0, 3, 1, 2))
    i = 0
    while f"layers_{i}_blocks_0" in params:
        j = 0
        while f"layers_{i}_blocks_{j}" in params:
            blk, key = params[f"layers_{i}_blocks_{j}"], f"layers.{i}.blocks.{j}"
            _ln(sd, key + ".norm1", blk["norm1"])
            _ln(sd, key + ".norm2", blk["norm2"])
            _linear(sd, key + ".attn.qkv", blk["attn"]["qkv"])
            _linear(sd, key + ".attn.proj", blk["attn"]["proj"])
            sd[key + ".attn.relative_position_bias_table"] = _t(
                blk["attn"]["relative_position_bias_table"])
            _linear(sd, key + ".mlp.fc1", blk["mlp"]["fc1"])
            _linear(sd, key + ".mlp.fc2", blk["mlp"]["fc2"])
            j += 1
        if f"layers_{i}_downsample" in params:
            down = params[f"layers_{i}_downsample"]
            _ln(sd, f"layers.{i}.downsample.norm", down["norm"])
            _linear(sd, f"layers.{i}.downsample.reduction", down["reduction"])
        if f"norm{i}" in params:
            _ln(sd, f"norm{i}", params[f"norm{i}"])
        i += 1
    return sd


def panoswin_v2_patch_embed(sd, key: str, pe: Dict[str, Any],
                            stats: Dict[str, Any]) -> None:
    """A JAX `PatchEmbedV2`'s variables into `sd` under `key` (e.g.
    "patch_embed."): the `'cnn'` stem's `conv0`, `bn0`, `conv1`, `bn1`,
    `proj` to `proj.{0,1,3,4,6}` (the BatchNorm statistics from `stats`), or
    the `'tf'` embed's `PixelTransformerV2` to `proj.preprocess_nouv.0`,
    `proj.pos_embedding` and `proj.encoder.layers.0.{self_attn.in_proj_weight,
    self_attn.in_proj_bias, self_attn.out_proj, linear1, linear2, norm1,
    norm2}` (`in_proj_weight` (3d, d), as flax holds it); `norm`."""
    if "pos_embedding" in pe["proj"]:
        tf, layer = pe["proj"], key + "proj.encoder.layers.0."
        _linear(sd, key + "proj.preprocess_nouv.0", tf["preprocess_nouv"])
        sd[key + "proj.pos_embedding"] = _t(tf["pos_embedding"])
        sd[layer + "self_attn.in_proj_weight"] = _t(tf["in_proj_weight"])
        sd[layer + "self_attn.in_proj_bias"] = _t(tf["in_proj_bias"])
        _linear(sd, layer + "self_attn.out_proj", tf["out_proj"])
        for name in ("linear1", "linear2"):
            _linear(sd, layer + name, tf[name])
        for name in ("norm1", "norm2"):
            _ln(sd, layer + name, tf[name])
    else:
        for conv, bn, conv_key, bn_key in (("conv0", "bn0", "proj.0", "proj.1"),
                                           ("conv1", "bn1", "proj.3", "proj.4")):
            _conv(sd, key + conv_key, pe[conv])
            _bn(sd, key + bn_key, pe[bn], stats[bn], np.shape(pe[conv]["kernel"])[-1])
        _conv(sd, key + "proj.6", pe["proj"])
    if "norm" in pe:
        _ln(sd, key + "norm", pe["norm"])


def panoswin_v2_attention(sd, key: str, attn: Dict[str, Any]) -> None:
    """A JAX `WindowAttentionV2`'s (or `V1`'s) variables into `sd` under
    `key`: `qkv`, `proj` and the three tables, `alpha_table` and
    `beta_table` as `sphere_position_alpha_table` and
    `sphere_position_beta_table`."""
    _linear(sd, key + "qkv", attn["qkv"])
    _linear(sd, key + "proj", attn["proj"])
    sd[key + "relative_position_bias_table"] = _t(attn["relative_position_bias_table"])
    sd[key + "sphere_position_alpha_table"] = _t(attn["alpha_table"])
    sd[key + "sphere_position_beta_table"] = _t(attn["beta_table"])


def panoswin_v2_block(sd, key: str, blk: Dict[str, Any]) -> None:
    """A JAX `PanoSwinBlockV2`'s (or `V1`'s) variables into `sd` under
    `key`: `norm1`, `attn`, `norm2`, `mlp.fc1`, `mlp.fc2`."""
    _ln(sd, key + "norm1", blk["norm1"])
    _ln(sd, key + "norm2", blk["norm2"])
    panoswin_v2_attention(sd, key + "attn.", blk["attn"])
    _linear(sd, key + "mlp.fc1", blk["mlp"]["fc1"])
    _linear(sd, key + "mlp.fc2", blk["mlp"]["fc2"])


def from_jax_panoswin_v2_backbone(params: Dict[str, Any],
                                  batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `PanoSwinTransformerV2` or `PanoSwinTransformerV1` variables ->
    the port backbone's state dict, the reference's keys as
    `convert_panoswin_v2_backbone` reads them: `patch_embed.`
    (`panoswin_v2_patch_embed`), `coord_encoder`, `layers_{i}_blocks_{j}` to
    `layers.{i}.blocks.{j}.` (`panoswin_v2_block`), `layers_{i}_downsample`
    to `layers.{i}.downsample`, `norm{i}`."""
    sd: Dict[str, torch.Tensor] = {}
    panoswin_v2_patch_embed(sd, "patch_embed.", params["patch_embed"],
                            batch_stats.get("patch_embed", {}))
    if "coord_encoder" in params:
        _linear(sd, "coord_encoder", params["coord_encoder"])
    i = 0
    while f"layers_{i}_blocks_0" in params:
        j = 0
        while f"layers_{i}_blocks_{j}" in params:
            panoswin_v2_block(sd, f"layers.{i}.blocks.{j}.", params[f"layers_{i}_blocks_{j}"])
            j += 1
        if f"layers_{i}_downsample" in params:
            down = params[f"layers_{i}_downsample"]
            _ln(sd, f"layers.{i}.downsample.norm", down["norm"])
            _linear(sd, f"layers.{i}.downsample.reduction", down["reduction"])
        if f"norm{i}" in params:
            _ln(sd, f"norm{i}", params[f"norm{i}"])
        i += 1
    return sd


def from_jax_cnn_backbone(params: Dict[str, Any],
                          batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `ResNet`, `ResNeXt`, `RegNet`, `Res2Net` or `ResNeSt` variables ->
    the port backbone's state dict, the reference's (torchvision's) keys:
    `conv1`, `bn1` (ResNeSt's `stem{i}`, `stem_bn{i}` to `stem.{3i}`,
    `stem.{3i + 1}`), block `layer{i}_{j}` to `layer{i}.{j}`, its
    `conv{1,2,3}` and `bn{1,2,3}`, Res2Net's `conv2_{k}` and `bn2_{k}` to
    `convs.{k - 1}` and `bns.{k - 1}`, ResNeSt's `splat` (`conv`, `bn`,
    `fc1`, `fc1_bn`, `fc2`) to `conv2.{conv, bn0, fc1, bn1, fc2}`, and
    `downsample_conv`, `downsample_bn` to `downsample.0`, `.1` (ResNeSt's
    `.1`, `.2`, after its average pool); flax BatchNorm's `scale`, `bias`
    and statistics `mean`, `var` to `weight`, `bias`, `running_mean`,
    `running_var` (the JAX `convert_resnet_backbone` reversed).  A
    TridentResNet's res4 entry `layer3_entry` goes to `layer3.0`, and a
    trident block's `conv2_kernel` to `conv2.weight`, its `bn{n}_{b}` to
    `bn{n}.{b}`; an HRNet (`stage2_m0` present) adds `conv2`, `bn2` and its
    stages (`from_jax_hrnet`)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv_bn(src, stats, conv, bn, key, bn_key):
        _conv(sd, key, src[conv])
        _bn(sd, bn_key, src[bn], stats[bn], np.shape(src[conv]["kernel"])[-1])

    def block_name(i, j):
        name = f"layer{i}_{j}"
        return f"layer{i}_entry" if j == 0 and f"layer{i}_entry" in params else name

    if "stem0" in params:
        for i in range(3):
            conv_bn(params, batch_stats, f"stem{i}", f"stem_bn{i}", f"stem.{3 * i}",
                    f"stem.{3 * i + 1}")
    else:
        conv_bn(params, batch_stats, "conv1", "bn1", "conv1", "bn1")
    i = 1
    while block_name(i, 0) in params:
        j = 0
        while block_name(i, j) in params:
            name = block_name(i, j)
            blk, st, key = params[name], batch_stats[name], f"layer{i}.{j}"
            if "conv2_kernel" in blk:                       # a trident block
                _conv(sd, f"{key}.conv1", blk["conv1"])
                _conv(sd, f"{key}.conv2", {"kernel": blk["conv2_kernel"]})
                _conv(sd, f"{key}.conv3", blk["conv3"])
                for n in (1, 2, 3):
                    b = 0
                    while f"bn{n}_{b}" in blk:
                        _bn(sd, f"{key}.bn{n}.{b}", blk[f"bn{n}_{b}"], st[f"bn{n}_{b}"], 0)
                        b += 1
                j += 1
                continue
            for n in (1, 2, 3):
                if f"conv{n}" in blk:
                    conv_bn(blk, st, f"conv{n}", f"bn{n}", f"{key}.conv{n}", f"{key}.bn{n}")
            k = 1
            while f"conv2_{k}" in blk:
                conv_bn(blk, st, f"conv2_{k}", f"bn2_{k}", f"{key}.convs.{k - 1}",
                        f"{key}.bns.{k - 1}")
                k += 1
            if "splat" in blk:
                sp, ss = blk["splat"], st["splat"]
                conv_bn(sp, ss, "conv", "bn", f"{key}.conv2.conv", f"{key}.conv2.bn0")
                _linear(sd, f"{key}.conv2.fc1", sp["fc1"])
                _bn(sd, f"{key}.conv2.bn1", sp["fc1_bn"], ss["fc1_bn"], 0)
                _linear(sd, f"{key}.conv2.fc2", sp["fc2"])
            if "downsample_conv" in blk:
                d = 1 if "splat" in blk else 0
                conv_bn(blk, st, "downsample_conv", "downsample_bn", f"{key}.downsample.{d}",
                        f"{key}.downsample.{d + 1}")
            j += 1
        i += 1
    if "stage2_m0" in params:
        conv_bn(params, batch_stats, "conv2", "bn2", "conv2", "bn2")
        from_jax_hrnet(sd, params, batch_stats)
    return sd


def from_jax_hrnet(sd, params: Dict[str, Any], batch_stats: Dict[str, Any]) -> None:
    """A JAX `HRNet`'s transitions and stages into `sd`, the reference's
    keys: `t{s}_{b}_conv`, `_bn` to `transition{s + 1}.{b}.0`, `.1` where
    branch b existed before stage s + 2, else to `.{b}.0.0`, `.0.1`;
    `stage{n}_m{m}`'s blocks `b{bi}_{k}` to `stage{n}.{m}.branches.{bi}.{k}`
    and its `fuse`'s `f{i}_{j}_conv`, `_bn` to `fuse_layers.{i}.{j}.0`,
    `.1` and `f{i}_{j}_d{s}_conv`, `_bn` to `fuse_layers.{i}.{j}.{s}.0`,
    `.1`."""
    def conv_bn(src, stats, name, key):
        _conv(sd, key + ".0", src[name + "_conv"])
        _bn(sd, key + ".1", src[name + "_bn"], stats[name + "_bn"], 0)

    s = 0
    while f"stage{s + 2}_m0" in params:
        for b in range(s + 2):
            if f"t{s}_{b}_conv" in params:
                conv_bn(params, batch_stats, f"t{s}_{b}",
                        f"transition{s + 1}.{b}" + (".0" if b == s + 1 else ""))
        n, m = s + 2, 0
        while f"stage{n}_m{m}" in params:
            mod, st, key = params[f"stage{n}_m{m}"], batch_stats[f"stage{n}_m{m}"], f"stage{n}.{m}"
            for name in mod:
                if name.startswith("b"):
                    bi, k = name[1:].split("_")
                    blk, bst = mod[name], st[name]
                    for c in (1, 2):
                        _conv(sd, f"{key}.branches.{bi}.{k}.conv{c}", blk[f"conv{c}"])
                        _bn(sd, f"{key}.branches.{bi}.{k}.bn{c}", blk[f"bn{c}"], bst[f"bn{c}"], 0)
            fuse, fst = mod["fuse"], st["fuse"]
            for name in fuse:
                if name.endswith("_conv"):
                    parts = name[1:-len("_conv")].split("_")    # i, j[, d{s}]
                    path = f"{key}.fuse_layers.{parts[0]}.{parts[1]}"
                    if len(parts) == 3:
                        path += "." + parts[2][1:]
                    conv_bn(fuse, fst, name[:-len("_conv")], path)
            m += 1
        s += 1


def _mask_iou_head(sd, key, p):
    """A JAX `MaskIoUHead`: `conv{i}` to `convs.{i}.conv`, `fc0` (its input
    the last (stride-2) conv's (h, w, C) flatten, reordered to (C, h, w))
    and `fc1` to `fcs.{0,1}`, `fc_mask_iou`."""
    i = 0
    while f"conv{i}" in p:
        _conv(sd, f"{key}.convs.{i}.conv", p[f"conv{i}"])
        i += 1
    c = np.shape(p[f"conv{i - 1}"]["kernel"])[-1]
    k = np.asarray(p["fc0"]["kernel"])                         # (h*w*C, out)
    out_dim, side = k.shape[1], math.isqrt(k.shape[0] // c)
    w = k.T.reshape(out_dim, side, side, c).transpose(0, 3, 1, 2)
    sd[key + ".fcs.0.weight"] = _t(w.reshape(out_dim, -1))
    sd[key + ".fcs.0.bias"] = _t(p["fc0"]["bias"])
    _linear(sd, key + ".fcs.1", p["fc1"])
    _linear(sd, key + ".fc_mask_iou", p["fc_mask_iou"])


def _mask_head(sd, key, p):
    i = 0
    while f"conv{i}" in p:
        _conv(sd, f"{key}.convs.{i}.conv", p[f"conv{i}"])
        i += 1
    k = np.asarray(p["upsample"]["kernel"])                   # (kh, kw, in, out)
    sd[key + ".upsample.weight"] = _t(k[::-1, ::-1].transpose(2, 3, 0, 1))
    sd[key + ".upsample.bias"] = _t(p["upsample"]["bias"])
    _conv(sd, key + ".conv_logits", p["conv_logits"])


def _bbox_head(sd, key, p, roi_size):
    """A Shared2FC or a Shared4Conv1FC (`conv{i}` without bias, `gn{i}`) bbox
    head; `shared_fc0` reads the last layer's (h, w, C) flatten."""
    i = 0
    while f"conv{i}" in p:
        sd[f"{key}.shared_convs.{i}.conv.weight"] = _t(
            np.asarray(p[f"conv{i}"]["kernel"]).transpose(3, 2, 0, 1))
        sd[f"{key}.shared_convs.{i}.gn.weight"] = _t(p[f"gn{i}"]["scale"])
        sd[f"{key}.shared_convs.{i}.gn.bias"] = _t(p[f"gn{i}"]["bias"])
        i += 1
    k = np.asarray(p["shared_fc0"]["kernel"])             # (h*w*C, out)
    out_dim = k.shape[1]
    c = k.shape[0] // (roi_size * roi_size)
    w = k.T.reshape(out_dim, roi_size, roi_size, c).transpose(0, 3, 1, 2)
    sd[key + ".shared_fcs.0.weight"] = _t(w.reshape(out_dim, -1))
    sd[key + ".shared_fcs.0.bias"] = _t(p["shared_fc0"]["bias"])
    if "shared_fc1" in p:
        _linear(sd, key + ".shared_fcs.1", p["shared_fc1"])
    _linear(sd, key + ".fc_cls", p["fc_cls"])
    _linear(sd, key + ".fc_reg", p["fc_reg"])


def from_jax_variables(params: Dict[str, Any], batch_stats: Dict[str, Any],
                       roi_size: int = 7) -> Dict[str, torch.Tensor]:
    """JAX detector variables -> the port's state dict (reference keys)."""
    bb = params["backbone_m"]
    if "alpha_table" in bb.get("layers_0_blocks_0", {}).get("attn", {}):
        bb_sd = from_jax_panoswin_v2_backbone(bb, batch_stats.get("backbone_m", {}))
    elif "layers_0_blocks_0" in bb:
        bb_sd = from_jax_swin_backbone(bb)
    elif "layer1_0" in bb:
        bb_sd = from_jax_cnn_backbone(bb, batch_stats["backbone_m"])
    else:
        bb_sd = from_jax_backbone(bb, batch_stats.get("backbone_m", {}))
    sd = {"backbone." + k: v for k, v in bb_sd.items()}
    neck = params["neck_m"]
    if "reduction" in neck:                                 # HRFPN
        _conv(sd, "neck.reduction_conv.conv", neck["reduction"])
    i = 0
    while f"fpn_{i}" in neck:
        if f"lateral_{i}" in neck:
            _conv(sd, f"neck.lateral_convs.{i}.conv", neck[f"lateral_{i}"])
        _conv(sd, f"neck.fpn_convs.{i}.conv", neck[f"fpn_{i}"])
        i += 1
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        _conv(sd, f"rpn_head.{name}", params["rpn_m"][name])

    t = 0
    while f"cascade_head_{t}" in params:
        _bbox_head(sd, f"roi_head.bbox_head.{t}", params[f"cascade_head_{t}"], roi_size)
        t += 1
    if not t:
        _bbox_head(sd, "roi_head.bbox_head", params["bbox_head_m"], roi_size)
    if "mask_head_m" in params:
        _mask_head(sd, "roi_head.mask_head", params["mask_head_m"])
    if "mask_iou_head_m" in params:
        _mask_iou_head(sd, "roi_head.mask_iou_head", params["mask_iou_head_m"])
    return sd


def fold_batchnorm(state_dict: Dict[str, torch.Tensor],
                   eps: float = BN_EPS) -> Dict[str, torch.Tensor]:
    """Fold the stem's eval BatchNorms into the convs before them.

    As `runtime/checkpoint.py:409 fold_batchnorm` of the JAX package does,
    with the stem's own formula (`ops/stem_conv.fold_bn`); the BatchNorm is
    left as the identity (var = 1 - eps).  Returns a new dict.
    """
    sd = dict(state_dict)
    for conv, bn in (("proj.0", "proj.1"), ("proj.3", "proj.4")):
        c = f"backbone.patch_embed.{conv}"
        b = f"backbone.patch_embed.{bn}"
        sd[c + ".weight"], sd[c + ".bias"] = fold_bn(
            sd[c + ".weight"], sd[c + ".bias"], sd[b + ".weight"], sd[b + ".bias"],
            sd[b + ".running_mean"], sd[b + ".running_var"], eps)
        ones = torch.ones_like(sd[b + ".weight"])
        sd[b + ".weight"] = ones
        sd[b + ".bias"] = torch.zeros_like(ones)
        sd[b + ".running_mean"] = torch.zeros_like(ones)
        sd[b + ".running_var"] = ones - eps
    return sd


def strip_module(sd: Dict[str, Any]) -> Dict[str, Any]:
    """Drop the `module.` prefix that a data-parallel wrapper puts on every
    key (only when every key has it)."""
    if all(k.startswith("module.") for k in sd):
        return {k[len("module."):]: v for k, v in sd.items()}
    return sd


def resize_bias_table(table: torch.Tensor, src_ws: int, dst_ws: int) -> torch.Tensor:
    """Bicubic resize of a ((2 src_ws - 1)^2, heads) relative-bias table to
    window `dst_ws` (`mmcv_custom/checkpoint.py:336-352`), with torch's
    bicubic weights, in float64, cast back to the table's type."""
    if src_ws == dst_ws:
        return table
    h = table.shape[1]
    s, d = 2 * src_ws - 1, 2 * dst_ws - 1
    img = table.detach().cpu().double().reshape(s, s, h)
    wh = torch.from_numpy(_torch_cubic_weights(d, s))
    out = torch.einsum("oh,hwc->owc", wh, img)
    out = torch.einsum("ow,hwc->hoc", wh, out)
    return out.reshape(d * d, h).to(table.dtype)


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a checkpoint file: the file's `state_dict` or
    `model` entry, or the file itself, with `module.` stripped.  A file path
    only, read on the CPU with `weights_only=True`, which unpickles tensors
    and plain containers only.  A URL or a `torchvision://` name raises,
    naming the file it stands for: the port fetches nothing."""
    if path.startswith("torchvision://"):
        name = path[len("torchvision://"):]
        raise FileNotFoundError(
            f"{path}: the port downloads nothing; get torchvision's "
            f"{TORCHVISION_FILES.get(name, name + '-*.pth')} onto this machine and give its "
            "local path instead")
    if "://" in path:
        raise FileNotFoundError(f"{path}: the port downloads nothing; give the path of a local "
                                f"copy of {os.path.basename(path)} instead")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    elif isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return strip_module(ckpt)


def load_reference_weights(model: nn.Module, sd: Dict[str, torch.Tensor],
                           strict: bool = True) -> None:
    """Load a reference-format state dict into `model` with
    `load_state_dict(strict=strict)`.  A bias table made for another window
    size (its length tells which: PanoSwin's sphere tables, those of the
    v-variant and Swin's relative position table) is resized first with
    `resize_bias_table`, as the JAX converters' `src_window_size` does.  A cascade
    checkpoint with a mask head a stage (`roi_head.mask_head.{t}.`, the
    reference's `CascadeRoIHead`) raises: the port, as the JAX package,
    keeps one mask head."""
    staged = sorted({k.split(".")[2] for k in sd if re.match(r"roi_head\.mask_head\.\d+\.", k)})
    if staged:
        raise NotImplementedError(
            f"the checkpoint has a mask head for each of the cascade stages {staged} (the "
            "reference's CascadeRoIHead averages their sigmoids); the port, as the JAX "
            "package, keeps one mask head: a known divergence (ROADMAP.md, Queue 3)")
    own = model.state_dict()
    sd = dict(sd)
    for key, table in sd.items():
        if (key.endswith(("_table_Te", "_table")) and key in own
                and table.shape != own[key].shape):
            side = math.isqrt(table.shape[0])
            dst = math.isqrt(own[key].shape[0])
            sd[key] = resize_bias_table(table, (side + 1) // 2, (dst + 1) // 2)
    model.load_state_dict(sd, strict=strict)


def regnet_from_pycls(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A pycls RegNet state dict (its checkpoint's `model_state`) -> the
    reference's keys, as `tools/model_converters/regnet2mmdet.py` maps them
    and the JAX `convert_regnet_backbone` reads them: `stem.conv`,
    `stem.bn` to `conv1`, `bn1`; `s{i}.b{j}.f.{a,b,c}` and their `_bn` to
    `layer{i}.{j - 1}.conv{1,2,3}`, `bn{1,2,3}`; a block's `proj` and `bn`
    to `downsample.0` and `.1`.  The classifier (`head.*`) is left out."""
    out = {}
    for key, v in strip_module(sd).items():
        m = re.match(r"s(\d+)\.b(\d+)\.(.+)$", key)
        if key.startswith("stem."):
            key = key.replace("stem.conv", "conv1").replace("stem.bn", "bn1")
        elif m:
            stage, block, rest = int(m.group(1)), int(m.group(2)) - 1, m.group(3)
            f = re.match(r"f\.([abc])(_bn)?\.(.+)$", rest)
            if f:
                n = "abc".index(f.group(1)) + 1
                rest = f"{'bn' if f.group(2) else 'conv'}{n}.{f.group(3)}"
            else:
                rest = rest.replace("proj.", "downsample.0.").replace("bn.", "downsample.1.")
            key = f"layer{stage}.{block}.{rest}"
        else:
            continue
        out[key] = v
    return out


def load_backbone_weights(backbone: nn.Module, sd: Dict[str, Any]) -> None:
    """A reference backbone checkpoint (`module.` stripped) into `backbone`:
    a PanoSwin one (`SimplePanoSwinTransformer`'s keys) as the JAX package's
    `convert_panoswin_backbone` reads it, a v-variant or v1 one as
    `convert_panoswin_v2_backbone` reads it, a stock Swin one (an ImageNet
    classifier's, `swin_transformer.py`'s keys) as `convert_swin_backbone`
    reads it: the stem or patch embed, the absolute encoder or position
    table, the stages and the out-norms, bias tables of another window size
    resized (`load_reference_weights`); a torchvision or mmdet ResNet or
    ResNeXt one (a detector's `backbone.*` keys taken alone) as
    `convert_resnet_backbone` reads it, a pycls RegNet one (`model_state`,
    `regnet_from_pycls`) as `convert_regnet_backbone` reads it, a Res2Net
    or ResNeSt one of the port's own keys.  Keys of other modules (a
    classifier's head, `fc` and last norm) are left out; the absolute
    encoder or table, the stem's LayerNorm and the out-norms, which the
    converters take only when present, keep the backbone's own values when
    absent, as do the `num_batches_tracked` counters; any other missing
    key raises.  Swin has no BatchNorm to fold."""
    if "model_state" in sd:
        sd = sd["model_state"]
    sd = strip_module(sd)
    if any(k.startswith("backbone.") for k in sd):
        sd = {k[len("backbone."):]: v for k, v in sd.items() if k.startswith("backbone.")}
    if "stem.conv.weight" in sd:
        sd = regnet_from_pycls(sd)
    own = backbone.state_dict()
    optional = ("abs_encoder.", "coord_encoder.", "absolute_pos_embed", "patch_embed.norm.",
                "norm")
    missing = [k for k in own if k not in sd and not k.startswith(optional)
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise KeyError(f"the backbone checkpoint has no {missing[:5]} ({len(missing)} keys "
                       "missing)")
    load_reference_weights(backbone, {k: torch.as_tensor(v) for k, v in sd.items() if k in own},
                           strict=False)


def save_checkpoint(path: str, model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                    step: int = 0, generators: Optional[Dict[str, Any]] = None,
                    rank_generators: Optional[List[Dict[str, Any]]] = None) -> None:
    """A training checkpoint: the model's state dict (reference keys; a
    `DistributedDataParallel`'s module's, without the `module.` prefix),
    the optimizer's and the schedule's state, the step, and the state of
    each host random generator in `generators` (name -> an object with
    `getstate`: Python's `random` module, a `random.Random`).  A
    distributed run passes every process's states too (`rank_generators`,
    by rank), and each process resumes its own."""
    model = getattr(model, "module", model)
    torch.save({"state_dict": model.state_dict(), "optimizer": optimizer.state_dict(),
                "scheduler": None if scheduler is None else scheduler.state_dict(),
                "step": int(step),
                "generators": {k: g.getstate() for k, g in (generators or {}).items()},
                "rank_generators": rank_generators}, path)


def load_checkpoint(path: str, model: nn.Module, optimizer: torch.optim.Optimizer,
                    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None,
                    generators: Optional[Dict[str, Any]] = None) -> int:
    """Restore what `save_checkpoint` wrote into `model` (or a
    `DistributedDataParallel`'s module), `optimizer`, `scheduler` (made as
    for the saved run, on the device to resume on) and each of `generators`
    (`setstate`): this process's states where the checkpoint has one for
    each process of this run, else the saved process's; returns the step."""
    model = getattr(model, "module", model)
    ckpt = torch.load(path, map_location=next(model.parameters()).device, weights_only=True)
    model.load_state_dict(ckpt["state_dict"], strict=True)
    optimizer.load_state_dict(ckpt["optimizer"])
    if scheduler is not None:
        scheduler.load_state_dict(ckpt["scheduler"])
    states = ckpt["generators"]
    by_rank = ckpt.get("rank_generators")
    if by_rank is not None and len(by_rank) == world():
        states = by_rank[rank()]
    for name, g in (generators or {}).items():
        g.setstate(states[name])
    return ckpt["step"]
