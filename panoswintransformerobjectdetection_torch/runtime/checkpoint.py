"""Parameters between the JAX package's variable trees and the port's
state dicts, and BatchNorm folding for inference.

`from_jax_variables` is the inverse of `convert_detector` in
`panoswintransformerobjectdetection_tpu/runtime/checkpoint.py`: it takes the
(params, batch_stats) trees of a JAX `PanoFasterRCNN` as numpy arrays and
returns a state dict in the reference's key layout, which the port's
detector loads with `load_state_dict`.  Layouts: conv HWIO -> OIHW, Dense
(in, out) -> Linear (out, in), LayerNorm scale -> weight, and `shared_fc0`'s
input reordered from the JAX (h, w, C) flatten to the reference's (C, h, w).
"""

from typing import Any, Dict

import numpy as np
import torch

from ..ops.stem_conv import BN_EPS, fold_bn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(sd, key, p):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[key + ".bias"] = _t(p["bias"])


def _conv(sd, key, p):
    sd[key + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[key + ".bias"] = _t(p["bias"])


def _ln(sd, key, p):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])


def _bn(sd, key, p, s):
    sd[key + ".weight"] = _t(p["scale"])
    sd[key + ".bias"] = _t(p["bias"])
    sd[key + ".running_mean"] = _t(s["mean"])
    sd[key + ".running_var"] = _t(s["var"])
    sd[key + ".num_batches_tracked"] = torch.tensor(0)


def from_jax_backbone(params: Dict[str, Any],
                      batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX `PanoSwinTransformer` variables -> the port backbone's state dict."""
    sd: Dict[str, torch.Tensor] = {}
    pe, pe_stats = params["patch_embed"], batch_stats["patch_embed"]
    _conv(sd, "patch_embed.proj.0", pe["conv0"])
    _bn(sd, "patch_embed.proj.1", pe["bn0"], pe_stats["bn0"])
    _conv(sd, "patch_embed.proj.3", pe["conv1"])
    _bn(sd, "patch_embed.proj.4", pe["bn1"], pe_stats["bn1"])
    _conv(sd, "patch_embed.proj.6", pe["proj"])
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
            _linear(sd, key + ".attn.qkv", blk["attn"]["qkv"])
            _linear(sd, key + ".attn.proj", blk["attn"]["proj"])
            sd[key + ".attn.sphere_position_alpha_table_Te"] = _t(blk["attn"]["alpha_table"])
            sd[key + ".attn.sphere_position_beta_table_Te"] = _t(blk["attn"]["beta_table"])
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


def from_jax_variables(params: Dict[str, Any], batch_stats: Dict[str, Any],
                       roi_size: int = 7) -> Dict[str, torch.Tensor]:
    """JAX detector variables -> the port's state dict (reference keys)."""
    sd = {"backbone." + k: v for k, v in
          from_jax_backbone(params["backbone_m"], batch_stats["backbone_m"]).items()}
    neck = params["neck_m"]
    i = 0
    while f"lateral_{i}" in neck:
        _conv(sd, f"neck.lateral_convs.{i}.conv", neck[f"lateral_{i}"])
        _conv(sd, f"neck.fpn_convs.{i}.conv", neck[f"fpn_{i}"])
        i += 1
    for name in ("rpn_conv", "rpn_cls", "rpn_reg"):
        _conv(sd, f"rpn_head.{name}", params["rpn_m"][name])

    head = params["bbox_head_m"]
    k = np.asarray(head["shared_fc0"]["kernel"])          # (h*w*C, out)
    out_dim = k.shape[1]
    c = k.shape[0] // (roi_size * roi_size)
    w = k.T.reshape(out_dim, roi_size, roi_size, c).transpose(0, 3, 1, 2)
    sd["roi_head.bbox_head.shared_fcs.0.weight"] = _t(w.reshape(out_dim, -1))
    sd["roi_head.bbox_head.shared_fcs.0.bias"] = _t(head["shared_fc0"]["bias"])
    _linear(sd, "roi_head.bbox_head.shared_fcs.1", head["shared_fc1"])
    _linear(sd, "roi_head.bbox_head.fc_cls", head["fc_cls"])
    _linear(sd, "roi_head.bbox_head.fc_reg", head["fc_reg"])
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
