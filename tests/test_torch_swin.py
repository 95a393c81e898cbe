"""Stock Swin backbone of the PyTorch port vs the JAX package's, stage by stage.

A narrow three-stage Swin (embed 16, depths 2-2-2, heads 1-2-2, window 7;
the four-stage detector is held against JAX in `test_torch_mask_rcnn.py`)
with random variables of the JAX init's spread (`torch_port_common.
random_variables`), carried across by `from_jax_swin_backbone`.  A 64 x 96
input gives stage maps of 16 x 24, 8 x 12 and 4 x 6: every stage pads to
whole windows and runs a shifted block with its 9-region mask; a 60 x 100
input pads the patch embed and gives odd sides (15 x 25 -> 8 x 13 -> 4 x 7)
to PatchMerging.  One case adds the absolute position table, of
another size than the patch grid.  float32: atol 1e-4 (sums in another
order, flax's and torch's LayerNorm variance); bfloat16: atol 0.05 on the
f32 out-norms, as `test_torch_backbone.py` holds the PanoSwin backbone
(the frameworks round to bf16 at different places in eight blocks).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models.layers import \
    SingleConvPatchEmbed as JaxPatchEmbed
from panoswintransformerobjectdetection_tpu.models.swin import SwinTransformer as JaxSwin
from panoswintransformerobjectdetection_torch.models.layers import SingleConvPatchEmbed
from panoswintransformerobjectdetection_torch.models.swin import SwinTransformer
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (
    _conv, _ln, from_jax_swin_backbone, load_reference_weights, resize_bias_table)
from torch_port_common import (quick_jit, random_variables, single_torch_thread,  # noqa: F401
                               to_numpy)

CFG = {"embed_dim": 16, "depths": (2, 2, 2), "num_heads": (1, 2, 2), "window_size": 7,
       "out_indices": (0, 1, 2), "drop_path_rate": 0.0}
# the stock four stages, for the names
FOUR = {"embed_dim": 16, "depths": (2, 2, 2, 2), "num_heads": (1, 2, 2, 4)}


@pytest.mark.parametrize("size,ape,dtype", [
    pytest.param((64, 96), False, "float32", id="padded-float32"),
    pytest.param((64, 96), False, "bfloat16", id="padded-bfloat16"),
    pytest.param((60, 100), False, "float32", id="odd-float32"),
    pytest.param((60, 100), False, "bfloat16", id="odd-bfloat16"),
    pytest.param((64, 96), True, "float32", id="ape-float32"),
])
def test_stages_match_jax(size, ape, dtype):
    extra = {"ape": True, "pretrain_img_size": 32} if ape else {}
    x = np.random.default_rng(1).random((2, *size, 3)).astype(np.float32)
    jmod = JaxSwin(**CFG, **extra, dtype=jnp.dtype(dtype))
    variables = random_variables(jmod, jnp.zeros((1, *size, 3), jnp.float32), seed=7)
    ref = quick_jit(jmod.apply, variables, jnp.asarray(x))
    port = SwinTransformer(**CFG, **extra, dtype=getattr(torch, dtype)).eval()
    port.load_state_dict(from_jax_swin_backbone(to_numpy(variables["params"])), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 3
    tol = 1e-4 if dtype == "float32" else 0.05
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol, err_msg=f"stage {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_norm", [True, False])
def test_single_conv_patch_embed_matches_jax(dtype, use_norm):
    """A 4 x 4 stride-4 conv (+ LayerNorm) on a 30 x 41 input, padded on the
    right and the bottom to 32 x 44; the output in the compute type.
    Tolerances: f32 1e-5; bf16 one bf16 unit of the largest value (the
    rounding of the conv's sum, taken in another order)."""
    x = np.random.default_rng(2).random((2, 30, 41, 3)).astype(np.float32)
    jmod = JaxPatchEmbed(4, 12, use_norm=use_norm, dtype=jnp.dtype(dtype))
    variables = random_variables(jmod, jnp.zeros((1, 30, 41, 3)), seed=3)
    ref = np.asarray(quick_jit(jmod.apply, variables, jnp.asarray(x)), np.float32)
    p = to_numpy(variables["params"])
    sd = {}
    _conv(sd, "proj", p["proj"])
    if use_norm:
        _ln(sd, "norm", p["norm"])
    port = SingleConvPatchEmbed(4, 12, 3, use_norm, getattr(torch, dtype))
    port.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == ref.shape == (2, 8, 11, 12)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)


def test_swin_names_are_the_reference_checkpoint_keys():
    """The keys JAX's `convert_swin_backbone` reads, and no others."""
    sd = SwinTransformer(**FOUR, ape=True).state_dict()
    assert "patch_embed.proj.weight" in sd and "patch_embed.norm.weight" in sd
    assert sd["absolute_pos_embed"].shape == (1, 16, 56, 56)
    for key in ("layers.0.blocks.1.attn.relative_position_bias_table",
                "layers.0.blocks.0.attn.qkv.weight", "layers.2.blocks.1.mlp.fc2.bias",
                "layers.2.downsample.reduction.weight", "layers.2.downsample.norm.bias",
                "norm3.weight"):
        assert key in sd, key
    assert sd["layers.0.blocks.0.attn.relative_position_bias_table"].shape == (169, 1)
    assert "layers.3.downsample.reduction.weight" not in sd
    # activation checkpointing changes no key (its gradients: test_torch_mask_train.py)
    assert set(SwinTransformer(**FOUR, ape=True, use_checkpoint=True).state_dict()) == set(sd)


def test_bias_tables_of_another_window_are_resized():
    """A window-7 checkpoint into a window-4 backbone: each relative
    position table resized bicubically (`resize_bias_table`), as the JAX
    `convert_swin_backbone` does with `src_window_size`."""
    src = SwinTransformer(**CFG).state_dict()
    key = "layers.1.blocks.0.attn.relative_position_bias_table"
    src[key] = torch.randn(src[key].shape)
    dst = SwinTransformer(**dict(CFG, window_size=4))
    load_reference_weights(dst, src)
    assert dst.state_dict()[key].shape == (49, 2)
    assert torch.equal(dst.state_dict()[key], resize_bias_table(src[key], 7, 4))
