"""PitchAttention, the block that ends a PanoSwin stage of odd depth, in the
PyTorch port vs JAX, with the geometry under it.

- The rotation (`pano_rotate` forward, reverse and about the south pole,
  `pano_rotate_image`) and `grid_sample_nhwc` (border and zeros padding),
  all from one jitted JAX function: float32 atol 1e-5 (the two frameworks'
  sin, cos and arccos differ in the last bits; the rotation adds a few such
  steps).
- `PitchAttention` at dim 6, 1 head, window 4, on an 8 x 16 map (whole
  windows) and a 7 x 13 one (padded), pano and planar, input in float32 and
  in bfloat16; the planar cases also take `qkv_bias=False` and a
  `qk_scale`.  The q/k/v/proj weights and the bias tables are 25 times the
  init's spread, so that the attention, and with it the rotated keys, moves
  the output as much as the residual does (an unrotated key map misses by
  about 2).  Tolerance 1e-5 for both input types: the JAX block creates
  its layers without a compute type, so flax promotes a bfloat16 input to
  float32 at the first LayerNorm and the block computes and returns float32
  (checked here); the port's block does the same.
- The backbone at the JAX tiny flagship's depths 1-1-1-1 (PitchAttention
  alone in every stage; a 32 x 64 input gives maps of 8 x 16 down to 1 x 2,
  the last two padded to one window), stage outputs against JAX in float32:
  atol 1e-4, as the even-depth backbone (`test_torch_backbone.py`).
- `resize_bias_table` against JAX's: float32 atol 1e-6 (both float64
  inside).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.geometry import resample as jresample
from panoswintransformerobjectdetection_tpu.geometry import rotate as jrotate
from panoswintransformerobjectdetection_tpu.geometry.sphere import make_uv_grid as jax_uv_grid
from panoswintransformerobjectdetection_tpu.models.panoswin import (
    PanoSwinTransformer as JaxBackbone, PitchAttention as JaxPitch)
from panoswintransformerobjectdetection_tpu.runtime.checkpoint import (
    convert_panoswin_backbone, resize_bias_table as jax_resize_bias_table)
from panoswintransformerobjectdetection_torch.geometry import rotate
from panoswintransformerobjectdetection_torch.geometry.resample import grid_sample_nhwc
from panoswintransformerobjectdetection_torch.geometry.sphere import make_uv_grid
from panoswintransformerobjectdetection_torch.models.panoswin import (PanoSwinTransformer,
                                                                      PitchAttention)
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (_linear, _ln, _t,
                                                                         from_jax_backbone,
                                                                         resize_bias_table)
from torch_port_common import (quick_jit, random_variables, single_torch_thread,  # noqa: F401
                               tiny_odd_detector, to_numpy)

PI = math.pi
AXES = {"pitch": (PI, -0.0001 * PI), "tilted": (0.7, 0.3), "south_pole": (0.3, -0.5 * PI)}


@pytest.fixture(scope="module")
def geometry():
    """Inputs and JAX references of the rotation and resampling tests."""
    rng = np.random.default_rng(0)
    inputs = {
        "s_uv": np.stack([rng.uniform(-PI, PI, 64), rng.uniform(-0.5 * PI, 0.5 * PI, 64)],
                         -1).astype(np.float32),
        "img": rng.standard_normal((2, 3, 8, 16)).astype(np.float32),
        "maps": rng.standard_normal((2, 6, 10, 4)).astype(np.float32),
        "grid": rng.uniform(-1.3, 1.3, (2, 5, 7, 2)).astype(np.float32),
    }

    def reference(a):
        out = {}
        for name, axis in AXES.items():
            np_uv = jnp.asarray(axis, jnp.float32)
            out[f"forward-{name}"] = jrotate.pano_rotate(np_uv, a["s_uv"])
            out[f"reverse-{name}"] = jrotate.pano_rotate(np_uv, a["s_uv"], reverse=True)
            out[f"image-{name}"], out[f"grid-{name}"] = jrotate.pano_rotate_image(a["img"],
                                                                                np_uv)
        for mode in ("border", "zeros"):
            out[f"sample-{mode}"] = jresample.grid_sample_nhwc(a["maps"], a["grid"], mode)
        return out

    ref = quick_jit(reference, jax.tree.map(jnp.asarray, inputs))
    return inputs, jax.tree.map(np.asarray, ref)


@pytest.mark.parametrize("axis", list(AXES))
@pytest.mark.parametrize("direction", ["forward", "reverse"])
def test_pano_rotate_matches_jax(geometry, axis, direction):
    inputs, ref = geometry
    got = rotate.pano_rotate(AXES[axis], torch.from_numpy(inputs["s_uv"]),
                             reverse=direction == "reverse")
    np.testing.assert_allclose(got.numpy(), ref[f"{direction}-{axis}"], atol=1e-5)
    if axis == "south_pole":
        assert torch.equal(got, torch.from_numpy(inputs["s_uv"]))


def test_pano_rotate_reverse_inverts_forward():
    """Up to float32 rounding through arccos, whose slope 1 / sqrt(1 - c^2)
    magnifies it near c = +-1: atol 1e-3."""
    s_uv = torch.from_numpy(np.random.default_rng(1).uniform(-1.4, 1.4, (32, 2))
                            .astype(np.float32))
    back = rotate.pano_rotate(AXES["tilted"], rotate.pano_rotate(AXES["tilted"], s_uv),
                              reverse=True)
    np.testing.assert_allclose(back.numpy(), s_uv.numpy(), atol=1e-3)


@pytest.mark.parametrize("axis", list(AXES))
def test_pano_rotate_image_matches_jax(geometry, axis):
    inputs, ref = geometry
    out, grid = rotate.pano_rotate_image(torch.from_numpy(inputs["img"]), AXES[axis])
    np.testing.assert_allclose(grid.numpy(), ref[f"grid-{axis}"], atol=1e-5)
    np.testing.assert_allclose(out.numpy(), ref[f"image-{axis}"], atol=1e-5)


@pytest.mark.parametrize("mode", ["border", "zeros"])
def test_grid_sample_matches_jax(geometry, mode):
    inputs, ref = geometry
    got = grid_sample_nhwc(torch.from_numpy(inputs["maps"]), torch.from_numpy(inputs["grid"]),
                           mode)
    np.testing.assert_allclose(got.numpy(), ref[f"sample-{mode}"], atol=1e-5)


PITCH_CASES = {"pano": {"pano_mode": True},
               "planar": {"pano_mode": False, "qkv_bias": False, "qk_scale": 0.3}}


def _pitch_state_dict(params):
    sd = {}
    for name in ("q_linear", "k_linear", "v_linear", "proj"):
        _linear(sd, name, params[name])
    _ln(sd, "norm1", params["norm1"])
    _ln(sd, "norm2", params["norm2"])
    _linear(sd, "mlp.fc1", params["mlp"]["fc1"])
    _linear(sd, "mlp.fc2", params["mlp"]["fc2"])
    sd["sphere_position_alpha_table_Te"] = _t(params["alpha_table"])
    sd["sphere_position_beta_table_Te"] = _t(params["beta_table"])
    return sd


@pytest.fixture(scope="module")
def pitch_reference():
    """(x, uv, state dict, {dtype: JAX output}) for a map size and a mode; one
    jitted JAX function gives both input types' outputs."""
    refs = {}

    def reference(H, W, mode):
        if (H, W, mode) not in refs:
            opts = dict(PITCH_CASES[mode])
            pano = opts.pop("pano_mode")
            jmod = JaxPitch(dim=6, num_heads=1, window_size=4, **opts)
            rng = np.random.default_rng(H * W)
            x = rng.standard_normal((2, H, W, 6)).astype(np.float32)
            uv = np.array(jax_uv_grid(H, W)) if pano else np.zeros((H, W, 2), np.float32)
            variables = random_variables(jmod, jnp.asarray(x), jnp.asarray(uv), seed=H + W)
            variables = jax.tree_util.tree_map_with_path(
                lambda path, a: a * 25.0 if "mlp" not in str(path) and path[-1].key in (
                    "kernel", "alpha_table", "beta_table") else a, variables)
            out = quick_jit(lambda v, a, u: {
                dt: jmod.apply(v, a.astype(dt), u, pano_mode=pano)
                for dt in ("float32", "bfloat16")}, variables, jnp.asarray(x), jnp.asarray(uv))
            refs[H, W, mode] = (x, uv, _pitch_state_dict(to_numpy(variables["params"])), out)
        return refs[H, W, mode]

    return reference


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(PITCH_CASES))
@pytest.mark.parametrize("size", [(8, 16), (7, 13)], ids=["8x16", "7x13-padded"])
def test_pitch_attention_matches_jax(pitch_reference, size, mode, dtype):
    x, uv, sd, ref = pitch_reference(*size, mode)
    ref = ref[dtype]
    assert ref.dtype == jnp.float32
    block = PitchAttention(6, 1, 4, **PITCH_CASES[mode])
    block.load_state_dict(sd)
    with torch.no_grad():
        got = block(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(uv))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_pitch_uv_follows_the_features():
    """The pano block's rotated uv comes through the same grids as its
    features: resampling a map that holds the uv grid as channels gives the
    rotated uv that the bias couples with."""
    block = PitchAttention(6, 1, 4)
    uv = make_uv_grid(8, 16)[None]
    grids = block.window_grids(8, 16, 0, 0, None)
    both = block.rotated_windows(torch.cat([uv, uv], -1), grids)
    np.testing.assert_array_equal(both[..., :2].numpy(), block.rotated_windows(uv, grids).numpy())
    assert not torch.equal(both[..., :2], uv)


@pytest.fixture(scope="module")
def odd_backbone():
    """The odd detector's backbone weights as JAX variables (JAX's own
    converter), the input, and JAX's stage outputs."""
    td = tiny_odd_detector()
    cfg = dict(td["config"]["model"]["backbone"])
    cfg.pop("type")
    sd = {k[len("backbone."):]: v for k, v in td["state_dict"].items()
          if k.startswith("backbone.")}
    params, stats = convert_panoswin_backbone({k: v.numpy() for k, v in sd.items()},
                                              cfg["depths"], cfg["window_size"])
    variables = {"params": params, "batch_stats": stats}
    x = np.random.default_rng(5).random((2, 32, 64, 3)).astype(np.float32)
    ref = quick_jit(JaxBackbone(**cfg).apply, variables, jnp.asarray(x))
    return cfg, sd, to_numpy(params), to_numpy(stats), x, ref


def test_from_jax_backbone_reads_pitch_blocks(odd_backbone):
    """JAX's converter and the port's inverse give back the reference keys
    and values, the PitchAttention blocks' flat keys included."""
    cfg, sd, params, stats, _, _ = odd_backbone
    back = from_jax_backbone(params, stats)
    assert set(back) == set(sd)
    assert "layers.0.blocks.0.q_linear.weight" in back
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_odd_depth_backbone_matches_jax(odd_backbone):
    cfg, sd, params, stats, x, ref = odd_backbone
    port = PanoSwinTransformer(**cfg).eval()
    assert all(isinstance(layer.blocks[-1], PitchAttention) for layer in port.layers)
    port.load_state_dict(from_jax_backbone(params, stats))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == torch.float32 and tuple(g.shape) == r.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=f"stage {i}")


@pytest.mark.parametrize("src,dst", [(4, 7), (7, 4), (7, 7)])
def test_resize_bias_table_matches_jax(src, dst):
    table = np.random.default_rng(src * dst).standard_normal(((2 * src - 1) ** 2, 3))
    table = table.astype(np.float32)
    ref = jax_resize_bias_table(table, src, dst)
    got = resize_bias_table(torch.from_numpy(table), src, dst)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
