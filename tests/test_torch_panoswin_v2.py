"""The v-variant PanoSwin of the PyTorch port (`models/panoswin_v2.py`), its
v1 revision (`models/panoswin_v1.py`) and the basketball warp
(`geometry/basketball.py`, `BasketBallExpand`) vs the JAX package.

Module by module: the warp's static and traced maps on full and partial
ratios whose ori_h is not the image's height, `BasketBallExpand`, and the
side-band helpers, exactly or within 1e-6; `WindowAttentionV2` and the v2
and v1 blocks in both layouts, shift 0 and 2, at odd H and W;
`PixelTransformerV2` and `PatchEmbedV2` (the `'cnn'` stem at eval time
through kernel K1's twin with its BatchNorm folded, against JAX's unfolded
convolutions; `'tf'`; the basketball warp) in float32 within 1e-4 (flax
and torch LayerNorm take the variance differently, sums run in another
order).  The backbones take a random state dict under the reference's
keys (`torch_port_common.random_reference_state_dict`): the port loads it
strictly, JAX through `convert_panoswin_v2_backbone` (a window-7 one into
window 4 through both packages' bicubic table resize), with per-image
ratios [[0, 1, 32], [0.1, 0.9, 40]] at 32 x 64 and at odd sizes: stage
outputs within 1e-4 in float32, 0.05 in bfloat16 (about three bf16 units
of the out-norms' largest values, as for the other backbones).

A tiny `PanoFasterRCNN` with the v2 backbone (embed 6, depths 2-2-2-2,
window 4, the shared tiny detector's other shapes), its BatchNorm drawn
away from the identity: `simple_test` with per-image ratios keeps JAX's
slots, boxes within 1e-3 px and scores within 1e-5; the port's
`train_detector` takes one step (lr 1e-2, no warm-up) over two frames with
partial ratios, handed the sampler noise of the JAX step, and JAX's
`make_train_step` takes it on the batch the port's loader made: losses
1e-4 relative, every gradient within 1e-5 + 2e-3 * max|g| (the step's
gradient is read off the port's `make_train_step` on the same batch), and
the parameters after the update as `test_torch_train_loop.py` holds them:
within 1e-5 + 1e-3 * max|p - p0| where Adam's step has a determined sign,
within twice the learning rate everywhere.  The JAX references compile at
XLA's optimisation level 0 (`quick_jit`).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.data import transforms as jtr
from panoswintransformerobjectdetection_tpu.geometry import basketball as jbb
from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.models import panoswin_v1 as jv1
from panoswintransformerobjectdetection_tpu.models import panoswin_v2 as jv2
from panoswintransformerobjectdetection_tpu.ops.windows import swin_attention_mask
from panoswintransformerobjectdetection_tpu.runtime.checkpoint import (
    convert_panoswin_v2_backbone)
from panoswintransformerobjectdetection_tpu.runtime.optim import make_optimizer
from panoswintransformerobjectdetection_tpu.runtime.train import TrainState, make_train_step
from panoswintransformerobjectdetection_torch.apis import train as tapi
from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.data import transforms as ttr
from panoswintransformerobjectdetection_torch.geometry import basketball as tbb
from panoswintransformerobjectdetection_torch.models import panoswin_v1 as tv1
from panoswintransformerobjectdetection_torch.models import panoswin_v2 as tv2
from panoswintransformerobjectdetection_torch.models.detectors import BACKBONES
from panoswintransformerobjectdetection_torch.runtime import checkpoint as tck
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime import train as ttrain
from torch_port_common import (ODD_CONFIG, TINY_TRAIN_CFG, jax_step_noise,  # noqa: F401
                               perturb_batch_norm, quick_jit, random_reference_state_dict,
                               random_variables, recording, single_torch_thread, to_numpy,
                               write_coco_set)

RATIOS = np.array([[0.0, 1.0, 32.0], [0.1, 0.9, 40.0]], np.float32)
LR = 1e-2


def _rng(seed=0):
    return np.random.default_rng(seed)


# ------------------------------------------------------------- basketball

@pytest.mark.parametrize("ratio,ori_h", [((0.0, 1.0), 40.0), ((0.1, 0.9), 56.0),
                                         ((0.25, 0.75), 80.0)])
def test_correct_center_matches_jax(ratio, ori_h):
    """Static map and warp at a known ratio, the traced warp with each
    image's own ratio and ori_h (not the image's height 40): exact."""
    img = _rng().random((2, 40, 80, 3)).astype(np.float32)
    for got, want in zip(tbb.correct_center_map(40, 80, 8, ratio),
                         jbb.correct_center_map(40, 80, 8, ratio)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tbb.patch_latitudes(40, 8, ratio),
                                  jbb.patch_latitudes(40, 8, ratio))
    assert tbb.stb_adjacency((40, 80), 8, ratio) == jbb.stb_adjacency((40, 80), 8, ratio)
    got = tbb.correct_center(torch.from_numpy(img), 8, ratio)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbb.correct_center(
        jnp.asarray(img), 8, ratio)))
    prv = np.array([[*ratio, ori_h], [0.0, 1.0, 40.0]], np.float32)
    got = tbb.correct_center_traced(torch.from_numpy(img), 8, torch.from_numpy(prv))
    want = jax.vmap(lambda im, pr: jbb.correct_center_traced(im, 8, pr[0], pr[1], pr[2]))(
        jnp.asarray(img), jnp.asarray(prv))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not np.array_equal(got[0].numpy(), got[1].numpy())


@pytest.mark.parametrize("ratio,patch", [(None, 20), ((0.1, 0.9), 6)])
def test_basketball_expand_matches_jax(ratio, patch):
    """The ported pipeline step against the JAX one: exact; it builds from
    a config and is no longer refused."""
    img = _rng(1).random((24, 60, 3)).astype(np.float32)
    results = {"img": img} if ratio is None else {"img": img, "pano_ratio_v": np.array(ratio)}
    got = ttr.BasketBallExpand(patch)(dict(results))["img"]
    want = jtr.BasketBallExpand(patch)(dict(results))["img"]
    assert got.shape == (24, 60, 6) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    [step] = tb.build_pipeline([{"type": "BasketBallExpand", "patch_size": patch}])
    np.testing.assert_array_equal(step(dict(results))["img"], want)
    assert "BasketBallExpand" not in tb.UNPORTED_PIPELINES


# ----------------------------------------------------------- side bands

def test_side_band_helpers_match_jax():
    """`patch_v_map`, `make_uv_from_v` (one-row maps too, where JAX's index
    clamps), `right_u_flag`, `seam_stitched_mask`, each image's stage mask
    and the latitude map's downsampling: within 1e-6 or exact."""
    prv = jnp.asarray(RATIOS)
    for H, W, patch in ((5, 9, 4), (1, 3, 1)):
        v = tv2.patch_v_map(H, W, torch.from_numpy(RATIOS), patch)
        jv = jax.vmap(lambda pr: jv2.patch_v_map(H, W, pr[0], pr[1], pr[2], patch))(prv)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-6)
        np.testing.assert_allclose(tv2.make_uv_from_v(v).numpy(),
                                   np.asarray(jv2.make_uv_from_v(jv)), atol=1e-6)
        np.testing.assert_array_equal(tv2.right_u_flag(H, W).numpy(),
                                      np.asarray(jv2.right_u_flag(H, W)))
    v = tv2.patch_v_map(5, 9, torch.from_numpy(RATIOS), 4)
    want = jnp.concatenate([jnp.asarray(v.numpy()), jnp.asarray(v.numpy())[:, -1:]], 1)
    want = jnp.concatenate([want, want[:, :, -1:]], 2)
    want = (want[:, 0::2, 0::2] + want[:, 1::2, 0::2] + want[:, 0::2, 1::2]
            + want[:, 1::2, 1::2]) * 0.25
    np.testing.assert_array_equal(tv2.downsample_v(v).numpy(), np.asarray(want))
    for Hp, Wp, ws, shift in ((8, 12, 4, 2), (14, 21, 7, 3)):
        stitched = jv2.seam_stitched_mask(Hp, Wp, ws, shift)
        np.testing.assert_array_equal(tv2.seam_stitched_mask(Hp, Wp, ws, shift), stitched)
        for width in (64, 48):
            # the JAX backbone's per-image choice (`panoswin_v2.py:452-463`)
            gap = 4 / prv[:, 2] * np.pi * (prv[:, 1] - prv[:, 0])
            side = (width / 4) * gap + 0.5 * gap > 2 * np.pi
            want = jnp.where(side[:, None, None, None], jnp.asarray(stitched)[None],
                             jnp.asarray(swin_attention_mask(Hp, Wp, ws, shift))[None])
            got = tv2.stage_masks(torch.from_numpy(RATIOS), width, 4, Hp, Wp, ws, shift)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("W", [8, 9])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "reverse"])
def test_pano_transition_v2_matches_jax(W, reverse):
    """Odd W too (the forward pads a column; the reverse rolls with it in
    place): exact."""
    shape = (2, 12, (W + 1) // 2, 3) if reverse else (2, 6, W, 3)
    x = _rng(2).random(shape).astype(np.float32)
    got = tv2.pano_transition_v2(torch.from_numpy(x), 2, reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jv2.pano_transition_v2(jnp.asarray(x), 2, reverse)))


# ------------------------------------------------ attention and blocks

def _state_dict(fill, tree) -> dict:
    sd = {}
    fill(sd, "", to_numpy(tree))
    return sd


@pytest.mark.parametrize("with_uv", [True, False], ids=["sphere", "table"])
def test_window_attention_v2_matches_jax(with_uv):
    """Per-image masks, the blend on each window's centre flag, and the
    table bias when no uv comes in: float32 within 1e-4."""
    rng = _rng(3)
    B, nW, O, c = 2, 3, 16, 8
    x = rng.standard_normal((B * nW, O, c)).astype(np.float32)
    uvr = np.concatenate([rng.uniform(-np.pi, np.pi, (B * nW, O, 1)),
                          rng.uniform(-1.5, 1.5, (B * nW, O, 1)),
                          rng.integers(0, 2, (B * nW, O, 1))], -1).astype(np.float32)
    mask = np.where(rng.random((B, nW, O, O)) < 0.3, -100.0, 0.0).astype(np.float32)
    args = (jnp.asarray(x), jnp.asarray(uvr) if with_uv else None, jnp.asarray(mask))
    jmod = jv2.WindowAttentionV2(c, 4, 2)
    variables = random_variables(jmod, *args, seed=3)
    want = quick_jit(lambda v, a, u, m: jmod.apply(v, a, u, m), variables, *args)
    mod = tv2.WindowAttentionV2(c, 4, 2)
    mod.load_state_dict(_state_dict(tck.panoswin_v2_attention, variables["params"]))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(uvr) if with_uv else None,
                  torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("version", ["v2", "v1"])
@pytest.mark.parametrize("wtt", [1, 0], ids=["pano", "planar"])
@pytest.mark.parametrize("shift", [0, 2])
def test_block_matches_jax(version, wtt, shift):
    """A 5 x 9 map (odd H and W) at window 4, each image's latitudes and
    stage mask: float32 within 1e-4."""
    jcls, tcls = {"v2": (jv2.PanoSwinBlockV2, tv2.PanoSwinBlockV2),
                  "v1": (jv1.PanoSwinBlockV1, tv1.PanoSwinBlockV1)}[version]
    B, H, W, c = 2, 5, 9, 8
    x = _rng(4).standard_normal((B, H, W, c)).astype(np.float32)
    v = tv2.patch_v_map(H, W, torch.from_numpy(RATIOS), 4)
    mask = tv2.stage_masks(torch.from_numpy(RATIOS), 36, 4, 8, 12, 4, 2)
    args = (jnp.asarray(x), jnp.asarray(v.numpy()), jnp.asarray(mask.numpy()))
    jmod = jcls(dim=c, num_heads=2, window_size=4, shift_size=shift, win_trans_type=wtt)
    variables = random_variables(jmod, *args, seed=5)
    want = quick_jit(lambda p, a, b, m: jmod.apply(p, a, b, m), variables, *args)
    mod = tcls(c, 2, 4, shift, win_trans_type=wtt)
    mod.load_state_dict(_state_dict(tck.panoswin_v2_block, variables["params"]))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), v, mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ------------------------------------------------------------ the embeds

def _embed_pair(emb, basketball, embed_dim=16):
    """The port's `PatchEmbedV2` with a random state dict under the
    reference's keys, and JAX's variables of it through
    `convert_panoswin_v2_backbone` (no stages)."""
    port = tv2.PatchEmbedV2(4, embed_dim, emb_conv_type=emb, basketball_trans=basketball)
    sd = random_reference_state_dict(port, 6)
    port.load_state_dict(sd, strict=True)
    params, stats = convert_panoswin_v2_backbone(
        {"patch_embed." + k: v for k, v in sd.items()}, depths=())
    return port.eval(), {"params": params["patch_embed"],
                         "batch_stats": stats.get("patch_embed", {})}


def test_pixel_transformer_matches_jax():
    """The `'tf'` embed's strided patches and its encoder layer: 1e-4."""
    port, variables = _embed_pair("tf", False)
    x = _rng(7).standard_normal((2, 12, 20, 3)).astype(np.float32)
    jmod = jv2.PixelTransformerV2(16, 4)
    want = quick_jit(lambda p, a: jmod.apply(p, a), {"params": variables["params"]["proj"]},
                     jnp.asarray(x))
    with torch.no_grad():
        got = port.proj(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("emb,basketball", [("cnn", False), ("cnn", True), ("tf", True)])
def test_patch_embed_v2_matches_jax(emb, basketball):
    """A 30 x 62 input (padded to whole patches), each image at its ratio:
    the `'cnn'` stem through K1's twin with the BatchNorm folded (the
    JAX stem runs its convolutions and BatchNorm unfolded): 1e-4."""
    port, variables = _embed_pair(emb, basketball)
    x = _rng(8).standard_normal((2, 30, 62, 3)).astype(np.float32)
    jmod = jv2.PatchEmbedV2(4, 16, emb_conv_type=emb, basketball_trans=basketball)
    want = quick_jit(lambda p, a, r: jmod.apply(p, a, r), variables, jnp.asarray(x),
                     jnp.asarray(RATIOS))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(RATIOS))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    if emb == "cnn":
        assert port.kernel_weights(torch.float32).w0.shape == (32, 3, 3, 3)


# ---------------------------------------------------------- the backbones

V2 = {"embed_dim": 6, "depths": (2, 2, 2, 2), "num_heads": (1, 1, 1, 2), "window_size": 4}
BACKBONES_CASES = [
    pytest.param("v2", dict(V2, ape=True), (32, 64), "float32", None, id="v2-ape"),
    pytest.param("v2", dict(V2, ape=True, win_trans_type=0), (36, 84), "float32", None,
                 id="v2-planar-odd"),
    pytest.param("v2", dict(V2, embed_dim=12, depths=(1, 1, 1, 1)), (36, 84), "float32",
                 None, id="v2-depth1-odd"),
    pytest.param("v2", dict(V2, embed_dim=8, emb_conv_type="tf", basketball_trans=True,
                            ape=True), (32, 64), "float32", None, id="v2-tf-basketball"),
    pytest.param("v2", dict(V2, ape=True), (32, 64), "float32", 7, id="v2-window7-to-4"),
    pytest.param("v1", dict(V2, ape=True), (32, 64), "float32", None, id="v1-ape"),
    pytest.param("v1", dict(V2, embed_dim=12, win_trans_type=0), (36, 84), "float32", None,
                 id="v1-planar-odd"),
    pytest.param("v2", dict(V2, ape=True), (32, 64), "bfloat16", None, id="v2-bfloat16"),
    pytest.param("v1", dict(V2, ape=True), (32, 64), "bfloat16", None, id="v1-bfloat16"),
]


@pytest.mark.parametrize("version,kwargs,size,dtype,src_window", BACKBONES_CASES)
def test_backbone_matches_jax(version, kwargs, size, dtype, src_window):
    """A random reference state dict (made at `src_window` where given and
    resized on both sides), loaded strictly into the port and converted for
    JAX: every stage's output."""
    tcls, jcls = {"v2": (tv2.PanoSwinTransformerV2, jv2.PanoSwinTransformerV2),
                  "v1": (tv1.PanoSwinTransformerV1, jv1.PanoSwinTransformerV1)}[version]
    port = tcls(**kwargs, drop_path_rate=0.0, dtype=getattr(torch, dtype)).eval()
    src = tcls(**dict(kwargs, window_size=src_window)) if src_window else port
    sd = random_reference_state_dict(src, 10)
    tck.load_reference_weights(port, sd, strict=True)
    params, stats = convert_panoswin_v2_backbone(sd, kwargs["depths"], window_size=4,
                                                 src_window_size=src_window)
    x = _rng(11).random((2, *size, 3)).astype(np.float32)
    jmod = jcls(**kwargs, drop_path_rate=0.0, dtype=jnp.dtype(dtype))
    want = quick_jit(lambda p, a, r: jmod.apply(p, a, r),
                     {"params": params, "batch_stats": stats}, jnp.asarray(x),
                     jnp.asarray(RATIOS))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(RATIOS))
    assert len(got) == len(want) == 4
    tol = 1e-4 if dtype == "float32" else 0.05
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, i
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=tol, err_msg=f"stage {i}")


def test_registry_and_reference_keys():
    """Both types build from a config; the reference's v2 keys are the
    port's, `coord_encoder` and the three tables included, and a v1 inside
    a detector takes no ratio (JAX's `extract_feat` passes it to the
    v-variant alone)."""
    assert BACKBONES["PanoSwinTransformerV2"] is tv2.PanoSwinTransformerV2
    assert BACKBONES["PanoSwinTransformerV1"] is tv1.PanoSwinTransformerV1
    keys = set(tv2.PanoSwinTransformerV2(**V2, ape=True).state_dict())
    assert {"coord_encoder.weight", "layers.0.blocks.1.attn.sphere_position_alpha_table",
            "layers.0.blocks.1.attn.sphere_position_beta_table",
            "layers.0.blocks.1.attn.relative_position_bias_table",
            "patch_embed.proj.4.running_var", "norm3.weight"} <= keys
    assert set(tv1.PanoSwinTransformerV1(**V2, ape=True).state_dict()) == keys
    assert tv2.PanoSwinTransformerV2.takes_ratio and not tv1.PanoSwinTransformerV1.takes_ratio


@pytest.mark.parametrize("version", ["v2", "v1"])
def test_use_checkpoint_gives_the_same_gradients(version):
    """The port alone (JAX's v-variant takes `use_checkpoint` and ignores
    it): each block recomputed in the backward pass, its DropPath masks
    drawn before it, gives the plain path's outputs and gradients bit for
    bit in train mode at DropPath 0.2 from one explicit generator."""
    cls = {"v2": tv2.PanoSwinTransformerV2, "v1": tv1.PanoSwinTransformerV1}[version]
    x = torch.from_numpy(_rng(16).random((2, 32, 64, 3)).astype(np.float32))
    runs = []
    for checkpointed in (False, True):
        model = cls(**V2, ape=True, drop_path_rate=0.2, use_checkpoint=checkpointed).train()
        model.load_state_dict(random_reference_state_dict(model, 17))
        model.set_drop_path_generator(torch.Generator().manual_seed(18))
        outs = model(x, torch.from_numpy(RATIOS))
        sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        runs.append((outs, {n: p.grad for n, p in model.named_parameters()
                            if p.grad is not None}))
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    assert runs[0][1].keys() == runs[1][1].keys()
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


# ---------------------------------------------------------- the detector

TINY_V2 = dict(ODD_CONFIG["model"], backbone=dict(
    V2, type="PanoSwinTransformerV2", ape=True, drop_path_rate=0.0),
    neck={"type": "FPN", "in_channels": (6, 12, 24, 48), "out_channels": 16, "num_outs": 5},
    train_cfg=TINY_TRAIN_CFG)


@pytest.fixture(scope="module")
def detector_pair():
    """The JAX tiny v2 detector, its variables (BatchNorm away from the
    identity) and the port's copy of them."""
    det = build(DETECTORS, dict(TINY_V2))
    variables = random_variables(det, jnp.zeros((1, 32, 64, 3), jnp.float32), seed=12)
    variables = perturb_batch_norm(to_numpy(variables), 13)
    state_dict = tck.from_jax_variables(variables["params"], variables["batch_stats"])
    variables = jax.tree.map(jnp.asarray, variables)
    return det, variables, state_dict


def _port_detector(state_dict):
    model = build_detector_from_cfg({"model": TINY_V2})
    model.load_state_dict(state_dict, strict=True)
    return model


def test_simple_test_matches_jax(detector_pair):
    """Each image at its own ratio: the same detection slots and labels,
    boxes within 1e-3 px, scores within 1e-5."""
    det, variables, state_dict = detector_pair
    images = _rng(14).random((2, 32, 64, 3)).astype(np.float32)
    shapes = np.array([[32, 64]] * 2, np.float32)
    ref = quick_jit(lambda v, x, s, r: det.apply(v, x, s, None, r, method=det.simple_test),
                    variables, jnp.asarray(images), jnp.asarray(shapes), jnp.asarray(RATIOS))
    model = _port_detector(state_dict).eval()
    got = model.simple_test(torch.from_numpy(images), torch.from_numpy(shapes),
                            pano_ratio_v=torch.from_numpy(RATIOS))
    m = torch.from_numpy(np.array(ref.mask))
    assert m.any() and torch.equal(got.mask, m)
    np.testing.assert_array_equal(got.labels[m].numpy(), np.asarray(ref.labels)[m.numpy()])
    np.testing.assert_allclose(got.boxes[m].numpy(), np.asarray(ref.boxes)[m.numpy()],
                               atol=1e-3)
    np.testing.assert_allclose(got.scores[m].numpy(), np.asarray(ref.scores)[m.numpy()],
                               atol=1e-5)
    # without a ratio the backbone runs at (0, 1, H0): another result
    other = model.simple_test(torch.from_numpy(images), torch.from_numpy(shapes))
    assert not torch.allclose(other.scores, got.scores)


class _PartialRatio:
    """A pipeline step that gives the second frame of each pair a partial
    ratio, as a cropped panorama carries."""

    def __call__(self, results):
        if results["img_info"]["id"] % 2:
            results["pano_ratio_v"] = np.array([0.1, 0.9], np.float32)
        return results


@pytest.fixture(scope="module")
def training(detector_pair, tmp_path_factory):
    """One `train_detector` step of the port, its batch, and JAX's
    `make_train_step` on that batch with the port's starting weights."""
    det, variables, state_dict = detector_pair
    root = tmp_path_factory.mktemp("v2train")
    ann_file, img_dir = write_coco_set(str(root), 2, 32, 64, seed=16, crowd=False)
    dataset = tb.build_dataset({"type": "StreetDataset", "ann_file": ann_file,
                                "img_prefix": img_dir, "pipeline": [
                                    {"type": "LoadImageFromFile"},
                                    {"type": "LoadAnnotations", "with_bbox": True},
                                    {"type": "Normalize", "mean": [123.675, 116.28, 103.53],
                                     "std": [58.395, 57.12, 57.375], "to_rgb": True},
                                    {"type": "PanoCheck"}]})
    dataset.pipeline.transforms.append(_PartialRatio())
    pth = str(root / "start.pth")
    torch.save({"state_dict": state_dict}, pth)
    seen = {}

    def randomness(model, seed, step, batch):
        seen["batch"] = batch
        return jax_step_noise(det, variables, model, seed, step, batch)

    model = _port_detector(state_dict)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tapi, "step_randomness", randomness)
        tapi.train_detector(model, dataset, work_dir=str(root / "work"), total_epochs=1,
                            batch_size=2, base_lr=LR, warmup_iters=0, max_gt=8,
                            num_workers=0, load_from=pth, device="cpu")
    batch = {k: seen["batch"][k] for k in tapi.BATCH_KEYS if k in seen["batch"]}
    assert float(batch["pano_ratio_v"][1, 0]) == pytest.approx(0.1)
    tx = recording(make_optimizer(variables["params"], base_lr=LR, warmup_iters=0))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    key = jax.random.PRNGKey(1)               # the JAX loop's at seed 0; the step folds in 0
    new_state, ref = quick_jit(make_train_step(det), state, jax.tree.map(jnp.asarray, batch),
                               key)
    # the port's step on the same batch, for its gradients
    stepped = _port_detector(state_dict).train()
    optimizer, scheduler = toptim.make_optimizer(stepped, base_lr=LR, warmup_iters=0)
    noise = jax_step_noise(det, variables, stepped, 0, 0, batch)
    got = ttrain.make_train_step(stepped, optimizer, scheduler)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, **noise)
    return {"ref": {k: float(v) for k, v in ref.items()}, "got": got, "looped": model,
            "grads": {n: p.grad.clone() for n, p in stepped.named_parameters()
                      if p.grad is not None},
            "before": state_dict,
            "ref_grads": tck.from_jax_variables(to_numpy(new_state.opt_state[1]),
                                                to_numpy(new_state.batch_stats)),
            "ref_after": tck.from_jax_variables(to_numpy(new_state.params),
                                                to_numpy(new_state.batch_stats))}


@pytest.mark.parametrize("name", ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox",
                                  "acc", "loss", "grad_norm"))
def test_forward_train_with_ratios_matches_jax(training, name):
    got, ref = float(training["got"][name]), training["ref"][name]
    assert np.isfinite(got) and (name == "acc" or got > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_every_gradient_matches_jax(training):
    """Every parameter that a loss reaches (the unused Swin tables get none
    in the port and zeros in JAX)."""
    grads, ref = training["grads"], training["ref_grads"]
    unreached = {k for k in ref if "running" not in k and "num_batches" not in k} - set(grads)
    assert unreached and all(k.endswith("relative_position_bias_table") for k in unreached)
    assert all(not ref[k].numpy().any() for k in unreached)
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 2e-3 * float(np.abs(r).max()),
                                   err_msg=name)


def test_train_detector_update_matches_jax(training):
    """The loop's update from the loader's batch (its ratios included) and
    the stem's running statistics against JAX's step."""
    ref, before, grads = training["ref_after"], training["before"], training["ref_grads"]
    for name, v in training["looped"].state_dict().items():
        if "num_batches" in name:
            continue
        r, p0 = ref[name].numpy(), before[name].numpy()
        assert np.array_equal(v.numpy(), p0) == np.array_equal(r, p0), name
        if "running" in name:
            np.testing.assert_allclose(v.numpy(), r, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            g = grads[name].numpy()
            firm = np.abs(g) > 1e-5 + 1e-3 * np.abs(g).max()
            step = float(np.abs(r - p0).max())
            np.testing.assert_allclose(v.numpy()[firm], r[firm], atol=1e-5 + 1e-3 * step,
                                       err_msg=name)
            np.testing.assert_allclose(v.numpy(), r, atol=2 * LR, err_msg=name)
