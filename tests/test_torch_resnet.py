"""ResNet, ResNeXt and RegNet backbones of the PyTorch port against the JAX
package (`models/resnet.py`, `models/backbones_extra.py` of each).

Each backbone runs at full width on a 64 x 128 frame with random
variables of the JAX init's spread (`random_variables`) whose BatchNorms are
drawn away from the identity (`perturb_batch_norm`: scales in [0.5, 1.5],
biases and means N(0, 0.1), variances in [0.5, 2]; with the identity a
wrong eps, a swapped statistic or a downsample BatchNorm on the wrong conv
would pass), carried across by `from_jax_cnn_backbone`.  The cases: ResNet-18,
ResNet-50 in pytorch and caffe style, ResNet-50 with a dilated last stage
of stride 1 (the DC5 layout), ResNeXt-50 32x4d and RegNetX-3.2GF.

Tolerances, per stage: float32 1e-4 * max|ref| (sums in another order
through up to 17 blocks; at most 1.6e-6 measured); the port's bfloat16
against JAX's float32 (JAX runs no CNN backbone in bfloat16) 0.05 *
max|ref|, as the Swin backbone's bfloat16 test allows on its unit-scale
outputs (at most 1.4e-2 measured).  The
stem's max-pool, the key layouts and every conv's shape are exact.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import backbones_extra as jextra
from panoswintransformerobjectdetection_tpu.models import resnet as jresnet
from panoswintransformerobjectdetection_tpu.runtime.checkpoint import convert_resnet_backbone
from panoswintransformerobjectdetection_torch.models import backbones_extra as textra
from panoswintransformerobjectdetection_torch.models import resnet as tresnet
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_cnn_backbone
from torch_port_common import (perturb_batch_norm, quick_jit,  # noqa: F401
                               random_variables, single_torch_thread, to_numpy)

H, W = 64, 128
# name -> (JAX class, port class, arguments)
CASES = {
    "r18": (jresnet.ResNet, tresnet.ResNet, {"depth": 18}),
    "r50": (jresnet.ResNet, tresnet.ResNet, {"depth": 50}),
    "r50_caffe": (jresnet.ResNet, tresnet.ResNet, {"depth": 50, "style": "caffe"}),
    "r50_dc5": (jresnet.ResNet, tresnet.ResNet, {"depth": 50, "strides": (1, 2, 2, 1),
                                                 "dilations": (1, 1, 1, 2)}),
    "x50_32x4d": (jresnet.ResNeXt, tresnet.ResNeXt, {"depth": 50}),
    "regnetx_3.2gf": (jextra.RegNet, textra.RegNet, {"arch": "regnetx_3.2gf"}),
}
RESNETS = [c for c in CASES if c != "regnetx_3.2gf"]


def _frames():
    return np.random.default_rng(0).standard_normal((1, H, W, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(case):
    """The JAX backbone of `case`, its variables (numpy, BatchNorm away from
    the identity) and its stage outputs on `_frames()`, made once."""
    jcls, _, kwargs = CASES[case]
    module = jcls(**kwargs)
    variables = perturb_batch_norm(to_numpy(
        random_variables(module, jnp.zeros((1, H, W, 3)), seed=11)), seed=12)
    outs = quick_jit(module.apply, variables, jnp.asarray(_frames()))
    return module, variables, [np.asarray(o) for o in outs]


def _port(case, dtype=None):
    _, tcls, kwargs = CASES[case]
    _, variables, _ = _reference(case)
    model = tcls(**kwargs, dtype=dtype)
    model.load_state_dict(from_jax_cnn_backbone(variables["params"], variables["batch_stats"]),
                          strict=True)
    return model.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_match_jax(case, dtype):
    """Every stage's output, its shape and its values; bfloat16 against
    JAX's float32."""
    _, _, ref = _reference(case)
    model = _port(case, getattr(torch, dtype))
    with torch.no_grad():
        got = model(torch.from_numpy(_frames()))
    assert len(got) == len(ref) == 4
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == getattr(torch, dtype) and g.shape == r.shape, f"stage {i}"
        rel = 1e-4 if dtype == "float32" else 0.05
        np.testing.assert_allclose(g.float().numpy(), r, atol=rel * float(np.abs(r).max()),
                                   rtol=0, err_msg=f"stage {i}")


def test_stem_and_stages_are_the_detector_hooks():
    """`patch_embed` (conv1, bn1, ReLU, the max-pool) then
    `forward_from_embed` is the whole backbone, as the detector's stem and
    backbone stages call it."""
    model = _port("r50")
    x = torch.from_numpy(_frames())
    with torch.no_grad():
        stem = model.patch_embed(x)
        assert stem.shape == (1, H // 4, W // 4, 64)
        for a, b in zip(model.forward_from_embed(stem), model(x)):
            assert torch.equal(a, b)


def test_max_pool_pads_with_minus_inf():
    """The stem's pool equals JAX's -inf pad and unpadded pool bit for bit,
    on negative maps where a zero-padded border would win."""
    x = -np.random.default_rng(1).random((2, 9, 14, 5)).astype(np.float32) - 0.1
    padded = jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)), constant_values=-jnp.inf)
    ref = np.asarray(fnn.max_pool(padded, (3, 3), strides=(2, 2)))
    got = tresnet.max_pool_stem(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == ref.shape == (2, 5, 7, 5)
    np.testing.assert_array_equal(got.numpy(), ref)
    zero_padded = np.asarray(fnn.max_pool(jnp.pad(jnp.asarray(x), ((0, 0), (1, 1), (1, 1),
                                                                   (0, 0))), (3, 3), strides=(2, 2)))
    assert (zero_padded != ref).any()


@pytest.mark.parametrize("case", RESNETS)
def test_convert_resnet_backbone_gives_back_the_jax_variables(case):
    """The JAX package's own `convert_resnet_backbone` (torchvision's keys)
    reads the port's `state_dict()` back into the JAX variables exactly: the
    port's keys are the reference's."""
    _, variables, _ = _reference(case)
    params, stats = convert_resnet_backbone(_port(case).state_dict(), CASES[case][2]["depth"])
    flat = jax.tree_util.tree_leaves_with_path
    want = dict(flat({"params": variables["params"], "batch_stats": variables["batch_stats"]}))
    got = dict(flat({"params": params, "batch_stats": stats}))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=jax.tree_util.keystr(k))


def _shapes(jcls, kwargs):
    variables = jax.eval_shape(jcls(**kwargs).init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), variables)
    sd = from_jax_cnn_backbone(zeros["params"], zeros["batch_stats"])
    return {k: tuple(v.shape) for k, v in sd.items()}


@pytest.mark.parametrize("name,jcls,tcls,kwargs", [
    pytest.param(name, jcls, tcls, kwargs, id=name) for name, jcls, tcls, kwargs in [
        ("x101_64x4d", jresnet.ResNeXt, tresnet.ResNeXt, {"depth": 101, "groups": 64}),
        ("x101_32x8d", jresnet.ResNeXt, tresnet.ResNeXt, {"depth": 101, "base_width": 8}),
    ] + [(arch, jextra.RegNet, textra.RegNet, {"arch": arch})
         for arch in ("regnetx_4.0gf", "regnetx_6.4gf", "regnetx_8.0gf", "regnetx_12gf")]])
def test_every_conv_shape_matches_jax(name, jcls, tcls, kwargs):
    """The other backbones of the configs that build: every key and every
    parameter's shape of the port equals the JAX backbone's, traced for its
    shapes alone: each conv's channels and groups (JAX's ResNeXt width,
    RegNet's `width // groups` with its fallback to 1 where the group width
    does not divide, as in regnetx_8.0gf's first stage)."""
    with torch.device("meta"):
        own = {k: tuple(v.shape) for k, v in tcls(**kwargs).state_dict().items()}
    assert own == _shapes(jcls, kwargs)
    if name == "regnetx_8.0gf":
        assert textra.conv_groups(80, 120) == 1 and textra.conv_groups(240, 120) == 2


@pytest.mark.parametrize("option,value", [
    ("dcn", {"dcn": {"type": "DCNv2"}, "stage_with_dcn": (False, True, True, True)}),
    ("gcb", {"gcb": {"ratio": 0.25}, "stage_with_gcb": (False, True, True, True)}),
    ("gen_attention", {"gen_attention": {"num_heads": 8}, "stage_with_gen_attention":
                       (False, False, True, True)}),
])
def test_plugin_options_raise_naming_item_17d(option, value):
    """DCN, GCB and GeneralizedAttention in some stage raise, naming item
    17d; with no stage they select nothing, as in JAX, and build."""
    with pytest.raises(NotImplementedError, match=f"{option}.*item 17d"):
        tresnet.ResNet(depth=18, **value)
    stages = next(k for k in value if k.startswith("stage_with"))
    with torch.device("meta"):
        tresnet.ResNet(depth=18, **dict(value, **{stages: (False,) * 4}))
    if option == "dcn":
        with pytest.raises(NotImplementedError, match="dcn.*item 17d"):
            textra.RegNet(**value)


def test_rfp_feats_raise_naming_item_17d():
    with torch.device("meta"):
        model = tresnet.ResNet(depth=18)
    with pytest.raises(NotImplementedError, match="rfp_feats.*item 17d"):
        model(torch.zeros((1, 32, 32, 3), device="meta"), rfp_feats=[None] * 4)
