"""Res2Net and ResNeSt backbones of the PyTorch port against the JAX
package's (`models/backbones_extra.py` of each), serving and training, and
the model zoo's `configs/res2net` and `configs/resnest` detectors.

Serving: Res2Net-50 and ResNeSt-50 at full width on a 64 x 128 frame, in
eval mode, from random variables of the JAX init's spread with every
BatchNorm drawn away from the identity (`perturb_batch_norm`), carried
across by `from_jax_cnn_backbone`: each stage in float32 within 1e-4 *
max|ref|, and the port's bfloat16 against JAX's float32 within 0.05 *
max|ref| (`test_torch_resnet.py`'s tolerances).  Training: both in train
mode with `norm_eval` True and False on 2 frames of 32 x 64, float64 on
both sides (`torch_port_common.cnn_train_pair`, and why float64 in
`test_torch_resnet_train.py`): stages, every gradient for a seeded
cotangent and the running statistics, ResNeSt's BatchNorm over (B, inter)
included.  The stride-2 average pools against flax's `avg_pool`, whose
padded zeros count in the mean.  Every key and shape of the 101-layer
variants against JAX's traced variables; the configs build as JAX would
(HTC aside), and the census counts them.
"""

import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import backbones_extra as jextra
from panoswintransformerobjectdetection_torch.apis.inference import (DETECTOR_TYPES,
                                                                     build_detector_from_cfg)
from panoswintransformerobjectdetection_torch.models import backbones_extra as textra
from panoswintransformerobjectdetection_torch.models.detectors import check_train_cfg
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_cnn_backbone
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from panoswintransformerobjectdetection_torch.tools import config_census
from torch_port_common import (check_cnn_train_pair, cnn_train_pair,  # noqa: F401
                               in_background, perturb_batch_norm, prefetch_cnn_references,
                               quick_jit, random_variables, selected_params,
                               single_torch_thread, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 64, 128
CASES = {"res2net50": (jextra.Res2Net, textra.Res2Net, {"depth": 50}),
         "resnest50": (jextra.ResNeSt, textra.ResNeSt, {"depth": 50})}
DIRS = ("res2net", "resnest")
CONFIGS = sorted(os.path.join(d, f) for d in DIRS
                 for f in os.listdir(os.path.join(ROOT, "configs", d)) if f.endswith(".py"))


def _frames():
    return np.random.default_rng(0).standard_normal((1, H, W, 3)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def cnn_references(request):
    """The JAX side of every selected serving case, started at once in
    background threads (`in_background`), and of every training case, in
    worker processes (`prefetch_cnn_references`)."""
    for p in selected_params(request, "test_stages_match_jax"):
        _serving_reference(p["case"])
    prefetch_cnn_references([
        (CASES[p["case"]][0], CASES[p["case"]][2], (32, 64), 21, {"norm_eval": p["norm_eval"]})
        for p in selected_params(request, "test_train_mode_backbone_matches_jax")])


def _reference(case):
    return _serving_reference(case).result()


@functools.lru_cache(maxsize=None)
def _serving_reference(case):
    """The JAX stage outputs of `case` in eval mode, started in the
    background (`in_background`) at the first call."""
    return in_background(_compute_reference, case)


def _compute_reference(case):
    jcls, _, kwargs = CASES[case]
    module = jcls(**kwargs)
    variables = perturb_batch_norm(to_numpy(
        random_variables(module, jnp.zeros((1, H, W, 3)), seed=11)), seed=12)
    outs = quick_jit(module.apply, variables, jnp.asarray(_frames()))
    return variables, [np.asarray(o) for o in outs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stages_match_jax(case, dtype):
    variables, ref = _reference(case)
    _, tcls, kwargs = CASES[case]
    model = tcls(**kwargs, dtype=getattr(torch, dtype))
    model.load_state_dict(from_jax_cnn_backbone(variables["params"], variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(_frames()))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref] == [
        (1, H // s, W // s, 256 * s // 4) for s in (4, 8, 16, 32)]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == getattr(torch, dtype)
        rel = 1e-4 if dtype == "float32" else 0.05
        np.testing.assert_allclose(g.float().numpy(), r, atol=rel * float(np.abs(r).max()),
                                   rtol=0, err_msg=f"stage {i}")


@pytest.mark.parametrize("norm_eval", [True, False], ids=["norm_eval", "live_bn"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_mode_backbone_matches_jax(case, norm_eval):
    jcls, tcls, kwargs = CASES[case]
    pair = cnn_train_pair(jcls, tcls, kwargs, (32, 64), 21, norm_eval=norm_eval)
    assert check_cnn_train_pair(pair, live=not norm_eval) == []


@pytest.mark.parametrize("size", [(8, 12), (7, 9)])
def test_avg_pool_counts_the_padding_as_flax_does(size):
    """Res2Net's pass-through split and ResNeSt-D's pool after the split
    attention: flax's `avg_pool(3 x 3, stride 2, padding 1)` divides by 9
    at the border too; a pool that leaves the padding out differs there."""
    x = np.random.default_rng(1).standard_normal((2,) + size + (5,)).astype(np.float32)
    ref = np.asarray(fnn.avg_pool(jnp.asarray(x), (3, 3), strides=(2, 2),
                                  padding=((1, 1), (1, 1))))
    got = textra.avg_pool_3x3(torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    other = torch.nn.functional.avg_pool2d(torch.from_numpy(x).permute(0, 3, 1, 2), 3, 2, 1,
                                           count_include_pad=False).permute(0, 2, 3, 1)
    assert np.abs(other.numpy() - ref).max() > 1e-2


@pytest.mark.parametrize("jcls,tcls,kwargs", [
    pytest.param(jextra.Res2Net, textra.Res2Net, {"depth": 101}, id="res2net101"),
    pytest.param(jextra.ResNeSt, textra.ResNeSt, {"depth": 101}, id="resnest101"),
    pytest.param(jextra.Res2Net, textra.Res2Net, {"depth": 50, "scales": 6, "base_width": 14},
                 id="res2net50_6s"),
])
def test_every_key_and_shape_matches_jax(jcls, tcls, kwargs):
    """Every state-dict key and shape of the port against JAX's variables,
    traced for their shapes alone: the reference's names (`convs.{i}`,
    `bns.{i}`; `stem.{0,1,3,4,6,7}`, `conv2.{conv,bn0,fc1,bn1,fc2}`,
    `downsample.{1,2}`)."""
    variables = jax.eval_shape(jcls(**kwargs).init, jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 3)))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), variables)
    want = {k: tuple(v.shape) for k, v in from_jax_cnn_backbone(
        zeros["params"], zeros["batch_stats"]).items()}
    with torch.device("meta"):
        own = {k: tuple(v.shape) for k, v in tcls(**kwargs).state_dict().items()}
    assert own == want


def test_resnest_keys_are_the_references():
    with torch.device("meta"):
        keys = set(textra.ResNeSt(depth=50).state_dict())
    for k in ("stem.0.weight", "stem.4.running_var", "stem.7.bias", "layer2.0.conv2.conv.weight",
              "layer2.0.conv2.bn0.weight", "layer2.0.conv2.fc1.bias", "layer2.0.conv2.bn1.weight",
              "layer2.0.conv2.fc2.weight", "layer2.0.downsample.1.weight",
              "layer2.0.downsample.2.running_mean", "layer4.2.bn3.weight"):
        assert k in keys, k
    with torch.device("meta"):
        keys = set(textra.Res2Net(depth=50).state_dict())
    for k in ("conv1.weight", "layer1.0.convs.2.weight", "layer3.5.bns.0.running_var",
              "layer1.0.downsample.0.weight", "layer1.0.downsample.1.bias"):
        assert k in keys, k


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build(name):
    """Every config of the two directories builds on the meta device with
    its backbone, stage widths equal to the FPN's `in_channels`, its
    detector type, and trains (`check_train_cfg`); the HTC config raises for
    its detector type."""
    cfg = load_config(os.path.join(ROOT, "configs", name))
    if cfg["model"]["type"] == "HybridTaskCascade":
        with pytest.raises(NotImplementedError, match="HybridTaskCascade.*item 17"):
            build_detector_from_cfg(cfg)
        return
    with torch.device("meta"):
        model = build_detector_from_cfg(cfg)
    bb = cfg["model"]["backbone"]
    assert type(model.backbone) is {"Res2Net": textra.Res2Net, "ResNeSt": textra.ResNeSt}[bb["type"]]
    widths = [stage[-1].bn3.num_features for stage in model.backbone.stages]
    assert widths == list(cfg["model"]["neck"]["in_channels"]) == [256, 512, 1024, 2048]
    assert len(model.backbone.stages[2]) == {50: 6, 101: 23}[bb["depth"]]
    assert type(model) is DETECTOR_TYPES[cfg["model"]["type"]]
    check_train_cfg(model.train_cfg)


def test_census_counts_res2net_and_resnest():
    counts = {}
    for d in DIRS:
        result = config_census.census(os.path.join(ROOT, "configs", d))
        counts[d] = (result["configs"], result["built"], result["trainable"])
    assert counts == {"res2net": (5, 4, 4), "resnest": (13, 13, 13)}
