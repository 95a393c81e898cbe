"""TridentNet in the PyTorch port against the JAX package: `TridentBlock`
and `TridentResNet` (`models/backbones_extra.py` of each), the
`TridentFasterRCNN` detector (JAX's plain `TwoStageDetector`), and the
model zoo's `configs/tridentnet`.

Every JAX side has random variables of the init's spread with every
BatchNorm drawn away from the identity (`perturb_batch_norm`); the serving
sides draw each shared 3 x 3 kernel (`conv2_kernel`, which the init's
spread draws at 0.02, as a table) normal of std fan_in**-0.5 as a
convolution's (at 256 planes, the train-mode pair's, 0.02 is within 4% of
that).

- `TridentBlock` (16 planes) on three different branch inputs of 2 x 9 x
  13, BatchNorm from its statistics and live: each branch's output (the
  shared kernel at dilations 1, 2, 3) within 1e-4 * max|ref| in float32,
  and every branch's running statistics within 1e-6;
- `TridentResNet-50` in eval mode at 64 x 64: each stage within 1e-4 *
  max|ref| in float32, the port's bfloat16 within 0.05 * max|ref|;
- `TridentResNet-50` in train mode with `norm_eval` True and False on 2
  frames of 64 x 64, float64 on both sides
  (`torch_port_common.cnn_train_pair`): the stages, every gradient for a
  seeded cotangent, and the running statistics of all three branches'
  BatchNorms (the outer branches' move exactly when BatchNorm is live).
  The parameters that get no gradient in the port are exactly the outer
  branches' BatchNorm parameters, whose gradient JAX computes as 0;
- in a training step of the port's optimizer those parameters, which no
  loss reaches, stay as they were, as optax leaves a parameter of zero
  gradient that it does not decay;
- a tiny `TridentFasterRCNN` (5 classes, FPN 16) `simple_test` with
  non-unit scale factors: equal counts, each detection with a partner of
  the same label within 1e-3 px and score within 1e-5;
- every config of `configs/tridentnet` builds and trains, and the census
  counts 3 built, 3 trainable.
"""

import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.models import backbones_extra as jextra
from panoswintransformerobjectdetection_torch.apis.inference import (DETECTOR_TYPES,
                                                                     build_detector_from_cfg)
from panoswintransformerobjectdetection_torch.models import backbones_extra as textra
from panoswintransformerobjectdetection_torch.models.detectors import (PanoFasterRCNN,
                                                                       check_train_cfg)
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (from_jax_cnn_backbone,
                                                                         from_jax_variables)
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from panoswintransformerobjectdetection_torch.tools import config_census
from test_torch_mask_rcnn import _match
from torch_port_common import (TINY_MASK_RCNN, check_cnn_train_pair,  # noqa: F401
                               cnn_train_pair, in_background, perturb_batch_norm,
                               prefetch_cnn_references, quick_jit, random_variables,
                               selected_params, single_torch_thread, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs", "tridentnet"))
                 if f.endswith(".py"))
SIZE = (64, 64)
H, W = 64, 96
TINY_TRIDENT = dict(TINY_MASK_RCNN, type="TridentFasterRCNN", with_mask=False,
                    backbone={"type": "TridentResNet", "depth": 50, "num_trident_blocks": 3},
                    neck={"type": "FPN", "in_channels": (256, 512, 1024, 2048),
                          "out_channels": 16, "num_outs": 5})
REG_SCALE = 0.05
OUTER = textra.OUTER_BRANCHES


@pytest.fixture(scope="module", autouse=True)
def trident_references(request):
    """The JAX side of every selected train-mode case in the worker
    processes, and of the eval backbone and the detector in background
    threads, started at once."""
    prefetch_cnn_references([
        (jextra.TridentResNet, {"depth": 50}, SIZE, 21, {"norm_eval": p["norm_eval"]})
        for p in selected_params(request, "test_train_mode_backbone_matches_jax")])
    names = {item.originalname for item in request.session.items
             if item.module is request.module}
    if "test_backbone_matches_jax" in names:
        _reference("backbone")
    if "test_simple_test_matches_jax" in names:
        _reference("detector")


def spread_trident_kernels(tree, seed):
    """numpy `tree` with every `conv2_kernel` (HWIO) drawn normal of std
    fan_in**-0.5 from `seed`."""
    rng = np.random.default_rng(seed)

    def walk(t):
        return {k: (rng.standard_normal(v.shape) * float(np.prod(v.shape[:3])) ** -0.5
                    ).astype(np.float32) if k == "conv2_kernel" else
                walk(v) if isinstance(v, dict) else v for k, v in sorted(t.items())}

    return walk(tree)


def _variables(module, *samples, seed):
    variables = perturb_batch_norm(to_numpy(random_variables(module, *samples, seed=seed)),
                                   seed=seed + 1)
    return dict(variables, params=spread_trident_kernels(variables["params"], seed + 2))


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).standard_normal((n, h, w, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(kind):
    return in_background({"backbone": _compute_backbone, "detector": _compute_detector}[kind])


def _compute_backbone():
    module = jextra.TridentResNet(depth=50)
    variables = _variables(module, jnp.zeros((1,) + SIZE + (3,)), seed=91)
    return variables, to_numpy(quick_jit(module.apply, variables,
                                         jnp.asarray(_frames(1, *SIZE, 94))))


def _detector_inputs():
    return (_frames(2, H, W, 95), np.array([[H, W], [60, 90]], np.float32),
            np.array([[1.5, 1.5, 1.5, 1.5], [1.2, 1.25, 1.2, 1.25]], np.float32))


def _compute_detector():
    det = build(DETECTORS, dict(TINY_TRIDENT))
    variables = _variables(det, jnp.zeros((1, H, W, 3), jnp.float32), seed=96)
    for p in variables["params"].values():
        for reg in ("rpn_reg", "fc_reg"):
            if reg in p:
                p[reg]["kernel"] = p[reg]["kernel"] * REG_SCALE
    ref = quick_jit(lambda v, a, b, c: det.apply(v, a, b, c, method=det.simple_test), variables,
                    *(jnp.asarray(x) for x in _detector_inputs()))
    return from_jax_variables(variables["params"], variables["batch_stats"]), to_numpy(ref)


def _block_state(params, stats):
    """A JAX `TridentBlock`'s variables under the port's keys, through
    `from_jax_cnn_backbone` (the block as a backbone's `layer1_1`, after an
    entry block)."""
    c = np.shape(params["conv1"]["kernel"])[2]
    stem = {"kernel": np.zeros((7, 7, 3, 64), np.float32)}
    bn = {"scale": np.ones(64, np.float32), "bias": np.zeros(64, np.float32)}
    bn_stats = {"mean": np.zeros(64, np.float32), "var": np.ones(64, np.float32)}
    entry = {"conv1": {"kernel": np.zeros((1, 1, 64, c), np.float32)},
             "bn1": {"scale": np.ones(c), "bias": np.zeros(c)}}
    sd = from_jax_cnn_backbone(
        {"conv1": stem, "bn1": bn, "layer1_entry": entry, "layer1_1": params},
        {"bn1": bn_stats, "layer1_entry": {"bn1": {"mean": np.zeros(c), "var": np.ones(c)}},
         "layer1_1": stats})
    return {k[len("layer1.1."):]: v for k, v in sd.items() if k.startswith("layer1.1.")}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "live_bn"])
def test_trident_block_matches_jax(train):
    rng = np.random.default_rng(97)
    xs = [rng.standard_normal((2, 9, 13, 64)).astype(np.float32) for _ in range(3)]
    jxs = [jnp.asarray(x) for x in xs]
    jmodule = jextra.TridentBlock(planes=16)
    variables = _variables(jmodule, jxs, seed=98)
    ref, updates = quick_jit(lambda v, a: jmodule.apply(v, a, train=train,
                                                        mutable=["batch_stats"]), variables, jxs)
    block = textra.TridentBlock(16)
    block.load_state_dict(_block_state(variables["params"], variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = [block.branch(torch.from_numpy(x).permute(0, 3, 1, 2), b, train)
               for b, x in enumerate(xs)]
    for b, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), r,
                                   atol=1e-4 * float(np.abs(r).max()), rtol=0,
                                   err_msg=f"branch {b}")
    want = _block_state(variables["params"], to_numpy(updates["batch_stats"]))
    before = _block_state(variables["params"], variables["batch_stats"])
    for name, v in block.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)
            assert torch.equal(v, before[name]) != train, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backbone_matches_jax(dtype):
    variables, ref = _reference("backbone").result()
    model = textra.TridentResNet(depth=50, dtype=getattr(torch, dtype))
    model.load_state_dict(from_jax_cnn_backbone(variables["params"], variables["batch_stats"]),
                          strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(_frames(1, *SIZE, 94)))
    assert [tuple(g.shape) for g in got] == [r.shape for r in ref] == [
        (1, SIZE[0] // s, SIZE[1] // s, 64 * s) for s in (4, 8, 16, 32)]
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == getattr(torch, dtype)
        rel = 1e-4 if dtype == "float32" else 0.05
        np.testing.assert_allclose(g.float().numpy(), r, atol=rel * float(np.abs(r).max()),
                                   rtol=0, err_msg=f"stage {i}")


@pytest.mark.parametrize("norm_eval", [True, False], ids=["norm_eval", "live_bn"])
def test_train_mode_backbone_matches_jax(norm_eval):
    pair = cnn_train_pair(jextra.TridentResNet, textra.TridentResNet, {"depth": 50}, SIZE, 21,
                          norm_eval=norm_eval)
    outer = [n for n in pair["grads"] if n.startswith("layer3.") and
             any(f".bn{k}.{b}." in n for k in (1, 2, 3) for b in OUTER)]
    assert len(outer) == 5 * 3 * 2 * 2
    assert check_cnn_train_pair(pair, live=not norm_eval) == outer


def test_unreached_branches_stay_put_under_the_optimizer():
    """One step of the port's AdamW on a trident detector with live
    BatchNorm: the outer branches' BatchNorm parameters get no gradient
    (None, as every parameter that no loss reaches) and stay as they were
    (no decay on norms; Adam's update of a zero gradient is 0, optax's
    too), the middle branch's move, and every branch's statistics move."""
    cfg = dict(TINY_TRIDENT, backbone=dict(TINY_TRIDENT["backbone"], norm_eval=False))
    model = build_detector_from_cfg({"model": cfg}).train()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    optimizer, _ = toptim.make_optimizer(model, base_lr=1e-2, warmup_iters=0)
    batch = {"images": torch.from_numpy(_frames(2, H, W, 99)),
             "img_shapes": torch.tensor([[H, W], [60.0, 90.0]]),
             "gt_boxes": torch.tensor([[[4.0, 2, 44, 34], [30, 10, 90, 60]],
                                       [[10.0, 4, 50, 44], [0, 0, 0, 0]]]),
             "gt_labels": torch.tensor([[0, 3], [1, 0]]),
             "gt_valid": torch.tensor([[True, True], [True, False]])}
    out = model.forward_train(**batch, generator=torch.Generator().manual_seed(0))
    sum(v for k, v in out.items() if "loss" in k).backward()
    unreached = {n for n, p in model.named_parameters() if p.grad is None}
    outer = {n for n, _ in model.named_parameters() if n.startswith("backbone.layer3.")
             and any(f".bn{k}.{b}." in n for k in (1, 2, 3) for b in OUTER)}
    assert unreached == outer
    optimizer.step()
    after = model.state_dict()
    for name in outer:
        assert torch.equal(after[name], before[name]), name
    mid = textra.TRIDENT_TEST_BRANCH
    assert not torch.equal(after[f"backbone.layer3.1.bn2.{mid}.weight"],
                           before[f"backbone.layer3.1.bn2.{mid}.weight"])
    for b in range(3):
        assert not torch.equal(after[f"backbone.layer3.5.bn3.{b}.running_var"],
                               before[f"backbone.layer3.5.bn3.{b}.running_var"])


def test_simple_test_matches_jax():
    sd, ref = _reference("detector").result()
    model = build_detector_from_cfg({"model": TINY_TRIDENT})
    assert type(model) is PanoFasterRCNN and type(model.backbone) is textra.TridentResNet
    model.load_state_dict(sd, strict=True)
    got = model.eval().simple_test(*(torch.from_numpy(x) for x in _detector_inputs()))
    for i in range(2):
        m = np.asarray(ref.mask[i])
        assert m.sum() > 0
        want = {k: np.asarray(getattr(ref, k)[i])[m] for k in ("boxes", "scores", "labels")}
        tm = got.mask[i].numpy()
        _match({k: getattr(got, k)[i].numpy()[tm] for k in ("boxes", "scores", "labels")},
               want, f"image {i}")


def test_reference_keys():
    """The reference's keys outside res4's trident blocks (res4's first
    block is the reference's `layer3.0`, norms shared); a branch index on
    the trident blocks' norms (`bn{n}.{b}`), the shared kernel at
    `conv2.weight`."""
    with torch.device("meta"):
        keys = set(textra.TridentResNet(depth=50).state_dict())
    for k in ("conv1.weight", "bn1.running_var", "layer3.0.conv2.weight", "layer3.0.bn2.weight",
              "layer3.0.downsample.0.weight", "layer3.0.downsample.1.num_batches_tracked",
              "layer3.1.conv2.weight", "layer3.5.bn3.2.running_mean", "layer3.3.bn1.0.bias",
              "layer4.2.bn3.weight"):
        assert k in keys, k
    assert not any(k.startswith(("layer3.1.bn1.weight", "layer3.1.downsample")) for k in keys)


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build(name):
    cfg = load_config(os.path.join(ROOT, "configs", "tridentnet", name))
    with torch.device("meta"):
        model = build_detector_from_cfg(cfg)
    assert cfg["model"]["type"] == "TridentFasterRCNN"
    assert type(model) is DETECTOR_TYPES["TridentFasterRCNN"] is PanoFasterRCNN
    assert type(model.backbone) is textra.TridentResNet
    res4 = model.backbone.stages[2]
    assert len(res4) == 6 and all(type(b) is textra.TridentBlock for b in res4[1:])
    check_train_cfg(model.train_cfg)


def test_census_counts_tridentnet():
    result = config_census.census(os.path.join(ROOT, "configs", "tridentnet"))
    assert (result["configs"], result["built"], result["trainable"]) == (3, 3, 3)
