"""HRNet and HRFPN of the PyTorch port against the JAX package's
(`models/hrnet.py` of each), serving and training, and the model zoo's
`configs/hrnet` detectors.

Every JAX side has random variables of the init's spread with every
BatchNorm drawn away from the identity (`perturb_batch_norm`): a BatchNorm
near the identity would hide a branch's error among the fusion paths.

- `FuseLayer` and `HRModule` on four branches of the sizes a 36 x 52 frame
  gives (9 x 13, 5 x 7, 3 x 4, 2 x 2: the non-integer nearest upsample and
  the strided chains' ceil), BatchNorm from its statistics and live: the
  outputs within 1e-4 * max|ref|, the running statistics within 1e-6;
- HRNet-W18 in eval mode at 32 x 32 and 36 x 52: each branch within
  1e-4 * max|ref| in float32, and the port's bfloat16 against JAX's float32
  within 0.05 * max|ref| (`test_torch_resnet.py`'s tolerances);
- HRNet-W18 in train mode with `norm_eval` True and False on 2 frames of
  64 x 64, float64 on both sides (`torch_port_common.cnn_train_pair`, and
  why float64 in `test_torch_resnet_train.py`): the branches, every
  gradient for a seeded cotangent, the running statistics.  Not 32 x 32:
  there the last branch is 1 x 1, each of its live BatchNorms normalises
  2 values, and float64 rounding moved a branch by 1.07e-7 against the
  check's 9.7e-9 (1e-9 * max|ref|) with its variance near 0.  For time the
  stages run one module each of two blocks a branch, on both sides
  (`STAGE_MODULES`, `BLOCKS_PER_BRANCH` patched at run time, the JAX side's
  in its worker process): every transition, every fusion path;
- `HRFPN` on the branches of a 72 x 104 frame, float32, 1e-4 * max|ref|;
- JAX fault (as for ResNet, `test_torch_resnet_detectors.py`):
  `TwoStageDetector.setup` hands the cascade configs' `compute_dtype` to
  the backbone and the neck, which take none, so JAX raises `TypeError` on
  the bf16 HRNet cascades; the port
  builds `cascade_mask_rcnn_hrnetv2p_w18_20e_coco.py` as it is (5 classes,
  HRFPN 16), loads a float32 JAX cascade's weights (`from_jax_variables`:
  HRNet, HRFPN, the three heads, the mask head) and serves it; its
  float32 backbone and neck within 1e-4 * max|ref| of JAX's, its bfloat16
  ones within 0.05 * max|ref|;
- a random state dict under the reference's keys loads strictly, with its
  `num_batches_tracked`, through `init_detector`;
- every config of `configs/hrnet` builds (FCOS and HTC refused) and the
  census counts 18 built, 18 trainable.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.models import hrnet as jhrnet
from panoswintransformerobjectdetection_torch.apis.inference import (DETECTOR_TYPES,
                                                                     build_detector_from_cfg,
                                                                     init_detector)
from panoswintransformerobjectdetection_torch.models import hrnet as thrnet
from panoswintransformerobjectdetection_torch.models.cascade import CASCADE_MASK_STAGES
from panoswintransformerobjectdetection_torch.models.detectors import check_train_cfg
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (from_jax_cnn_backbone,
                                                                         from_jax_hrnet,
                                                                         from_jax_variables)
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from panoswintransformerobjectdetection_torch.tools import config_census
from torch_port_common import (TINY_MASK_RCNN, check_cnn_train_pair,  # noqa: F401
                               cnn_train_pair, in_background, perturb_batch_norm,
                               prefetch_cnn_references, quick_jit, random_reference_state_dict,
                               random_variables, selected_params, single_torch_thread, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs", "hrnet"))
                 if f.endswith(".py"))
CASCADE_CONFIG = "configs/hrnet/cascade_mask_rcnn_hrnetv2p_w18_20e_coco.py"
W18 = (18, 36, 72, 144)
# the branches of a 36 x 52 frame, narrow
WIDTHS = (4, 6, 8, 10)
SIZES = ((9, 13), (5, 7), (3, 4), (2, 2))
# one module a stage, two blocks a branch: the train-mode pair, on both sides
JAX_HRNET = jhrnet.__name__
NARROW = ((JAX_HRNET, "STAGE_MODULES", (1, 1, 1)), (JAX_HRNET, "BLOCKS_PER_BRANCH", 2))
H, W = 64, 96
TRAIN_SIZE = (64, 64)
# The RPN's and the heads' regression kernels are scaled by this, as in
# `test_torch_resnet_detectors.py`: with the init's spread every box of a
# random CNN detector would be clipped flat.
REG_SCALE = 0.05


@pytest.fixture(scope="module", autouse=True)
def hrnet_references(request):
    """The JAX side of the cascade (whose backbone the serving tests share)
    in a background thread, and of every selected train-mode case in the
    worker processes, started at once."""
    prefetch_cnn_references([
        (jhrnet.HRNet, {"width": 18}, TRAIN_SIZE, 21, {"norm_eval": p["norm_eval"]}, NARROW)
        for p in selected_params(request, "test_train_mode_backbone_matches_jax")])
    names = {item.originalname for item in request.session.items
             if item.module is request.module}
    if names & {"test_backbone_matches_jax", "test_jax_cannot_build_the_bf16_cascade_and_the_port_"
                "serves_it"}:
        _cascade_future()


def _cascade_cfg(dtype=None):
    model = dict(load_config(os.path.join(ROOT, CASCADE_CONFIG))["model"])
    model.pop("compute_dtype")
    model.pop("pretrained", None)
    model = dict(model, num_classes=5, neck=dict(model["neck"], out_channels=16),
                 test_cfg=TINY_MASK_RCNN["test_cfg"])
    return dict(model, compute_dtype=dtype) if dtype else model


def _frames(n, h, w, seed):
    return np.random.default_rng(seed).standard_normal((n, h, w, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _cascade_future():
    return in_background(_compute_cascade)


def _compute_cascade():
    """The JAX float32 HRNet-W18 cascade: its variables, and its backbone's
    and neck's outputs on 2 frames of 64 x 96, and its backbone's alone at
    32 x 32 and 36 x 52 (each compiled at XLA's backend optimisation level
    0)."""
    det = build(DETECTORS, _cascade_cfg())
    variables = perturb_batch_norm(to_numpy(random_variables(
        det, jnp.zeros((1, H, W, 3), jnp.float32), seed=31)), seed=32)
    for p in variables["params"].values():
        for reg in ("rpn_reg", "fc_reg"):
            if reg in p:
                p[reg]["kernel"] = p[reg]["kernel"] * REG_SCALE
    backbone = {"params": variables["params"]["backbone_m"],
                "batch_stats": variables["batch_stats"]["backbone_m"]}
    alone = {size: in_background(lambda x: to_numpy(quick_jit(jhrnet.HRNet(width=18).apply,
                                                               backbone, jnp.asarray(x))),
                                 _frames(1, *size, 34)) for size in ((32, 32), (36, 52))}
    def backbone_and_neck(m, y):
        maps = m.backbone_m(y)
        return maps, m.neck_m(maps)

    feats = quick_jit(lambda v, x: det.apply(v, x, method=backbone_and_neck), variables,
                      jnp.asarray(_frames(2, H, W, 33)))
    return {"det": det, "variables": variables, "feats": to_numpy(feats), "alone": alone}


def _nchw(xs):
    return [torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2) for x in xs]


def _check(got, ref, rel, what):
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape, what
        np.testing.assert_allclose(g.float().numpy(), r, atol=rel * float(np.abs(r).max()),
                                   rtol=0, err_msg=f"{what}: branch {i}")


def _port_state(prefix, params, stats):
    """The port's keys of a JAX `HRModule` (`stage2_m0`) or its `fuse`,
    through `from_jax_hrnet`, with `prefix` taken off."""
    sd = {}
    from_jax_hrnet(sd, {"stage2_m0": params}, {"stage2_m0": stats})
    return {k[len(prefix):]: v for k, v in sd.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "live_bn"])
def test_fuse_layer_matches_jax(train):
    jmodule = jhrnet.FuseLayer(widths=WIDTHS)
    tmodule = thrnet.FuseLayer(WIDTHS)
    _check_module(jmodule, tmodule, "stage2.0.fuse_layers.", lambda t: {"fuse": t}, train, 41,
                  lambda xs: tmodule(xs, None, train))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "live_bn"])
def test_hr_module_matches_jax(train):
    jmodule = jhrnet.HRModule(widths=WIDTHS)
    tmodule = thrnet.HRModule(WIDTHS)
    _check_module(jmodule, tmodule, "stage2.0.", lambda t: t, train, 51,
                  lambda xs: tmodule(xs, train))


def _check_module(jmodule, tmodule, prefix, wrap, train, seed, run):
    """`jmodule` and `tmodule` on four seeded branches of `SIZES` and
    `WIDTHS`: the outputs in float32 within 1e-4 * max|ref|, and the running
    statistics within 1e-6 (moved where `train`, else as they were)."""
    xs = [np.random.default_rng(seed + i).standard_normal((2,) + s + (w,)).astype(np.float32)
          for i, (s, w) in enumerate(zip(SIZES, WIDTHS))]
    jxs = [jnp.asarray(x) for x in xs]
    variables = perturb_batch_norm(to_numpy(random_variables(jmodule, jxs, seed=seed)),
                                   seed=seed + 1)
    ref, updates = quick_jit(lambda v, a: jmodule.apply(v, a, train=train,
                                                        mutable=["batch_stats"]), variables, jxs)
    tmodule.load_state_dict(_port_state(prefix, wrap(variables["params"]),
                                        wrap(variables["batch_stats"])), strict=True)
    with torch.no_grad():
        got = run(_nchw(xs))
    _check([g.permute(0, 2, 3, 1) for g in got], ref, 1e-4, type(tmodule).__name__)
    want = _port_state(prefix, wrap(to_numpy(variables["params"])),
                       wrap(to_numpy(updates["batch_stats"])))
    before = _port_state(prefix, wrap(variables["params"]), wrap(variables["batch_stats"]))
    for name, v in tmodule.state_dict().items():
        if "running" in name:
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), atol=1e-6, err_msg=name)
            assert torch.equal(v, before[name]) != train, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("size", [(32, 32), (36, 52)], ids=["32x32", "36x52"])
def test_backbone_matches_jax(size, dtype):
    """HRNet-W18 in eval mode, the cascade's backbone variables: float32
    within 1e-4 * max|ref| a branch, bfloat16 within 0.05 * max|ref|."""
    ref = _cascade_future().result()
    bb = (ref["variables"]["params"]["backbone_m"], ref["variables"]["batch_stats"]["backbone_m"])
    model = thrnet.HRNet(width=18, dtype=getattr(torch, dtype))
    model.load_state_dict(from_jax_cnn_backbone(*bb), strict=True)
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(_frames(1, *size, 34)))
    assert [tuple(g.shape[1:]) for g in got] == [
        (-(-size[0] // s), -(-size[1] // s), w) for s, w in zip((4, 8, 16, 32), W18)]
    assert all(g.dtype == getattr(torch, dtype) for g in got)
    _check(got, ref["alone"][size].result(), 1e-4 if dtype == "float32" else 0.05,
           f"{size} {dtype}")


@pytest.mark.parametrize("norm_eval", [True, False], ids=["norm_eval", "live_bn"])
def test_train_mode_backbone_matches_jax(norm_eval, monkeypatch):
    for _, name, value in NARROW:
        monkeypatch.setattr(thrnet, name, value)
    pair = cnn_train_pair(jhrnet.HRNet, thrnet.HRNet, {"width": 18}, TRAIN_SIZE, 21,
                          patches=NARROW, norm_eval=norm_eval)
    assert len(pair["grads"]) > 100 and check_cnn_train_pair(pair, live=not norm_eval) == []


def test_hrfpn_matches_jax():
    """The branches of a 72 x 104 frame (18 x 26, 9 x 13, 5 x 7, 3 x 4):
    non-integer nearest upsampling, and pooled levels of 9 x 13, 4 x 6,
    2 x 3, 1 x 1."""
    sizes = ((18, 26), (9, 13), (5, 7), (3, 4))
    rng = np.random.default_rng(61)
    feats = [rng.standard_normal((2,) + s + (w,)).astype(np.float32)
             for s, w in zip(sizes, WIDTHS)]
    jmodule = jhrnet.HRFPN(in_channels=WIDTHS, out_channels=8, num_outs=5)
    variables = to_numpy(random_variables(jmodule, [jnp.asarray(f) for f in feats], seed=62))
    params = variables["params"]
    for p in params.values():
        p["bias"] = rng.standard_normal(p["bias"].shape).astype(np.float32) * 0.1
    ref = quick_jit(jmodule.apply, variables, [jnp.asarray(f) for f in feats])
    model = thrnet.HRFPN(WIDTHS, 8, 5)

    def conv(p):
        return {"weight": torch.from_numpy(np.array(p["kernel"]).transpose(3, 2, 0, 1)),
                "bias": torch.from_numpy(np.array(p["bias"]))}

    sd = {f"reduction_conv.conv.{k}": v for k, v in conv(params["reduction"]).items()}
    for i in range(5):
        sd.update({f"fpn_convs.{i}.conv.{k}": v for k, v in conv(params[f"fpn_{i}"]).items()})
    model.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = model([torch.from_numpy(f) for f in feats])
    assert [tuple(g.shape[1:3]) for g in got] == [(18, 26), (9, 13), (4, 6), (2, 3), (1, 1)]
    _check(got, ref, 1e-4, "HRFPN")


def test_jax_cannot_build_the_bf16_cascade_and_the_port_serves_it():
    """The config's bfloat16 raises `TypeError` in JAX; the port serves it
    from the float32 JAX cascade's weights (finite detections and mask
    probabilities of the float32 shapes, the stages `CASCADE_MASK_STAGES`),
    and its backbone and neck agree with JAX's float32 ones (the port's
    float32 within 1e-4 * max|ref|, its bfloat16 within 0.05 * max|ref|)."""
    cfg = load_config(os.path.join(ROOT, CASCADE_CONFIG))
    assert cfg["model"]["compute_dtype"] == "bfloat16"
    with pytest.raises(TypeError, match="unexpected keyword argument 'dtype'"):
        jax.eval_shape(build(DETECTORS, _cascade_cfg("bfloat16")).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, H, W, 3)))
    ref = _cascade_future().result()
    sd = from_jax_variables(ref["variables"]["params"], ref["variables"]["batch_stats"])
    images = torch.from_numpy(_frames(2, H, W, 33))
    for dtype, rel in ((None, 1e-4), ("bfloat16", 0.05)):
        model = build_detector_from_cfg({"model": _cascade_cfg(dtype)})
        model.load_state_dict(sd, strict=True)
        model.eval()
        assert type(model.backbone) is thrnet.HRNet and type(model.neck) is thrnet.HRFPN
        assert model.backbone.dtype == model.neck.dtype == (dtype and torch.bfloat16)
        with torch.no_grad():
            bb = model.backbone(images)
            neck = model.neck(bb)
        _check(bb, ref["feats"][0], rel, f"backbone {dtype}")
        _check(neck, ref["feats"][1], rel, f"neck {dtype}")
    calls = []
    shapes = torch.tensor([[H, W], [60.0, 90.0]])
    det, probs = model.simple_test_masks(images, shapes, torch.ones(2, 4),
                                         stage=lambda name, fn: calls.append(name) or fn())
    assert calls == list(CASCADE_MASK_STAGES)
    assert probs.shape == (2, 8, 28, 28) and det.mask.sum() > 0
    assert torch.isfinite(det.boxes).all() and torch.isfinite(probs.float()).all()


def test_reference_state_dict_loads_strictly(tmp_path):
    """Random weights under the reference's (mmdet v2.11) HRNet-W32 and
    HRFPN keys, `num_batches_tracked` included, through `init_detector`."""
    cfg = load_config(os.path.join(ROOT, "configs/hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py"))
    sd = random_reference_state_dict(build_detector_from_cfg(cfg), 71)
    for key in ("backbone.conv2.weight", "backbone.bn2.running_var",
                "backbone.layer1.0.downsample.1.num_batches_tracked",
                "backbone.transition1.0.0.weight", "backbone.transition1.0.1.running_mean",
                "backbone.transition1.1.0.0.weight", "backbone.transition1.1.0.1.bias",
                "backbone.transition2.2.0.0.weight", "backbone.transition3.3.0.1.weight",
                "backbone.stage2.0.branches.1.3.conv2.weight",
                "backbone.stage3.3.fuse_layers.0.2.0.weight",
                "backbone.stage3.3.fuse_layers.0.2.1.running_var",
                "backbone.stage4.2.fuse_layers.3.0.2.0.weight",
                "backbone.stage4.2.fuse_layers.3.0.1.1.num_batches_tracked",
                "backbone.stage4.2.branches.3.3.bn2.weight", "neck.reduction_conv.conv.bias",
                "neck.fpn_convs.4.conv.weight"):
        assert key in sd, key
    assert not any(k.startswith(("backbone.transition2.0.", "backbone.transition3.1."))
                   for k in sd)
    path = str(tmp_path / "mask_rcnn_hrnetv2p_w32.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    model = init_detector(cfg, path, device="cpu")
    got = model.state_dict()
    assert got.keys() == sd.keys()
    assert all(torch.equal(got[k], v) for k, v in sd.items())


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build(name):
    """Every config builds on the meta device with an HRNet of its width,
    branch widths equal to HRFPN's `in_channels`, its detector type and
    compute type, and trains (`check_train_cfg`); FCOS and HTC raise for
    their detector types."""
    cfg = load_config(os.path.join(ROOT, "configs", "hrnet", name))
    kind = cfg["model"]["type"]
    if kind in ("FCOS", "HybridTaskCascade"):
        with pytest.raises(NotImplementedError, match=f"{kind}.*item 17"):
            build_detector_from_cfg(cfg)
        return
    with torch.device("meta"):
        model = build_detector_from_cfg(cfg)
    width = cfg["model"]["backbone"]["width"]
    assert type(model.backbone) is thrnet.HRNet and type(model.neck) is thrnet.HRFPN
    widths = [b[-1].bn2.num_features for b in model.backbone.stages[-1][-1].branches]
    assert widths == list(cfg["model"]["neck"]["in_channels"]) == [width * 2 ** i for i in
                                                                     range(4)]
    assert model.neck.reduction_conv.conv.in_channels == 15 * width
    assert type(model) is DETECTOR_TYPES[kind]
    want = {"bfloat16": torch.bfloat16}.get(cfg["model"].get("compute_dtype"))
    assert model.backbone.dtype == model.neck.dtype == want
    assert (want is torch.bfloat16) == kind.startswith("Cascade")
    check_train_cfg(model.train_cfg)


def test_census_counts_hrnet():
    result = config_census.census(os.path.join(ROOT, "configs", "hrnet"))
    assert (result["configs"], result["built"], result["trainable"]) == (30, 18, 18)
    assert result["refused_by_cause"] == {
        "NotImplementedError: detector type 'FCOS' is not ported yet (ROADMAP.md, Queue 1, "
        "item 17)": 7,
        "NotImplementedError: detector type 'HybridTaskCascade' is not ported yet (ROADMAP.md, "
        "Queue 1, item 17)": 5}
