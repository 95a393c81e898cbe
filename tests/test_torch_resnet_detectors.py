"""Faster, Mask and Cascade R-CNN with a ResNet, ResNeXt or RegNet backbone
in the PyTorch port, at test time, against the JAX package: `simple_test`,
`simple_test_masks`, `single_device_test(with_masks=True)` with
`evaluate(["bbox", "segm"])` and `tools.test`, `aug_test_detector`; the
model zoo's configs of `configs/{faster_rcnn,mask_rcnn,cascade_rcnn,regnet}`;
the census; the refusals (the backbones not ported yet, the DCN, GCB and
GeneralizedAttention options); and the two faults of the JAX package on
this path that the port repairs.

The detectors are full-width ResNet-50s with 5 classes and a 16-channel
FPN (the mask head at the JAX package's fixed 256 channels): a Mask R-CNN
(its weights without the mask head make the Faster R-CNN, whose
detections are the Mask R-CNN's) and the Cascade Mask R-CNN of
`configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py` in float32.
Their random variables have the JAX init's spread with every BatchNorm
drawn away from the identity (`perturb_batch_norm`), carried across by
`from_jax_variables`.  Tolerances, as `test_torch_mask_rcnn.py`'s and
`test_torch_cascade.py`'s: detections with equal counts, each with a partner
of the same label, box within 1e-3 px and score within 1e-5; mask
probabilities 1e-4; bitmaps equal but for at most one pixel in 1000;
metrics 1e-4; a backbone 1e-4 * max|ref| a stage in float32, and the
port's bfloat16 against JAX's float32 0.05 * max|ref| a stage
(`test_torch_resnet.py`).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.apis import inference as jinf
from panoswintransformerobjectdetection_tpu.apis.tta import aug_test_detector as jax_aug_test
from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.models.resnet import ResNet as JaxResNet
from panoswintransformerobjectdetection_tpu.runtime.checkpoint import convert_resnet_backbone
from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                     init_detector)
from panoswintransformerobjectdetection_torch.apis.tta import aug_test_detector
from panoswintransformerobjectdetection_torch.models.backbones_extra import RegNet
from panoswintransformerobjectdetection_torch.models.cascade import CASCADE_MASK_STAGES
from panoswintransformerobjectdetection_torch.models.detectors import MASK_STAGES
from panoswintransformerobjectdetection_torch.models.resnet import ResNet, ResNeXt
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (
    from_jax_cnn_backbone, from_jax_variables)
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from panoswintransformerobjectdetection_torch.tools import config_census
from test_torch_mask_rcnn import _loop_matches_jax, _match
from torch_port_common import (TINY_MASK_RCNN, perturb_batch_norm, quick_jit,  # noqa: F401
                               random_reference_state_dict, random_variables,
                               single_torch_thread, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N_IMAGES = 64, 96, 4
R50_NECK = {"type": "FPN", "in_channels": (256, 512, 1024, 2048), "out_channels": 16,
            "num_outs": 5}
TINY_R50 = dict(TINY_MASK_RCNN, backbone={"type": "ResNet", "depth": 50}, neck=R50_NECK)
CASCADE_CONFIG = "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py"
CNN_DIRS = ("faster_rcnn", "mask_rcnn", "cascade_rcnn", "regnet")
CNN_CONFIGS = sorted(os.path.join(d, f) for d in CNN_DIRS
                     for f in os.listdir(os.path.join(ROOT, "configs", d)) if f.endswith(".py"))
# The configs of those directories that the port does not build, and why.
UNBUILT = {
    "faster_rcnn/faster_rcnn_r50_caffe_c4_1x_coco.py": "bbox_roi_size=14",
    "mask_rcnn/mask_rcnn_r50_caffe_c4_1x_coco.py": "bbox_roi_size=14",
    "faster_rcnn/faster_rcnn_r50_caffe_dc5_1x_coco.py": "neck.*Identity",
    "faster_rcnn/faster_rcnn_r50_caffe_dc5_mstrain_1x_coco.py": "neck.*Identity",
    "faster_rcnn/faster_rcnn_r50_caffe_dc5_mstrain_3x_coco.py": "neck.*Identity",
    "regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py": "dcn.*item 17d",
    "regnet/retinanet_regnetx-1.6GF_fpn_1x_coco.py": "RetinaNet",
    "regnet/retinanet_regnetx-3.2GF_fpn_1x_coco.py": "RetinaNet",
    "regnet/retinanet_regnetx-800MF_fpn_1x_coco.py": "RetinaNet",
}


# The RPN's and the heads' regression kernels are scaled by this: the stage
# outputs of a random ResNet are not unit-scale, as a Swin's LayerNorm-ed
# ones are, and with the init's spread every box would be clipped flat.
REG_SCALE = 0.05


def _inputs():
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    shapes = np.array([[H, W], [60, 90]], np.float32)
    sf = np.array([[1.5, 1.5, 1.5, 1.5], [1.2, 1.25, 1.2, 1.25]], np.float32)
    return imgs, shapes, sf


def _jax_variables(det, seed):
    """numpy variables for the JAX detector `det`: the init's spread, every
    BatchNorm away from the identity, the regression kernels scaled by
    `REG_SCALE`."""
    variables = perturb_batch_norm(to_numpy(random_variables(
        det, jnp.zeros((1, H, W, 3), jnp.float32), seed=seed)), seed=seed + 1)
    for p in variables["params"].values():
        for reg in ("rpn_reg", "fc_reg"):
            if reg in p:
                p[reg]["kernel"] = p[reg]["kernel"] * REG_SCALE
    return variables


def _jax_detector(model_cfg, seed):
    """A JAX detector of `model_cfg`, its variables (`_jax_variables`), and
    `simple_test_masks` compiled once (XLA's backend optimisation level 0)
    at `_inputs()`' shapes."""
    det = build(DETECTORS, dict(model_cfg))
    variables = _jax_variables(det, seed)
    args = (jnp.zeros((2, H, W, 3)), jnp.zeros((2, 2)), jnp.zeros((2, 4)))
    compiled = jax.jit(lambda v, a, b, c: det.apply(v, a, b, c, method=det.simple_test_masks)
                       ).lower(variables, *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return {"det": det, "variables": variables,
            "state_dict": from_jax_variables(variables["params"], variables["batch_stats"]),
            "run": lambda *a: compiled(variables, *(jnp.asarray(x) for x in a))}


def _port(model_cfg, state_dict):
    model = build_detector_from_cfg({"model": model_cfg})
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def r50():
    """The JAX tiny-class ResNet-50 Mask R-CNN and the port's Mask and
    Faster R-CNN from its weights."""
    shared = _jax_detector(TINY_R50, seed=13)
    faster = dict(TINY_R50, type="FasterRCNN", with_mask=False)
    shared["model"] = _port(TINY_R50, shared["state_dict"])
    shared["faster"] = _port(faster, {k: v for k, v in shared["state_dict"].items()
                                      if not k.startswith("roi_head.mask_head.")})
    return shared


def _cascade_cfg():
    """The R-50 Cascade Mask R-CNN config at 5 classes, a 16-channel FPN and
    `TINY_MASK_RCNN`'s test configuration, in float32 (no compute_dtype)."""
    model = dict(load_config(os.path.join(ROOT, CASCADE_CONFIG))["model"])
    model.pop("compute_dtype")
    model.pop("pretrained", None)
    return dict(model, num_classes=5, neck=R50_NECK, test_cfg=TINY_MASK_RCNN["test_cfg"])


@functools.lru_cache(maxsize=None)
def _cascade():
    shared = _jax_detector(_cascade_cfg(), seed=15)
    shared["model"] = _port(_cascade_cfg(), shared["state_dict"])
    return shared


def _want(det, i):
    m = np.asarray(det.mask[i])
    return {"boxes": np.asarray(det.boxes[i])[m], "scores": np.asarray(det.scores[i])[m],
            "labels": np.asarray(det.labels[i])[m]}, m


def _got(det, i):
    m = det.mask[i].numpy()
    return {k: getattr(det, k)[i].numpy()[m] for k in ("boxes", "scores", "labels")}, m


def _check_masks(run, model, stages):
    """`simple_test_masks` of the port against JAX's, with non-unit scale
    factors: the stages in order, detections, and each slot's 28 x 28
    probabilities of its own class."""
    imgs, shapes, sf = _inputs()
    jd, jp = run(imgs, shapes, sf)
    calls = []
    td, tp = model.simple_test_masks(torch.from_numpy(imgs), torch.from_numpy(shapes),
                                     torch.from_numpy(sf),
                                     stage=lambda name, fn: calls.append(name) or fn())
    assert calls == list(stages) and tp.shape == np.asarray(jp).shape == (2, 8, 28, 28)
    for i in range(2):
        want, m = _want(jd, i)
        got, tm = _got(td, i)
        assert m.sum() > 0
        partners = _match(got, want, f"image {i}")
        np.testing.assert_allclose(tp[i].numpy()[tm], np.asarray(jp[i])[m][partners], atol=1e-4)
    return jd


def test_mask_rcnn_simple_test_masks_matches_jax(r50):
    _check_masks(r50["run"], r50["model"], MASK_STAGES)


def test_faster_rcnn_simple_test_matches_jax(r50):
    """The Faster R-CNN (the Mask R-CNN's weights but its mask head) gives
    the detections of JAX's Mask R-CNN, whose detection path is the Faster
    R-CNN's."""
    imgs, shapes, sf = _inputs()
    jd, _ = r50["run"](imgs, shapes, sf)
    td = r50["faster"].simple_test(torch.from_numpy(imgs), torch.from_numpy(shapes),
                                   torch.from_numpy(sf))
    assert not r50["faster"].with_mask
    for i in range(2):
        want, m = _want(jd, i)
        assert m.sum() > 0
        _match(_got(td, i)[0], want, f"image {i}")


def test_cascade_simple_test_masks_matches_jax():
    shared = _cascade()
    _check_masks(shared["run"], shared["model"], CASCADE_MASK_STAGES)


def test_single_device_test_with_masks_matches_jax(r50, tmp_path, monkeypatch):
    """The port's loop against JAX's `single_device_test(with_masks=True)`
    on the R-50 Mask R-CNN, both packages' `evaluate(["bbox", "segm"])`, and
    `tools.test --eval bbox segm` on the same weights from a `.pth`
    (`test_torch_mask_rcnn._loop_matches_jax`)."""
    _loop_matches_jax(r50["run"], r50["det"], r50["variables"], r50["model"], TINY_R50,
                      tmp_path, monkeypatch)


def test_aug_test_detector_matches_jax(monkeypatch):
    """Test-time augmentation of a ResNet-18 Faster R-CNN (JAX compiles its
    backbone twice here, so the narrower one): one scale at the image's own
    size, with the flip (JAX's two jits at XLA's backend optimisation level
    0)."""
    cfg = dict(TINY_R50, type="PanoFasterRCNN", with_mask=False,
               backbone={"type": "ResNet", "depth": 18},
               neck=dict(R50_NECK, in_channels=(64, 128, 256, 512)))
    det = build(DETECTORS, dict(cfg))
    variables = _jax_variables(det, seed=17)
    model = _port(cfg, from_jax_variables(variables["params"], variables["batch_stats"]))
    img = (np.random.default_rng(7).random((H, W, 3)) * 255).astype(np.float32)
    jit = jax.jit

    def quick(fn, **kw):
        compiled = {}

        def run(*args):
            if "fn" not in compiled:
                compiled["fn"] = jit(fn, **kw).lower(*args).compile(
                    compiler_options={"xla_backend_optimization_level": 0})
            return compiled["fn"](*args)
        return run

    monkeypatch.setattr(jax, "jit", quick)
    ref = jax_aug_test(det, variables, img, scales=((H, 1333),), flip=True, num_classes=5)
    monkeypatch.undo()
    got = aug_test_detector(model, img, scales=((H, 1333),), flip=True)
    assert len(ref["boxes"]) > 0 and got["boxes"].shape == ref["boxes"].shape
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-3)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-5)


def test_jax_cannot_build_the_bf16_cascade_and_the_port_serves_it():
    """JAX fault 1: `TwoStageDetector.setup` hands `compute_dtype` to the
    backbone, and JAX's `ResNet` takes no `dtype`.  The port builds the
    config as it is (bfloat16), loads the float32 cascade's weights and
    serves it: finite detections and probabilities of the float32 shapes,
    the backbone within the bfloat16 tolerance of JAX's float32 one."""
    cfg = dict(_cascade_cfg(), compute_dtype="bfloat16")
    with pytest.raises(TypeError, match="unexpected keyword argument 'dtype'"):
        jax.eval_shape(build(DETECTORS, dict(cfg)).init, jax.random.PRNGKey(0),
                       jnp.zeros((1, H, W, 3)))
    shared = _cascade()
    model = _port(cfg, shared["state_dict"])
    assert model.backbone.dtype == torch.bfloat16
    imgs, shapes, sf = _inputs()
    det, probs = model.simple_test_masks(torch.from_numpy(imgs), torch.from_numpy(shapes),
                                         torch.from_numpy(sf))
    assert probs.shape == (2, 8, 28, 28) and det.mask.sum() > 0
    assert torch.isfinite(det.boxes).all() and torch.isfinite(probs.float()).all()
    jdet = shared["det"]
    ref = quick_jit(lambda v, x: jdet.apply(v, x, method=lambda m, y: m.backbone_m(y)),
                    shared["variables"], jnp.asarray(imgs))
    with torch.no_grad():
        got = model.backbone(torch.from_numpy(imgs))
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), r, atol=0.05 * float(np.abs(r).max()),
                                   rtol=0, err_msg=f"stage {i}")


def test_jax_cannot_load_a_reference_resnet_pth_and_the_port_can(tmp_path):
    """JAX fault 2: `load_weights` converts every backbone but PanoSwin's
    with the Swin keys, so a reference ResNet-50 Faster R-CNN `.pth` raises
    there.  The port loads it strictly, and its backbone holds what the JAX
    package's own `convert_resnet_backbone` reads from the file: the same
    tensors, and the same stage outputs (float32, 1e-4 * max|ref|)."""
    cfg = load_config(os.path.join(ROOT, "configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py"))
    sd = random_reference_state_dict(build_detector_from_cfg(cfg), 16)
    assert any(k.endswith("num_batches_tracked") for k in sd)
    path = str(tmp_path / "faster_rcnn_r50.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    with pytest.raises(KeyError, match="patch_embed"):
        jinf.load_weights(None, {}, path, cfg)
    model = init_detector(cfg, path, device="cpu")
    params, stats = convert_resnet_backbone(sd, 50)
    want = from_jax_cnn_backbone(params, stats)
    got = model.backbone.state_dict()
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    x = np.random.default_rng(3).standard_normal((1, 64, 128, 3)).astype(np.float32)
    ref = quick_jit(JaxResNet(depth=50).apply, {"params": params, "batch_stats": stats},
                    jnp.asarray(x))
    with torch.no_grad():
        outs = model.backbone(torch.from_numpy(x))
    for i, (g, r) in enumerate(zip(outs, ref)):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-4 * float(np.abs(r).max()), rtol=0,
                                   err_msg=f"stage {i}")


def _stage_widths(backbone):
    """Each stage's output channels, from its last block's last BatchNorm."""
    return [[m for m in stage.modules() if isinstance(m, torch.nn.BatchNorm2d)][-1].num_features
            for stage in backbone.stages]


@pytest.mark.parametrize("name", CNN_CONFIGS)
def test_cnn_configs_build(name):
    """Every config of the four directories builds on the meta device with
    its backbone type, stage widths equal to the FPN's `in_channels`, its
    detector type and compute type, or raises for the cause in `UNBUILT`."""
    cfg = load_config(os.path.join(ROOT, "configs", name))
    model_cfg = cfg["model"]
    if name in UNBUILT:
        with pytest.raises(NotImplementedError, match=UNBUILT[name]):
            build_detector_from_cfg(cfg)
        return
    with torch.device("meta"):
        model = build_detector_from_cfg(cfg)
    bb = model_cfg["backbone"]
    want = {"ResNet": ResNet, "ResNeXt": ResNeXt, "RegNet": RegNet}[bb["type"]]
    assert type(model.backbone) is want
    widths = _stage_widths(model.backbone)
    assert widths == list(model_cfg["neck"]["in_channels"])
    assert [m.conv.in_channels for m in model.neck.lateral_convs] == widths
    if bb["type"] != "RegNet":
        assert len(model.backbone.stages[2]) == {50: 6, 101: 23}[bb["depth"]]
        assert model.backbone.stages[0][0].conv2.groups == bb.get("groups", 1)
        caffe = bb.get("style") == "caffe"
        block = model.backbone.stages[1][0]
        assert (block.conv1.stride, block.conv2.stride) == (((2, 2), (1, 1)) if caffe
                                                           else ((1, 1), (2, 2)))
    dtype = {"bfloat16": torch.bfloat16}.get(model_cfg.get("compute_dtype"))
    assert model.backbone.dtype == model.neck.dtype == dtype
    assert type(model).__name__ == {"PanoFasterRCNN": "PanoFasterRCNN"}.get(
        model_cfg["type"], model_cfg["type"])
    assert model.with_mask == ("Mask" in model_cfg["type"])


def test_census_counts_the_cnn_configs():
    """Built and trainable configs of the four directories: every config
    that builds there trains, but the two whose RoI sampler or box loss is
    not ported (OHEM, bounded IoU; item 17d)."""
    counts = {}
    for d in CNN_DIRS:
        result = config_census.census(os.path.join(ROOT, "configs", d))
        counts[d] = (result["configs"], result["built"], result["trainable"])
    assert counts == {"faster_rcnn": (25, 21, 19), "mask_rcnn": (20, 19, 19),
                      "cascade_rcnn": (21, 21, 21), "regnet": (14, 10, 10)}


@pytest.mark.parametrize("name", [
    "dcn/faster_rcnn_r50_fpn_dconv_c3-c5_1x_coco.py",
    "gcnet/mask_rcnn_r50_fpn_r4_gcb_c3-c5_1x_coco.py",
    "empirical_attention/faster_rcnn_r50_fpn_attention_1111_1x_coco.py",
    "regnet/mask_rcnn_regnetx-3.2GF_fpn_mdconv_c3-c5_1x_coco.py",
])
def test_plugin_configs_raise_naming_item_17d(name):
    cfg = load_config(os.path.join(ROOT, "configs", name))
    with pytest.raises(NotImplementedError, match="item 17d"):
        build_detector_from_cfg(cfg)


@pytest.mark.parametrize("backbone,match", [
    ({"type": "HourglassNet"}, "HourglassNet.*item 17"),
    ({"type": "ResNet", "depth": 50, "dcn": {"type": "DCN"},
      "stage_with_dcn": (False, True, True, True)}, "dcn.*item 17d"),
    ({"type": "ResNet", "depth": 50, "gcb": {"ratio": 0.0625},
      "stage_with_gcb": (False, True, True, True)}, "gcb.*item 17d"),
])
def test_training_refusals_name_item_17c(backbone, match):
    """The CNN backbones that the port trains now (ResNet, ResNeXt, RegNet,
    Res2Net, ResNeSt, HRNet, TridentResNet) no longer raise; the backbone
    not ported yet (HourglassNet, which only CornerNet uses: item 17d) and
    the DCN and GCB options (item 17d) still raise when the detector is
    built, naming their item, so neither serving nor training reaches
    them."""
    with pytest.raises(NotImplementedError, match=match):
        build_detector_from_cfg({"model": dict(TINY_R50, backbone=backbone)})
