"""The PyTorch port's inference API vs the JAX package's: configs, the test
pipeline, reference `.pth` files, `init_detector` + `inference_detector`,
test-time augmentation, and saving and resuming a training run.

The end-to-end tests take the odd-depth tiny flagship
(`torch_port_common.tiny_odd_detector`: depths 1-1-1-1, PitchAttention in
every stage) with random weights, written as a reference-format `.pth`
(`{"state_dict": {"module." + key: tensor}}`).  The JAX side reads that
file through its `init_detector`'s own steps, `build_detector_from_cfg` and
`load_weights`, which replaces every variable; `init_detector`'s third step,
an eager `det.init` that `load_weights` overwrites, takes about 100 s on a
CPU and is left out.  The port reads it through its `init_detector`.  Both
run on one 64 x 128 image, already at the pipeline's size, so that `Resize`
leaves it exact in both and the interpolation difference below cannot move
an NMS tie.  Detections must have the same counts per class and the same
labels, boxes within 1e-3 pixels and scores within 1e-5 (as the detector's
own parity test, `test_torch_detector.py`).

`Resize` is `F.interpolate` in the port and `cv2.resize` in JAX: same sizes
and scale factors, pixel values within 0.02 on 0-255 images (measured:
0.0127 at 512 x 1024 -> 667 x 1333).
"""

import glob
import os

import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.apis import inference as jinf
from panoswintransformerobjectdetection_tpu.apis.tta import aug_test_detector as jax_aug_test
from panoswintransformerobjectdetection_tpu.data import transforms as jtr
from panoswintransformerobjectdetection_tpu.runtime import config as jconfig
from panoswintransformerobjectdetection_torch.apis import inference as tinf
from panoswintransformerobjectdetection_torch.apis.tta import aug_test_detector
from panoswintransformerobjectdetection_torch.data import transforms as ttr
from panoswintransformerobjectdetection_torch.flagship import build_flagship, flagship_train_batch
from panoswintransformerobjectdetection_torch.models.panoswin import PitchAttention
from panoswintransformerobjectdetection_torch.models.panoswin_v2 import PanoSwinTransformerV2
from panoswintransformerobjectdetection_torch.runtime import checkpoint as tck
from panoswintransformerobjectdetection_torch.runtime.config import (Config, load_config,
                                                                     set_by_dotted)
from panoswintransformerobjectdetection_torch.runtime.optim import make_optimizer
from panoswintransformerobjectdetection_torch.runtime.train import make_train_step
from torch_port_common import single_torch_thread, tiny_odd_detector  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "panoswin", "*.py")))
NORM = ([123.675, 116.28, 103.53], [58.395, 57.12, 57.375])


def _name(path):
    return os.path.basename(path)


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_load_config_matches_jax(path):
    """`_base_` inheritance and `_delete_` (the v2 config) as JAX reads
    them; `Config` and a dotted override as well."""
    cfg = load_config(path)
    assert cfg == jconfig.load_config(path)
    assert Config.fromfile(path).model.backbone.depths == cfg["model"]["backbone"]["depths"]
    ref = jconfig.load_config(path)
    for c, fn in ((cfg, set_by_dotted), (ref, jconfig.set_by_dotted)):
        fn(c, "model.backbone.window_size", 12)
        fn(c, "optimizer.extra.lr", 0.5)
    assert cfg == ref and cfg["model"]["backbone"]["window_size"] == 12


@pytest.mark.parametrize("path", CONFIGS, ids=_name)
def test_build_detector_from_config(path):
    """Every PanoSwin config builds in the port, the v-variant's (the
    reference's own detection composition) included.  Built on the meta
    device: no weights are made."""
    cfg = load_config(path)
    with torch.device("meta"):
        model = tinf.build_detector_from_cfg(cfg)
    bb = cfg["model"]["backbone"]
    assert model.num_classes == cfg["model"]["num_classes"]
    assert [len(layer.blocks) for layer in model.backbone.layers] == list(bb["depths"])
    if bb.get("type") == "PanoSwinTransformerV2":
        assert type(model.backbone) is PanoSwinTransformerV2
        assert model.backbone.win_trans_type == bb["win_trans_type"]
        assert model.backbone.coord_encoder is not None
        assert model.backbone.patch_embed.proj[0].out_channels == 32
    else:
        assert [isinstance(layer.blocks[-1], PitchAttention) for layer in model.backbone.layers] \
            == [d % 2 == 1 for d in bb["depths"]]
        assert model.backbone.pano_mode == bb.get("pano_mode", True)
    want = torch.bfloat16 if cfg["model"].get("compute_dtype") == "bfloat16" else None
    assert model.backbone.patch_embed.dtype == want
    assert model.test_cfg == cfg["model"]["test_cfg"]
    assert model.with_mask == cfg["model"].get("with_mask", False)


@pytest.mark.parametrize("option,value", [("type", "HybridTaskCascade"), ("roi_sampling_ratio", 0),
                                          ("bbox_roi_size", 14), ("pisa", {}),
                                          ("bbox_head", {"type": "DoubleConvFCBBoxHead"}),
                                          ("roi_extractor", "generic")])
def test_unported_detector_options_raise(option, value):
    model = dict(tiny_odd_detector()["config"]["model"], **{option: value})
    with pytest.raises(NotImplementedError, match=f"{option}.*item 17"):
        tinf.build_detector_from_cfg({"model": model})


def test_unported_backbone_options_raise():
    model = tiny_odd_detector()["config"]["model"]
    cfg = {"model": dict(model, backbone=dict(model["backbone"], use_checkpoint=True))}
    # activation checkpointing is ported: it builds (`test_torch_train_loop.py`)
    assert all(layer.use_checkpoint for layer in tinf.build_detector_from_cfg(cfg).backbone.layers)
    cfg = {"model": dict(model, neck=dict(model["neck"], add_extra_convs=True))}
    with pytest.raises(NotImplementedError, match="add_extra_convs.*item 17"):
        tinf.build_detector_from_cfg(cfg)


@pytest.mark.parametrize("size,scale", [((512, 1024), (800, 1333)), ((64, 128), (40, 1333)),
                                        ((100, 200), (333, 1333))],
                         ids=["512x1024", "64x128", "100x200"])
def test_pipeline_matches_jax(size, scale):
    img = (np.random.default_rng(size[0]).random(size + (3,)) * 255).astype(np.float32)
    results = []
    for tr in (jtr, ttr):
        pipeline = tr.Compose([tr.Resize(scale), tr.Normalize(*NORM), tr.Pad(32)])
        results.append(pipeline({"img": img.copy(), "img_shape": img.shape,
                                 "ori_shape": img.shape,
                                 "scale_factor": np.ones(4, np.float32)}))
    ref, got = results
    for key in ("img_shape", "pad_shape"):
        assert tuple(got[key]) == tuple(ref[key])
    np.testing.assert_array_equal(got["scale_factor"], ref["scale_factor"])
    assert got["img"].dtype == np.float32
    # 0.02 on the 0-255 scale, after Normalize's division by the std
    np.testing.assert_allclose(got["img"], ref["img"], atol=0.02 / min(NORM[1]))
    # Normalize and Pad alone are the same arithmetic
    for tr in (jtr, ttr):
        results.append(tr.Compose([tr.Normalize(*NORM), tr.Pad(32)])({"img": img.copy()}))
    np.testing.assert_array_equal(results[3]["img"], results[2]["img"])


@pytest.fixture(scope="module")
def detectors(tmp_path_factory):
    """The odd-depth tiny flagship from one reference `.pth` on both sides,
    and an image at the test pipeline's size."""
    td = tiny_odd_detector()
    cfg = td["config"]
    path = str(tmp_path_factory.mktemp("weights") / "reference.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in td["state_dict"].items()}}, path)
    jdet = jinf.build_detector_from_cfg(cfg)
    jvars = jinf.load_weights(jdet, {}, path, cfg)
    port = tinf.init_detector(cfg, path, device="cpu")
    img = (np.random.default_rng(7).random((64, 128, 3)) * 255).astype(np.float32)
    return {"jax": (jdet, jvars), "port": port, "img": img, "path": path}


def _pipelines():
    return [tr.Compose([tr.Resize((64, 1333)), tr.Normalize(*NORM), tr.Pad(32)])
            for tr in (jtr, ttr)]


def test_inference_detector_matches_jax(detectors):
    jpipe, tpipe = _pipelines()
    ref = jinf.inference_detector(*detectors["jax"], detectors["img"], jpipe)
    got = tinf.inference_detector(detectors["port"], detectors["img"], tpipe)
    assert len(got) == len(ref) == 5 and sum(len(r) for r in ref) > 0
    for c, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == np.float32 and g.shape == r.shape, c
        np.testing.assert_allclose(g[:, :4], r[:, :4], atol=1e-3, err_msg=f"class {c}")
        np.testing.assert_allclose(g[:, 4], r[:, 4], atol=1e-5, err_msg=f"class {c}")


def test_async_inference_detector_matches_sync(detectors):
    import asyncio
    _, tpipe = _pipelines()
    got = asyncio.run(tinf.async_inference_detector(detectors["port"], detectors["img"], tpipe))
    want = tinf.inference_detector(detectors["port"], detectors["img"], tpipe)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_aug_test_detector_matches_jax(detectors):
    """One scale at the image's own size, with the flip."""
    ref = jax_aug_test(*detectors["jax"], detectors["img"], scales=((64, 1333),), flip=True,
                       num_classes=5)
    got = aug_test_detector(detectors["port"], detectors["img"], scales=((64, 1333),),
                            flip=True)
    assert len(ref["boxes"]) > 0 and got["boxes"].shape == ref["boxes"].shape
    np.testing.assert_array_equal(got["labels"], ref["labels"])
    np.testing.assert_allclose(got["boxes"], ref["boxes"], atol=1e-3)
    np.testing.assert_allclose(got["scores"], ref["scores"], atol=1e-5)


def test_init_detector_reads_reference_layouts(detectors, tmp_path):
    """The `model` nesting and a state dict at the top level load as the
    `state_dict` nesting does; without a checkpoint the weights come from
    the seed."""
    want = detectors["port"].state_dict()
    sd = tck.load_torch_state_dict(detectors["path"])
    assert set(sd) == set(want)
    for layout in ({"model": sd}, sd):
        path = str(tmp_path / "layout.pth")
        torch.save(layout, path)
        got = tinf.init_detector(tiny_odd_detector()["config"], path, device="cpu").state_dict()
        assert all(torch.equal(got[k], v) for k, v in want.items())
    cfg = tiny_odd_detector()["config"]
    a, b, c = (tinf.init_detector(cfg, seed=s, device="cpu").state_dict() for s in (1, 1, 2))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["roi_head.bbox_head.fc_cls.weight"],
                           c["roi_head.bbox_head.fc_cls.weight"])


def test_load_resizes_bias_tables_of_another_window():
    """Tables trained at window 3 load into a window-4 model, resized by
    `resize_bias_table`; every other entry is loaded as it is."""
    model = tiny_odd_detector()["config"]["model"]
    small = tinf.build_detector_from_cfg({"model": dict(
        model, backbone=dict(model["backbone"], window_size=3))})
    sd = small.state_dict()
    target = tinf.build_detector_from_cfg({"model": model})
    tck.load_reference_weights(target, sd)
    key = "backbone.layers.0.blocks.0.sphere_position_alpha_table_Te"
    assert sd[key].shape == (25, 1) and target.state_dict()[key].shape == (49, 1)
    assert torch.equal(target.state_dict()[key], tck.resize_bias_table(sd[key], 3, 4))
    key = "backbone.layers.0.blocks.0.q_linear.weight"
    assert torch.equal(target.state_dict()[key], sd[key])


def test_save_then_resume_is_bit_exact(tmp_path):
    """Two training steps in a row equal one step, save, load into a model
    with other weights, one step: parameters, running statistics, optimizer
    state and schedule bit for bit."""
    batch = flagship_train_batch(1, "cpu", height=32, width=64, num_gt=3)

    def trainer(seed):
        model = build_flagship(tiny=True, device="cpu", seed=seed, train=True)
        optimizer, scheduler = make_optimizer(model, base_lr=1e-2, warmup_iters=3)
        return model, optimizer, scheduler, make_train_step(model, optimizer, scheduler)

    def noise(step):
        return torch.Generator().manual_seed(100 + step)

    model, optimizer, scheduler, step = trainer(0)
    for i in range(2):
        step(batch, generator=noise(i))
    first, opt1, sched1, step1 = trainer(0)
    step1(batch, generator=noise(0))
    path = str(tmp_path / "run.pth")
    tck.save_checkpoint(path, first, opt1, sched1, step=1)
    resumed, optimizer2, scheduler2, step2 = trainer(5)
    assert tck.load_checkpoint(path, resumed, optimizer2, scheduler2) == 1
    step2(batch, generator=noise(1))
    want, got = model.state_dict(), resumed.state_dict()
    assert set(got) == set(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert scheduler2.state_dict()["last_epoch"] == scheduler.state_dict()["last_epoch"] == 2
    want, got = optimizer.state_dict()["state"], optimizer2.state_dict()["state"]
    assert set(got) == set(want)
    assert all(torch.equal(got[i][k], v) for i in want for k, v in want[i].items())
