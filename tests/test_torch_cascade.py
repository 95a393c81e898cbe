"""Cascade Mask R-CNN serving of the PyTorch port against the JAX package:
class-agnostic `multiclass_nms`, the bbox heads (Shared2FC class-agnostic,
Shared4Conv1FC with GroupNorm), each cascade stage, `simple_test` and
`simple_test_masks`, `single_device_test(with_masks=True)` with
`evaluate(["bbox", "segm"])` and `tools.test --eval bbox segm`, the eight
`configs/swin/cascade_mask_rcnn_swin_*` configs, and the refusals (a
training sampler, cascade test-time augmentation, a checkpoint with a mask
head a stage).  Cascade training: `test_torch_cascade_train.py`.

The detector is the tiny Swin Mask R-CNN of `TINY_MASK_RCNN` as a Cascade
Mask R-CNN (`torch_port_common.tiny_swin_cascade`), with the Shared2FC and
with a Shared4Conv1FC bbox head, random variables of the JAX init's spread
carried across by `from_jax_variables`.  Tolerances, all in f32: each
stage's probabilities 1e-4 and its refined boxes 1e-3 px (the proposals
they start from, out of the backbone, FPN and RPN in another sum order,
already differ by about 1e-4 px: 1.7e-4 px measured); detections as the detector's
own parity tests (equal counts, each with a partner of the same label, box
within 1e-3 px, score within 1e-5); mask probabilities 1e-4; metrics 1e-4.
The heads alone: f32 1e-4; bf16 4 units of 2**-8 * max|ref| (bf16 convs
and fcs whose f32 sums run in another order can flip a rounding, which the
next layer carries).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import roi_head as jroi
from panoswintransformerobjectdetection_tpu.models import cascade as jcascade
from panoswintransformerobjectdetection_tpu.ops.nms import multiclass_nms as jax_multiclass_nms
from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                     init_detector)
from panoswintransformerobjectdetection_torch.apis.tta import aug_test_detector
from panoswintransformerobjectdetection_torch.models import roi_head as troi
from panoswintransformerobjectdetection_torch.models.cascade import (CASCADE_MASK_STAGES,
                                                                     STAGE_STDS, CascadeMaskRCNN)
from panoswintransformerobjectdetection_torch.ops.nms import multiclass_nms
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (_bbox_head,
                                                                         load_reference_weights)
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from test_torch_mask_rcnn import _loop_matches_jax, _match
from torch_port_common import (CASCADE_BBOX_HEADS, quick_jit,  # noqa: F401
                               random_variables, single_torch_thread, tiny_cascade_config,
                               tiny_swin_cascade, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASCADE_CONFIGS = sorted(p for p in os.listdir(os.path.join(ROOT, "configs", "swin"))
                         if p.startswith("cascade_mask_rcnn_swin_"))
H, W, N_IMAGES = 64, 96, 4
HEADS = sorted(CASCADE_BBOX_HEADS)


def _jax_cascade(det, variables, images, img_shapes, scale_factors):
    """JAX's `simple_test_masks`, with each stage's logits (the output of
    `cascade_head_{t}`, by `capture_intermediates`) and decoded boxes (each
    `delta_decode` that `models/cascade.py` calls, recorded as it is
    traced)."""
    decoded, decode = [], jcascade.delta_decode

    def recorded(*args, **kwargs):
        decoded.append(decode(*args, **kwargs))
        return decoded[-1]

    jcascade.delta_decode = recorded
    try:
        out, inter = det.apply(
            variables, images, img_shapes, scale_factors, method=det.simple_test_masks,
            capture_intermediates=lambda m, _: (m.name or "").startswith("cascade_head_"),
            mutable=["intermediates"])
    finally:
        jcascade.delta_decode = decode
    logits = [inter["intermediates"][f"cascade_head_{t}"]["__call__"][0][0] for t in range(3)]
    return out, logits, decoded


@pytest.fixture(scope="module", params=HEADS)
def tiny(request):
    """The JAX tiny cascade of one bbox head, its variables, the port's copy
    (all built once a process, `tiny_swin_cascade`), and `_jax_cascade`
    compiled once (XLA's backend optimisation level 0) at the loop's batch
    shape."""
    shared = tiny_swin_cascade(request.param)
    det, variables = shared["det"], shared["variables"]
    model = build_detector_from_cfg({"model": tiny_cascade_config(request.param)})
    model.load_state_dict(shared["state_dict"], strict=True)
    model.eval()
    args = (jnp.zeros((2, H, W, 3)), jnp.zeros((2, 2)), jnp.zeros((2, 4)))
    compiled = jax.jit(lambda v, a, b, c: _jax_cascade(det, v, a, b, c)
                       ).lower(variables, *args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return {"head": request.param, "det": det, "variables": variables, "model": model,
            "run": lambda *a: compiled(variables, *(jnp.asarray(x) for x in a))}


def _inputs():
    rng = np.random.default_rng(0)
    imgs = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    shapes = np.array([[H, W], [60, 90]], np.float32)
    sf = np.array([[1.5, 1.5, 1.5, 1.5], [1.2, 1.25, 1.2, 1.25]], np.float32)
    return imgs, shapes, sf


def test_multiclass_nms_class_agnostic_matches_jax():
    """(B, N, 4) boxes shared by every class, with tied scores (within a
    class and across classes) and near-duplicate boxes: the same
    detections, in the same slot order, as JAX's on (N, 4) boxes."""
    rng = np.random.default_rng(1)
    B, N, C = 2, 40, 4
    centers = rng.uniform(10, 90, (B, N, 2))
    sizes = rng.uniform(5, 30, (B, N, 2))
    boxes = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    boxes[:, 1::5] = boxes[:, ::5] + 0.5                   # near-duplicates
    scores = rng.dirichlet(np.ones(C + 1), (B, N)).astype(np.float32)
    scores[:, 3:9, :C] = 0.25                              # ties across rows and classes
    valid = rng.random((B, N)) > 0.1
    got = multiclass_nms(torch.from_numpy(boxes), torch.from_numpy(scores), 0.05, 0.5, 30,
                         valid=torch.from_numpy(valid))
    wants = quick_jit(jax.vmap(lambda b, s, v: jax_multiclass_nms(b, s, 0.05, 0.5, 30, valid=v)),
                      jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
    for i in range(B):
        want = jax.tree.map(lambda a: a[i], wants)
        m = np.asarray(want.mask)
        assert m.sum() > 10 and np.array_equal(got.mask[i].numpy(), m)
        assert np.array_equal(got.labels[i].numpy()[m], np.asarray(want.labels)[m])
        np.testing.assert_array_equal(got.boxes[i].numpy()[m], np.asarray(want.boxes)[m])
        np.testing.assert_array_equal(got.scores[i].numpy()[m], np.asarray(want.scores)[m])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", ["Shared4Conv1FCBBoxHead", "Shared2FCBBoxHead"])
def test_bbox_head_matches_flax(head, dtype):
    """A class-agnostic head on random 7 x 7 RoI features of 16 channels:
    the 4conv1f head at `norm_groups` 4 and 16 conv channels, random
    GroupNorm scales and biases, a random (so not symmetric) `shared_fc0`
    whose rows the port reads channel-first; with the rows left in JAX's
    (h, w, C) order, the logits differ.  In bf16 the convs and fcs run in
    bf16 and each GroupNorm returns f32, as flax's does."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 7, 7, 16)).astype(np.float32)
    kw = {"norm_groups": 4, "conv_out_channels": 16} if head.startswith("Shared4") else {}
    jdt = None if dtype == "float32" else jnp.bfloat16
    jmod = getattr(jroi, head)(num_classes=5, fc_out_channels=64, reg_class_agnostic=True,
                               dtype=jdt, **kw)
    params = to_numpy(random_variables(jmod, jnp.zeros((1, 7, 7, 16)), seed=3)["params"])
    for name, p in params.items():
        if name.startswith("gn"):
            p["scale"] = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
            p["bias"] = (0.1 * rng.standard_normal(16)).astype(np.float32)
        elif "bias" in p:
            p["bias"] = (0.02 * rng.standard_normal(p["bias"].shape)).astype(np.float32)
    ref = [np.asarray(r) for r in quick_jit(jmod.apply, {"params": params}, jnp.asarray(x))]
    mod = troi.build_bbox_head({"type": head, "fc_out_channels": 64, **kw}, 16, 5,
                               getattr(torch, dtype) if dtype == "bfloat16" else None,
                               reg_class_agnostic=True)
    sd = {}
    _bbox_head(sd, "h", params, 7)
    mod.load_state_dict({k[2:]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = [t.numpy() for t in mod(torch.from_numpy(x))]
    assert [g.shape for g in got] == [r.shape for r in ref] == [(6, 6), (6, 4)]
    for g, r in zip(got, ref):
        tol = 1e-4 if dtype == "float32" else 4 * 2.0 ** -8 * float(np.abs(r).max())
        np.testing.assert_allclose(g, r, rtol=0, atol=tol)
    k = params["shared_fc0"]["kernel"]                    # (h*w*C, out) in (h, w, C) order
    mod.shared_fcs[0].weight.data = torch.from_numpy(np.ascontiguousarray(k.T))
    with torch.no_grad():
        unpermuted = mod(torch.from_numpy(x))[0].numpy()
    assert np.abs(unpermuted - ref[0]).max() > 1e-2


def test_stages_match_jax(tiny):
    """Each stage's class probabilities and refined (clipped) boxes, captured
    through the port's `stage` hook, against JAX's (the softmax of each
    stage's logits; its decoded boxes clipped to each image, as
    `models/cascade.py:146-150` clips them): every proposal slot,
    probabilities within 1e-4 and boxes within 1e-3 px."""
    imgs, shapes, sf = _inputs()
    _, logits, decoded = tiny["run"](imgs, shapes, sf)
    assert len(decoded) == 3
    jstages = []
    for cls, dec in zip(logits, decoded):
        cls = np.asarray(cls, np.float64).reshape(2, -1, 6)
        e = np.exp(cls - cls.max(-1, keepdims=True))
        dec = np.asarray(dec).reshape(2, -1, 2, 2)
        dec = np.minimum(np.maximum(dec, 0), shapes[:, None, None, ::-1])
        jstages.append((e / e.sum(-1, keepdims=True), dec.reshape(2, -1, 4)))
    got, calls = {}, []

    def stage(name, fn):
        calls.append(name)
        out = fn()
        if name.startswith("refine."):
            got[name] = out
        return out

    tiny["model"].simple_test_masks(torch.from_numpy(imgs), torch.from_numpy(shapes),
                                    torch.from_numpy(sf), stage=stage)
    assert calls == list(CASCADE_MASK_STAGES)
    for t, (jprobs, jboxes) in enumerate(jstages):
        probs, boxes = got[f"refine.{t}"]
        assert probs.shape == jprobs.shape and boxes.shape == jboxes.shape
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=0, atol=1e-4)
        np.testing.assert_allclose(boxes.numpy(), np.asarray(jboxes), rtol=0, atol=1e-3)
    assert STAGE_STDS == jcascade.STAGE_STDS


def test_simple_test_masks_matches_jax(tiny):
    """Detections of `simple_test` and of `simple_test_masks` (the same), and
    each slot's 28 x 28 probabilities of its own class, with non-unit scale
    factors."""
    imgs, shapes, sf = _inputs()
    (jd, jp), _, _ = tiny["run"](imgs, shapes, sf)
    args = [torch.from_numpy(a) for a in (imgs, shapes, sf)]
    td, tp = tiny["model"].simple_test_masks(*args)
    plain = tiny["model"].simple_test(*args)
    assert all(torch.equal(a, b) for a, b in zip(plain, td))
    assert tp.shape == (2, 8, 28, 28) and np.asarray(jp).shape == tp.shape
    for i in range(2):
        m = np.asarray(jd.mask[i])
        want = {"boxes": np.asarray(jd.boxes[i])[m], "scores": np.asarray(jd.scores[i])[m],
                "labels": np.asarray(jd.labels[i])[m]}
        tm = td.mask[i].numpy()
        got = {k: getattr(td, k)[i].numpy()[tm] for k in ("boxes", "scores", "labels")}
        assert m.sum() > 0
        partners = _match(got, want, f"{tiny['head']} image {i}")
        np.testing.assert_allclose(tp[i].numpy()[tm], np.asarray(jp[i])[m][partners], atol=1e-4)


def test_single_device_test_with_masks_matches_jax(tiny, tmp_path, monkeypatch):
    """The port's loop against the JAX package's `single_device_test(
    with_masks=True)` on the cascade, then both packages' `evaluate(["bbox",
    "segm"])` on ground truth made from JAX's detections and masks (and
    more polygons): equal detections, bitmaps equal but for at most one
    pixel in 1000 (a pixel whose probability lies within rounding of 0.5
    flips: 1 of 3545 in one mask of the 4conv1f cascade), metrics within
    1e-4;
    `tools.test --eval bbox segm` on the same weights from a `.pth` gives
    the port's metrics (`test_torch_mask_rcnn._loop_matches_jax`)."""
    _loop_matches_jax(lambda *a: tiny["run"](*a)[0], tiny["det"], tiny["variables"],
                      tiny["model"], tiny_cascade_config(tiny["head"])
                      if tiny["head"] == "shared2fc" else None, tmp_path, monkeypatch)


@pytest.mark.parametrize("name", CASCADE_CONFIGS)
def test_cascade_configs_build(name):
    """Every Swin cascade config builds on the meta device: a
    `CascadeMaskRCNN` with three class-agnostic heads of the config's type
    under `roi_head.bbox_head.{0,1,2}`, one mask head, the config's widths
    and compute type.  A GIoU config (its `train_cfg` sets `reg_loss`)
    builds for serving."""
    cfg = load_config(os.path.join(ROOT, "configs", "swin", name))
    with torch.device("meta"):
        model = build_detector_from_cfg(cfg)
    want = (cfg["model"].get("bbox_head") or {}).get("type", "Shared2FCBBoxHead")
    assert isinstance(model, CascadeMaskRCNN) and model.with_mask
    assert [type(h).__name__ for h in model.roi_head.bbox_head] == [want] * 3
    assert all(h.fc_reg.out_features == 4 for h in model.roi_head.bbox_head)
    keys = model.state_dict()
    assert "roi_head.bbox_head.2.fc_cls.weight" in keys and "roi_head.mask_head.upsample.weight" \
        in keys and not any(k.startswith("roi_head.mask_head.0.") for k in keys)
    if want == "Shared4Conv1FCBBoxHead":
        assert keys["roi_head.bbox_head.0.shared_convs.3.gn.weight"].shape == (256,)
        assert "roi_head.bbox_head.0.shared_convs.0.conv.bias" not in keys
        assert cfg["model"]["train_cfg"]["rcnn"]["reg_loss"] == "giou"
    bb = cfg["model"]["backbone"]
    assert model.backbone.patch_embed.proj.out_channels == bb.get("embed_dim", 96)
    assert [len(layer.blocks) for layer in model.backbone.layers] == list(bb["depths"])
    assert model.backbone.patch_embed.dtype == torch.bfloat16
    assert model.roi_head.bbox_head[0].dtype == torch.bfloat16


def test_giou_config_serves_at_a_tiny_width():
    """The Swin-T GIoU 4conv1f config at a tiny width (its `train_cfg`,
    `reg_loss="giou"`, kept; `score_thr` lowered to 0.005, as random weights
    give each of its 80 classes about 1/81) serves through `init_detector`
    on the CPU."""
    cfg = load_config(os.path.join(ROOT, "configs", "swin", next(
        n for n in CASCADE_CONFIGS if "tiny" in n and "giou" in n)))
    model = dict(cfg["model"], **{k: tiny_cascade_config("shared2fc")[k]
                                  for k in ("backbone", "neck", "test_cfg")})
    model["bbox_head"] = dict(model["bbox_head"], norm_groups=4, conv_out_channels=16,
                              fc_out_channels=64)
    model["test_cfg"] = dict(model["test_cfg"], rcnn=dict(model["test_cfg"]["rcnn"],
                                                          score_thr=0.005))
    small = init_detector({"model": model}, device="cpu")
    det, probs = small.simple_test_masks(torch.rand(1, 64, 96, 3) * 2 - 1,
                                         torch.tensor([[64.0, 96.0]]))
    assert probs.shape == (1, 8, 28, 28) and torch.isfinite(probs).all() and det.mask.any()


def _refuse_training(model):
    """A cascade trains since its training was ported; an OHEM sampler is
    still refused."""
    model.train_cfg = dict(model.train_cfg, rcnn=dict(model.train_cfg["rcnn"], sampler="ohem"))
    model.train().forward_train(torch.zeros(1, 64, 96, 3), torch.tensor([[64., 96.]]),
                                torch.zeros(1, 1, 4), torch.zeros(1, 1), torch.ones(1, 1))


def _refuse_tta(model):
    aug_test_detector(model, np.zeros((32, 48, 3), np.float32), scales=((32, 48),))


def _refuse_staged_mask_heads(model):
    sd = dict(model.state_dict())
    for key in [k for k in sd if k.startswith("roi_head.mask_head.")]:
        value = sd.pop(key)
        for t in range(3):
            sd[key.replace("mask_head.", f"mask_head.{t}.")] = value
    load_reference_weights(model, sd)


@pytest.mark.parametrize("refuse,match", [
    (_refuse_training, "sampler.*item 17d"),
    (_refuse_tta, "test-time augmentation of a cascade.*bbox_head_m"),
    (_refuse_staged_mask_heads, r"mask head for each of the cascade stages \['0', '1', '2'\]")],
    ids=["forward_train", "aug_test_detector", "per_stage_mask_heads"])
def test_cascade_refusals(refuse, match):
    model = build_detector_from_cfg({"model": tiny_cascade_config("shared2fc")})
    with pytest.raises(NotImplementedError, match=match):
        refuse(model)


def test_jax_tta_reads_the_unused_bbox_head():
    """The fault that the port's refusal of a cascade's TTA names: JAX's
    `bbox_for_rois` (its `aug_test_detector`'s scoring step) runs
    `bbox_head_m`, not a cascade stage: changing `bbox_head_m` changes its
    output, changing `cascade_head_2` (or any stage) does not."""
    shared = tiny_swin_cascade("shared2fc")
    det, variables = shared["det"], shared["variables"]
    rng = np.random.default_rng(9)
    imgs = jnp.asarray(rng.standard_normal((1, H, W, 3)).astype(np.float32))
    boxes = jnp.asarray([[[4.0, 6.0, 40.0, 50.0], [20.0, 10.0, 90.0, 60.0]]])
    shapes = jnp.asarray([[H, W]], jnp.float32)
    fn = jax.jit(lambda v: det.apply(v, imgs, boxes, shapes, method=det.bbox_for_rois)).lower(
        variables).compile(compiler_options={"xla_backend_optimization_level": 0})

    def moved(name):
        params = dict(variables["params"])
        params[name] = jax.tree.map(lambda a: a + 0.05, params[name])
        return [np.asarray(o) for o in fn({"params": params})]

    base = [np.asarray(o) for o in fn(variables)]
    assert all(np.array_equal(a, b) for a, b in zip(base, moved("cascade_head_2")))
    assert any(np.abs(a - b).max() > 1e-3 for a, b in zip(base, moved("bbox_head_m")))
