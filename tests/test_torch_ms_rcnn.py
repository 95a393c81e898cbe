"""Mask Scoring R-CNN of the PyTorch port against the JAX package's: the
mask-IoU head, its targets and loss (`models/mask_head.py`), the detector
(`models/detectors.py MaskScoringRCNN`) in training and at test time, and
the model zoo's `configs/ms_rcnn`.

The detector is a tiny-class ResNet-18 Mask Scoring R-CNN (5 classes, FPN
16, the mask and mask-IoU heads at the JAX package's fixed widths,
`TINY_TRAIN_CFG`), float32, its random variables of the init's spread with
every BatchNorm drawn away from the identity (`perturb_batch_norm`), the
regression kernels scaled by `REG_SCALE` and the mask logits' kernel by
`LOGIT_SCALE`, carried across by `from_jax_variables`.

- `MaskIoUHead`: the JAX head's own variables through
  `from_jax_variables`, whose `fcs.0` reorders the (h, w, C) flatten to
  (C, h, w): within 1e-4 * max(1, max|ref|); the kernel unreordered misses;
- `mask_iou_targets` equal to JAX's on shared inputs, probabilities exactly
  0.5 included (both binarise with > 0.5); `mask_iou_loss` within 1e-6,
  background labels clipped, weight-0 slots, no positive at all;
- one training step on 2 frames of 64 x 96 with mask bitmaps, JAX's
  `make_train_step` against the port's `forward_train` and backward on the
  same batch, weights and sampler noise (`jax_step_noise`): the outputs
  (`loss_mask_iou` included) within 1e-4 relative and every gradient
  within 1e-5 + 2e-3 * max|g|.  The IoU targets binarise probabilities
  that the two packages compute about 1e-7 apart, so the test allows no
  flip: it asserts that no positive slot's probability lies within 1e-5 of
  0.5 (`LOGIT_SCALE` spreads the logits), so that both sides' targets are
  the same;
- `simple_test_masks` with non-unit scale factors: the stages
  (`MASK_SCORING_STAGES`), equal counts, each detection with a partner of
  the same label within 1e-3 px and its rescored score within 1e-5, mask
  probabilities within 1e-4, the padded slots' scores untouched;
- every config of `configs/ms_rcnn` builds and trains, and the census
  counts 8 built, 8 trainable.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.models import mask_head as jmask
from panoswintransformerobjectdetection_tpu.runtime import optim as joptim
from panoswintransformerobjectdetection_tpu.runtime import train as jtrain
from panoswintransformerobjectdetection_torch.apis.inference import (DETECTOR_TYPES,
                                                                     build_detector_from_cfg)
from panoswintransformerobjectdetection_torch.models.detectors import (
    MASK_SCORING_STAGES, MASK_SCORING_TRAIN_STAGES, MaskScoringRCNN, check_train_cfg)
from panoswintransformerobjectdetection_torch.models.mask_head import (MaskIoUHead,
                                                                       mask_iou_loss,
                                                                       mask_iou_targets)
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables
from panoswintransformerobjectdetection_torch.runtime.config import load_config
from panoswintransformerobjectdetection_torch.tools import config_census
from test_torch_mask_rcnn import _match
from torch_port_common import (TINY_MASK_RCNN, in_background, jax_step_noise,  # noqa: F401
                               perturb_batch_norm, quick_jit, random_variables, recording,
                               single_torch_thread, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(ROOT, "configs", "ms_rcnn"))
                 if f.endswith(".py"))
H, W = 64, 96
TINY_MS = dict(TINY_MASK_RCNN, type="MaskScoringRCNN", backbone={"type": "ResNet", "depth": 18},
               neck={"type": "FPN", "in_channels": (64, 128, 256, 512), "out_channels": 16,
                     "num_outs": 5})
# The RPN's and the bbox head's regression kernels are scaled by this (a
# random ResNet's boxes would be clipped flat), the mask logits' kernel by
# `LOGIT_SCALE` (random mask logits lie near 0, their probabilities near
# the IoU targets' threshold).
REG_SCALE, LOGIT_SCALE = 0.05, 30.0
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc", "loss_mask",
          "loss_mask_iou")
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def ms_references(request):
    """The JAX step and `simple_test_masks`, started in background threads
    at the module's start."""
    names = {item.originalname for item in request.session.items
             if item.module is request.module}
    if names & {"test_forward_train_matches_jax", "test_every_gradient_matches_jax"}:
        _reference("step")
    if "test_simple_test_masks_matches_jax" in names:
        _reference("test")


def _jax_detector():
    """The JAX detector, its numpy variables and the port's state dict of
    them, made once (`_detector_future`) for every thread that asks."""
    return _detector_future().result()


@functools.lru_cache(maxsize=None)
def _detector_future():
    return in_background(_make_jax_detector)


def _make_jax_detector():
    det = build(DETECTORS, dict(TINY_MS))
    variables = perturb_batch_norm(to_numpy(random_variables(
        det, jnp.zeros((1, H, W, 3), jnp.float32), seed=81)), seed=82)
    params = variables["params"]
    for p in params.values():
        for reg in ("rpn_reg", "fc_reg"):
            if reg in p:
                p[reg]["kernel"] = p[reg]["kernel"] * REG_SCALE
    logits = params["mask_head_m"]["conv_logits"]
    logits["kernel"] = logits["kernel"] * LOGIT_SCALE
    logits["bias"] = np.random.default_rng(83).standard_normal(logits["bias"].shape).astype(
        np.float32)
    return det, variables, from_jax_variables(params, variables["batch_stats"])


def _port(train=False):
    model = build_detector_from_cfg({"model": TINY_MS})
    model.load_state_dict(_jax_detector()[2], strict=True)
    return model.train(train)


def _inputs():
    rng = np.random.default_rng(84)
    return (rng.standard_normal((2, H, W, 3)).astype(np.float32),
            np.array([[H, W], [60, 90]], np.float32),
            np.array([[1.5, 1.5, 1.5, 1.5], [1.2, 1.25, 1.2, 1.25]], np.float32))


def _batch():
    """2 frames with 3 and 2 ground truths, each with an elliptic bitmap
    inside its box."""
    images, shapes, _ = _inputs()
    boxes = np.array([[[4, 2, 44, 34], [30, 10, 90, 60], [50, 4, 94, 40]],
                      [[10, 4, 50, 44], [40, 6, 88, 58], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[True, True, True], [True, True, False]])
    ys, xs = np.mgrid[:H, :W] + 0.5
    masks = np.zeros((2, 3, H, W), np.uint8)
    for b in range(2):
        for g in range(3):
            if valid[b, g]:
                x1, y1, x2, y2 = boxes[b, g]
                cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
                masks[b, g] = ((xs - cx) / rx) ** 2 + ((ys - cy) / ry) ** 2 <= 1
    return {"images": images, "img_shapes": shapes, "gt_boxes": boxes,
            "gt_labels": np.array([[0, 3, 4], [1, 2, 0]], np.int32), "gt_valid": valid,
            "gt_masks": masks}


@functools.lru_cache(maxsize=None)
def _reference(kind):
    return in_background({"step": _compute_step, "test": _compute_test}[kind])


def _compute_step():
    """JAX's `make_train_step` on `_batch()` (its optimizer recording the
    gradients), compiled at XLA's backend optimisation level 0."""
    det, variables, _ = _jax_detector()
    tx = recording(joptim.make_optimizer(variables["params"], base_lr=LR, warmup_iters=0))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]), tx=tx)
    new_state, metrics = quick_jit(jtrain.make_train_step(det), state,
                                   jax.tree.map(jnp.asarray, _batch()), jax.random.PRNGKey(1))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": from_jax_variables(to_numpy(new_state.opt_state[1]),
                                        to_numpy(new_state.batch_stats))}


def _compute_test():
    det, variables, _ = _jax_detector()
    return to_numpy(quick_jit(lambda v, a, b, c: det.apply(v, a, b, c,
                                                           method=det.simple_test_masks),
                              variables, *(jnp.asarray(x) for x in _inputs())))


@pytest.fixture(scope="module")
def step():
    """The JAX step's outputs and gradients, and the port's `forward_train`
    and backward on the same batch, weights and sampler noise."""
    det, variables, _ = _jax_detector()
    ref = _reference("step").result()
    model = _port(train=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    noise = jax_step_noise(det, variables, model, 0, 0, _batch())["noise"]
    calls, seen, extra = [], {}, model._extra_mask_losses

    def capture(out, mask_out, stage):
        seen.update(mask_out)
        return extra(out, mask_out, stage)

    model._extra_mask_losses = capture
    out = model.forward_train(**batch, noise=noise,
                              stage=lambda name, fn: calls.append(name) or fn())
    sum(v for k, v in out.items() if "loss" in k).backward()
    lab = seen["labels"].long().clamp(0, 4)
    probs = torch.sigmoid(seen["mlogits"][torch.arange(lab.shape[0]), lab]).detach()
    return {"ref": ref, "got": {k: float(v.detach()) for k, v in out.items()}, "calls": calls,
            "positive_probs": probs[seen["weights"] > 0],
            "grads": {n: p.grad for n, p in model.named_parameters()}}


def test_mask_iou_head_matches_jax():
    """The tiny detector's JAX head on 6 RoIs of 14 x 14 x 16 features and
    28 x 28 probabilities; then `fcs.0` with JAX's kernel merely transposed
    (the (h, w, C) order): far off."""
    det, variables, sd = _jax_detector()
    params = variables["params"]["mask_iou_head_m"]
    rng = np.random.default_rng(85)
    feats = rng.standard_normal((6, 14, 14, 16)).astype(np.float32)
    probs = rng.random((6, 28, 28)).astype(np.float32)
    ref = np.asarray(quick_jit(lambda p, a, b: jmask.MaskIoUHead(num_classes=5).apply(
        {"params": p}, a, b), params, jnp.asarray(feats), jnp.asarray(probs)))
    head = MaskIoUHead(5, 16)
    prefix = "roi_head.mask_iou_head."
    own = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    head.load_state_dict(own, strict=True)
    with torch.no_grad():
        got = head(torch.from_numpy(feats), torch.from_numpy(probs)).numpy()
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(got, ref, atol=tol, rtol=0)
    head.load_state_dict(dict(own, **{"fcs.0.weight": torch.from_numpy(
        np.array(params["fc0"]["kernel"]).T)}))
    with torch.no_grad():
        wrong = head(torch.from_numpy(feats), torch.from_numpy(probs)).numpy()
    assert np.abs(wrong - ref).max() > 100 * tol


def test_mask_iou_targets_match_jax():
    """Probabilities and targets on a grid of 1/8 steps (0.5 exactly on
    many pixels), an empty prediction and an empty target."""
    rng = np.random.default_rng(86)
    probs = (rng.integers(0, 9, (5, 28, 28)) / 8).astype(np.float32)
    targets = (rng.integers(0, 9, (5, 28, 28)) / 8).astype(np.float32)
    probs[3] = 0.0
    targets[4] = 0.5
    ref = np.asarray(jmask.mask_iou_targets(jnp.asarray(probs), jnp.asarray(targets)))
    got = mask_iou_targets(torch.from_numpy(probs), torch.from_numpy(targets)).numpy()
    assert got.dtype == np.float32 and (got[3:] == 0).all() and (got[:3] > 0).all()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("weights", [[1, 1, 0, 1, 0, 1], [0, 0, 0, 0, 0, 0]],
                         ids=["positives", "none"])
def test_mask_iou_loss_matches_jax(weights):
    rng = np.random.default_rng(87)
    pred = rng.standard_normal((6, 5)).astype(np.float32)
    target = rng.random(6).astype(np.float32)
    labels = np.array([0, 4, 5, 2, 5, 3], np.int32)          # 5: background, clipped
    w = np.array(weights, np.float32)
    ref = float(jmask.mask_iou_loss(*(jnp.asarray(a) for a in (pred, target, labels, w))))
    got = float(mask_iou_loss(*(torch.from_numpy(a) for a in (pred, target, labels, w))))
    assert (ref > 0) == bool(w.any())
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", LOSSES + ("loss",))
def test_forward_train_matches_jax(step, name):
    want = step["ref"]["metrics"][name]
    got = (sum(v for k, v in step["got"].items() if "loss" in k) if name == "loss"
           else step["got"][name])
    assert np.isfinite(got) and (name == "acc" or got > 0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_every_gradient_matches_jax(step):
    """Every parameter's gradient; the stages `MASK_SCORING_TRAIN_STAGES`;
    no positive slot's mask probability within 1e-5 of the IoU targets'
    threshold (so both sides binarise alike); the mask head's gradient
    includes `loss_mask_iou`'s (its logits feed the IoU head undetached)."""
    assert step["calls"] == list(MASK_SCORING_TRAIN_STAGES)
    probs = step["positive_probs"]
    assert len(probs) > 0 and float((probs - 0.5).abs().min()) > 1e-5
    assert 0.2 < float((probs > 0.5).float().mean()) < 0.8
    grads, ref = step["grads"], step["ref"]["grads"]
    assert set(grads) == {k for k in ref if "running" not in k and "num_batches" not in k}
    for name, g in grads.items():
        r = ref[name].numpy()
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 2e-3 * float(np.abs(r).max()),
                                   rtol=0, err_msg=name)
    assert float(grads["roi_head.mask_iou_head.fc_mask_iou.weight"].abs().max()) > 0


def test_mask_iou_loss_reaches_the_mask_head():
    """Without `loss_mask_iou`, the mask head's gradient changes: the IoU
    head's input is not detached (JAX's is not either)."""
    det, variables, _ = _jax_detector()
    grads = []
    for keep_iou in (True, False):
        model = _port(train=True)
        batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
        noise = jax_step_noise(det, variables, model, 0, 0, _batch())["noise"]
        out = model.forward_train(**batch, noise=noise)
        sum(v for k, v in out.items() if "loss" in k and (keep_iou or k != "loss_mask_iou")
            ).backward()
        grads.append(model.roi_head.mask_head.convs[0].conv.weight.grad.clone())
    assert not torch.allclose(grads[0], grads[1])


def test_simple_test_masks_matches_jax():
    jd, jp = _reference("test").result()
    model = _port()
    imgs, shapes, sf = _inputs()
    calls = []
    td, tp = model.simple_test_masks(torch.from_numpy(imgs), torch.from_numpy(shapes),
                                     torch.from_numpy(sf),
                                     stage=lambda name, fn: calls.append(name) or fn())
    assert calls == list(MASK_SCORING_STAGES) and tp.shape == jp.shape == (2, 8, 28, 28)
    plain = model.simple_test(torch.from_numpy(imgs), torch.from_numpy(shapes),
                              torch.from_numpy(sf))
    for i in range(2):
        m = np.asarray(jd.mask[i])
        tm = td.mask[i].numpy()
        assert m.sum() > 0 and np.array_equal(tm, plain.mask[i].numpy())
        want = {k: np.asarray(getattr(jd, k)[i])[m] for k in ("boxes", "scores", "labels")}
        got = {k: getattr(td, k)[i].numpy()[tm] for k in ("boxes", "scores", "labels")}
        partners = _match(got, want, f"image {i}")
        np.testing.assert_allclose(tp[i].numpy()[tm], np.asarray(jp[i])[m][partners],
                                   atol=1e-4)
        assert torch.equal(td.scores[i][~td.mask[i]], plain.scores[i][~td.mask[i]])
        assert (td.scores[i][td.mask[i]] <= plain.scores[i][td.mask[i]]).all()
        assert not torch.equal(td.scores[i], plain.scores[i])


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_build(name):
    """Every config builds on the meta device as a `MaskScoringRCNN` with
    the mask-IoU head under `roi_head.mask_iou_head`, its backbone, and
    trains (`check_train_cfg`)."""
    cfg = load_config(os.path.join(ROOT, "configs", "ms_rcnn", name))
    with torch.device("meta"):
        model = build_detector_from_cfg(cfg)
    assert type(model) is DETECTOR_TYPES["MaskScoringRCNN"] is MaskScoringRCNN
    head = model.roi_head.mask_iou_head
    assert head.convs[0].conv.in_channels == 257 and head.fcs[0].in_features == 256 * 49
    assert head.fc_mask_iou.out_features == cfg["model"].get("num_classes", 80)
    bb = cfg["model"]["backbone"]
    assert type(model.backbone).__name__ == bb["type"]
    assert model.backbone.stages[1][0].conv1.stride == ((2, 2) if bb.get("style") == "caffe"
                                                        else (1, 1))
    check_train_cfg(model.train_cfg)


def test_census_counts_ms_rcnn():
    result = config_census.census(os.path.join(ROOT, "configs", "ms_rcnn"))
    assert (result["configs"], result["built"], result["trainable"]) == (8, 8, 8)
