"""Mask R-CNN training of the PyTorch port against the JAX package's, on the
tiny Swin Mask R-CNN (`torch_port_common.tiny_swin_mask_rcnn`: embed 16,
depths 2-2-2-2, window 4, FPN 16, 5 classes, the mask head at 256
channels, `TINY_TRAIN_CFG`'s 4 positive slots an image), in float32.

The pieces: `mask_targets` against `mask_targets_from_bitmaps` (per image)
on RoIs inside, across every border, tiny and wider than a frame whose
bitmaps the loader padded: within 1e-6 of JAX's function run op by op
(float32 sums of the same products in another order), and within 2**-17
of it compiled (`quick_jit`), whose fused code rounds a sample's position
differently: one unit of float32 at the bitmap's coordinates (below 128),
which moves a tap's weight by as much (measured: 3.96e-06); `mask_head_loss`
within 1e-6;
`roi_align_backward_plain` at 14 x 14 bins against `jax.vjp` of JAX's
`multilevel_roi_align(out_size=14)`, within 1e-5 * max(1, max|ref|).

The slice: the port's `train_detector` runs beside the JAX package's own
over 2 steps of 2 frames of 64 x 96 with polygon masks on disk (the
pipeline: masks, flip, a resize to the frames' own size, pad), from the
same weights (JAX's `init` hands back the tiny
variables: its `load_weights` drops a Mask R-CNN's mask head; the port
loads them from a reference `.pth`) and the same sampler noise
(`jax_step_noise`).  For time, the JAX step compiles once
(`quick_jit_train_step`) with its optimizer wrapped so that it keeps the
gradients of each step (`recording`).  The first step is the
`forward_train` parity test: the same batch (masks, boxes and labels
equal, images exact), the five losses, `loss_mask` and `acc` within 1e-4
relative, and every gradient within 1e-5 + 1e-3 * max|g| of JAX's (float32
sums in another order through some twenty layers).  The loops: losses,
gradient norms within 1e-4 relative, learning rates equal in float32, the
parameters after the 2 updates (`test_loop_parameters_match_jax`).

The port alone: Swin's `use_checkpoint` gives bit-equal losses and
gradients at DropPath 0.2; a stock Swin ImageNet `.pth` loads into the
backbone as JAX's `convert_swin_backbone` converts it; both Swin Mask
R-CNN mstrain configs go through the CLI to `train_detector` as through
JAX's.
"""

import functools
import json
import os
import random
import sys

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu import runtime as jruntime
from panoswintransformerobjectdetection_tpu.apis import train as japi
from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.models.mask_head import \
    mask_head_loss as jax_mask_head_loss
from panoswintransformerobjectdetection_tpu.models.mask_head import mask_targets_from_bitmaps
from panoswintransformerobjectdetection_tpu.ops.roi_align import multilevel_roi_align
from panoswintransformerobjectdetection_tpu.runtime import checkpoint as jck
from panoswintransformerobjectdetection_tpu.runtime import hooks as jhooks
from panoswintransformerobjectdetection_tpu.runtime import optim as joptim
from panoswintransformerobjectdetection_tpu.runtime import train as jtrain
from panoswintransformerobjectdetection_torch.apis import train as tapi
from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.models import swin as tswin
from panoswintransformerobjectdetection_torch.models.detectors import MASK_TRAIN_STAGES
from panoswintransformerobjectdetection_torch.models.mask_head import (mask_head_loss,
                                                                       mask_targets)
from panoswintransformerobjectdetection_torch.ops.roi_align import roi_align_backward_plain
from panoswintransformerobjectdetection_torch.runtime import checkpoint as tck
from panoswintransformerobjectdetection_torch.runtime import hooks as thooks
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables
from panoswintransformerobjectdetection_torch.tools import train as train_cli
from torch_port_common import (TINY_MASK_RCNN, TINY_TRAIN_CFG, Recorder,  # noqa: F401
                               jax_step_noise, jax_train_cli, quick_jit, quick_jit_train_step,
                               recording, single_torch_thread, tiny_swin_mask_rcnn, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, MAX_GT = 64, 96, 4
CLASSES = ("a", "b", "c", "d", "e")
LOOP = {"total_epochs": 1, "batch_size": 2, "base_lr": 1e-2, "warmup_iters": 1,
        "decay_epochs": (0.5,), "max_gt": MAX_GT, "log_interval": 1, "num_workers": 0,
        "seed": 0}
PIPELINE = [{"type": "LoadImageFromFile"},
            {"type": "LoadAnnotations", "with_bbox": True, "with_mask": True},
            {"type": "RandomFlip", "flip_ratio": 0.5},
            {"type": "Resize", "img_scale": (H, 1333), "keep_ratio": True},
            {"type": "Normalize", "mean": [123.675, 116.28, 103.53],
             "std": [58.395, 57.12, 57.375], "to_rgb": True},
            {"type": "Pad", "size_divisor": 32}]
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "loss_mask", "acc")
BATCH = ("images", "img_shapes", "gt_boxes", "gt_labels", "gt_valid", "gt_masks",
         "pano_ratio_v")
MSTRAIN = [os.path.join(ROOT, "configs", "swin", f"mask_rcnn_swin_tiny_patch4_window7_mstrain_"
                        f"480-800_adamw_{s}_coco.py") for s in ("1x", "3x")]


def _port_model(**backbone):
    model = dict(TINY_MASK_RCNN, backbone=dict(TINY_MASK_RCNN["backbone"], **backbone))
    return build_detector_from_cfg({"model": model})


def test_mask_targets_match_jax():
    """Two images of 3 bitmaps of a 40 x 60 frame, padded by the loader to
    48 x 64; 5 RoIs an image (inside, across the top-left and bottom-right
    borders, under a pixel, wider than the frame), each matched to one of
    its image's bitmaps."""
    rng = np.random.default_rng(0)
    B, G = 2, 3
    masks = np.zeros((B, G, 48, 64), np.uint8)
    masks[:, :, :40, :60] = rng.random((B, G, 40, 60)) > 0.5
    boxes = np.array([[5.3, 4.1, 30.7, 25.2], [-6.5, -3.2, 12.4, 14.9],
                      [50.1, 30.6, 70.2, 52.3], [20.2, 20.1, 21.0, 20.6], [-10, 5, 80, 45]],
                     np.float32)
    rois = np.concatenate([np.repeat(np.arange(B, dtype=np.float32), 5)[:, None],
                           np.tile(boxes, (B, 1))], 1).reshape(B, 5, 5)
    gidx = rng.integers(0, G, (B, 5))
    args = (jnp.asarray(masks, jnp.float32), jnp.asarray(rois), jnp.asarray(gidx))
    targets = jax.vmap(lambda m, r, g: mask_targets_from_bitmaps(m, r, g, 28))
    with jax.disable_jit():
        ref = np.concatenate([np.asarray(mask_targets_from_bitmaps(*(a[b] for a in args), 28))
                              for b in range(B)])
    compiled = np.asarray(quick_jit(targets, *args)).reshape(-1, 28, 28)
    got = mask_targets(torch.from_numpy(masks), torch.from_numpy(rois.reshape(-1, 5)),
                       torch.from_numpy(gidx.reshape(-1)))
    assert got.shape == (B * 5, 28, 28) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.numpy(), compiled, atol=2.0 ** -17, rtol=0)
    assert ((ref > 0) & (ref < 1)).any() and not np.array_equal(ref[0], ref[5])


def test_mask_head_loss_matches_jax():
    """6 RoIs, 5 classes, a background label (clipped to the last class),
    two RoIs of weight 0; then no positive at all (the divisor's floor)."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((6, 28, 28, 5)) * 3).astype(np.float32)
    targets = rng.random((6, 28, 28)).astype(np.float32)
    labels = np.array([0, 4, 5, 2, 1, 3], np.int32)
    for weights in (np.array([1, 1, 0, 1, 0, 1], np.float32), np.zeros(6, np.float32)):
        ref = float(quick_jit(jax_mask_head_loss, *map(jnp.asarray, (logits, targets, labels,
                                                                     weights))))
        got = float(mask_head_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                   *map(torch.from_numpy, (targets, labels, weights))))
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("wide", [False, True], ids=["tall", "wide"])
def test_roi_align_backward_plain_at_14_matches_jax_vjp(wide):
    """The maps' gradient at 14 x 14 bins over four levels of 2 images
    (192 x 128 or 128 x 192: the wide maps contract W first), 2 x 6 RoIs on
    every level, some across the border."""
    rng = np.random.default_rng(2)
    h, w = (128, 192) if wide else (192, 128)
    strides = (4, 8, 16, 32)
    feats = [rng.standard_normal((2, h // s, w // s, 8)).astype(np.float32) for s in strides]
    rois = []
    for b in range(2):
        for size in (20, 60, 150, 300, 500, 12):
            x1 = rng.uniform(-10, max(w - size * 0.5, 0))
            y1 = rng.uniform(-10, max(h - size * 0.5, 0))
            rois.append([b, x1, y1, x1 + size * rng.uniform(0.6, 1.4), y1 + size])
    rois = np.asarray(rois, np.float32)
    cot = rng.standard_normal((len(rois), 14, 14, 8)).astype(np.float32)

    def vjp(cot, *maps):
        _, pull = jax.vjp(lambda *m: multilevel_roi_align(list(m), jnp.asarray(rois), strides,
                                                          out_size=14), *maps)
        return pull(cot)

    ref = quick_jit(vjp, jnp.asarray(cot), *map(jnp.asarray, feats))
    got = roi_align_backward_plain(torch.from_numpy(cot), torch.from_numpy(rois),
                                   [f.shape for f in feats], torch.float32, strides)
    for level, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert np.abs(r).max() > 0, level
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 * max(1.0, float(np.abs(r).max())),
                                   rtol=0, err_msg=f"level {level}")


@pytest.fixture(scope="module")
def mask_frames(tmp_path_factory):
    """4 frames of 64 x 96 on disk with 1-3 polygon instances each.  The
    seed matters: where an input of the bbox head's ReLUs lies within
    rounding of zero, the gate opens in one framework only and a whole row
    of gradients moves by a percent, which no tolerance should cover (seed
    7 put one at 6e-7; with seed 9 no input of either step lies within
    8e-6 of zero).  See `torch_port_common.tiny_detector`."""
    root = str(tmp_path_factory.mktemp("mask_frames"))
    rng = np.random.default_rng(9)
    images, anns = [], []
    for i in range(4):
        cv2.imwrite(os.path.join(root, f"{i}.png"), (rng.random((H, W, 3)) * 255).astype(np.uint8))
        images.append({"id": i, "file_name": f"{i}.png", "width": W, "height": H})
        for _ in range(int(rng.integers(1, 4))):
            cx, cy = rng.uniform(24, W - 24), rng.uniform(20, H - 20)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
            rad = rng.uniform(14, 26) * rng.uniform(0.7, 1.0, 6)
            xs, ys = cx + rad * np.cos(ang), cy + rad * np.sin(ang)
            anns.append({"id": len(anns) + 1, "image_id": i, "iscrowd": 0, "area": 200.0,
                         "category_id": int(rng.integers(1, 6)),
                         "bbox": [float(xs.min()), float(ys.min()), float(np.ptp(xs)),
                                  float(np.ptp(ys))],
                         "segmentation": [[float(v) for v in np.stack([xs, ys], 1).ravel()]]})
    path = os.path.join(root, "ann.json")
    with open(path, "w") as f:
        json.dump({"images": images, "annotations": anns,
                   "categories": [{"id": k + 1, "name": c} for k, c in enumerate(CLASSES)]}, f)
    return path, root


def _split(frames):
    return {"type": "CocoDataset", "ann_file": frames[0], "img_prefix": frames[1],
            "classes": CLASSES, "pipeline": PIPELINE}


@pytest.fixture(scope="module")
def loops(mask_frames, tmp_path_factory):
    """The JAX loop and the port's, on the same frames, draws and weights,
    and what JAX's first step saw and computed (its batch and gradients)."""
    shared = tiny_swin_mask_rcnn()
    det, variables = shared["det"], shared["variables"]
    pth = str(tmp_path_factory.mktemp("pth") / "tiny_mask_rcnn.pth")
    torch.save({"state_dict": shared["state_dict"]}, pth)
    first = {}

    def jit_train_step(step_fn, mesh):
        run = quick_jit_train_step(step_fn, mesh)

        def step(state, batch, rng):
            new_state, metrics = run(state, batch, rng)
            if not first:
                first.update(batch=to_numpy(batch), grads=to_numpy(new_state.opt_state[1]),
                             metrics={k: float(v) for k, v in metrics.items()})
            return new_state, metrics
        return step

    make_optimizer, devices = jruntime.make_optimizer, jax.devices
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "jit_train_step", jit_train_step)
        mp.setattr(jruntime, "make_optimizer", lambda *a, **k: recording(make_optimizer(*a, **k)))
        mp.setattr(type(det), "init", lambda self, *args, **kw: variables)
        mp.setattr(jax, "devices", lambda *args: devices(*args)[:1])
        mp.setattr(jck, "save_checkpoint", lambda path, state: os.makedirs(path))
        rec = Recorder()
        random.seed(21)
        state = japi.train_detector(
            det, jb.build_dataset(_split(mask_frames)),
            work_dir=str(tmp_path_factory.mktemp("jax_loop")),
            hooks=[jhooks.LrRecordHook(joptim.warmup_step_schedule(
                LOOP["base_lr"], LOOP["warmup_iters"], decay_steps=(1,))), rec], **LOOP)
        out["jax"] = {"rec": rec, "state": state, "first": first}

        port = _port_model()
        mp.setattr(tapi, "step_randomness", functools.partial(jax_step_noise, det, variables))
        rec, port_first = Recorder(), {}

        def stage(name, fn):
            result = fn()
            if name == "copy" and not port_first:
                port_first["batch"] = {k: v.numpy().copy() for k, v in result.items()}
            if name == "step" and "grads" not in port_first:
                port_first.update(metrics={k: float(v) for k, v in result.items()},
                                  grads={n: p.grad.clone() for n, p in port.named_parameters()})
            return result

        random.seed(21)
        tapi.train_detector(
            port, tb.build_dataset(_split(mask_frames)),
            work_dir=str(tmp_path_factory.mktemp("port_loop")), load_from=pth,
            hooks=[thooks.LrRecordHook(toptim.warmup_step_schedule(
                LOOP["base_lr"], LOOP["warmup_iters"], decay_steps=(1,))), rec],
            device="cpu", stage=stage, **LOOP)
        out["port"] = {"rec": rec, "model": port, "first": port_first}
    return out


@pytest.fixture(scope="module")
def first_step(loops):
    """Both first steps: the port's `forward_train` and backward through
    its step function, JAX's `make_train_step`, on the same batch, weights
    and sampler noise."""
    got, ref = loops["port"]["first"], loops["jax"]["first"]
    return {"out": got["metrics"], "grads": got["grads"], "batch": got["batch"],
            "ref_batch": ref["batch"], "ref": ref["metrics"],
            "ref_grads": from_jax_variables(ref["grads"], {})}


def test_first_batches_are_equal(first_step):
    got, ref = first_step["batch"], first_step["ref_batch"]
    assert set(got) == set(BATCH)
    for key in BATCH:
        assert np.array_equal(got[key], ref[key]), key
    assert got["gt_masks"].any() and got["gt_masks"].shape == (2, MAX_GT, H, W)


@pytest.mark.parametrize("name", LOSSES)
def test_forward_train_outputs_match_jax(first_step, name):
    got, ref = first_step["out"][name], first_step["ref"][name]
    assert np.isfinite(got) and (name == "acc" or got > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_every_gradient_matches_jax(first_step):
    grads, ref = first_step["grads"], first_step["ref_grads"]
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 1e-3 * float(np.abs(r).max()),
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("key", LOSSES + ("loss", "grad_norm", "lr", "step"))
def test_loop_steps_match_jax(loops, key):
    got, want = loops["port"]["rec"].steps, loops["jax"]["rec"].steps
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if key in ("lr", "step"):
            assert np.float32(g[key]) == np.float32(w[key])
        else:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4)
    assert loops["port"]["rec"].calls == loops["jax"]["rec"].calls


def test_loop_parameters_match_jax(loops):
    """After the two updates (lr 1e-5 then 1e-3): within twice the summed
    learning rates everywhere; within 1e-5 + 2e-2 * max|p - p0| where
    Adam's first moment 0.09 g1 + 0.1 g2 lies 50 times above its own
    tolerance, 0.09 t1 + 0.1 t2 with each step's gradient tolerance t = 1e-5
    + 1e-3 * max|g| (then m / sqrt(v), and so the update, is known to about
    2%; measured 0.7e-2 at worst, on 16% of the entries).  The criterion
    of `test_torch_train_loop.py` (the first moment above 1e-3 of its
    largest) does not hold here: the mask head's
    gradients are small (max|g| about 1e-3) and agree to a few units of
    1e-6, so a moment a hundredth of the largest, or one where the steps
    cancel, moves its update by up to a third of lr."""
    state = loops["jax"]["state"]
    want = from_jax_variables(to_numpy(state.params), {})
    grads = [from_jax_variables(loops["jax"]["first"]["grads"], {}),
             from_jax_variables(to_numpy(state.opt_state[1]), {})]
    before = tiny_swin_mask_rcnn()["state_dict"]
    got = loops["port"]["model"].state_dict()
    lr_sum = LOOP["base_lr"] * (1e-3 + 1e-1)
    firm_entries = 0
    for name, v in got.items():
        g, w, p0 = v.numpy(), want[name].numpy(), before[name].numpy()
        np.testing.assert_allclose(g, w, atol=2 * lr_sum + 1e-6, rtol=0, err_msg=name)
        g1, g2 = (step[name].numpy() for step in grads)
        t1, t2 = (1e-5 + 1e-3 * np.abs(a).max() for a in (g1, g2))
        firm = np.abs(0.09 * g1 + 0.1 * g2) > 50 * (0.09 * t1 + 0.1 * t2)
        firm_entries += int(firm.sum())
        np.testing.assert_allclose(g[firm], w[firm], rtol=0, err_msg=name,
                                   atol=1e-5 + 2e-2 * float(np.abs(w - p0).max()))
    assert firm_entries > 0.1 * sum(v.numel() for v in got.values())


def test_swin_use_checkpoint_gradients_are_bit_equal(monkeypatch):
    """One `forward_train` + backward of the tiny Swin Mask R-CNN with and
    without activation checkpointing: the same weights, batch, masks,
    sampler generator and DropPath generator (rate 0.2): losses and every
    gradient bit-equal; every block went through `checkpoint`; the mask
    branch ran its stages (`MASK_TRAIN_STAGES`)."""
    calls = []
    original = tswin.checkpoint
    monkeypatch.setattr(tswin, "checkpoint", lambda *a, **k: calls.append(1) or original(*a, **k))
    rng = np.random.default_rng(3)
    masks = np.zeros((2, 2, H, W), np.uint8)
    masks[:, 0, 10:40, 8:50] = 1
    masks[:, 1, 20:60, 40:90] = rng.random((2, 40, 50)) > 0.3
    batch = {"images": torch.from_numpy(rng.random((2, H, W, 3)).astype(np.float32)),
             "img_shapes": torch.tensor([[H, W]] * 2, dtype=torch.float32),
             "gt_boxes": torch.tensor([[[8., 10., 50., 40.], [40., 20., 90., 60.]]] * 2),
             "gt_labels": torch.tensor([[0, 3]] * 2), "gt_valid": torch.ones(2, 2, dtype=bool),
             "gt_masks": torch.from_numpy(masks)}
    runs, stages = [], []
    for use_checkpoint in (False, True):
        model = _port_model(drop_path_rate=0.2, use_checkpoint=use_checkpoint).train()
        model.load_state_dict(tiny_swin_mask_rcnn()["state_dict"])
        model.backbone.set_drop_path_generator(torch.Generator().manual_seed(3))
        out = model.forward_train(**batch, generator=torch.Generator().manual_seed(4),
                                  stage=lambda name, fn: stages.append(name) or fn())
        sum(v for k, v in out.items() if "loss" in k).backward()
        runs.append(({k: float(v) for k, v in out.items()},
                     {n: p.grad for n, p in model.named_parameters()}))
    assert len(calls) == sum(TINY_MASK_RCNN["backbone"]["depths"])
    assert tuple(stages) == MASK_TRAIN_STAGES * 2
    assert runs[0][0] == runs[1][0] and runs[0][0]["loss_mask"] > 0
    for n, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][n]), n
    assert any(g.abs().max() > 0 for n, g in runs[0][1].items() if "blocks" in n)


@pytest.mark.parametrize("src_window", [4, 7])
def test_stock_swin_pth_loads_as_the_converter(src_window, tmp_path):
    """A stock Swin ImageNet classifier's `.pth` (`{"model": ...}`; its
    head, last norm, relative position indices and attention masks; no
    out-norms) made from a seed, of the tiny backbone's window or of window
    7: `pretrained` loads into the backbone what JAX's
    `convert_swin_backbone` makes of it (its bias tables resized where the
    window differs, within 1e-6: both resize bicubically in float64), the
    out-norms keep their values, and a missing key raises."""
    rng = np.random.default_rng(src_window)
    bb = {k: v for k, v in TINY_MASK_RCNN["backbone"].items() if k != "type"}
    src = tswin.SwinTransformer(**dict(bb, window_size=src_window))
    sd = {k: torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in src.state_dict().items() if not k.startswith("norm")}
    sd.update({"norm.weight": torch.ones(128), "norm.bias": torch.zeros(128),
               "head.weight": torch.zeros(1000, 128), "head.bias": torch.zeros(1000),
               "layers.0.blocks.0.attn.relative_position_index": torch.zeros(
                   (2 * src_window - 1) ** 2, dtype=torch.long),
               "layers.0.blocks.1.attn_mask": torch.zeros(4, 16, 16)})
    path = str(tmp_path / "swin_imagenet.pth")
    torch.save({"model": sd}, path)
    model = _port_model()
    kept = {k: v.clone() for k, v in model.backbone.state_dict().items() if k.startswith("norm")}
    tapi.apply_init_weights(model, pretrained=path)
    params, _ = jck.convert_swin_backbone(
        {k: v.numpy() for k, v in sd.items()}, (2, 2, 2, 2), 4,
        src_window_size=src_window if src_window != 4 else None)
    want = tck.from_jax_swin_backbone(params)
    got = model.backbone.state_dict()
    assert set(want) | set(kept) == set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, rtol=0, err_msg=k)
    assert all(torch.equal(got[k], v) for k, v in kept.items())
    del sd["layers.1.blocks.0.mlp.fc1.weight"]
    with pytest.raises(KeyError, match="fc1"):
        tck.load_backbone_weights(model.backbone, sd)


def _tiny_options(frames, tmp_path):
    """--cfg-options that point a config's data at the synthetic set and
    cut its model to the tiny one (the widths, the classes, the samples)."""
    bb = TINY_MASK_RCNN["backbone"]
    return ["--cfg-options", f"data.train.ann_file={frames[0]}",
            f"data.train.img_prefix={frames[1]}", f"data.train.classes={CLASSES}",
            "data.val=None", "data.workers_per_gpu=0", "runner.max_epochs=1",
            "log_config.interval=1", f"model.num_classes={len(CLASSES)}",
            f"model.backbone.embed_dim={bb['embed_dim']}",
            f"model.backbone.depths={bb['depths']}", f"model.backbone.num_heads={bb['num_heads']}",
            f"model.backbone.window_size={bb['window_size']}",
            f"model.neck={TINY_MASK_RCNN['neck']}", f"model.train_cfg={TINY_TRAIN_CFG}"]


@pytest.mark.parametrize("path", MSTRAIN, ids=["1x", "3x"])
def test_train_cli_trains_swin_mask_rcnn(path, mask_frames, monkeypatch, tmp_path):
    """Both CLIs on an mstrain config (data at the synthetic set, the model
    cut to the tiny one): the same arguments to `train_detector`, and a
    dataset whose first sample carries JAX's masks through the config's own
    pipeline (resized to 480-800 on the short side)."""
    options = _tiny_options(mask_frames, tmp_path)
    captured = {}
    with monkeypatch.context() as mp:
        mp.setattr(japi, "train_detector", lambda det, ds, **kw: captured.update(jax=(ds, kw)))
        mp.setattr(tapi, "train_detector",
                   lambda m, ds, **kw: captured.update(port=(m, ds, kw)))
        mp.setattr(sys, "argv", ["train.py", path, "--work-dir", str(tmp_path), *options])
        jax_train_cli().main()
        train_cli.main([path, "--work-dir", str(tmp_path), "--device", "cpu", *options])
    jax_ds, jax_kw = captured["jax"]
    model, ds, kw = captured["port"]
    assert kw.pop("device") == torch.device("cpu") and kw.pop("eval_fn") is jax_kw.pop("eval_fn")
    assert kw == jax_kw and kw["total_epochs"] == 1 and len(ds) == len(jax_ds) == 4
    assert model.with_mask and model.backbone.layers[0].blocks[1].drop_path1.rate > 0
    samples = []
    for dataset in (ds, jax_ds):
        random.seed(0)
        samples.append(dataset[0])
    got, ref = samples
    assert got["gt_masks"].shape == (len(got["gt_bboxes"]), *got["img"].shape[:2])
    assert got["img"].shape[0] >= 480 and np.array_equal(got["gt_masks"], ref["gt_masks"])
