"""Cascade (Mask) R-CNN training of the PyTorch port against the JAX
package's, on the tiny Swin Cascade Mask R-CNN of each bbox head
(`torch_port_common.tiny_swin_cascade`: embed 16, depths 2-2-2-2, window
4, FPN 16, 5 classes, `TINY_TRAIN_CFG`), in float32.

The pieces: `giou_loss` and `iou_loss` on overlapping, disjoint, touching,
identical, degenerate and weight-0 pairs, values within 1e-6 and gradients
within 1e-6 * max(1, max|g|) of `jax.grad`'s, all finite; the
class-agnostic `bbox_head_loss` with the L1, GIoU and IoU box losses, the
unfilled slots decoding a zero box, values within 1e-6 relative and the
gradients of the logits and the deltas within 1e-6 * max(1, max|g|);
`AccumulatingAdamW` on a parameter that no loss reaches (decay only, two
updates, within 1e-7 relative of optax's chain: the port decays in optax's
order, p + (-lr) * (wd * p)) and one that a loss reaches from the second
update on (within 1e-6, as `test_torch_train_loop.py` holds Adam's steps).

The slice: for each head (Shared2FC with the L1 loss; Shared4Conv1FC with
the GIoU loss at weight 10, as the `giou_4conv1f` recipes), the port's
`train_detector` runs beside the JAX package's own over 2 steps of 2
frames of 64 x 96 with polygon masks (the mask test's frames and
pipeline), from the same weights and the same sampler noise
(`jax_cascade_step_noise`).  The JAX step compiles once a head
(`quick_jit_train_step`), its optimizer wrapped to keep each step's
gradients (`recording`).  The first step is the `forward_train` parity
test: the 11 outputs within 1e-4 relative, and every gradient of the three
heads, the RPN, the FPN and the backbone within 1e-5 + 2e-3 * max|g|
(float32 sums in another order through some twenty layers, three heads
deep).  The heads pool proposals that the two packages compute about
1e-4 px apart, and stages 1 and 2 boxes that the stage before refined, so
a ReLU gate whose input lies within 1e-5 of zero may open in one package
only, and its unit's gradient row then moves by a few percent of max|g|
(one gate of stage 2's Shared2FC head, input 3.06e-6 in the port, did:
its row moved by 3.3% of max|g|).  Where a gated stage's gradients miss,
they are compared with such gates set either way
(`_flip_aware_gradients`, at most 4 flipped).  The pin: `gt_masks` move no
output in either package (JAX's compiled step rerun on other masks; the
port's `forward_train` with other masks and with none), JAX's
`mask_head_m` gradient is exactly 0 and the port's mask head gets none.
The loops: losses and gradient norms within 1e-4 relative, learning rates
and steps equal in float32; the parameters after the two updates within
twice the summed learning rates everywhere, the mask head's within 1e-7
relative of JAX's and 1e-6 of its decay-only value, and the rest as
`test_torch_mask_train.py` holds them where Adam's moment is firm, but for
the output units whose gradient a gate flip moved at either step
(`test_loop_parameters_match_jax`; at the second step the gates searched
lie within 3e-5 of zero, `GATE_MARGINS`).

The port alone: `tools.train` on a tiny cascade config, resumed from
`epoch_1`, is bit for bit the uninterrupted run; `config_census` counts
the nine Swin cascade configs as trainable; the options of item 17d
raise.
"""

import functools
import json
import os
import random

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from panoswintransformerobjectdetection_tpu import runtime as jruntime
from panoswintransformerobjectdetection_tpu.apis import train as japi
from panoswintransformerobjectdetection_tpu.core import losses as jlosses
from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.models import roi_head as jroi
from panoswintransformerobjectdetection_tpu.runtime import checkpoint as jck
from panoswintransformerobjectdetection_tpu.runtime import hooks as jhooks
from panoswintransformerobjectdetection_tpu.runtime import optim as joptim
from panoswintransformerobjectdetection_tpu.runtime import train as jtrain
from panoswintransformerobjectdetection_torch.apis import train as tapi
from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
from panoswintransformerobjectdetection_torch.core import losses as tlosses
from panoswintransformerobjectdetection_torch.core.bbox import delta_encode
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.models import roi_head as troi
from panoswintransformerobjectdetection_torch.models.cascade import CASCADE_TRAIN_STAGES
from panoswintransformerobjectdetection_torch.runtime import hooks as thooks
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables
from panoswintransformerobjectdetection_torch.tools import config_census
from panoswintransformerobjectdetection_torch.tools import train as train_cli
from test_torch_mask_train import CLASSES, LOOP, _split, mask_frames  # noqa: F401
from torch_port_common import (CASCADE_BBOX_HEADS, TINY_TRAIN_CFG, Recorder,  # noqa: F401
                               jax_cascade_step_noise, quick_jit, quick_jit_train_step,
                               recording, single_torch_thread, tiny_cascade_config,
                               tiny_swin_cascade, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADS = sorted(CASCADE_BBOX_HEADS)
# The box loss each head trains with: the GIoU head as the giou_4conv1f recipes.
REG_LOSS = {"shared2fc": {}, "4conv1f": {"reg_loss": "giou", "reg_loss_weight": 10.0}}
OUTPUTS = ("loss_rpn_cls", "loss_rpn_bbox") + tuple(
    f"s{t}.{k}" for t in range(3) for k in ("loss_cls", "loss_bbox", "acc"))
SWIN_CASCADES = sorted(n for n in os.listdir(os.path.join(ROOT, "configs", "swin"))
                       if n.startswith("cascade_mask_rcnn_swin_") or n == "example.py")


def _train_cfg(head):
    return dict(TINY_TRAIN_CFG, rcnn=dict(TINY_TRAIN_CFG["rcnn"], **REG_LOSS[head]))


def _port_cascade(head):
    return build_detector_from_cfg({"model": dict(tiny_cascade_config(head),
                                                  train_cfg=_train_cfg(head))})


# The stages whose ReLUs can flip a gate on a rounding-level input (their
# inputs come from the proposals, which the two packages compute to about
# 1e-4 px apart, and from the refined boxes), and which parameters they own.
GATED_STAGES = ("rpn_head",) + tuple(f"bbox_head.{t}" for t in range(3))
# How near zero a gate's input may lie to be set either way, at the loop's
# first and second step: at the second, the packages' weights already differ
# by the first update, where a gate flipped, and so do their gate inputs.
GATE_MARGINS = (1e-5, 3e-5)


def _owner(name):
    if name.startswith("rpn_head."):
        return "rpn_head"
    if name.startswith("roi_head.bbox_head."):
        return f"bbox_head.{name.split('.')[2]}"
    return None


def _misses(grads, ref, stage):
    """The worst gradient error of `stage`'s own parameters, in units of
    the test's tolerance (1e-5 + 2e-3 * max|ref|)."""
    return max(float((g - ref[n]).abs().max()) / (1e-5 + 2e-3 * float(ref[n].abs().max()))
               for n, g in grads.items() if _owner(n) == stage)


def _flip_aware_gradients(model, batch, noise, ref, stages, margin):
    """One `forward_train` and backward of the port in which every ReLU gate
    of `GATED_STAGES` whose input lies within `margin` of zero may be
    set either way.  For each of `stages`, gates are flipped one at a time,
    and a flip kept while it brings that stage's own parameters' gradients
    closer to `ref`; then every gradient is taken with the flips kept.
    Returns the gradients (None where no loss reaches) and the flips,
    (stage, |input|) each."""
    gates, current = [], []
    relu = torch.relu

    def gated(x):
        if not current or current[-1] not in GATED_STAGES:
            return relu(x)
        gate = (x > 0).to(x.dtype)
        gates.append((current[-1], x.detach(), gate))
        return x * gate

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "relu", gated)
        out = model.forward_train(**batch, noise=noise,
                                  stage=lambda name, fn: current.append(name) or fn())
    total = sum(v for k, v in out.items() if "loss" in k)
    params = dict(model.named_parameters())

    def worst(stage):
        names = [n for n in params if _owner(n) == stage]
        grads = torch.autograd.grad(total, [params[n] for n in names], retain_graph=True)
        return _misses(dict(zip(names, grads)), ref, stage)

    flips = []
    for stage in stages:
        near = [(x, gate, tuple(i)) for s, x, gate in gates if s == stage
                for i in (x.abs() < margin).nonzero().tolist()]
        best, improved = worst(stage), True
        while best > 1 and improved:
            improved = False
            for x, gate, i in near:
                gate.data[i] = 1 - gate.data[i]
                err = worst(stage)
                if err < best:
                    best, improved = err, True
                    flips.append((stage, float(x[i].abs())))
                else:
                    gate.data[i] = 1 - gate.data[i]
    grads = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    return dict(zip(params, grads)), flips


def _box_pairs():
    """Pairs of xyxy boxes (pred, target) and their weights: overlapping,
    disjoint, nested, touching at an edge, identical, zero-size (at one
    point and apart), inverted, and two of weight 0 (a zero box against a
    zero box, a box against a zero box)."""
    pairs = [([0, 0, 10, 10], [5, 5, 15, 15]), ([0, 0, 4, 4], [10, 12, 20, 30]),
             ([2, 2, 8, 8], [0, 0, 10, 10]), ([0, 0, 5, 5], [5, 0, 9, 5]),
             ([3, 4, 9, 11], [3, 4, 9, 11]), ([4, 4, 4, 4], [4, 4, 4, 4]),
             ([4, 4, 4, 4], [0, 0, 6, 6]), ([9, 9, 1, 1], [0, 0, 10, 10]),
             ([0, 0, 0, 0], [0, 0, 0, 0]), ([1.5, 2.5, 7.25, 9.0], [0, 0, 0, 0])]
    pred = np.asarray([p for p, _ in pairs], np.float32)
    target = np.asarray([t for _, t in pairs], np.float32)
    pred[:5] += np.random.default_rng(0).uniform(-0.3, 0.3, (5, 4)).astype(np.float32)
    weight = np.ones(len(pairs), np.float32)
    weight[-2:] = 0.0
    return pred, target, weight


@pytest.mark.parametrize("name", ["giou_loss", "iou_loss"])
def test_iou_losses_match_jax(name):
    pred, target, weight = _box_pairs()
    jfn, tfn = getattr(jlosses, name), getattr(tlosses, name)
    per_pair, (want, jgrad) = quick_jit(lambda p, t, w: (
        jax.vmap(jfn)(p, t), jax.value_and_grad(lambda q: jfn(q, t, weight=w, avg_factor=7.0))(p)),
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = tfn(p, torch.from_numpy(target), weight=torch.from_numpy(weight), avg_factor=7.0)
    got.backward()
    each = torch.stack([tfn(a[None], b[None]) for a, b in zip(torch.from_numpy(pred),
                                                               torch.from_numpy(target))])
    np.testing.assert_allclose(each.numpy(), np.asarray(per_pair), rtol=0, atol=1e-6)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=0, atol=1e-6)
    jgrad = np.asarray(jgrad)
    assert np.isfinite(jgrad).all() and torch.isfinite(p.grad).all()
    np.testing.assert_allclose(p.grad.numpy(), jgrad, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(jgrad).max())))
    assert not p.grad[-2:].any() and np.abs(jgrad[:-2]).max() > 0


def _samples(rng, B=2, S=12, num_classes=5):
    """RoISamples of a class-agnostic stage: the first 4 slots of each image
    positive (targets encoded towards a box near the RoI with stds
    (0.05, 0.05, 0.1, 0.1)), then 5 negatives, then 3 unfilled slots whose
    RoI is a zero box (a padded ground truth)."""
    xy = rng.uniform(0, 60, (B, S, 2))
    wh = rng.uniform(4, 40, (B, S, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 9:] = 0.0
    gt = boxes + rng.uniform(-3, 3, boxes.shape).astype(np.float32)
    targets = delta_encode(torch.from_numpy(boxes), torch.from_numpy(gt), (0., 0., 0., 0.),
                           (0.05, 0.05, 0.1, 0.1)).numpy()
    pos = np.zeros((B, S), np.float32)
    pos[:, :4] = 1.0
    targets = targets * pos[..., None]
    filled = np.zeros((B, S), np.float32)
    filled[:, :9] = 1.0
    labels = np.where(pos > 0, rng.integers(0, num_classes, (B, S)), num_classes)
    rois = np.concatenate([np.repeat(np.arange(B, dtype=np.float32), S).reshape(B, S, 1),
                           boxes], -1)
    return (rois, labels.astype(np.int32), filled, targets.astype(np.float32), pos)


@pytest.mark.parametrize("reg_loss", ["l1", "giou", "iou"])
def test_class_agnostic_bbox_head_loss_matches_jax(reg_loss):
    rng = np.random.default_rng(1)
    fields = _samples(rng)
    cls = (rng.standard_normal((24, 6)) * 2).astype(np.float32)
    reg = (rng.standard_normal((24, 4)) * 0.5).astype(np.float32)
    kw = {"reg_class_agnostic": True, "reg_loss": reg_loss, "reg_loss_weight": 10.0,
          "target_stds": (0.05, 0.05, 0.1, 0.1)}
    jsamples = jroi.RoISamples(*map(jnp.asarray, fields))

    def jloss(c, r):
        out = jroi.bbox_head_loss(c, r, jsamples, 5, **kw)
        return out["loss_cls"] + out["loss_bbox"], out

    (_, want), (jgc, jgr) = quick_jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
                                      jnp.asarray(cls), jnp.asarray(reg))
    c, r = (torch.from_numpy(a).requires_grad_(True) for a in (cls, reg))
    tfields = [torch.from_numpy(a) for a in fields]
    tfields[1] = tfields[1].long()
    got = troi.bbox_head_loss(c, r, troi.RoISamples(*tfields), 5, **kw)
    (got["loss_cls"] + got["loss_bbox"]).backward()
    assert set(got) == set(want) == {"loss_cls", "loss_bbox", "acc"}
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-6, err_msg=k)
    assert float(want["loss_bbox"]) > 0
    for g, w in ((c.grad, jgc), (r.grad, jgr)):
        w = np.asarray(w)
        assert torch.isfinite(g).all() and np.isfinite(w).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-6 * max(1.0, float(np.abs(w).max())))
    assert not r.grad.reshape(2, 12, 4)[:, 4:].any()


@pytest.mark.parametrize("kw", [{"reg_loss": "balanced_l1"}, {"reg_loss": "bounded_iou"},
                                {"pisa": {"isr_k": 2.0}}],
                         ids=["balanced_l1", "bounded_iou", "pisa"])
def test_unported_box_losses_raise(kw):
    rng = np.random.default_rng(2)
    fields = [torch.from_numpy(a) for a in _samples(rng)]
    fields[1] = fields[1].long()
    with pytest.raises(NotImplementedError, match="item 17d"):
        troi.bbox_head_loss(torch.zeros(24, 6), torch.zeros(24, 4), troi.RoISamples(*fields),
                            5, reg_class_agnostic=True, **kw)


def test_unreached_parameters_step_as_optax():
    """A Linear that no loss reaches decays as optax decays it (its Adam
    step is exactly 0) and one that a loss reaches only from the second
    update on starts Adam's moments with optax's count; the parent of this
    test left the first untouched and counted the second's Adam steps from
    its first gradient."""
    class Model(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.used, self.idle, self.late = (torch.nn.Linear(5, 4), torch.nn.Linear(6, 3),
                                               torch.nn.Linear(3, 2))

    model = Model()
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in model.parameters():        # magnitudes of 0.4-0.9: well off zero
            p.copy_(torch.from_numpy((rng.uniform(0.4, 0.9, p.shape)
                                      * rng.choice([-1, 1], p.shape)).astype(np.float32)))
    names = ("used", "idle", "late")
    params = {n: {"kernel": jnp.array(getattr(model, n).weight.detach().numpy().T),
                  "bias": jnp.array(getattr(model, n).bias.detach().numpy())} for n in names}
    before = {n: params[n]["kernel"] for n in names}
    kw = {"base_lr": 1e-2, "warmup_iters": 1, "decay_steps": (2,)}
    optimizer, scheduler = toptim.make_optimizer(model, **kw)
    tx = joptim.make_optimizer(params, **kw)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    for i in range(2):
        reached = ("used", "late") if i else ("used",)
        grads = {n: jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32)
                                 if n in reached else jnp.zeros_like(a), params[n])
                 for n in names}
        optimizer.zero_grad(set_to_none=True)
        for n in reached:
            getattr(model, n).weight.grad = torch.tensor(np.asarray(grads[n]["kernel"]).T.copy())
            getattr(model, n).bias.grad = torch.tensor(np.asarray(grads[n]["bias"]))
        assert optimizer.step()
        scheduler.step()
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        assert model.idle.weight.grad is None
    for n in names:
        m = getattr(model, n)
        for got, want in ((m.weight, params[n]["kernel"].T), (m.bias, params[n]["bias"])):
            # Adam's steps as `test_torch_train_loop.py` holds them, decay alone 1e-7
            tol = {"rtol": 1e-7, "atol": 0} if n == "idle" else {"rtol": 0, "atol": 1e-6}
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), err_msg=n,
                                       **tol)
    lrs = [1e-2 * 1e-3, 1e-2]
    decayed = np.asarray(before["idle"]).T * np.prod([1 - lr * 0.05 for lr in lrs])
    np.testing.assert_allclose(model.idle.weight.detach().numpy(), decayed, rtol=1e-7, atol=0)
    assert not np.array_equal(model.idle.weight.detach().numpy(), np.asarray(before["idle"]).T)


@pytest.fixture(scope="module", params=HEADS)
def loops(request, mask_frames, tmp_path_factory):
    """For one head: the JAX loop and the port's, on the same frames, draws
    and weights; what JAX's first step saw and computed (its batch, state,
    key and gradients) and its compiled step; the port's first metrics and
    gradients."""
    head = request.param
    shared = tiny_swin_cascade(head)
    det = shared["det"].clone(train_cfg=_train_cfg(head))
    variables = shared["variables"]
    pth = str(tmp_path_factory.mktemp("pth") / "tiny_cascade.pth")
    torch.save({"state_dict": shared["state_dict"]}, pth)
    first = {}

    def jit_train_step(step_fn, mesh):
        run = quick_jit_train_step(step_fn, mesh)

        def step(state, batch, rng):
            new_state, metrics = run(state, batch, rng)
            if not first:
                first.update(batch=to_numpy(batch), grads=to_numpy(new_state.opt_state[1]),
                             metrics={k: float(v) for k, v in metrics.items()},
                             rerun=functools.partial(run, state, rng=rng))
            return new_state, metrics
        return step

    make_optimizer, devices = jruntime.make_optimizer, jax.devices
    out = {"head": head, "lrs": []}
    sched = functools.partial(joptim.warmup_step_schedule, LOOP["base_lr"], LOOP["warmup_iters"],
                              decay_steps=(1,))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "jit_train_step", jit_train_step)
        mp.setattr(jruntime, "make_optimizer", lambda *a, **k: recording(make_optimizer(*a, **k)))
        mp.setattr(type(det), "init", lambda self, *args, **kw: variables)
        mp.setattr(jax, "devices", lambda *args: devices(*args)[:1])
        mp.setattr(jck, "save_checkpoint", lambda path, state: os.makedirs(path))
        rec = Recorder()
        random.seed(21)
        state = japi.train_detector(det, jb.build_dataset(_split(mask_frames)),
                                    work_dir=str(tmp_path_factory.mktemp("jax_loop")),
                                    hooks=[jhooks.LrRecordHook(sched()), rec], **LOOP)
        out["jax"] = {"rec": rec, "state": state, "first": first}

        port = _port_cascade(head)
        mp.setattr(tapi, "step_randomness",
                   functools.partial(jax_cascade_step_noise, det, variables))
        rec, port_steps = Recorder(), []

        def stage(name, fn):
            if name == "step":
                port_steps[-1]["state"] = {k: v.clone() for k, v in port.state_dict().items()}
            result = fn()
            if name == "copy":
                port_steps.append({"batch": {k: v.clone() for k, v in result.items()}})
            if name == "step":
                port_steps[-1].update(metrics={k: float(v) for k, v in result.items()},
                                      grads={n: p.grad for n, p in port.named_parameters()})
            return result

        random.seed(21)
        tapi.train_detector(port, tb.build_dataset(_split(mask_frames)),
                            work_dir=str(tmp_path_factory.mktemp("port_loop")), load_from=pth,
                            hooks=[thooks.LrRecordHook(toptim.warmup_step_schedule(
                                LOOP["base_lr"], LOOP["warmup_iters"], decay_steps=(1,))), rec],
                            device="cpu", stage=stage, **LOOP)
        out["port"] = {"rec": rec, "model": port, "first": port_steps[0], "steps": port_steps}
    out["det"], out["variables"] = det, variables
    # Each step's gradients in the port's loop, unless a gated stage misses
    # JAX's: then the same step again with gates near zero set as JAX set them.
    out["flip_aware"] = []
    for k, (step, jax_grads) in enumerate(zip(port_steps, (first["grads"],
                                                             to_numpy(state.opt_state[1])))):
        ref = from_jax_variables(jax_grads, {})
        missed = [s for s in GATED_STAGES if _misses(step["grads"], ref, s) > 1]
        out["flip_aware"].append((step["grads"], []))
        if missed:
            model = _port_cascade(head)
            model.load_state_dict(step["state"])
            noise = jax_cascade_step_noise(det, variables, model, LOOP["seed"], k, {
                n: v.numpy() for n, v in step["batch"].items()})["noise"]
            out["flip_aware"][k] = _flip_aware_gradients(model.train(), step["batch"], noise,
                                                         ref, missed, GATE_MARGINS[k])
    return out


def test_first_batches_are_equal(loops):
    got, ref = loops["port"]["first"]["batch"], loops["jax"]["first"]["batch"]
    assert set(got) == set(ref) and got["gt_masks"].any()
    for key, value in got.items():
        assert np.array_equal(value.numpy(), ref[key]), key


@pytest.mark.parametrize("name", OUTPUTS)
def test_forward_train_outputs_match_jax(loops, name):
    got, ref = loops["port"]["first"]["metrics"], loops["jax"]["first"]["metrics"]
    assert set(got) == set(ref) == set(OUTPUTS) | {"loss", "grad_norm"}
    assert np.isfinite(got[name]) and (name.endswith("acc") or got[name] > 0)
    np.testing.assert_allclose(got[name], ref[name], rtol=1e-4)


def test_every_gradient_matches_jax(loops):
    """Every parameter's gradient, the mask head's aside (the port gives it
    none, JAX exactly 0: the pin).  The loop's first step, where the RPN
    head's and the bbox heads' gradients hold; else the same step with the
    gates whose input lies within `GATE_MARGINS[0]` of zero set as JAX set
    them
    (`_flip_aware_gradients`)."""
    grads = loops["port"]["first"]["grads"]
    ref = from_jax_variables(loops["jax"]["first"]["grads"], {})
    assert set(grads) == set(ref)
    mask_head = [n for n in grads if n.startswith("roi_head.mask_head.")]
    assert len(mask_head) == 12
    for name in mask_head:
        assert grads[name] is None and not ref[name].any(), name
    aware, flips = loops["flip_aware"][0]
    assert len(flips) <= 4 and all(x < GATE_MARGINS[0] for _, x in flips), flips
    for name, g in grads.items():
        if name in mask_head:
            assert aware[name] is None, name
            continue
        if not flips:
            assert torch.equal(aware[name], g), name
        r = ref[name].numpy()
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(aware[name].numpy(), r, rtol=0, err_msg=name,
                                   atol=1e-5 + 2e-3 * float(np.abs(r).max()))
    heads = {n.split(".")[2] for n in grads if n.startswith("roi_head.bbox_head.")}
    assert heads == {"0", "1", "2"}


def test_gt_masks_move_no_loss(loops):
    """The pin, in both packages: JAX's compiled step on the first batch with
    the masks moved (each shifted by 9 pixels, and one filled) gives the
    same outputs; the port's `forward_train` on the same weights and noise
    with the masks moved, and with none, gives equal outputs, calls no mask
    stage and leaves the mask head without gradient."""
    first = loops["jax"]["first"]
    batch = dict(first["batch"])
    moved = np.roll(batch["gt_masks"], 9, axis=-1)
    moved[0, 0] = 1
    _, metrics = first["rerun"](dict(batch, gt_masks=jnp.asarray(moved)))
    assert {k: float(v) for k, v in metrics.items()} == first["metrics"]
    model = _port_cascade(loops["head"])
    model.load_state_dict(tiny_swin_cascade(loops["head"])["state_dict"])
    model.train()
    host = loops["port"]["first"]["batch"]
    noise = jax_cascade_step_noise(loops["det"], loops["variables"], model, LOOP["seed"], 0,
                                   {k: v.numpy() for k, v in host.items()})["noise"]
    outs = []
    for masks in (host["gt_masks"], torch.from_numpy(moved), None):
        stages = []
        model.zero_grad(set_to_none=True)
        out = model.forward_train(**dict(host, gt_masks=masks), noise=noise,
                                  stage=lambda name, fn: stages.append(name) or fn())
        sum(v for k, v in out.items() if "loss" in k).backward()
        assert tuple(stages) == CASCADE_TRAIN_STAGES
        assert all(p.grad is None for p in model.roi_head.mask_head.parameters())
        outs.append({k: float(v) for k, v in out.items()})
    assert outs[0] == outs[1] == outs[2]
    np.testing.assert_allclose(outs[0]["s1.loss_cls"], first["metrics"]["s1.loss_cls"],
                               rtol=1e-4)


@pytest.mark.parametrize("key", ("s0.loss_cls", "s1.loss_bbox", "s2.loss_cls", "loss",
                                 "grad_norm", "lr", "step"))
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
    learning rates everywhere; the mask head's within 1e-7 relative of
    JAX's and within 1e-6 of p0 * (1 - lr1 wd)(1 - lr2 wd) (its biases
    untouched); elsewhere within 1e-5 + 2e-2 * max|p - p0| where Adam's
    first moment 0.09 g1 + 0.1 g2 lies 50 times above its own tolerance
    (`test_torch_mask_train.py`'s rule: with each step's gradient known to
    1e-5 + 2e-3 * max|g|, `test_torch_train_loop.py`'s 1e-3 of the largest
    moment leaves a step's sign undetermined), except in the rows (output
    units) whose gradient at either step a gate flip of
    `_flip_aware_gradients` moved beyond that tolerance: the port's loop
    stepped them with its own gate, JAX's with its own.  At least a tenth
    of the entries outside the gated stages, and some of every tensor in
    them, are held so."""
    state = loops["jax"]["state"]
    want = from_jax_variables(to_numpy(state.params), {})
    grads = [from_jax_variables(loops["jax"]["first"]["grads"], {}),
             from_jax_variables(to_numpy(state.opt_state[1]), {})]
    port_grads = [step["grads"] for step in loops["port"]["steps"]]
    aware = [a for a, _ in loops["flip_aware"]]
    before = tiny_swin_cascade(loops["head"])["state_dict"]
    got = loops["port"]["model"].state_dict()
    lr_sum = LOOP["base_lr"] * (1e-3 + 1e-1)
    decay = (1 - LOOP["base_lr"] * 1e-3 * 0.05) * (1 - LOOP["base_lr"] * 1e-1 * 0.05)
    firm_entries = checked = 0
    for name, v in got.items():
        g, w, p0 = v.numpy(), want[name].numpy(), before[name].numpy()
        np.testing.assert_allclose(g, w, atol=2 * lr_sum + 1e-6, rtol=0, err_msg=name)
        if name.startswith("roi_head.mask_head."):
            np.testing.assert_allclose(g, w, rtol=1e-7, atol=0, err_msg=name)
            np.testing.assert_allclose(g, p0.astype(np.float64) * (
                decay if name.endswith("weight") else 1.0), rtol=1e-6, atol=0, err_msg=name)
            continue
        g1, g2 = (step[name].numpy() for step in grads)
        t1, t2 = (1e-5 + 2e-3 * np.abs(a).max() for a in (g1, g2))
        firm = np.abs(0.09 * g1 + 0.1 * g2) > 50 * (0.09 * t1 + 0.1 * t2)
        for a, p, t in zip(aware, port_grads, (t1, t2)):
            moved = ((a[name] - p[name]).abs() > t).numpy()
            firm[moved.reshape(moved.shape[0], -1).any(1)] = False
        np.testing.assert_allclose(g[firm], w[firm], rtol=0, err_msg=name,
                                   atol=1e-5 + 2e-2 * float(np.abs(w - p0).max()))
        if _owner(name):
            assert firm.any(), name
        else:
            firm_entries += int(firm.sum())
            checked += g.size
    assert firm_entries > 0.1 * checked


def _cli_config(frames, directory):
    """A tiny cascade config on the synthetic set: 2 epochs of 2 steps, the
    loader in the model's thread, no evaluation."""
    path = os.path.join(directory, "tiny_cascade.py")
    cfg = {"model": dict(tiny_cascade_config("4conv1f"), train_cfg=_train_cfg("4conv1f")),
           "data": {"samples_per_gpu": 2, "workers_per_gpu": 0,
                    "train": dict(_split(frames), classes=list(CLASSES))},
           "optimizer": {"type": "AdamW", "lr": 1e-3, "weight_decay": 0.05},
           "lr_config": {"warmup_iters": 1, "step": [1]}, "runner": {"max_epochs": 2},
           "log_config": {"interval": 1}, "checkpoint_config": {"interval": 1}}
    with open(path, "w") as f:
        f.write("".join(f"{k} = {v!r}\n" for k, v in cfg.items()))
    return path


def test_train_cli_trains_and_resumes_a_cascade(mask_frames, tmp_path):
    """`tools.train` on a tiny GIoU 4conv1f cascade config: `epoch_{n}` holds
    the three heads and the mask head, the mask head's weights only
    decayed; a run resumed from `epoch_1` is the uninterrupted run's second
    epoch bit for bit (log lines, parameters, optimizer state)."""
    cfg = _cli_config(mask_frames, str(tmp_path))
    runs = {}
    for name, resume in (("whole", []), ("resumed", ["--resume-from",
                                                     str(tmp_path / "whole" / "epoch_1")])):
        work_dir = str(tmp_path / name)
        random.seed(5)
        model = train_cli.main([cfg, "--work-dir", work_dir, "--device", "cpu", *resume])
        with open(os.path.join(work_dir, "train.log.json")) as f:
            lines = [{k: v for k, v in json.loads(line).items() if k != "time"} for line in f]
        runs[name] = (model, lines, torch.load(os.path.join(work_dir, "epoch_2"),
                                               weights_only=True))
    (whole, whole_lines, whole_ckpt), (resumed, resumed_lines, resumed_ckpt) = \
        runs["whole"], runs["resumed"]
    assert len(whole_lines) == 4 and set(whole_lines[0]) >= set(OUTPUTS)
    assert resumed_lines == whole_lines[2:]
    for (n, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n
    for a, b in zip(whole_ckpt["optimizer"]["state"].values(),
                    resumed_ckpt["optimizer"]["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    first = torch.load(str(tmp_path / "whole" / "epoch_1"), weights_only=True)["state_dict"]
    assert {k.split(".")[2] for k in first if k.startswith("roi_head.bbox_head.")} == \
        {"0", "1", "2"}
    w1, w2 = (ck["roi_head.mask_head.conv_logits.weight"]
              for ck in (first, whole_ckpt["state_dict"]))
    lrs = [toptim.warmup_step_schedule(1e-3, 1, decay_steps=(2,))(step) for step in (2, 3)]
    assert not torch.equal(w1, w2)
    np.testing.assert_allclose(w2.numpy(), w1.numpy().astype(np.float64) * np.prod(
        [1 - lr * 0.05 for lr in lrs]), rtol=1e-6, atol=0)


def test_census_counts_the_cascades_as_trainable():
    result = config_census.census(os.path.join(ROOT, "configs", "swin"))
    cascades = [n for n in result["trainable_configs"] if n in SWIN_CASCADES]
    assert len(SWIN_CASCADES) == 9 and cascades == SWIN_CASCADES
    assert result["trainable"] == len(result["trainable_configs"]) <= result["built"]
