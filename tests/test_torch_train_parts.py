"""The training step's parts of the PyTorch port vs JAX, function by function.

Numpy inputs from a seed go through the JAX function and its counterpart in
the port.  Integer results (assignments, sampled indices, masks) must be
identical; float results agree to 1e-6 relative unless a test says
otherwise (both sides are float32 and do the same operations; only sums run
in another order).  The samplers get JAX's own uniform noise handed in.
"""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from panoswintransformerobjectdetection_tpu.core import assigner as jassigner
from panoswintransformerobjectdetection_tpu.core import bbox as jbbox
from panoswintransformerobjectdetection_tpu.core import losses as jlosses
from panoswintransformerobjectdetection_tpu.core import sampler as jsampler
from panoswintransformerobjectdetection_tpu.models import roi_head as jroi
from panoswintransformerobjectdetection_tpu.models import rpn_head as jrpn
from panoswintransformerobjectdetection_tpu.runtime import optim as joptim
from panoswintransformerobjectdetection_torch.core import assigner, bbox, losses, sampler
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.models import roi_head as troi
from panoswintransformerobjectdetection_torch.models import rpn_head as trpn
from panoswintransformerobjectdetection_torch.models.detectors import PanoFasterRCNN
from panoswintransformerobjectdetection_torch.models.layers import DropPath
from panoswintransformerobjectdetection_torch.runtime import optim
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables
from torch_port_common import (jax_sampler_noise, quick_jit,  # noqa: F401
                               single_torch_thread, tiny_detector, to_numpy)


def _boxes(rng, *shape, size=64.0):
    xy = rng.uniform(0, size * 0.7, shape + (2,))
    wh = rng.uniform(2, size * 0.5, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, ref, rtol=1e-6, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=atol)


def test_bbox_overlaps_and_delta_encode():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 2, 5), _boxes(rng, 2, 9)
    _close(bbox.bbox_overlaps(_t(a), _t(b)), quick_jit(jbbox.bbox_overlaps, a, b))
    props = _boxes(rng, 2, 7)
    props[0, 0] = [3, 3, 3, 3]                      # degenerate: clamped, finite
    gts = _boxes(rng, 2, 7)
    stds = (0.1, 0.1, 0.2, 0.2)
    got = bbox.delta_encode(_t(props), _t(gts), stds=stds)
    assert torch.isfinite(got).all()
    _close(got, quick_jit(lambda p, g: jbbox.delta_encode(p, g, stds=stds), props, gts),
           rtol=1e-5, atol=1e-5)
    back = bbox.delta_decode(_t(props[1]), got[1], stds=stds)
    _close(back, gts[1], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("low_quality", [True, False])
def test_max_iou_assign(low_quality):
    rng = np.random.default_rng(1)
    gts, cand = _boxes(rng, 4), _boxes(rng, 60)
    cand[:4] = gts                                  # exact matches
    cand[10] = cand[11] = gts[1] + [1, 0, 1, 0]     # two candidates tie for gt 1
    valid = np.array([True, True, False, True])
    ious = np.asarray(quick_jit(jbbox.bbox_overlaps, gts, cand))
    ref, ref_max = quick_jit(lambda i, v: jassigner.max_iou_assign(i, v, 0.7, 0.3, 0.3,
                                                                   low_quality), ious, valid)
    got, got_max = assigner.max_iou_assign(_t(ious), _t(valid), 0.7, 0.3, 0.3, low_quality)
    assert got.tolist() == np.asarray(ref).tolist()
    assert set(got.tolist()) >= {-1, 0, 1, 2, 4}
    _close(got_max, ref_max)
    both, _ = assigner.max_iou_assign(_t(np.stack([ious, ious[::-1]])),
                                      _t(np.stack([valid, valid[::-1]])), 0.7, 0.3, 0.3,
                                      low_quality)
    assert torch.equal(both[0], got)                # leading dimensions are batches


@pytest.mark.parametrize("neg_pos_ub", [-1, 2])
@pytest.mark.parametrize("n_pos", [0, 3, 40])
def test_random_sample_identical_under_jax_noise(n_pos, neg_pos_ub):
    """Too few, some and too many positives for the quota of 8 of 16."""
    rng = np.random.default_rng(2)
    N = 97
    assigned = np.zeros(N, np.int32)
    assigned[rng.permutation(N)[:20]] = -1
    assigned[rng.permutation(N)[:n_pos]] = rng.integers(1, 4, n_pos)
    key = jax.random.PRNGKey(5)
    ref, noise = quick_jit(
        lambda k, a: (jsampler.random_sample(k, a, 16, 0.5, neg_pos_ub),
                      [jax.random.uniform(kk, (N,)) for kk in jax.random.split(k)]),
        key, jnp.asarray(assigned))
    noise = tuple(_t(n) for n in noise)
    got = sampler.random_sample(noise, _t(assigned).long(), 16, 0.5, neg_pos_ub)
    for g, r in zip(got, ref):
        assert g.tolist() == np.asarray(r).tolist()
    n = int(got.pos_mask.sum())
    assert n == min(int((assigned > 0).sum()), 8)
    assert int(got.neg_mask.sum()) == min(16 - n, max(n, 1) * 2 if neg_pos_ub >= 0 else 16)


def test_sampler_noise_follows_the_generator():
    a = sampler.sampler_noise((2, 50), torch.Generator().manual_seed(3))
    b = sampler.sampler_noise((2, 50), torch.Generator().manual_seed(3))
    assert all(torch.equal(x, y) for x, y in zip(a, b)) and not torch.equal(a[0], a[1])
    assert all(t.shape == (2, 50) and t.dtype == torch.float32 and 0 <= t.min()
               and t.max() < 1 for t in a)


@pytest.mark.parametrize("name", ["cross_entropy", "binary_cross_entropy", "l1_loss",
                                  "accuracy"])
def test_losses(name):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 12, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, (2, 12))
    weight = (rng.random((2, 12)) > 0.3).astype(np.float32)
    if name == "cross_entropy":
        args, targs = (logits, labels), (_t(logits), _t(labels))
    elif name == "accuracy":
        args, targs = (logits, labels, weight), (_t(logits), _t(labels), _t(weight))
        _close(losses.accuracy(*targs), jlosses.accuracy(*args))
        _close(losses.accuracy(*targs[:2]), jlosses.accuracy(*args[:2]))
        return
    else:
        target = rng.random((2, 12, 6)).astype(np.float32)
        args, targs = (logits, target), (_t(logits), _t(target))
        weight = weight[..., None]
    jfn, tfn = getattr(jlosses, name), getattr(losses, name)
    _close(tfn(*targs), jfn(*args))
    _close(tfn(*targs, weight=_t(weight), avg_factor=_t(weight.sum())),
           jfn(*args, weight=weight, avg_factor=weight.sum()))
    _close(tfn(*targs, weight=_t(weight * 0), avg_factor=0.0),
           jfn(*args, weight=weight * 0, avg_factor=0.0))


def _rpn_case(rng, B=2, G=3):
    sizes = [(8, 16), (4, 8), (2, 4)]
    cls = [rng.standard_normal((B, h, w, 3)).astype(np.float32) for h, w in sizes]
    reg = [rng.standard_normal((B, h, w, 12)).astype(np.float32) * 0.1 for h, w in sizes]
    port = PanoFasterRCNN(**flagship_config(tiny=True))
    anchors = torch.cat(port.anchor_gen.grid_anchors(sizes)).numpy()
    gts = _boxes(rng, B, G)
    gts[0, 0] = anchors[40]                         # one exact anchor match
    valid = np.array([[True, True, False], [True, True, True]])
    return cls, reg, anchors, gts, valid


def test_rpn_loss_matches_jax():
    """Values 1e-6; gradients of the logits and deltas 1e-6."""
    cls, reg, anchors, gts, valid = _rpn_case(np.random.default_rng(4))
    key = jax.random.PRNGKey(7)
    cfg = {"num_samples": 32, "pos_fraction": 0.5}

    def jloss(c, r):
        out = jrpn.rpn_loss(c, r, jnp.asarray(anchors), gts, valid, key, **cfg)
        return out["loss_rpn_cls"] + out["loss_rpn_bbox"], out

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        tuple(cls), tuple(reg))
    tc = [_t(c).requires_grad_() for c in cls]
    tr = [_t(r).requires_grad_() for r in reg]
    got = trpn.rpn_loss(tc, tr, _t(anchors), _t(gts), _t(valid),
                        jax_sampler_noise(key, 2, anchors.shape[0]), **cfg)
    assert float(got["loss_rpn_bbox"].detach()) > 0
    for k in ("loss_rpn_cls", "loss_rpn_bbox"):
        _close(got[k].detach(), ref[k])
    (got["loss_rpn_cls"] + got["loss_rpn_bbox"]).backward()
    for g, r in zip(tc + tr, ref_grads[0] + ref_grads[1]):
        _close(g.grad, r)


def _roi_case(rng, B=2, G=3, P=20):
    gts = _boxes(rng, B, G)
    props = _boxes(rng, B, P)
    props[:, :6] = gts[:, [0, 0, 1, 1, 2, 2]] + rng.uniform(-2, 2, (B, 6, 4)).astype(np.float32)
    pmask = rng.random((B, P)) > 0.2
    valid = np.array([[True, True, False], [True, True, True]])
    labels = rng.integers(0, 5, (B, G)).astype(np.int32)
    return gts, props, pmask, valid, labels


def test_sample_rois_for_training_matches_jax():
    gts, props, pmask, valid, labels = _roi_case(np.random.default_rng(5))
    key = jax.random.PRNGKey(9)
    cfg = {"num_samples": 16, "pos_fraction": 0.25}
    ref = jax.jit(lambda k: jroi.sample_rois_for_training(k, props, pmask, gts, labels, valid,
                                                          5, **cfg))(key)
    got = troi.sample_rois_for_training(jax_sampler_noise(key, 2, 3 + 20), _t(props), _t(pmask),
                                        _t(gts), _t(labels), _t(valid), 5, **cfg)
    assert got.rois.shape == (2, 4 + 16, 5) and got.bbox_weights.sum() > 0
    assert got.labels.tolist() == np.asarray(ref.labels).tolist()
    for name in ("label_weights", "bbox_weights"):
        assert getattr(got, name).tolist() == np.asarray(getattr(ref, name)).tolist()
    filled = np.asarray(ref.label_weights) > 0      # unfilled slots hold arbitrary boxes
    _close(got.rois.numpy()[filled], np.asarray(ref.rois)[filled])
    _close(got.bbox_targets, ref.bbox_targets, rtol=1e-5, atol=1e-5)


def test_bbox_head_loss_matches_jax():
    rng = np.random.default_rng(6)
    gts, props, pmask, valid, labels = _roi_case(rng)
    key = jax.random.PRNGKey(9)
    samples = troi.sample_rois_for_training(jax_sampler_noise(key, 2, 23), _t(props), _t(pmask),
                                            _t(gts), _t(labels), _t(valid), 5, num_samples=16)
    jsamples = jroi.RoISamples(*(t.numpy() for t in samples))
    cls = rng.standard_normal((2 * 20, 6)).astype(np.float32)
    reg = rng.standard_normal((2 * 20, 20)).astype(np.float32)
    ref = quick_jit(lambda c, r, sm: jroi.bbox_head_loss(c, r, sm, 5), jnp.asarray(cls),
                    jnp.asarray(reg), jsamples)
    got = troi.bbox_head_loss(_t(cls), _t(reg), samples, 5)
    assert set(got) == {"loss_cls", "loss_bbox", "acc"} and float(got["loss_bbox"]) > 0
    for k, v in got.items():
        _close(v, ref[k])


def test_unported_training_options_raise():
    """An unported training option builds (the model can serve) and raises
    in `forward_train`; so does eval mode."""
    cfg = {"rpn": {}, "rpn_proposal": {}, "rcnn": {"sampler": "ohem"}}
    model = PanoFasterRCNN(**flagship_config(tiny=True), train_cfg=cfg).train()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.forward_train(torch.zeros(1, 32, 64, 3), torch.tensor([[32., 64.]]),
                            torch.zeros(1, 1, 4), torch.zeros(1, 1), torch.ones(1, 1))
    model = PanoFasterRCNN(**flagship_config(tiny=True)).eval()
    with pytest.raises(RuntimeError, match="train mode"):
        model.forward_train(torch.zeros(1, 32, 64, 3), torch.tensor([[32., 64.]]),
                            torch.zeros(1, 1, 4), torch.zeros(1, 1), torch.ones(1, 1))


def test_drop_path_scaling_and_keep_rate():
    """Kept samples are scaled by 1 / keep, dropped ones are zero; over 4000
    samples the keep rate is within 0.03 of 0.7 (5 sigma is 0.036)."""
    dp = DropPath(0.3).train()
    dp.generator = torch.Generator().manual_seed(0)
    x = torch.ones(4000, 2, 3)
    y = dp(x)
    kept = y[:, 0, 0] != 0
    assert torch.equal(y, kept[:, None, None] * x / 0.7)
    assert abs(float(kept.float().mean()) - 0.7) < 0.03
    dp.generator = torch.Generator().manual_seed(0)
    assert torch.equal(dp(x), y)
    assert dp.eval()(x) is x and DropPath(0.0).train()(x) is x


def test_drop_path_rates_rise_over_the_blocks():
    model = PanoFasterRCNN(**flagship_config())
    rates = [blk.drop_path1.rate for layer in model.backbone.layers for blk in layer.blocks]
    np.testing.assert_allclose(rates, np.linspace(0, 0.1, 12))
    assert [blk.drop_path2.rate for layer in model.backbone.layers
            for blk in layer.blocks] == rates


def test_no_decay_mask_equals_jax_on_the_converted_tree():
    td = tiny_detector()
    params = to_numpy(td["variables"]["params"])
    jmask = jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32),
                         joptim.no_decay_mask(params), params)
    ref = from_jax_variables(jmask, to_numpy(td["variables"]["batch_stats"]))
    model = PanoFasterRCNN(**flagship_config(tiny=True))
    got = optim.no_decay_mask(model)
    assert set(got) == {n for n, _ in model.named_parameters()}
    assert 0 < sum(got.values()) < len(got)
    for name, decays in got.items():
        assert bool(ref[name].flatten()[0]) == decays, name


def test_warmup_step_schedule():
    kw = {"warmup_iters": 10, "warmup_ratio": 0.01, "decay_steps": (20, 30)}
    ref, got = joptim.warmup_step_schedule(1e-3, **kw), optim.warmup_step_schedule(1e-3, **kw)
    steps = (0, 1, 9, 10, 19, 20, 29, 30, 100)
    np.testing.assert_allclose([got(step) for step in steps], np.asarray(ref(jnp.asarray(steps))),
                               rtol=1e-6)
    _, sched = optim.make_optimizer(torch.nn.Linear(2, 2), base_lr=1e-3, **kw)
    assert sched.get_last_lr()[0] == pytest.approx(1e-5)


def test_adamw_update_matches_optax():
    """Three steps on a small tree: a decayed kernel, a bias and a norm
    scale.  1e-6 relative: the same update, written in another order."""
    class Small(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(3, 4)
            self.norm = torch.nn.LayerNorm(4)
    rng = np.random.default_rng(7)
    model = Small()
    tree = {"fc": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                   "bias": rng.standard_normal(4).astype(np.float32)},
            "norm": {"scale": rng.standard_normal(4).astype(np.float32),
                     "bias": rng.standard_normal(4).astype(np.float32)}}
    names = {"fc.weight": ("fc", "kernel", True), "fc.bias": ("fc", "bias", False),
             "norm.weight": ("norm", "scale", False), "norm.bias": ("norm", "bias", False)}
    with torch.no_grad():
        for n, p in model.named_parameters():
            a = tree[names[n][0]][names[n][1]]
            p.copy_(_t(a.T if names[n][2] else a))
    kw = {"base_lr": 1e-2, "weight_decay": 0.05, "warmup_iters": 2, "decay_steps": (2,)}
    tx = joptim.make_optimizer(tree, **kw)
    opt_state = tx.init(tree)
    opt, sched = optim.make_optimizer(model, **kw)
    for step in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
        updates, opt_state = tx.update(grads, opt_state, tree)
        tree = optax.apply_updates(tree, updates)
        for n, p in model.named_parameters():
            g = grads[names[n][0]][names[n][1]]
            p.grad = _t(g.T.copy() if names[n][2] else g)
        opt.step()
        sched.step()
        for n, p in model.named_parameters():
            a = np.asarray(tree[names[n][0]][names[n][1]])
            _close(p.detach(), a.T if names[n][2] else a, rtol=1e-6, atol=1e-7)
