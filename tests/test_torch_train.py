"""The PyTorch port's training step vs JAX: the train-mode stem, then the
slice as a whole on the tiny flagship, in float32.

The tiny JAX detector (`torch_port_common.tiny_detector`) takes one step of
the JAX package's own `make_train_step`, jitted once; its optimizer is
wrapped so that the step also hands back the gradients it applied.  The
port takes the same step from the same weights (`from_jax_variables`), the
same batch, `drop_path_rate=0` and the same sampler noise: the key that the
JAX module draws with is read back and the split chain followed
(`torch_port_common.jax_sampler_noise`).  JAX's gradients and updated
variables come across through `from_jax_variables`, which is linear in the
values it lays out.

Tolerances: the five outputs 1e-5 relative.  Gradients, per tensor,
atol = 1e-5 + 1e-3 * max|g|: float32 sums in another order through some
twenty layers (measured: 1.3e-4 * max|g| at worst).  After the step (lr 1e-2, no warm-up, so that the update is
far above rounding) parameters atol 2e-4.  Adam's first update is
lr * g / (|g| + 1e-8), the gradient's sign, so an entry whose gradient
lies within the gradient tolerance of zero (the bias of a conv before a
BatchNorm, whose true gradient is zero, above all) has no determined sign,
can land 2 * lr apart, and is left out.  Running statistics 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import layers as jlayers
from panoswintransformerobjectdetection_tpu.runtime.optim import make_optimizer
from panoswintransformerobjectdetection_tpu.runtime.train import TrainState, make_train_step
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.models.detectors import (TRAIN_STAGES,
                                                                       PanoFasterRCNN)
from panoswintransformerobjectdetection_torch.models.layers import ConvStemPatchEmbed
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime import train as ttrain
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (from_jax_backbone,
                                                                         from_jax_variables)
from torch_port_common import (TINY_TRAIN_CFG, jax_sampler_noise,  # noqa: F401
                               quick_jit, recording, single_torch_thread, tiny_detector,
                               to_numpy)

B, H, W, G = 2, 32, 64, 3
LR = 1e-2
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_stem_matches_flax(dtype):
    """Output, parameter gradients and the running statistics after one
    train-mode call against flax (`mutable=["batch_stats"]`).  float32:
    1e-4; bfloat16: output and gradients within 0.05 * max|ref| (the
    frameworks round at other places), statistics 1e-2 relative.  The
    biases of the two convs before a BatchNorm have a true gradient of zero
    (the normalisation removes a bias), so in bfloat16 theirs is each
    framework's own rounding noise and is not compared."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 24, 3)).astype(np.float32)
    g = rng.standard_normal((2, 4, 6, 12)).astype(np.float32)
    jdt = None if dtype == "float32" else jnp.bfloat16
    jmod = jlayers.ConvStemPatchEmbed(patch_size=4, embed_dim=12, dtype=jdt)
    variables = quick_jit(lambda k, a: jmod.init(k, a, train=False), jax.random.PRNGKey(0),
                          jnp.asarray(x))
    stats = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
             for k, v in variables["batch_stats"].items()}

    def loss(params):
        y, upd = jmod.apply({"params": params, "batch_stats": stats}, jnp.asarray(x),
                            train=True, mutable=["batch_stats"])
        return (y.astype(jnp.float32) * g).sum(), (y, upd["batch_stats"])

    (_, (ref, ref_stats)), ref_grads = quick_jit(jax.value_and_grad(loss, has_aux=True),
                                                 variables["params"])
    embed = {"patch_embed": to_numpy(variables["params"])}
    as_sd = lambda p, s: {k[len("patch_embed."):]: v for k, v in   # noqa: E731
                          from_jax_backbone({"patch_embed": p}, {"patch_embed": s}).items()}
    mod = ConvStemPatchEmbed(4, 12, None if dtype == "float32" else torch.bfloat16).train()
    mod.load_state_dict(as_sd(embed["patch_embed"], stats))
    eval_weights = mod.eval().kernel_weights(torch.float32)
    got = mod.train()(torch.from_numpy(x))
    (got.float() * torch.from_numpy(g)).sum().backward()

    ref = np.asarray(ref, np.float32)
    tol = (lambda r: 1e-4) if dtype == "float32" else (lambda r: 0.05 * float(np.abs(r).max()))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.detach().float().numpy(), ref, atol=tol(ref))
    want = as_sd(to_numpy(ref_grads), to_numpy(ref_stats))
    for name, p in mod.named_parameters():
        if dtype == "bfloat16" and name in ("proj.0.bias", "proj.3.bias"):
            continue
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=tol(want[name].numpy()),
                                   err_msg=name)
    for name, b in mod.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(b.numpy(), want[name].numpy(),
                                       rtol=1e-5 if dtype == "float32" else 1e-2, atol=1e-5,
                                       err_msg=name)
    # the eval path's folded weights are made again from the new statistics
    assert mod.eval().kernel_weights(torch.float32) is not eval_weights


@pytest.fixture(scope="module")
def step_pair():
    """One training step on both sides."""
    td = tiny_detector()
    det, variables = td["det"], td["variables"]
    rng = np.random.default_rng(1)
    batch = {"images": rng.random((B, H, W, 3)).astype(np.float32),
             "img_shapes": np.array([[H, W]] * B, np.float32),
             "gt_boxes": np.array([[[4, 2, 36, 30], [20, 8, 60, 28], [0, 0, 0, 0]],
                                   [[10, 4, 30, 24], [34, 6, 62, 30], [2, 12, 26, 30]]],
                                  np.float32),
             "gt_labels": np.array([[0, 3, 0], [1, 4, 2]], np.int32),
             "gt_valid": np.array([[True, True, False], [True, True, True]])}
    tx = recording(make_optimizer(variables["params"], base_lr=LR, warmup_iters=0))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    key = jax.random.PRNGKey(1)
    new_state, ref = quick_jit(make_train_step(det), state, jax.tree.map(jnp.asarray, batch), key)

    # the sampler's key, as `make_train_step` and `forward_train` derive it
    r1, _ = jax.random.split(jax.random.fold_in(jax.random.fold_in(key, 0), 0))
    k = det.apply(variables, method=lambda m: m.make_rng("sampler"), rngs={"sampler": r1})
    k_rpn, k_rcnn = jax.random.split(k)
    port = PanoFasterRCNN(**flagship_config(tiny=True), train_cfg=TINY_TRAIN_CFG).train()
    port.load_state_dict(td["state_dict"])
    anchors = sum(a.shape[0] for a in port.anchor_gen.grid_anchors(
        [(-(-H // s), -(-W // s)) for s in (4, 8, 16, 32, 64)]))
    noise = {"rpn": jax_sampler_noise(k_rpn, B, anchors),
             "rcnn": jax_sampler_noise(k_rcnn, B, G + TINY_TRAIN_CFG["rpn_proposal"]["max_per_img"])}
    optimizer, scheduler = toptim.make_optimizer(port, base_lr=LR, warmup_iters=0)
    stages = []

    def stage(name, fn):
        stages.append(name)
        return fn()

    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = ttrain.make_train_step(port, optimizer, scheduler)(tbatch, noise=noise, stage=stage)
    grads = {n: p.grad.clone() for n, p in port.named_parameters()}
    return {"ref": {k: float(v) for k, v in ref.items()}, "got": got, "port": port,
            "grads": grads, "stages": stages, "before": td["state_dict"],
            "ref_grads": from_jax_variables(to_numpy(new_state.opt_state[1]),
                                            to_numpy(new_state.batch_stats)),
            "ref_after": from_jax_variables(to_numpy(new_state.params),
                                            to_numpy(new_state.batch_stats))}


@pytest.mark.parametrize("name", LOSSES + ("loss", "grad_norm"))
def test_forward_train_outputs_match_jax(step_pair, name):
    got, ref = float(step_pair["got"][name]), step_pair["ref"][name]
    assert np.isfinite(got) and (name == "acc" or got > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_forward_train_runs_its_stages_in_order(step_pair):
    assert tuple(step_pair["stages"]) == TRAIN_STAGES + ttrain.STEP_STAGES


def test_every_gradient_matches_jax(step_pair):
    grads, ref = step_pair["grads"], step_pair["ref_grads"]
    assert set(grads) == {k for k in ref if "running" not in k and "num_batches" not in k}
    for name, g in grads.items():
        r = ref[name].numpy()
        assert np.abs(r).max() > 0, name
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 1e-3 * float(np.abs(r).max()),
                                   err_msg=name)


def test_parameters_and_statistics_after_one_step_match_jax(step_pair):
    ref, before = step_pair["ref_after"], step_pair["before"]
    moved = 0
    for name, v in step_pair["port"].state_dict().items():
        if "num_batches" in name:
            continue
        r = ref[name].numpy()
        if "running" in name:
            np.testing.assert_allclose(v.numpy(), r, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            g = step_pair["ref_grads"][name].numpy()
            firm = np.abs(g) > 1e-5 + 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(v.numpy()[firm], r[firm], atol=2e-4, err_msg=name)
        moved += int(not np.array_equal(r, before[name].numpy()))
    assert moved == len(ref) - 2        # all but the two `num_batches_tracked`
