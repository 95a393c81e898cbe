"""The PyTorch port's training loop against the JAX package's.

`make_optimizer` with clipping and accumulation is held against optax's
chain (`MultiSteps` around `clip_by_global_norm`, Adam, decayed weights and
the schedule) on a Linear and a LayerNorm over 6 micro-steps that
cross the warm-up and a decay step: parameters within 1e-6 (float32
rounding of two formulas of the decoupled decay), learning rates within
1e-6 relative (optax's schedule runs in float32).

The port's `train_detector` runs beside the JAX package's own
`train_detector` on the tiny detector (`torch_port_common.tiny_detector`),
2 epochs of 2 steps over 4 frames of 32 x 64 on disk, `accumulate_steps=2`,
a `grad_clip` that triggers, DropPath 0, through a pipeline that draws from
Python's `random` without resizing (PanoStretch, RollAug, RandomFlip).  In
this test only, for time: JAX's `runtime.train.jit_train_step` compiles
through `quick_jit` on one CPU device; the detector's `init`, whose values
`load_from` replaces, hands back the tiny detector's variables instead of
running eagerly; and orbax's save is an empty `epoch_{n}` directory under
the name the loop gives it.  JAX's `load_weights`, which the JAX loop calls
without the model's config, is handed the tiny backbone's depths and
window.  The port's `step_randomness` hands each step the sampler noise
that the JAX step draws (`jax_sampler_noise` on the key that the JAX step
folds in).  Both start from one reference `.pth` (`load_from`).  Tolerances: losses
and gradient norms 1e-4 relative (the first update, at lr 1e-5, moves
entries of an undetermined sign apart by 2e-5); learning rates equal in float32; the
parameters after the two updates within 1e-5 + 1e-3 * max|p - p0| of each
tensor's update where optax's first moment is firm (above 1e-3 * its max:
Adam's step there has a determined sign; not in the two stem biases whose
true gradient is zero), and within twice the summed learning rates
everywhere; the keys of every `train.log.json` line and the
work directory's names equal.

The port alone: a run resumed from `epoch_1` is bit for bit the
uninterrupted run (DropPath 0.2, PanoStretch, accumulation, clipping);
`use_checkpoint` gives bit-equal gradients at DropPath 0.2 with an explicit
generator, plain and fused attention; the CLI hands `train_detector` what
the JAX CLI hands it.
"""

import functools
import json
import logging
import os
import random
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from panoswintransformerobjectdetection_tpu.apis import inference as jinference
from panoswintransformerobjectdetection_tpu.apis import train as japi
from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.runtime import checkpoint as jck
from panoswintransformerobjectdetection_tpu.runtime import hooks as jhooks
from panoswintransformerobjectdetection_tpu.runtime import optim as joptim
from panoswintransformerobjectdetection_tpu.runtime import train as jtrain
from panoswintransformerobjectdetection_torch.apis import train as tapi
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.models import panoswin as tpanoswin
from panoswintransformerobjectdetection_torch.models.detectors import PanoFasterRCNN
from panoswintransformerobjectdetection_torch.runtime import checkpoint as tck
from panoswintransformerobjectdetection_torch.runtime import hooks as thooks
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables
from panoswintransformerobjectdetection_torch.tools import train as train_cli
from torch_port_common import (TINY_TRAIN_CFG, Recorder, adam_mu,  # noqa: F401
                               jax_step_noise, jax_train_cli, quick_jit_train_step,
                               single_torch_thread, tiny_detector, to_numpy, write_coco_set)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, MAX_GT = 32, 64, 8
LOOP = {"total_epochs": 2, "batch_size": 2, "base_lr": 1e-2, "warmup_iters": 1,
        "decay_epochs": (0.5,), "grad_clip": 0.5, "accumulate_steps": 2, "max_gt": MAX_GT,
        "log_interval": 1, "num_workers": 0, "seed": 0}
PIPELINE = [{"type": "LoadImageFromFile"}, {"type": "LoadAnnotations", "with_bbox": True},
            {"type": "PanoStretch", "chance": 1.0, "kxy": (1.5, 1.5)},
            {"type": "RollAug", "chance": 1.0}, {"type": "RandomFlip", "flip_ratio": 0.5},
            {"type": "Normalize", "mean": [123.675, 116.28, 103.53],
             "std": [58.395, 57.12, 57.375], "to_rgb": True},
            {"type": "Pad", "size_divisor": 32}, {"type": "PanoCheck"}]
# The biases of the stem's two convs before a BatchNorm: their true gradient
# is zero (the normalisation removes a bias), so each framework's is its own
# rounding noise, and Adam's step there has no determined sign.
ZERO_GRADIENT = ("backbone.patch_embed.proj.0.bias", "backbone.patch_embed.proj.3.bias")
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc", "loss", "grad_norm")


def _port_model(**backbone):
    cfg = flagship_config(tiny=True)
    cfg["backbone"].update(backbone)
    return PanoFasterRCNN(**cfg, train_cfg=TINY_TRAIN_CFG)


def _dataset(builder, ann_file, img_dir):
    return builder.build_dataset({"type": "StreetDataset", "ann_file": ann_file,
                                  "img_prefix": img_dir, "pipeline": PIPELINE})


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    return write_coco_set(str(tmp_path_factory.mktemp("frames")), 4, H, W, seed=9,
                          crowd=False)


@pytest.fixture(scope="module")
def bfov_frames(tmp_path_factory):
    return write_coco_set(str(tmp_path_factory.mktemp("bfov")), 4, H, W, seed=8, crowd=False,
                          classes=tuple(f"c{i}" for i in range(37)), bfov=True)


@pytest.fixture(scope="module")
def reference_pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("pth") / "tiny.pth")
    torch.save({"state_dict": tiny_detector()["state_dict"]}, path)
    return path


@pytest.fixture(scope="module")
def loops(frames, reference_pth, tmp_path_factory):
    """The JAX loop and the port's, on the same frames, draws and weights."""
    td = tiny_detector()
    det, variables = td["det"], td["variables"]
    tiny_model = {"model": {"backbone": {"type": "PanoSwinTransformer", "depths": (2, 2, 2, 2),
                                         "window_size": 4}}}
    sched = joptim.warmup_step_schedule(LOOP["base_lr"], LOOP["warmup_iters"],
                                        decay_steps=(1,))
    out = {}
    devices = jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "jit_train_step", quick_jit_train_step)
        mp.setattr(jinference, "load_weights",
                   functools.partial(jinference.load_weights, config=tiny_model))
        mp.setattr(type(det), "init", lambda self, *args, **kw: variables)
        mp.setattr(jax, "devices", lambda *args: devices(*args)[:1])
        mp.setattr(jck, "save_checkpoint", lambda path, state: os.makedirs(path))
        rec, evals = Recorder(), []
        work_dir = str(tmp_path_factory.mktemp("jax_loop"))
        random.seed(21)
        state = japi.train_detector(
            det, _dataset(jb, *frames), work_dir=work_dir, load_from=reference_pth,
            hooks=[jhooks.LrRecordHook(sched), rec],
            eval_fn=lambda s: evals.append(int(s.step)) or {"bbox_mAP": 0.5}, **LOOP)
        out["jax"] = {"rec": rec, "evals": evals, "work_dir": work_dir, "state": state}

        port = _port_model()
        mp.setattr(tapi, "step_randomness", functools.partial(jax_step_noise, det, variables))
        rec, evals = Recorder(), []
        work_dir = str(tmp_path_factory.mktemp("port_loop"))
        random.seed(21)
        tapi.train_detector(
            port, _dataset(tb, *frames), work_dir=work_dir, load_from=reference_pth,
            hooks=[thooks.LrRecordHook(toptim.warmup_step_schedule(
                LOOP["base_lr"], LOOP["warmup_iters"], decay_steps=(1,))), rec],
            eval_fn=lambda m: evals.append(m.training) or {"bbox_mAP": 0.5}, device="cpu",
            **LOOP)
        out["port"] = {"rec": rec, "evals": evals, "work_dir": work_dir, "model": port}
    return out


@pytest.mark.parametrize("key", LOSSES + ("lr", "step"))
def test_loop_steps_match_jax(loops, key):
    got, want = loops["port"]["rec"].steps, loops["jax"]["rec"].steps
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if key in ("lr", "step"):
            assert np.float32(g[key]) == np.float32(w[key])
        else:
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4)
    if key == "grad_norm":       # the clip triggers on every micro-step
        assert min(w[key] for w in want) > LOOP["grad_clip"]


def test_loop_hooks_and_evals_match_jax(loops):
    assert loops["port"]["rec"].calls == loops["jax"]["rec"].calls
    assert loops["jax"]["evals"] == [2, 4] and loops["port"]["evals"] == [False, False]
    assert loops["port"]["model"].training


def test_loop_logs_and_checkpoints_match_jax(loops):
    def lines(work_dir):
        with open(os.path.join(work_dir, "train.log.json")) as f:
            return [json.loads(line) for line in f]

    got, want = lines(loops["port"]["work_dir"]), lines(loops["jax"]["work_dir"])
    assert [set(g) for g in got] == [set(w) for w in want] and len(got) == 6
    assert [g["epoch"] for g in got] == [w["epoch"] for w in want]
    assert sorted(os.listdir(loops["port"]["work_dir"])) == \
        sorted(os.listdir(loops["jax"]["work_dir"])) == \
        ["epoch_1", "epoch_2", "latest", "train.log", "train.log.json"]
    latest = os.path.join(loops["port"]["work_dir"], "latest")
    assert os.path.realpath(latest).endswith("epoch_2")
    with open(os.path.join(loops["port"]["work_dir"], "train.log")) as f:
        text = f.read()
    assert "Epoch [2][2/2]" in text and "Eval epoch 2" in text and "load_from" in text


def test_loop_parameters_match_jax(loops):
    state = loops["jax"]["state"]
    stats = to_numpy(state.batch_stats)
    want = from_jax_variables(to_numpy(state.params), stats)
    mu = from_jax_variables(to_numpy(adam_mu(state.opt_state)), stats)
    before = tiny_detector()["state_dict"]
    got = loops["port"]["model"].state_dict()
    lr_sum = LOOP["base_lr"] * (1e-3 + 1e-1)
    firm_entries = 0
    for name, v in got.items():
        if "num_batches" in name:
            continue
        g, w, p0 = v.numpy(), want[name].numpy(), before[name].numpy()
        if "running" in name:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)
            continue
        np.testing.assert_allclose(g, w, atol=2 * lr_sum + 1e-6, err_msg=name)
        if name in ZERO_GRADIENT:
            continue
        m = np.abs(mu[name].numpy())
        firm = m > 1e-3 * m.max()
        firm_entries += int(firm.sum())
        np.testing.assert_allclose(g[firm], w[firm], err_msg=name,
                                   atol=1e-5 + 1e-3 * float(np.abs(w - p0).max()))
    assert firm_entries > 0.5 * sum(v.numel() for v in got.values())


class _Small(torch.nn.Module):
    """A Linear (decayed weight, bias not) and a LayerNorm (not decayed)."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(5, 4)
        self.norm = torch.nn.LayerNorm(4)


def test_make_optimizer_matches_optax_chain():
    """Clipping (it triggers) and accumulation over 6 micro-steps: warm-up at
    update 1, a decay from update 2 on; the port's parameters and learning
    rate after every micro-step against the JAX package's `make_optimizer`
    (optax) on the same gradients."""
    model = _Small()
    params = {"fc": {"kernel": jnp.asarray(model.fc.weight.detach().numpy().T),
                     "bias": jnp.asarray(model.fc.bias.detach().numpy())},
              "norm": {"scale": jnp.ones(4), "bias": jnp.zeros(4)}}
    kw = {"base_lr": 1e-2, "warmup_iters": 1, "decay_steps": (1,), "grad_clip": 1.0,
          "accumulate_steps": 2}
    optimizer, scheduler = toptim.make_optimizer(model, **kw)
    tx = joptim.make_optimizer(params, **kw)
    update = jax.jit(tx.update)
    opt_state = tx.init(params)
    sched = joptim.warmup_step_schedule(1e-2, 1, decay_steps=(1,))
    rng = np.random.default_rng(0)
    before = model.fc.weight.detach().clone()
    for i in range(6):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
                             params)
        assert optax.global_norm(grads) > kw["grad_clip"]
        model.fc.weight.grad = torch.tensor(np.asarray(grads["fc"]["kernel"]).T)
        model.fc.bias.grad = torch.tensor(np.asarray(grads["fc"]["bias"]))
        model.norm.weight.grad = torch.tensor(np.asarray(grads["norm"]["scale"]))
        model.norm.bias.grad = torch.tensor(np.asarray(grads["norm"]["bias"]))
        updated = optimizer.step()
        if updated:
            scheduler.step()
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        assert updated == (i % 2 == 1)
        # optax's schedule runs in float32, the port's in Python's float
        assert scheduler.get_last_lr()[0] == pytest.approx(float(sched((i + 1) // 2)), rel=1e-6)
        with torch.no_grad():
            for got, want in ((model.fc.weight, params["fc"]["kernel"].T),
                              (model.fc.bias, params["fc"]["bias"]),
                              (model.norm.weight, params["norm"]["scale"]),
                              (model.norm.bias, params["norm"]["bias"])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)
        moved = not torch.equal(model.fc.weight.detach(), before)
        assert moved == (i >= 1)


def _resumable_run(frames, work_dir, resume_from=None):
    model = _port_model(drop_path_rate=0.2)
    random.seed(5)
    tapi.train_detector(model, _dataset(tb, *frames), work_dir=work_dir, device="cpu",
                        resume_from=resume_from, **dict(LOOP, base_lr=1e-3))
    with open(os.path.join(work_dir, "train.log.json")) as f:
        lines = [json.loads(line) for line in f]
    return model, [{k: v for k, v in line.items() if k != "time"} for line in lines]


def test_resume_from_epoch_1_is_bit_exact(frames, tmp_path):
    """The port's own draws (DropPath 0.2, sampler, pipeline, shuffle): the
    second epoch of a run resumed from `epoch_1` equals the uninterrupted
    run's, bit for bit: losses, parameters, statistics, optimizer state."""
    whole, whole_lines = _resumable_run(frames, str(tmp_path / "whole"))
    ckpt = str(tmp_path / "whole" / "epoch_1")
    resumed, resumed_lines = _resumable_run(frames, str(tmp_path / "resumed"), ckpt)
    assert resumed_lines == [line for line in whole_lines if line["epoch"] == 2]
    for (n, a), b in zip(whole.state_dict().items(), resumed.state_dict().values()):
        assert torch.equal(a, b), n
    opt = [torch.load(str(tmp_path / d / "epoch_2"), weights_only=True)
           for d in ("whole", "resumed")]
    assert opt[0]["step"] == opt[1]["step"] == 4
    assert opt[0]["generators"] == opt[1]["generators"]
    for a, b in zip(opt[0]["optimizer"]["state"].values(), opt[1]["optimizer"]["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    differs = whole_lines[0]["loss"] != whole_lines[2]["loss"]
    assert differs


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_use_checkpoint_gradients_are_bit_equal(fused, monkeypatch):
    """One `forward_train` + backward with and without activation
    checkpointing: the same weights, batch, sampler generator and DropPath
    generator (rate 0.2, so masks are drawn): every gradient and the running
    statistics bit-equal; every window block went through `checkpoint`."""
    calls = []
    original = tpanoswin.checkpoint
    monkeypatch.setattr(tpanoswin, "checkpoint",
                        lambda *a, **k: calls.append(1) or original(*a, **k))
    rng = np.random.default_rng(2)
    batch = {"images": torch.from_numpy(rng.random((2, H, W, 3)).astype(np.float32)),
             "img_shapes": torch.tensor([[H, W]] * 2, dtype=torch.float32),
             "gt_boxes": torch.tensor([[[4., 2., 36., 30.], [20., 8., 60., 28.]]] * 2),
             "gt_labels": torch.tensor([[0, 3]] * 2), "gt_valid": torch.ones(2, 2, dtype=bool)}
    grads, stats = [], []
    for use_checkpoint in (False, True):
        model = _port_model(drop_path_rate=0.2, use_checkpoint=use_checkpoint,
                            fused_attention=fused).train()
        model.load_state_dict(tiny_detector()["state_dict"])
        model.backbone.set_drop_path_generator(torch.Generator().manual_seed(3))
        out = model.forward_train(**batch, generator=torch.Generator().manual_seed(4))
        sum(v for k, v in out.items() if "loss" in k).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
        stats.append({n: b for n, b in model.named_buffers() if "running" in n})
    assert len(calls) == sum(flagship_config(tiny=True)["backbone"]["depths"])
    for n, g in grads[0].items():
        assert torch.equal(g, grads[1][n]), n
    for n, b in stats[0].items():
        assert torch.equal(b, stats[1][n]), n
    assert any(g.abs().max() > 0 for n, g in grads[0].items() if "blocks" in n)


@pytest.mark.parametrize("config", ["faster_rcnn_panoswin_tiny_bf16_streetwin.py",
                                    "faster_rcnn_panoswin_tiny_indoor360.py"])
def test_train_cli_hands_train_detector_what_jax_does(config, frames, bfov_frames, monkeypatch,
                                                     tmp_path):
    """Both CLIs on one config (its data pointed at a synthetic set): the
    same arguments to `train_detector`, the port's on the CPU."""
    path = os.path.join(ROOT, "configs", "panoswin", config)
    frames = bfov_frames if "indoor360" in config else frames
    options = ["--cfg-options", *(f"data.{split}.{k}={v}" for split in ("train", "val")
                                  for k, v in (("ann_file", frames[0]),
                                               ("img_prefix", frames[1])))]
    captured = {}
    monkeypatch.setattr(japi, "train_detector", lambda det, ds, **kw: captured.update(jax=(ds, kw)))
    monkeypatch.setattr(tapi, "train_detector",
                        lambda m, ds, **kw: captured.update(port=(m, ds, kw)))
    monkeypatch.setattr(sys, "argv", ["train.py", path, "--work-dir", str(tmp_path), "--seed", "3",
                                      *options])
    jax_train_cli().main()
    train_cli.main([path, "--work-dir", str(tmp_path), "--seed", "3", "--device", "cpu",
                    *options])
    jax_ds, jax_kw = captured["jax"]
    model, ds, kw = captured["port"]
    assert kw.pop("device") == torch.device("cpu")
    assert callable(kw.pop("eval_fn")) and callable(jax_kw.pop("eval_fn"))
    assert kw == jax_kw and len(ds) == len(jax_ds) and ds.CLASSES == jax_ds.CLASSES
    assert model.num_classes == len(ds.CLASSES) and len(ds) == 4
    assert kw["total_epochs"] in (12, 360)


def test_train_cli_refuses_what_jax_refuses(frames, tmp_path, caplog, monkeypatch):
    path = os.path.join(ROOT, "configs", "panoswin",
                        "faster_rcnn_panoswin_tiny_patch4_window7_streetwin.py")
    with pytest.raises(ValueError, match=r"runner.max_epochs \(360\) != total_epochs \(5\)"):
        train_cli.main([path, "--device", "cpu", "--cfg-options", "total_epochs=5",
                        *(f"data.{split}.{k}={v}" for split in ("train", "val")
                          for k, v in (("ann_file", frames[0]), ("img_prefix", frames[1])))])
    # JAX's `--launcher jax` is not the port's; `pytorch` needs torchrun's environment
    with pytest.raises(SystemExit):
        train_cli.main([path, "--launcher", "jax", "--device", "cpu"])
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        train_cli.main([path, "--launcher", "pytorch", "--device", "cpu"])
    model, ds = _port_model(), _dataset(tb, *frames)
    ds.CLASSES = ds.CLASSES + ("extra",)
    for hook, logger in ((thooks.NumClassCheckHook(), "panoswin_torch"),
                         (jhooks.NumClassCheckHook(), "panoswin_tpu")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            hook.before_train({"model": model, "dataset": ds})
        assert "num_classes (5) != len(dataset.CLASSES) (6)" in caplog.text


def test_pretrained_backbone_loads_like_the_converter(tmp_path):
    """A backbone checkpoint of window 7 (a classifier's: head and last norm,
    no out-norms, no encoder) into the tiny backbone of window 4: tables
    resized, out-norms and encoder kept, the head left out; a missing block
    key raises; other backbones name item 17."""
    src = _port_model(window_size=7).backbone.state_dict()
    sd = {k: torch.randn(v.shape) if v.is_floating_point() else v for k, v in src.items()
          if not k.startswith(("norm", "abs_encoder"))}
    sd["head.weight"] = torch.zeros(3)
    path = str(tmp_path / "backbone.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    model = _port_model()
    keep = {k: v.clone() for k, v in model.backbone.state_dict().items()
            if k.startswith(("norm", "abs_encoder"))}
    tapi.apply_init_weights(model, pretrained=path)
    got = model.backbone.state_dict()
    assert all(torch.equal(got[k], v) for k, v in keep.items())
    key = "layers.0.blocks.0.attn.sphere_position_alpha_table_Te"
    assert torch.equal(got[key], tck.resize_bias_table(sd[key], 7, 4))
    fc1 = "layers.1.blocks.1.mlp.fc1.weight"
    assert torch.equal(got[fc1], sd[fc1])
    del sd["layers.1.blocks.1.mlp.fc1.weight"]
    with pytest.raises(KeyError, match="layers.1.blocks.1.mlp.fc1.weight"):
        tck.load_backbone_weights(model.backbone, sd)
    model.backbone = torch.nn.Identity()
    with pytest.raises(NotImplementedError, match="Identity.*item 17"):
        tapi.apply_init_weights(model, pretrained=path)


def test_hooks_and_seed_match_jax():
    sched = toptim.warmup_step_schedule(1e-2, 3, decay_steps=(5,))
    jsched = joptim.warmup_step_schedule(1e-2, 3, decay_steps=(5,))
    for step in (0, 2, 3, 6):
        got, want = {"step": step, "metrics": {}}, {"step": step, "metrics": {}}
        thooks.LrRecordHook(sched).after_iter(got)
        jhooks.LrRecordHook(jsched).after_iter(want)
        assert got["metrics"]["lr"] == pytest.approx(want["metrics"]["lr"], rel=1e-6)
    ctx = {"step": 4, "model": _port_model()}
    thooks.EmptyCacheHook(interval=2).after_iter(ctx)
    assert "logs" not in ctx                     # on the CPU there is no cache to empty
    gen = tapi.set_random_seed(7)
    a = (random.random(), np.random.random(), torch.rand(1), torch.rand(1, generator=gen))
    japi.set_random_seed(7)
    assert (random.random(), np.random.random()) == a[:2]
    gen = tapi.set_random_seed(7)
    assert torch.equal(torch.rand(1), a[2]) and torch.equal(torch.rand(1, generator=gen), a[3])
