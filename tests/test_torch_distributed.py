"""The PyTorch port's data parallelism against the JAX package's global-batch
step: two processes over gloo on the CPU.

Two workers (`torch_distributed_worker.py`, torch and the port, never JAX)
are started once for the module, with torchrun's environment, and run
every case on their rows of the global batches written here; this process
computes the references meanwhile (JAX's, and the port's in one process)
and each test reads the workers' outputs.  The JAX package's data-mesh
step is one step on the global batch, so a run of W processes, each
holding `batch // W` images, must take the steps one process takes on the
whole batch: every loss normaliser and live BatchNorm's statistics the
global batch's, the gradient the sum.

Tolerances.  Live BatchNorm against flax's `BatchNorm` on the whole batch:
float32 output, gradients and statistics within 1e-5 * max|ref| (+1e-6),
float64 within 1e-12 * max|ref| (sums in another order).  The tiny
flagship's two steps, against JAX's `make_train_step` on both images with
JAX's sampler noise and against the port's two steps in one process: the
first step's outputs within 1e-5 relative (`test_torch_train.py`'s
tolerance), the second's within 1e-4; after both, parameters within 2e-4
(`test_torch_train.py`'s) where each step's JAX gradient and Adam's first
moment after the second (0.9 g1 + g2, up to a factor) are above 1e-5 +
1e-3 * max|.|, running variances within 1e-5 and running means within
1e-5 + momentum * 2 lr.  The second step is looser because Adam's first
update is lr times the gradient's sign: an entry whose gradient is
rounding noise (the bias of a conv before a BatchNorm, whose true gradient
is zero) lands 2 lr apart in any two runs that sum in another order, and
that bias moves the BatchNorm's next batch mean; the one-process port's
second step is 6.3e-5 relative from JAX's (measured).  The tiny Mask
R-CNN at W = 2 against the port at W = 1 on the same two images: losses
1e-5 relative, gradients 1e-5 + 1e-3 * max|g|, parameters after the step
2e-4 where the gradient is firm.  The sharded roll and the evaluation are
exact.
"""

import os
import pickle
import socket
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_tpu.runtime.optim import make_optimizer as jmake_optimizer
from panoswintransformerobjectdetection_tpu.runtime.train import TrainState, make_train_step
from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
from panoswintransformerobjectdetection_torch.apis.test import multi_host_test, single_device_test
from panoswintransformerobjectdetection_torch.apis.train import step_randomness
from panoswintransformerobjectdetection_torch.data.builder import build_dataset
from panoswintransformerobjectdetection_torch.data.loader import DetDataLoader
from panoswintransformerobjectdetection_torch.flagship import (build_flagship, flagship_config,
                                                               init_weights)
from panoswintransformerobjectdetection_torch.models.detectors import PanoFasterRCNN
from panoswintransformerobjectdetection_torch.parallel import dist as pdist
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime import train as ttrain
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables
from torch_port_common import (STREET_CLASSES, TINY_MASK_RCNN, TINY_TRAIN_CFG,  # noqa: F401
                               jax_step_noise, quick_jit_train_step, recording,
                               single_torch_thread, tiny_detector, to_numpy, write_coco_set)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_distributed_worker.py")
WORLD = 2
LR = 1e-2
SEED = 0
FLAGSHIP_STEPS = 2
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc")
TRAIN_PIPELINE = [{"type": "LoadImageFromFile"}, {"type": "LoadAnnotations", "with_bbox": True},
                  {"type": "Resize", "img_scale": (32, 1333), "keep_ratio": True},
                  {"type": "Normalize", "mean": [123.675, 116.28, 103.53],
                   "std": [58.395, 57.12, 57.375], "to_rgb": True},
                  {"type": "Pad", "size_divisor": 32}]
TEST_PIPELINE = [TRAIN_PIPELINE[0]] + TRAIN_PIPELINE[2:]
LOOP = {"total_epochs": 2, "batch_size": 2, "base_lr": LR, "warmup_iters": 0,
        "decay_epochs": (1,), "log_interval": 1, "num_workers": 0, "pad_to": (32, 64),
        "seed": SEED, "max_gt": 8}
TEST_CFG = {"rpn": {"nms_pre": 256, "max_per_img": 64, "iou_threshold": 0.7, "min_bbox_size": 0},
            "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 32}}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _batch_norm_inputs():
    rng = np.random.default_rng(5)
    cases = {}
    for name, dtype in (("float32", np.float32), ("float64", np.float64)):
        C = 6
        cases[name] = {
            "x": (rng.standard_normal((4, C, 5, 7)) * 2 + 0.5).astype(dtype),
            "g": rng.standard_normal((4, C, 5, 7)).astype(dtype),
            "weight": rng.uniform(0.5, 1.5, C).astype(dtype),
            "bias": (rng.standard_normal(C) * 0.1).astype(dtype),
            "running_mean": (rng.standard_normal(C) * 0.1).astype(dtype),
            "running_var": rng.uniform(0.5, 2.0, C).astype(dtype),
            "eps": 1e-5, "momentum": 0.1}
    return cases


def _flax_batch_norm(case):
    """flax's train-mode `BatchNorm` on the whole batch (NHWC): output,
    gradients of x, scale and bias for the cotangent `g`, statistics."""
    f64 = case["x"].dtype == np.float64
    with jax.enable_x64(f64):
        dt = jnp.float64 if f64 else jnp.float32
        bn = fnn.BatchNorm(use_running_average=False, momentum=1 - case["momentum"],
                           epsilon=case["eps"], dtype=dt, param_dtype=dt)
        stats = {"mean": jnp.asarray(case["running_mean"]), "var": jnp.asarray(case["running_var"])}
        params = {"scale": jnp.asarray(case["weight"]), "bias": jnp.asarray(case["bias"])}

        def run(p, x):
            y, upd = bn.apply({"params": p, "batch_stats": stats}, x, mutable=["batch_stats"])
            return y, upd["batch_stats"]

        x = jnp.asarray(case["x"].transpose(0, 2, 3, 1))
        y, pull, new = jax.vjp(run, params, x, has_aux=True)
        dp, dx = pull(jnp.asarray(case["g"].transpose(0, 2, 3, 1)))
        return {"y": np.asarray(y).transpose(0, 3, 1, 2), "dx": np.asarray(dx).transpose(0, 3, 1, 2),
                "dweight": np.asarray(dp["scale"]), "dbias": np.asarray(dp["bias"]),
                "running_mean": np.asarray(new["mean"]), "running_var": np.asarray(new["var"])}


def _flagship_batch():
    """Two frames of 32 x 64 with 2 and 3 ground-truth boxes."""
    rng = np.random.default_rng(11)
    return {"images": rng.random((2, 32, 64, 3)).astype(np.float32),
            "img_shapes": np.array([[32, 64]] * 2, np.float32),
            "gt_boxes": np.array([[[4, 2, 36, 30], [20, 8, 60, 28], [0, 0, 0, 0]],
                                  [[10, 4, 30, 24], [34, 6, 62, 30], [2, 12, 26, 30]]],
                                 np.float32),
            "gt_labels": np.array([[0, 3, 0], [1, 4, 2]], np.int32),
            "gt_valid": np.array([[True, True, False], [True, True, True]])}


def _mask_batch():
    """Two frames of 64 x 64: three large boxes in the first, one small box in
    the second (so their positive RoIs differ in number), with box masks."""
    rng = np.random.default_rng(12)
    boxes = np.array([[[2, 2, 40, 36], [20, 16, 62, 60], [6, 30, 44, 62]],
                      [[40, 6, 52, 16], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[True, True, True], [True, False, False]])
    masks = np.zeros((2, 3, 64, 64), np.uint8)
    for b in range(2):
        for g in range(3):
            if valid[b, g]:
                x1, y1, x2, y2 = boxes[b, g].astype(int)
                masks[b, g, y1:y2, x1 + 2:x2 - 2] = 1
    return {"images": rng.standard_normal((2, 64, 64, 3)).astype(np.float32),
            "img_shapes": np.array([[64, 64]] * 2, np.float32), "gt_boxes": boxes,
            "gt_labels": np.array([[0, 3, 0], [2, 0, 0]], np.int32), "gt_valid": valid,
            "gt_masks": masks}


def _write_cli_config(path, ann_file, img_dir):
    model = dict(flagship_config(tiny=True), type="PanoFasterRCNN", test_cfg=TEST_CFG)
    model["backbone"] = dict(model["backbone"], type="PanoSwinTransformer")
    model["neck"] = dict(model["neck"], type="FPN")
    split = lambda pipeline, **kw: dict(type="StreetDataset", ann_file=ann_file,  # noqa: E731
                                        img_prefix=img_dir, pipeline=pipeline, **kw)
    with open(path, "w") as f:
        f.write(f"classes = {STREET_CLASSES!r}\nmodel = {model!r}\n")
        f.write(f"data = {dict(samples_per_gpu=1, workers_per_gpu=0, train=split(TRAIN_PIPELINE), val=split(TEST_PIPELINE, test_mode=True), test=split(TEST_PIPELINE, test_mode=True))!r}\n")  # noqa: E501
        f.write("runner = dict(max_epochs=1)\noptimizer = dict(lr=0.001, weight_decay=0.05)\n"
                "lr_config = dict(warmup_iters=0, step=[1])\nlog_config = dict(interval=1)\n"
                "checkpoint_config = dict(interval=1)\n")
    return path


def _inputs(root):
    td = tiny_detector()
    port = PanoFasterRCNN(**flagship_config(tiny=True), train_cfg=TINY_TRAIN_CFG)
    batch = _flagship_batch()
    noise = [jax_step_noise(td["det"], td["variables"], port, SEED, s, batch)["noise"]
             for s in range(FLAGSHIP_STEPS)]
    train_ann, train_imgs = write_coco_set(os.path.join(root, "train_set"), 4, 32, 64, seed=31,
                                           crowd=False)
    test_ann, test_imgs = write_coco_set(os.path.join(root, "test_set"), 5, 32, 64, seed=32,
                                         crowd=False)
    train_ds = {"type": "StreetDataset", "ann_file": train_ann, "img_prefix": train_imgs,
                "pipeline": TRAIN_PIPELINE}
    test_ds = {"type": "StreetDataset", "ann_file": test_ann, "img_prefix": test_imgs,
               "pipeline": TEST_PIPELINE, "test_mode": True}
    return {
        "batch_norm": _batch_norm_inputs(),
        "roll": {"x": np.arange(2 * 4 * 64 * 3, dtype=np.float32).reshape(2, 4, 64, 3),
                 "shifts": (1, 3, 8)},
        "flagship": {"state_dict": td["state_dict"], "batch": batch, "noise": noise, "lr": LR,
                     "train_cfg": TINY_TRAIN_CFG},
        "mask": {"cfg": TINY_MASK_RCNN, "seed": 5, "batch": _mask_batch()},
        "loops": {"root": os.path.join(root, "loops"), "dataset": train_ds, "loop": LOOP,
                  "drop_path_rate": 0.2},
        "multi_host": {"dataset": test_ds, "seed": 3},
        "cli": {"root": os.path.join(root, "cli"), "pad_to": (32, 64), "options": [],
                "config": _write_cli_config(os.path.join(root, "cli.py"), train_ann,
                                            train_imgs)},
    }


def _jax_flagship_steps(inputs):
    """JAX's `make_train_step` twice on both images, with the noise handed to
    the workers (its optimizer recording each step's gradients)."""
    td = tiny_detector()
    det, variables = td["det"], td["variables"]
    tx = recording(jmake_optimizer(variables["params"], base_lr=LR, warmup_iters=0))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]), tx=tx)
    run = quick_jit_train_step(make_train_step(det), None)
    batch = jax.tree.map(jnp.asarray, inputs["flagship"]["batch"])
    metrics, grads = [], []
    for _ in range(FLAGSHIP_STEPS):
        state, m = run(state, batch, jax.random.PRNGKey(SEED + 1))
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append(from_jax_variables(to_numpy(state.opt_state[1]),
                                        to_numpy(state.batch_stats)))
    return {"metrics": metrics, "grads": grads,
            "after": from_jax_variables(to_numpy(state.params), to_numpy(state.batch_stats))}


def _port_flagship_steps(inputs):
    """The same two steps in one process, on both images."""
    model = PanoFasterRCNN(**flagship_config(tiny=True), train_cfg=TINY_TRAIN_CFG).train()
    model.load_state_dict(inputs["flagship"]["state_dict"])
    optimizer, scheduler = toptim.make_optimizer(model, base_lr=LR, warmup_iters=0)
    step = ttrain.make_train_step(model, optimizer, scheduler)
    batch = {k: torch.from_numpy(v) for k, v in inputs["flagship"]["batch"].items()}
    metrics = [{k: float(v) for k, v in step(batch, noise=noise).items()}
               for noise in inputs["flagship"]["noise"]]
    return {"metrics": metrics, "state": model.state_dict()}


def _port_mask_step(inputs):
    model = build_detector_from_cfg({"model": inputs["mask"]["cfg"]})
    init_weights(model, inputs["mask"]["seed"])
    model.train()
    optimizer, scheduler = toptim.make_optimizer(model, base_lr=1e-2, warmup_iters=0)
    batch = {k: torch.from_numpy(v) for k, v in inputs["mask"]["batch"].items()}
    metrics = ttrain.make_train_step(model, optimizer, scheduler)(
        batch, generator=torch.Generator().manual_seed(7))
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: None if p.grad is None else p.grad.clone()
                      for n, p in model.named_parameters()},
            "state": model.state_dict()}


def _port_accumulated_loop(inputs):
    """One process's steps on the workers' global batches (each shard's
    batch of 1, the shards side by side) for `train_detector`'s one epoch
    with `accumulate_steps=2`: its weights, schedule, randomness and step."""
    loop = inputs["loops"]["loop"]
    model = build_flagship(tiny=True, device="cpu", train=True,
                           drop_path_rate=inputs["loops"]["drop_path_rate"])
    init_weights(model, loop["seed"])
    model.train()
    ds = build_dataset(dict(inputs["loops"]["dataset"]))
    shards = [DetDataLoader(ds, batch_size=loop["batch_size"] // WORLD, max_gt=loop["max_gt"],
                            seed=loop["seed"], num_shards=WORLD, shard_id=k,
                            pad_to=loop["pad_to"]) for k in range(WORLD)]
    steps_per_epoch = len(shards[0])
    optimizer, scheduler = toptim.make_optimizer(
        model, base_lr=loop["base_lr"], warmup_iters=loop["warmup_iters"],
        decay_steps=tuple(int(e * steps_per_epoch) for e in loop["decay_epochs"]),
        accumulate_steps=2)
    step_fn = ttrain.make_train_step(model, optimizer, scheduler)
    for step, parts in enumerate(zip(*shards)):
        batch = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        tensors = {k: torch.from_numpy(batch[k]) for k in
                   ("images", "img_shapes", "gt_boxes", "gt_labels", "gt_valid")}
        step_fn(tensors, **step_randomness(model, loop["seed"], step, batch))
    return {"state": model.state_dict(),
            "grads": {n: p.grad for n, p in model.named_parameters() if p.grad is not None},
            "steps": steps_per_epoch}


def _single(inputs):
    model = build_flagship(tiny=True, device="cpu", seed=inputs["multi_host"]["seed"])
    ds = build_dataset(dict(inputs["multi_host"]["dataset"]))
    return {"single": single_device_test(model, ds, device="cpu"),
            "w1": multi_host_test(model, ds, device="cpu")}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_distributed"))
    inputs = _inputs(root)
    path = os.path.join(root, "inputs.pkl")
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    port = _free_port()
    procs = []
    for r in range(WORLD):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(WORLD), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs.append(subprocess.Popen([sys.executable, WORKER, path, root], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    try:
        refs = {"jax_flagship": _jax_flagship_steps(inputs),
                "port_flagship": _port_flagship_steps(inputs),
                "batch_norm": {k: _flax_batch_norm(v) for k, v in inputs["batch_norm"].items()},
                "mask": _port_mask_step(inputs), "accumulated": _port_accumulated_loop(inputs),
                "eval": _single(inputs)}
        outs = [p.communicate(timeout=240)[0] for p in procs]
    except BaseException:
        for p in procs:
            p.kill()
        outs = [p.communicate()[0] or "" for p in procs]
        pytest.fail("distributed workers failed or timed out:\n" +
                    "\n----\n".join(o[-3000:] for o in outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, f"worker {r}:\n{out[-4000:]}"
    ranks = [torch.load(os.path.join(root, f"rank{r}.pt"), weights_only=False)
             for r in range(WORLD)]
    return {"inputs": inputs, "ranks": ranks, "root": root, **refs}


def _within(got, ref, rel, abs_=0.0, name=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=abs_ + rel * float(np.abs(ref).max()),
                               err_msg=name)


def test_workers_joined_one_gloo_group(run):
    assert [(o["rank"], o["world"], o["backend"]) for o in run["ranks"]] == \
        [(0, WORLD, "gloo"), (1, WORLD, "gloo")]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_live_batch_norm_matches_flax_on_the_whole_batch(run, dtype):
    ref = run["batch_norm"][dtype]
    got = [o["batch_norm"][dtype] for o in run["ranks"]]
    rel, abs_ = (1e-5, 1e-6) if dtype == "float32" else (1e-12, 0.0)
    for key in ("y", "dx"):
        _within(torch.cat([g[key] for g in got]).numpy(), ref[key], rel, abs_, key)
    for key in ("dweight", "dbias", "running_mean", "running_var"):
        for g in got:
            _within(g[key].numpy(), ref[key], rel, abs_, key)
        assert torch.equal(got[0][key], got[1][key]), key
    assert got[0]["y"].dtype == getattr(torch, dtype)


@pytest.mark.parametrize("shift", [1, 3, 8])
def test_sharded_roll_is_np_roll(run, shift):
    x = run["inputs"]["roll"]["x"]
    got = torch.cat([o["roll"][shift] for o in run["ranks"]], dim=2).numpy()
    np.testing.assert_array_equal(got, np.roll(x, shift, axis=2))


def test_sharded_roll_refuses_a_shift_wider_than_the_shard():
    from panoswintransformerobjectdetection_torch.parallel.spatial import sharded_roll
    x = torch.zeros(1, 2, 4, 3)
    assert sharded_roll(x, 0) is x
    with pytest.raises(ValueError, match="shift <= 4"):
        sharded_roll(x, 5)


def test_drop_path_keeps_its_rows_of_the_global_draw(run):
    for r, o in enumerate(run["ranks"]):
        assert torch.equal(o["drop_path"]["got"], o["drop_path"]["global"][2 * r:2 * r + 2])


@pytest.mark.parametrize("step", range(FLAGSHIP_STEPS))
@pytest.mark.parametrize("name", LOSSES + ("loss", "grad_norm"))
def test_flagship_steps_match_jax_global_batch(run, name, step):
    ref = run["jax_flagship"]["metrics"][step][name]
    one = run["port_flagship"]["metrics"][step][name]
    for o in run["ranks"]:
        assert o["flagship"]["ddp"]
        got = o["flagship"]["metrics"][step][name]
        assert np.isfinite(got) and (name == "acc" or got > 0)
        for want in (one, ref):
            np.testing.assert_allclose(got, want, rtol=1e-5 if step == 0 else 1e-4,
                                       err_msg=name)


def test_flagship_parameters_after_two_steps_match_jax(run):
    ref, grads = run["jax_flagship"]["after"], run["jax_flagship"]["grads"]
    states = [o["flagship"]["state"] for o in run["ranks"]]
    for name, v in states[0].items():
        assert torch.equal(v, states[1][name]), name
        if "num_batches" in name:
            continue
        for r in (ref[name].numpy(), run["port_flagship"]["state"][name].numpy()):
            if "running" in name:
                spread = 0.1 * 2 * LR if "running_mean" in name else 0.0
                np.testing.assert_allclose(v.numpy(), r, rtol=1e-5, atol=1e-5 + spread,
                                           err_msg=name)
                continue
            g1, g2 = (g[name].numpy() for g in grads)
            firm = np.ones(r.shape, bool)
            for g in (g1, g2, 0.9 * g1 + g2):    # each step's gradient, Adam's moment
                firm &= np.abs(g) > 1e-5 + 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(v.numpy()[firm], r[firm], atol=2e-4, err_msg=name)


@pytest.mark.parametrize("name", LOSSES + ("loss_mask", "loss", "grad_norm"))
def test_mask_rcnn_step_matches_one_process(run, name):
    ref = run["mask"]["metrics"][name]
    for o in run["ranks"]:
        np.testing.assert_allclose(o["mask"]["metrics"][name], ref, rtol=1e-5, err_msg=name)


def test_mask_rcnn_gradients_and_parameters_match_one_process(run):
    ref = run["mask"]
    for o in run["ranks"]:
        assert set(o["mask"]["grads"]) == set(ref["grads"])
        for name, g in o["mask"]["grads"].items():
            r = ref["grads"][name]
            assert (g is None) == (r is None), name
            if r is None:
                continue
            r = r.numpy()
            np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 1e-3 * float(np.abs(r).max()),
                                       rtol=0, err_msg=name)
            firm = np.abs(r) > 1e-5 + 1e-3 * np.abs(r).max()
            np.testing.assert_allclose(o["mask"]["state"][name].numpy()[firm],
                                       ref["state"][name].numpy()[firm], atol=2e-4,
                                       err_msg=name)


def test_a_local_mask_normaliser_would_show(run):
    """The two images have different numbers of positive RoIs, so the mean of
    the two processes' losses over their own positives (plain DDP's loss) is
    not the one-process loss, and the global normaliser is."""
    positives = [o["mask"]["positives"] for o in run["ranks"]]
    assert positives[0] != positives[1] and min(positives) >= 1
    local = np.mean([o["mask"]["local_loss_mask"] for o in run["ranks"]])
    ref = run["mask"]["metrics"]["loss_mask"]
    assert abs(local - ref) > 100 * 1e-5 * abs(ref)


def test_gradient_scale_is_the_sum_not_plain_ddps_mean(run):
    """DDP's own hook averages: its gradient is the global one over W, which
    the port's summing hook is not."""
    ref = run["mask"]["grads"]
    for o in run["ranks"]:
        names = [n for n, r in ref.items() if r is not None and float(r.abs().max()) > 0]
        got = torch.cat([o["mask"]["grads"][n].flatten() for n in names])
        plain = torch.cat([o["mask"]["plain_ddp_grads"][n].flatten() for n in names])
        want = torch.cat([ref[n].flatten() for n in names])
        assert abs(float(got.norm() / want.norm()) - 1) < 1e-4
        assert abs(float(plain.norm() / want.norm()) - 1 / WORLD) < 1e-4


def test_train_detector_writes_on_rank_0_only(run):
    root = run["inputs"]["loops"]["root"]
    saves = [o["loops"]["full"]["saves"] for o in run["ranks"]]
    assert saves == [["epoch_1", "epoch_2"], []]
    full = os.path.join(root, "full")
    assert os.path.realpath(os.path.join(full, "latest")) == os.path.join(full, "epoch_2")
    with open(os.path.join(full, "train.log.json")) as f:
        lines = f.read().splitlines()
    # 4 frames, a global batch of 2: two steps an epoch, each logged once
    assert len(lines) == 4
    with open(os.path.join(full, "train.log")) as f:
        assert sum("Epoch [" in line for line in f) == 4


def test_train_detector_ranks_end_bit_identical(run):
    states = [o["loops"]["full"]["state"] for o in run["ranks"]]
    for name, v in states[0].items():
        assert torch.equal(v, states[1][name]), name


def test_resumed_run_ends_where_the_uninterrupted_one_does(run):
    for o in run["ranks"]:
        full, resumed = o["loops"]["full"]["state"], o["loops"]["resumed"]["state"]
        assert resumed.keys() == full.keys()
        for name, v in full.items():
            assert torch.equal(resumed[name], v), name
        assert o["loops"]["resumed"]["saves"] == (["epoch_2"] if o["rank"] == 0 else [])


def test_accumulated_steps_match_one_process_on_the_global_batches(run):
    ref = run["accumulated"]
    assert ref["steps"] == 2
    firm_entries = 0
    for o in run["ranks"]:
        got = o["loops"]["accumulated"]["state"]
        for name, r in ref["state"].items():
            if "num_batches" in name:
                assert torch.equal(got[name], r), name
            elif "running" in name:
                np.testing.assert_allclose(got[name].numpy(), r.numpy(), rtol=1e-5, atol=1e-5,
                                           err_msg=name)
            else:
                g = ref["grads"][name].numpy()
                firm = np.abs(g) > 1e-5 + 1e-3 * np.abs(g).max()
                firm_entries += int(firm.sum())
                np.testing.assert_allclose(got[name].numpy()[firm], r.numpy()[firm],
                                           atol=2e-4, err_msg=name)
    assert firm_entries > 0.5 * WORLD * sum(v.numel() for v in ref["grads"].values())


def _assert_same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == {"boxes", "scores", "labels"}
        for k in g:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_multi_host_test_equals_single_device_test(run):
    want = run["eval"]["single"]
    assert len(want) == 5 and sum(len(r["boxes"]) for r in want) > 0
    assert run["ranks"][1]["multi_host"] is None
    _assert_same_results(run["ranks"][0]["multi_host"], want)
    _assert_same_results(run["eval"]["w1"], want)


def test_clis_run_under_the_pytorch_launcher(run):
    cli = [o["cli"] for o in run["ranks"]]
    assert cli[1]["metrics"] is None and 0 <= cli[0]["metrics"]["bbox_mAP"] <= 1
    for name, v in cli[0]["state"].items():
        assert torch.equal(v, cli[1]["state"][name]), name
    with open(os.path.join(run["inputs"]["cli"]["root"], "cli_train", "train.log.json")) as f:
        lines = f.read().splitlines()
    # 4 frames at 1 a process: two steps, then rank 0's evaluation
    assert len(lines) == 3 and "bbox_mAP" in lines[-1]


def test_init_distributed_needs_torchrun(monkeypatch):
    for k in pdist.LAUNCH_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        pdist.init_distributed("pytorch", device="cpu")
    with pytest.raises(ValueError, match="launcher"):
        pdist.init_distributed("slurm", device="cpu")
    assert (pdist.world(), pdist.rank(), pdist.is_main()) == (1, 0, True)
    t = torch.ones(3, requires_grad=True)
    assert pdist.all_reduce_sum(t) is t and pdist.shard_rows(t, 3) is t
    assert pdist.all_gather_object({"a": 1}) == [{"a": 1}]
