"""ResNet-family training in the PyTorch port against the JAX package:
train-mode backbones (live and frozen BatchNorm, `frozen_stages`), R-18
Faster and Mask R-CNN training steps and loops, and the CNN `pretrained`
loaders with their converters.

Backbones (`torch_port_common.cnn_train_pair`): ResNet-18 (basic blocks),
ResNet-50 in pytorch and caffe style, ResNeXt-50 32x4d and RegNetX-400MF,
each in train mode with `norm_eval` True and False on 2 frames of 32 x 64,
in float64 on both sides.  Outputs, `jax.vjp` gradients for a seeded
cotangent, the running statistics against flax's `mutable=
["batch_stats"]`.  float64, because the float32 gradients of these random
networks are not determined to the detector tests' tolerance: the port in
float32 against itself in float64 differs by up to 96 times 1e-5 + 2e-3 *
max|g| on ResNet-50 with live BatchNorm at 64 x 128 (a ReLU gate whose
input lies within rounding of zero opens in one run only, a BatchNorm over
few samples amplifies the difference), and JAX against the port in float32
by as much.  In float64 they agree within 1e-6 of each gradient's largest
entry (`check_cnn_train_pair`).  `frozen_stages` 0-4 on ResNet-18 with
live BatchNorm: the port's frozen parameters get no gradient exactly where
JAX's are all zero, and the frozen stages' statistics move as JAX's do.

Detectors, float32 as they train: an R-18 Faster R-CNN (5 classes, FPN 16,
`norm_eval` True as the configs have it) takes one step of the JAX
package's `make_train_step` and of the port's on the same batch, weights
and sampler noise: the outputs within 1e-4 relative, every gradient within
1e-5 + 2e-3 * max|g|.  An R-18 Mask R-CNN with `norm_eval=False` goes
through both `train_detector` loops for 2 steps of 2 frames of 64 x 128
with polygon masks on disk: each step's losses within 1e-4 relative, the
first step's gradients as above, the running statistics after the loop
within 1e-5 (+ 1e-5 relative), and the parameters after the two updates
within twice the summed learning rates (Adam's update is known to its
sign where its moment is small: `test_torch_mask_train.py`'s criterion).

Checkpoints: a torchvision-key ResNet-50 `.pth` (with its classifier and a
`module.` prefix, or an mmdet detector's `backbone.` keys), a pycls
RegNetX `.pyth` (`model_state`, its head), and a Detectron `.pkl` through
`tools/detectron2pytorch.py` and a pycls file through
`tools/regnet2pytorch.py` load as `pretrained` into exactly what the JAX
package's `convert_resnet_backbone` / `convert_regnet_backbone` make of
them; a URL or `torchvision://` name and a missing key raise.
"""

import functools
import importlib.util
import json
import os
import pickle
import random

import cv2
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu import runtime as jruntime
from panoswintransformerobjectdetection_tpu.apis import train as japi
from panoswintransformerobjectdetection_tpu.data import builder as jb
from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.models import backbones_extra as jextra
from panoswintransformerobjectdetection_tpu.models import resnet as jresnet
from panoswintransformerobjectdetection_tpu.runtime import checkpoint as jck
from panoswintransformerobjectdetection_tpu.runtime import hooks as jhooks
from panoswintransformerobjectdetection_tpu.runtime import optim as joptim
from panoswintransformerobjectdetection_tpu.runtime import train as jtrain
from panoswintransformerobjectdetection_torch.apis import train as tapi
from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
from panoswintransformerobjectdetection_torch.data import builder as tb
from panoswintransformerobjectdetection_torch.models import backbones_extra as textra
from panoswintransformerobjectdetection_torch.models import resnet as tresnet
from panoswintransformerobjectdetection_torch.runtime import hooks as thooks
from panoswintransformerobjectdetection_torch.runtime import optim as toptim
from panoswintransformerobjectdetection_torch.runtime import train as ttrain
from panoswintransformerobjectdetection_torch.runtime.checkpoint import (from_jax_cnn_backbone,
                                                                         from_jax_variables)
from panoswintransformerobjectdetection_torch.tools import detectron2pytorch, regnet2pytorch
from torch_port_common import (TINY_MASK_RCNN, TINY_TRAIN_CFG, Recorder,  # noqa: F401
                               check_cnn_train_pair, cnn_train_pair, jax_sampler_noise,
                               in_background, jax_step_noise, perturb_batch_norm,
                               prefetch_cnn_references, quick_jit_train_step,
                               random_variables, recording, selected_params,
                               single_torch_thread, to_numpy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = (32, 64)
# name -> (JAX class, port class, arguments)
CASES = {
    "r18": (jresnet.ResNet, tresnet.ResNet, {"depth": 18}),
    "r50": (jresnet.ResNet, tresnet.ResNet, {"depth": 50}),
    "r50_caffe": (jresnet.ResNet, tresnet.ResNet, {"depth": 50, "style": "caffe"}),
    "x50_32x4d": (jresnet.ResNeXt, tresnet.ResNeXt, {"depth": 50}),
    "regnetx_400mf": (jextra.RegNet, textra.RegNet, {"arch": "regnetx_400mf"}),
}
H, W, MAX_GT = 64, 128, 4
CLASSES = ("a", "b", "c", "d", "e")
R18_NECK = {"type": "FPN", "in_channels": (64, 128, 256, 512), "out_channels": 16,
            "num_outs": 5}
R18_FASTER = dict(TINY_MASK_RCNN, type="FasterRCNN", with_mask=False,
                  backbone={"type": "ResNet", "depth": 18}, neck=R18_NECK)
R18_MASK = dict(TINY_MASK_RCNN, backbone={"type": "ResNet", "depth": 18, "norm_eval": False},
                neck=R18_NECK)
LOSSES = ("loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox", "acc")
LOOP = {"total_epochs": 1, "batch_size": 2, "base_lr": 1e-2, "warmup_iters": 1,
        "decay_epochs": (0.5,), "max_gt": MAX_GT, "log_interval": 1, "num_workers": 0,
        "seed": 0}
PIPELINE = [{"type": "LoadImageFromFile"},
            {"type": "LoadAnnotations", "with_bbox": True, "with_mask": True},
            {"type": "RandomFlip", "flip_ratio": 0.5},
            {"type": "Resize", "img_scale": (H, 1333), "keep_ratio": True},
            {"type": "Normalize", "mean": [103.53, 116.28, 123.675], "std": [1.0, 1.0, 1.0],
             "to_rgb": False},
            {"type": "Pad", "size_divisor": 32}]
# The RPN's and the bbox head's regression kernels are scaled by this, as in
# `test_torch_resnet_detectors.py`: a random ResNet's maps are not
# unit-scale, and with the init's spread every box would be clipped flat.
REG_SCALE = 0.05


@pytest.fixture(scope="module", autouse=True)
def cnn_references(request):
    """The JAX side of every selected backbone case, started at once in
    worker processes (`prefetch_cnn_references`), and of the Faster R-CNN
    step and the Mask R-CNN loop, in background threads (`in_background`)."""
    cases = [(CASES[p["case"]][0], CASES[p["case"]][2], SIZE, 21, {"norm_eval": p["norm_eval"]})
             for p in selected_params(request, "test_train_mode_backbone_matches_jax")]
    cases += [(jresnet.ResNet, {"depth": 18}, SIZE, 21,
               {"norm_eval": False, "frozen_stages": p["frozen_stages"]})
              for p in selected_params(request, "test_frozen_stages_zero_the_gradients_jax_zeroes")]
    prefetch_cnn_references(cases)
    fixtures = {f for item in request.session.items if item.module is request.module
                for f in item.fixturenames}
    if "faster_step" in fixtures:
        _faster_reference()
    if "mask_loops" in fixtures:
        request.getfixturevalue("jax_mask_loop")


@pytest.mark.parametrize("norm_eval", [True, False], ids=["norm_eval", "live_bn"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_train_mode_backbone_matches_jax(case, norm_eval):
    jcls, tcls, kwargs = CASES[case]
    pair = cnn_train_pair(jcls, tcls, kwargs, SIZE, 21, norm_eval=norm_eval)
    assert check_cnn_train_pair(pair, live=not norm_eval) == []


@pytest.mark.parametrize("frozen_stages", [0, 1, 2, 3, 4])
def test_frozen_stages_zero_the_gradients_jax_zeroes(frozen_stages):
    """ResNet-18 with live BatchNorm: the stem's parameters get no gradient
    from `frozen_stages` 0 on, stage i's from i + 1 on, as JAX's
    `stop_gradient` zeroes them; every BatchNorm, frozen or not, moves its
    statistics as JAX's does."""
    pair = cnn_train_pair(jresnet.ResNet, tresnet.ResNet, {"depth": 18}, SIZE, 21,
                          norm_eval=False, frozen_stages=frozen_stages)
    frozen = check_cnn_train_pair(pair, live=True)
    prefixes = ("conv1.", "bn1.") + tuple(f"layer{i}." for i in range(1, frozen_stages + 1))
    assert frozen == [n for n in pair["grads"] if n.startswith(prefixes)]


def test_norm_eval_backbone_keeps_its_statistics_and_nn_batchnorm_is_not_run():
    """`norm_eval=True` in train mode: every running statistic and
    `num_batches_tracked` bit for bit as before, the BatchNorms' affine
    parameters with gradients; `nn.BatchNorm2d.forward` (whose train mode
    would store the unbiased variance) is called in neither mode."""
    model = tresnet.ResNet(depth=18).train()
    before = {k: v.clone() for k, v in model.state_dict().items() if "weight" not in k
              and "bias" not in k}
    calls = []
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.register_forward_hook(lambda *a: calls.append(1))
    sum(o.sum() for o in model(torch.randn(2, 32, 64, 3))).backward()
    assert all(torch.equal(model.state_dict()[k], v) for k, v in before.items())
    assert model.bn1.weight.grad is not None and model.layer4[1].bn2.bias.grad is not None
    model.norm_eval = False
    model(torch.randn(2, 32, 64, 3))
    assert not calls and int(model.bn1.num_batches_tracked) == 1


def _jax_variables(det, seed):
    variables = perturb_batch_norm(to_numpy(random_variables(
        det, jnp.zeros((1, H, W, 3), jnp.float32), seed=seed)), seed=seed + 1)
    for p in variables["params"].values():
        for reg in ("rpn_reg", "fc_reg"):
            if reg in p:
                p[reg]["kernel"] = p[reg]["kernel"] * REG_SCALE
    return variables


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"images": rng.standard_normal((2, H, W, 3)).astype(np.float32),
            "img_shapes": np.array([[H, W], [60, 120]], np.float32),
            "gt_boxes": np.array([[[4, 2, 44, 34], [30, 10, 90, 60], [70, 4, 124, 40]],
                                  [[10, 4, 50, 44], [60, 6, 118, 58], [0, 0, 0, 0]]],
                                 np.float32),
            "gt_labels": np.array([[0, 3, 4], [1, 2, 0]], np.int32),
            "gt_valid": np.array([[True, True, True], [True, True, False]])}


@functools.lru_cache(maxsize=None)
def _faster_reference():
    """The JAX side of `faster_step`, started in the background
    (`in_background`) at the first call."""
    return in_background(_compute_faster_reference)


def _compute_faster_reference():
    det = build(DETECTORS, dict(R18_FASTER))
    variables = _jax_variables(det, 31)
    batch = _batch(32)
    tx = recording(joptim.make_optimizer(variables["params"], base_lr=1e-2, warmup_iters=0))
    state = jtrain.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                              batch_stats=variables["batch_stats"],
                              opt_state=tx.init(variables["params"]), tx=tx)
    new_state, ref = quick_jit_train_step(jtrain.make_train_step(det), None)(
        state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    # the sampler's key, as `make_train_step` and `forward_train` derive it
    r1, _ = jax.random.split(jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(1), 0), 0))
    k_rpn, k_rcnn = jax.random.split(det.apply(variables, method=lambda m: m.make_rng("sampler"),
                                               rngs={"sampler": r1}))
    return variables, batch, new_state, ref, k_rpn, k_rcnn


@pytest.fixture(scope="module")
def faster_step():
    """One step of the R-18 Faster R-CNN on both sides: JAX's
    `make_train_step` (its optimizer recording the gradients) and the
    port's, from the same weights, batch and sampler noise."""
    variables, batch, new_state, ref, k_rpn, k_rcnn = _faster_reference().result()
    model = build_detector_from_cfg({"model": R18_FASTER})
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]))
    model.train()
    anchors = sum(a.shape[0] for a in model.anchor_gen.grid_anchors(
        [(-(-H // s), -(-W // s)) for s in (4, 8, 16, 32, 64)]))
    noise = {"rpn": jax_sampler_noise(k_rpn, 2, anchors),
             "rcnn": jax_sampler_noise(k_rcnn, 2, 3 + TINY_TRAIN_CFG["rpn_proposal"]["max_per_img"])}
    optimizer, scheduler = toptim.make_optimizer(model, base_lr=1e-2, warmup_iters=0)
    got = ttrain.make_train_step(model, optimizer, scheduler)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, noise=noise)
    return {"got": {k: float(v) for k, v in got.items()},
            "ref": {k: float(v) for k, v in ref.items()},
            "grads": {n: p.grad for n, p in model.named_parameters()},
            "ref_grads": from_jax_variables(to_numpy(new_state.opt_state[1]),
                                            to_numpy(new_state.batch_stats)),
            "state": model.state_dict(), "before": variables}


@pytest.mark.parametrize("name", LOSSES + ("loss", "grad_norm"))
def test_faster_rcnn_step_outputs_match_jax(faster_step, name):
    got, ref = faster_step["got"][name], faster_step["ref"][name]
    assert np.isfinite(got) and (name == "acc" or got > 0)
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_faster_rcnn_step_gradients_match_jax(faster_step):
    """Every parameter's gradient, the frozen-statistics backbone's included;
    the running statistics and `num_batches_tracked` unmoved
    (`norm_eval=True`)."""
    grads, ref = faster_step["grads"], faster_step["ref_grads"]
    assert set(grads) == {k for k in ref if "running" not in k and "num_batches" not in k}
    reached = 0
    for name, g in grads.items():
        r = ref[name].numpy()
        reached += int(np.abs(r).max() > 0)
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 2e-3 * float(np.abs(r).max()),
                                   rtol=0, err_msg=name)
    assert reached > 0.9 * len(grads)
    before = from_jax_variables(faster_step["before"]["params"],
                                faster_step["before"]["batch_stats"])
    for name, v in faster_step["state"].items():
        if "running" in name or "num_batches" in name:
            assert torch.equal(v, before[name]), name


@pytest.fixture(scope="module")
def mask_frames(tmp_path_factory):
    """4 frames of 64 x 128 on disk with 1-3 polygon instances each."""
    root = str(tmp_path_factory.mktemp("r18_mask_frames"))
    rng = np.random.default_rng(17)
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
    return {"type": "CocoDataset", "ann_file": path, "img_prefix": root, "classes": CLASSES,
            "pipeline": PIPELINE}


def _jax_mask_loop(frames: dict, work_dir: str) -> dict:
    """JAX's `train_detector` over the R-18 Mask R-CNN with live BatchNorm
    from `_jax_variables(det, 41)` (JAX's `init` hands them back), its
    optimizer recording the first step's gradients."""
    det = build(DETECTORS, dict(R18_MASK))
    variables = _jax_variables(det, 41)
    first = {}

    def jit_train_step(step_fn, mesh):
        run = quick_jit_train_step(step_fn, mesh)

        def step(state, batch, rng):
            new_state, metrics = run(state, batch, rng)
            if not first:
                first.update(grads=to_numpy(new_state.opt_state[1]))
            return new_state, metrics
        return step

    make_optimizer, devices = jruntime.make_optimizer, jax.devices
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrain, "jit_train_step", jit_train_step)
        mp.setattr(jruntime, "make_optimizer", lambda *a, **k: recording(make_optimizer(*a, **k)))
        mp.setattr(type(det), "init", lambda self, *args, **kw: jax.tree.map(jnp.asarray,
                                                                             variables))
        mp.setattr(jax, "devices", lambda *args: devices(*args)[:1])
        mp.setattr(jck, "save_checkpoint", lambda path, state: os.makedirs(path))
        rec = Recorder()
        random.seed(21)
        state = japi.train_detector(
            det, jb.build_dataset(dict(frames)), work_dir=work_dir,
            hooks=[jhooks.LrRecordHook(joptim.warmup_step_schedule(
                LOOP["base_lr"], LOOP["warmup_iters"], decay_steps=(1,))), rec], **LOOP)
    return {"det": det, "variables": variables, "rec": rec, "state": state, "first": first}


@pytest.fixture(scope="module")
def jax_mask_loop(mask_frames, tmp_path_factory):
    """`_jax_mask_loop` started in the background (`in_background`): its
    future."""
    return in_background(_jax_mask_loop, mask_frames,
                         str(tmp_path_factory.mktemp("r18_jax_loop")))


@pytest.fixture(scope="module")
def mask_loops(mask_frames, jax_mask_loop, tmp_path_factory):
    """Both `train_detector` loops over the R-18 Mask R-CNN with live
    BatchNorm, from the same weights (JAX's `init` hands back the variables;
    the port loads them from a reference `.pth`) and sampler noise."""
    jax_out = jax_mask_loop.result()
    det, variables = jax_out["det"], jax_out["variables"]
    pth = str(tmp_path_factory.mktemp("r18_pth") / "r18_mask_rcnn.pth")
    torch.save({"state_dict": from_jax_variables(variables["params"], variables["batch_stats"])},
               pth)
    out = {"jax": {k: jax_out[k] for k in ("rec", "state", "first")}}
    with pytest.MonkeyPatch.context() as mp:
        port = build_detector_from_cfg({"model": R18_MASK})
        mp.setattr(tapi, "step_randomness", functools.partial(jax_step_noise, det, variables))
        rec, port_first = Recorder(), {}

        def stage(name, fn):
            result = fn()
            if name == "step" and not port_first:
                port_first.update(grads={n: p.grad.clone() for n, p in port.named_parameters()})
            return result

        random.seed(21)
        tapi.train_detector(
            port, tb.build_dataset(dict(mask_frames)),
            work_dir=str(tmp_path_factory.mktemp("r18_port_loop")), load_from=pth,
            hooks=[thooks.LrRecordHook(toptim.warmup_step_schedule(
                LOOP["base_lr"], LOOP["warmup_iters"], decay_steps=(1,))), rec],
            device="cpu", stage=stage, **LOOP)
        out["port"] = {"rec": rec, "model": port, "first": port_first}
    out["before"] = from_jax_variables(variables["params"], variables["batch_stats"])
    return out


@pytest.mark.parametrize("key", LOSSES + ("loss_mask", "loss", "grad_norm", "lr"))
def test_mask_rcnn_loop_steps_match_jax(mask_loops, key):
    got, want = mask_loops["port"]["rec"].steps, mask_loops["jax"]["rec"].steps
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        if key == "lr":
            assert np.float32(g[key]) == np.float32(w[key])
        else:
            assert np.isfinite(g[key])
            np.testing.assert_allclose(g[key], w[key], rtol=1e-4)


def test_mask_rcnn_first_step_gradients_match_jax(mask_loops):
    grads = mask_loops["port"]["first"]["grads"]
    ref = from_jax_variables(mask_loops["jax"]["first"]["grads"],
                             to_numpy(mask_loops["jax"]["state"].batch_stats))
    assert set(grads) == {k for k in ref if "running" not in k and "num_batches" not in k}
    for name, g in grads.items():
        r = ref[name].numpy()
        np.testing.assert_allclose(g.numpy(), r, atol=1e-5 + 2e-3 * float(np.abs(r).max()),
                                   rtol=0, err_msg=name)


def test_mask_rcnn_loop_statistics_and_parameters_match_jax(mask_loops):
    """After the two updates (lr 1e-5, then 1e-3): every running statistic,
    moved twice by the live BatchNorms, within 1e-5 + 1e-5 relative and
    `num_batches_tracked` 2; every parameter within twice the summed
    learning rates of JAX's."""
    state = mask_loops["jax"]["state"]
    want = from_jax_variables(to_numpy(state.params), to_numpy(state.batch_stats))
    before = mask_loops["before"]
    lr_sum = LOOP["base_lr"] * (1e-3 + 1e-1)
    moved = 0
    for name, v in mask_loops["port"]["model"].state_dict().items():
        if name.endswith("num_batches_tracked"):
            assert int(v) == 2, name
            continue
        w = want[name].numpy()
        if "running" in name:
            np.testing.assert_allclose(v.numpy(), w, rtol=1e-5, atol=1e-5, err_msg=name)
            moved += int(not torch.equal(v, before[name]))
        else:
            np.testing.assert_allclose(v.numpy(), w, atol=2 * lr_sum + 1e-6, rtol=0,
                                       err_msg=name)
    assert moved == sum("running" in k for k in before)


def _torchvision_r50(seed):
    """A torchvision ResNet-50 state dict of seeded values, its classifier
    (`fc.*`) included."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in tresnet.ResNet(depth=50).state_dict().items()}
    sd = {}
    for k, s in shapes.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(7)
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, s).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    sd["fc.weight"] = torch.zeros(1000, 2048)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def _r50_model():
    return build_detector_from_cfg({"model": dict(R18_FASTER, backbone={"type": "ResNet",
                                                                         "depth": 50},
                                                  neck=dict(R18_NECK, in_channels=(
                                                      256, 512, 1024, 2048)))})


def _assert_backbone_is(model, params, stats):
    want = from_jax_cnn_backbone(params, stats)
    got = model.backbone.state_dict()
    assert {k for k in got if "num_batches" not in k} == {k for k in want if "num_batches"
                                                          not in k}
    for k, v in want.items():
        if "num_batches" not in k:
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("layout", ["torchvision", "mmdet"])
def test_resnet_pretrained_loads_as_convert_resnet_backbone(layout, tmp_path):
    sd = _torchvision_r50(1)
    if layout == "mmdet":
        ckpt = {"state_dict": {"backbone." + k: v for k, v in sd.items() if "fc." not in k}}
        ckpt["state_dict"]["neck.lateral_convs.0.conv.weight"] = torch.zeros(1)
    else:
        ckpt = {"module." + k: v for k, v in sd.items()}
    path = str(tmp_path / "r50.pth")
    torch.save(ckpt, path)
    model = _r50_model()
    tapi.apply_init_weights(model, pretrained=path)
    params, stats = jck.convert_resnet_backbone({k: v.numpy() for k, v in sd.items()}, 50)
    _assert_backbone_is(model, params, stats)


def _pycls_regnet(arch, seed):
    """A pycls RegNetX checkpoint of seeded values: `model_state` with the
    stem, `s{i}.b{j}.f.{a,b,c}[_bn]`, `proj`/`bn` and the head's `fc`."""
    rng = np.random.default_rng(seed)
    with torch.device("meta"):
        own = {k: tuple(v.shape) for k, v in textra.RegNet(arch=arch).state_dict().items()
               if "num_batches" not in k}
    ms = {}
    for k, s in own.items():
        name = k.replace("conv1.", "stem.conv.", 1) if k.startswith("conv1.") else k
        name = name.replace("bn1.", "stem.bn.", 1) if k.startswith("bn1.") else name
        if k.startswith("layer"):
            layer, j, rest = k.split(".", 2)
            i, j = int(layer[5:]), int(j)
            for n, sub in ((1, "a"), (2, "b"), (3, "c")):
                rest = rest.replace(f"conv{n}.", f"f.{sub}.").replace(f"bn{n}.", f"f.{sub}_bn.")
            rest = rest.replace("downsample.0.", "proj.").replace("downsample.1.", "bn.")
            name = f"s{i}.b{j + 1}.{rest}"
        a = rng.uniform(0.5, 2.0, s) if k.endswith("running_var") else rng.standard_normal(s)
        ms[name] = torch.from_numpy(a.astype(np.float32))
    ms["head.fc.weight"] = torch.zeros(1000, 8)
    return {"model_state": ms, "epoch": 100}


def test_pycls_regnet_pretrained_loads_as_convert_regnet_backbone(tmp_path):
    arch = "regnetx_400mf"
    ckpt = _pycls_regnet(arch, 2)
    path = str(tmp_path / "RegNetX-400MF.pyth")
    torch.save(ckpt, path)
    model = build_detector_from_cfg({"model": dict(R18_FASTER, backbone={
        "type": "RegNet", "arch": arch}, neck=dict(R18_NECK, in_channels=(32, 64, 160, 384)))})
    tapi.apply_init_weights(model, pretrained=path)
    params, stats = jck.convert_regnet_backbone(
        {k: v.numpy() for k, v in ckpt["model_state"].items()}, arch)
    _assert_backbone_is(model, params, stats)
    out = str(tmp_path / "regnetx_400mf_mmdet.pth")
    regnet2pytorch.main([path, out])
    converted = torch.load(out, weights_only=True)["state_dict"]
    assert not any(k.startswith(("s1.", "stem.", "head.")) for k in converted)
    model2 = build_detector_from_cfg({"model": dict(R18_FASTER, backbone={
        "type": "RegNet", "arch": arch}, neck=dict(R18_NECK, in_channels=(32, 64, 160, 384)))})
    tapi.apply_init_weights(model2, pretrained=out)
    _assert_backbone_is(model2, params, stats)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", "model_converters", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_detectron_pkl_converts_and_loads_as_jax_converts_it(tmp_path):
    """A caffe2 `.pkl` of seeded blobs (`conv_w`, affine-channel `_s`, `_b`,
    and the classifier's `pred_*`) through the port's
    `tools/detectron2pytorch.py`: the reference's keys, BatchNorm mean 0 and
    variance 1; as `pretrained`, exactly what JAX's `detectron2jax`
    mapping and `convert_resnet_backbone` make of the same blobs."""
    rng = np.random.default_rng(3)
    sd = _torchvision_r50(4)
    blobs = {"pred_w": np.zeros((1000, 2048), np.float32)}
    for k, v in sd.items():
        if k.startswith("fc.") or not k.endswith((".weight", ".bias")):
            continue
        mod = k.rsplit(".", 1)[0]
        if mod == "conv1":
            caffe = "conv1"
        elif mod == "bn1":
            caffe = "res_conv1_bn"
        else:
            layer, j, rest = mod.split(".", 2)
            name = f"res{int(layer[5:]) + 1}_{j}"
            caffe = {"conv1": f"{name}_branch2a", "conv2": f"{name}_branch2b",
                     "conv3": f"{name}_branch2c", "bn1": f"{name}_branch2a_bn",
                     "bn2": f"{name}_branch2b_bn", "bn3": f"{name}_branch2c_bn",
                     "downsample.0": f"{name}_branch1",
                     "downsample.1": f"{name}_branch1_bn"}[rest]
        suffix = {"weight": "_s" if "bn" in caffe else "_w", "bias": "_b"}[k.rsplit(".", 1)[1]]
        blobs[caffe + suffix] = rng.standard_normal(tuple(v.shape)).astype(np.float32)
    src, dst = str(tmp_path / "R-50.pkl"), str(tmp_path / "r50_detectron.pth")
    with open(src, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    detectron2pytorch.main([src, dst, "50"])
    converted = torch.load(dst, weights_only=True)["state_dict"]
    assert torch.equal(converted["layer1.0.bn1.running_var"], torch.ones(64))
    model = _r50_model()
    tapi.apply_init_weights(model, pretrained=dst)
    ref = _jax_tool("detectron2jax").detectron_to_torch_names(blobs, 50)
    params, stats = jck.convert_resnet_backbone(ref, 50)
    _assert_backbone_is(model, params, stats)


@pytest.mark.parametrize("name", ["torchvision://resnet50", "https://example.invalid/r50.pth"])
def test_urls_raise_without_fetching(name):
    model = _r50_model()
    want = "resnet50-0676ba61.pth" if name.startswith("torchvision") else "r50.pth"
    with pytest.raises(FileNotFoundError, match=f"downloads nothing.*{want}"):
        tapi.apply_init_weights(model, pretrained=name)


def test_a_missing_backbone_key_raises(tmp_path):
    sd = _torchvision_r50(5)
    del sd["layer3.4.bn2.running_mean"]
    path = str(tmp_path / "r50.pth")
    torch.save(sd, path)
    with pytest.raises(KeyError, match="layer3.4.bn2.running_mean"):
        tapi.apply_init_weights(_r50_model(), pretrained=path)
