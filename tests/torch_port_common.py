"""Shared pieces of the PyTorch port's parity tests (`test_torch_*.py`).

`single_torch_thread` keeps PyTorch to one CPU thread while a port test
module runs: the suite runs several pytest workers on few cores, beside JAX's
own thread pool.  `quick_jit` compiles a JAX reference without XLA's backend
optimisations: these references run once, so their compile time is their
cost.  `tiny_detector` builds the JAX tiny flagship and the port's copy of
its weights once per process, for every module that needs them;
`tiny_odd_detector` does the same for the odd-depth tiny flagship, whose
weights are a reference-format state dict, `tiny_swin_mask_rcnn` for the
tiny Swin Mask R-CNN (serving and training tests alike) and
`tiny_swin_cascade` for the tiny Swin Cascade Mask R-CNN of each bbox head.
`in_background` (threads) and `in_processes` (three spawned processes, for
`jax_cnn_reference.cnn_reference`) start JAX references ahead of the tests
that read them, so that their traces and compiles overlap.
"""

import concurrent.futures
import functools
import importlib.util
import multiprocessing
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_tpu.runtime import hooks as jhooks
from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.runtime import hooks as thooks
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables
from jax_cnn_reference import (cnn_reference, perturb_batch_norm,  # noqa: F401
                               random_variables, to_numpy)

# A training configuration of the tiny flagship's size: few samples, few
# proposals.  The thresholds are the defaults'.
TINY_TRAIN_CFG = {
    "rpn": {"pos_iou_thr": 0.7, "neg_iou_thr": 0.3, "min_pos_iou": 0.3,
            "num_samples": 32, "pos_fraction": 0.5},
    "rpn_proposal": {"nms_pre": 64, "max_per_img": 24, "iou_threshold": 0.7,
                     "min_bbox_size": 0},
    "rcnn": {"pos_iou_thr": 0.5, "neg_iou_thr": 0.5, "min_pos_iou": 0.5,
             "num_samples": 16, "pos_fraction": 0.25},
}


@pytest.fixture(scope="module", autouse=True)
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def quick_jit(fn, *args):
    """`jax.jit(fn)(*args)`, compiled at XLA's backend optimisation level 0."""
    compiled = jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
    return compiled(*args)


@functools.lru_cache(maxsize=None)
def tiny_detector():
    """The JAX `PanoFasterRCNN` at `flagship_config(tiny=True)` with
    `TINY_TRAIN_CFG`, random variables for it (`random_variables`), and the
    same weights as the port's state dict.  The seed matters to the training
    test: where a ReLU's input lies within rounding of zero, the gate opens
    in one framework only and a whole row of gradients moves by a percent
    (seen once, with other values), which no tolerance should cover."""
    cfg = flagship_config(tiny=True)
    det = build(DETECTORS, {"type": "PanoFasterRCNN",
                            "backbone": dict(cfg["backbone"], type="PanoSwinTransformer"),
                            "neck": dict(cfg["neck"], type="FPN"),
                            "num_classes": cfg["num_classes"], "train_cfg": TINY_TRAIN_CFG})
    variables = random_variables(det, jnp.zeros((1, 32, 64, 3), jnp.float32), seed=3)
    state_dict = from_jax_variables(to_numpy(variables["params"]),
                                    to_numpy(variables["batch_stats"]))
    return {"det": det, "variables": variables, "state_dict": state_dict}


def jax_sampler_noise(key, batch: int, n: int):
    """The uniform noise that the JAX package's batched samplers draw from
    `key` for `batch` images of `n` candidates (`rpn_head.py:91`,
    `roi_head.py:298`: one key an image; `core/sampler.py:34`: split into
    the positives' and the negatives' key), as two (batch, n) torch tensors."""
    out = ([], [])
    for image_key in jax.random.split(key, batch):
        for dst, k in zip(out, jax.random.split(image_key)):
            dst.append(np.asarray(jax.random.uniform(k, (n,))))
    return tuple(torch.from_numpy(np.stack(o)) for o in out)


def _jax_sampler_key(det, variables, seed, step):
    """The sampler key of the JAX loop's step `step`: `make_train_step` folds
    the step into `PRNGKey(seed + 1)`, then 0, and splits off the sampler
    key, which `forward_train` draws with `make_rng("sampler")`."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed + 1), step)
    r1, _ = jax.random.split(jax.random.fold_in(rng, 0))
    return det.apply(variables, method=lambda m: m.make_rng("sampler"), rngs={"sampler": r1})


def _anchor_count(model, batch):
    h, w = batch["images"].shape[1:3]
    return sum(a.shape[0] for a in model.anchor_gen.grid_anchors(
        [(-(-h // s), -(-w // s)) for s in (4, 8, 16, 32, 64)]))


def jax_step_noise(det, variables, model, seed, step, batch):
    """The sampler noise of the JAX loop's step `step`, as the keyword
    arguments of the port's step (`apis/train.step_randomness`'s place):
    `forward_train` splits the sampler key between the RPN and the RoI
    head.  `TINY_TRAIN_CFG`'s proposals."""
    k_rpn, k_rcnn = jax.random.split(_jax_sampler_key(det, variables, seed, step))
    b = batch["images"].shape[0]
    n_rcnn = batch["gt_boxes"].shape[1] + TINY_TRAIN_CFG["rpn_proposal"]["max_per_img"]
    return {"noise": {"rpn": jax_sampler_noise(k_rpn, b, _anchor_count(model, batch)),
                      "rcnn": jax_sampler_noise(k_rcnn, b, n_rcnn)}}


def jax_cascade_step_noise(det, variables, model, seed, step, batch):
    """`jax_step_noise` of a cascade: its `forward_train` splits the sampler
    key in 4 (`models/cascade.py:81`), the first for the RPN and one for
    each stage t, `noise["rcnn.{t}"]`, of G + `max_per_img` candidates at
    stage 0 and G + S after it (S = `int(num_samples * pos_fraction) +
    num_samples` sampled slots, the ground truth appended again).
    `TINY_TRAIN_CFG`'s proposals and samples."""
    keys = jax.random.split(_jax_sampler_key(det, variables, seed, step), 4)
    b, g = batch["gt_boxes"].shape[:2]
    rcnn = TINY_TRAIN_CFG["rcnn"]
    slots = int(rcnn["num_samples"] * rcnn["pos_fraction"]) + rcnn["num_samples"]
    noise = {"rpn": jax_sampler_noise(keys[0], b, _anchor_count(model, batch))}
    for t in range(3):
        n = g + (TINY_TRAIN_CFG["rpn_proposal"]["max_per_img"] if t == 0 else slots)
        noise[f"rcnn.{t}"] = jax_sampler_noise(keys[t + 1], b, n)
    return {"noise": noise}


def quick_jit_train_step(step_fn, mesh):
    """The JAX package's `jit_train_step`, compiled at XLA's backend
    optimisation level 0 on one device."""
    compiled = {}

    def run(state, batch, rng):
        if "fn" not in compiled:
            compiled["fn"] = jax.jit(step_fn).lower(state, batch, rng).compile(
                compiler_options={"xla_backend_optimization_level": 0})
        return compiled["fn"](state, batch, rng)

    return run


def recording(tx):
    """An optax transformation: `tx`, with the gradients it was given kept
    in its state, (tx's state, gradients)."""
    def init(params):
        return tx.init(params), jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[0], params)
        return updates, (inner, grads)

    return optax.GradientTransformation(init, update)


def jax_train_cli():
    """The JAX package's `tools/train.py`, loaded as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "train.py")
    spec = importlib.util.spec_from_file_location("jax_train_cli", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def adam_mu(opt_state):
    """Adam's first moment in an optax state."""
    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    return found[0].mu


class Recorder(thooks.Hook, jhooks.Hook):
    """A hook of both loops: every step's metrics and the hook calls in order."""

    def __init__(self):
        self.steps, self.calls = [], []

    def before_train(self, ctx):
        self.calls.append("before_train")

    def before_epoch(self, ctx):
        self.calls.append("before_epoch")

    def after_iter(self, ctx):
        self.calls.append("after_iter")
        self.steps.append(dict(ctx["metrics"], step=ctx["step"]))

    def after_epoch(self, ctx):
        self.calls.append("after_epoch")

    def after_train(self, ctx):
        self.calls.append("after_train")


# The JAX package's own tiny flagship (`__graft_entry__.py:_flagship(tiny=True)`:
# depths 1-1-1-1, so every stage is one PitchAttention block), as a config,
# with a test configuration of its size.
ODD_CONFIG = {"model": {
    "type": "PanoFasterRCNN",
    "backbone": {"type": "PanoSwinTransformer", "embed_dim": 6, "depths": (1, 1, 1, 1),
                 "num_heads": (1, 1, 1, 2), "window_size": 4, "ape": True,
                 "drop_path_rate": 0.0},
    "neck": {"type": "FPN", "in_channels": (6, 12, 24, 48), "out_channels": 16, "num_outs": 5},
    "num_classes": 5,
    "test_cfg": {"rpn": {"nms_pre": 256, "max_per_img": 64, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
                 "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 32}}}}


def random_reference_state_dict(model: torch.nn.Module, seed: int):
    """A state dict in the reference's keys for `model`, numpy values from
    `seed`: Linear weights and the sphere-bias tables normal cut at 2 sigma
    (0.02), conv weights normal (fan_in**-0.5), biases normal (0.02), norm
    scales 1 + normal (0.1), BatchNorm means normal (0.1) and variances
    uniform in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        if name.endswith("num_batches_tracked"):
            out[name] = t.clone()
            continue
        if name.endswith("_Te") or (name.endswith(".weight") and len(shape) == 2):
            a = rng.standard_normal(shape).clip(-2, 2) * 0.02
        elif name.endswith(".weight") and len(shape) == 4:
            a = rng.standard_normal(shape) * float(np.prod(shape[1:])) ** -0.5
        elif name.endswith(".weight"):
            a = 1.0 + rng.standard_normal(shape) * 0.1
        elif name.endswith("running_var"):
            a = rng.uniform(0.5, 2.0, shape)
        elif name.endswith("running_mean"):
            a = rng.standard_normal(shape) * 0.1
        else:
            a = rng.standard_normal(shape) * 0.02
        out[name] = torch.from_numpy(a.astype(np.float32))
    return out


@functools.lru_cache(maxsize=None)
def tiny_odd_detector():
    """`ODD_CONFIG` and a reference-format state dict of random weights for
    it (`random_reference_state_dict`, seed 4)."""
    return {"config": ODD_CONFIG,
            "state_dict": random_reference_state_dict(build_detector_from_cfg(ODD_CONFIG), 4)}


STREET_CLASSES = ("car", "crosswalk", "light", "traffic_sign", "warning_line")


def write_coco_set(root, n_images: int, height: int, width: int, seed: int,
                   classes=STREET_CLASSES, crowd: bool = True, bfov: bool = False):
    """A synthetic COCO-format set on disk, on the model of
    `test_eval_protocol_parity.py:_make_dataset`: `n_images` JPEG frames of
    (height, width) with filled rectangles, 1-4 boxes each (log-uniform
    sizes, so all three COCOeval area buckets), one crowd region (an RLE) on
    image 0.  With `bfov`, each box is written as 360-Indoor's BFoV (tangent
    point and extent in radians) and a last box of image 0 as pixels.
    Returns (ann_file, img_dir)."""
    import json
    import os
    import cv2
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n_images):
        img = (rng.random((height, width, 3)) * 60).astype(np.uint8)
        for _ in range(int(rng.integers(1, 5))):
            s = float(np.exp(rng.uniform(np.log(6), np.log(min(height, width) * 0.8))))
            ar = float(np.exp(rng.uniform(np.log(0.6), np.log(1.8))))
            bw, bh = min(s * np.sqrt(ar), width - 2.0), min(s / np.sqrt(ar), height - 2.0)
            x = float(rng.uniform(0, width - bw - 1))
            y = float(rng.uniform(0, height - bh - 1))
            color = tuple(int(c) for c in rng.integers(90, 255, 3))
            cv2.rectangle(img, (int(x), int(y)), (int(x + bw), int(y + bh)), color, -1)
            if bfov:
                box = [float(rng.uniform(-np.pi, np.pi)), float(rng.uniform(-1.2, 1.2)),
                       float(rng.uniform(0.05, 1.2)), float(rng.uniform(0.05, 1.0))]
                area = box[2] * box[3]
            else:
                box, area = [x, y, float(bw), float(bh)], float(bw * bh)
            annotations.append({"id": len(annotations) + 1, "image_id": i,
                                "category_id": int(rng.integers(1, len(classes) + 1)),
                                "bbox": box, "area": area, "iscrowd": 0})
        if i == 0 and crowd:
            annotations.append({"id": len(annotations) + 1, "image_id": 0, "category_id": 1,
                                "bbox": [0.0, 0.0, 20.0, 12.0], "area": 240.0, "iscrowd": 1,
                                "segmentation": {"size": [height, width],
                                                 "counts": [40, 240, height * width - 280]}})
        if i == 0 and bfov:
            annotations.append({"id": len(annotations) + 1, "image_id": 0, "category_id": 2,
                                "bbox": [width * 0.5, 3.0, 30.0, 9.0], "area": 270.0,
                                "iscrowd": 0})
        cv2.imwrite(os.path.join(img_dir, f"{i}.jpg"), img)
        images.append({"id": i, "file_name": f"{i}.jpg", "width": width, "height": height})
    ann = {"images": images, "annotations": annotations,
           "categories": [{"id": k + 1, "name": n} for k, n in enumerate(classes)]}
    ann_file = os.path.join(root, "ann.json")
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    return ann_file, img_dir


# A tiny Swin Mask R-CNN: embed 16, depths 2-2-2-2, window 4, FPN 16, 5
# classes, the mask head at the JAX package's fixed 256 channels; the
# training configuration `TINY_TRAIN_CFG` (4 positive slots an image).
TINY_MASK_RCNN = {
    "type": "MaskRCNN", "with_mask": True,
    "backbone": {"type": "SwinTransformer", "embed_dim": 16, "depths": (2, 2, 2, 2),
                 "num_heads": (1, 2, 2, 4), "window_size": 4, "drop_path_rate": 0.0},
    "neck": {"type": "FPN", "in_channels": (16, 32, 64, 128), "out_channels": 16,
             "num_outs": 5},
    "num_classes": 5, "train_cfg": TINY_TRAIN_CFG,
    "test_cfg": {"rpn": {"nms_pre": 256, "max_per_img": 64, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
                 "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 8}}}


@functools.lru_cache(maxsize=None)
def tiny_swin_mask_rcnn():
    """The JAX `MaskRCNN` of `TINY_MASK_RCNN`, random variables for it
    (`random_variables`, seed 5, from a 64 x 96 sample) and the same weights
    as the port's state dict (reference keys)."""
    det = build(DETECTORS, dict(TINY_MASK_RCNN))
    variables = random_variables(det, jnp.zeros((1, 64, 96, 3), jnp.float32), seed=5)
    return {"det": det, "variables": variables,
            "state_dict": from_jax_variables(to_numpy(variables["params"]), {})}


# The tiny Swin Mask R-CNN of `TINY_MASK_RCNN` as a Cascade Mask R-CNN, with
# each of its bbox heads: Shared2FC (the default) and a narrow
# Shared4Conv1FC (4 groups of 4 channels).
CASCADE_BBOX_HEADS = {"shared2fc": None,
                      "4conv1f": {"type": "Shared4Conv1FCBBoxHead", "norm_groups": 4,
                                  "conv_out_channels": 16}}


def tiny_cascade_config(head: str) -> dict:
    model = dict(TINY_MASK_RCNN, type="CascadeMaskRCNN")
    if CASCADE_BBOX_HEADS[head] is not None:
        model["bbox_head"] = dict(CASCADE_BBOX_HEADS[head])
    return model


@functools.lru_cache(maxsize=None)
def tiny_swin_cascade(head: str):
    """The JAX `CascadeMaskRCNN` of `tiny_cascade_config(head)`, random
    variables for it (`random_variables`, seed 7, from a 64 x 96 sample; the
    GroupNorms' scales 1 + N(0, 0.1) and biases N(0, 0.1)) and the same
    weights as the port's state dict (reference keys)."""
    det = build(DETECTORS, tiny_cascade_config(head))
    variables = random_variables(det, jnp.zeros((1, 64, 96, 3), jnp.float32), seed=7)
    rng = np.random.default_rng(8)
    params = to_numpy(variables["params"])
    for t in range(3):
        for name, p in params[f"cascade_head_{t}"].items():
            if name.startswith("gn"):
                p["scale"] = (1 + 0.1 * rng.standard_normal(p["scale"].shape)).astype(np.float32)
                p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)).astype(np.float32)
    variables = {"params": jax.tree.map(jnp.asarray, params)}
    return {"det": det, "variables": variables, "state_dict": from_jax_variables(params, {})}


# (jcls, kwargs, size, seed, mode) -> the future of its `cnn_reference`
_CNN_REFERENCES = {}
# "threads": this process's background threads; "processes": three spawned
# worker processes
_POOLS = {}


def _cnn_key(jcls, kwargs, size, seed, mode, patches=()):
    return (jcls, tuple(sorted(kwargs.items())), tuple(size), seed, tuple(sorted(mode.items())),
            tuple(patches))


def in_background(fn, *args) -> concurrent.futures.Future:
    """`fn(*args)` started in the shared background threads (four, first
    come first served); its future.  For JAX references whose results stay
    in this process: tracing holds the interpreter, XLA's compile and run
    do not."""
    if "threads" not in _POOLS:
        _POOLS["threads"] = concurrent.futures.ThreadPoolExecutor(4)
    return _POOLS["threads"].submit(fn, *args)


def in_processes(fn, *args) -> concurrent.futures.Future:
    """`fn(*args)` started in one of three spawned worker processes (first
    come first served), `fn` a module-level function whose arguments and
    result pickle; its future.  Each process traces on its own interpreter,
    so three references trace side by side.  The processes serve every
    later module of the session and end with it."""
    if "processes" not in _POOLS:
        _POOLS["processes"] = concurrent.futures.ProcessPoolExecutor(
            3, mp_context=multiprocessing.get_context("spawn"))
    return _POOLS["processes"].submit(fn, *args)


def prefetch_cnn_references(cases):
    """Start the JAX side of each `cnn_train_pair(jcls, tcls, kwargs, size,
    seed, [patches,] **mode)` case, given as (jcls, kwargs, size, seed, mode[,
    patches]), in the worker processes (`in_processes`), in order: three
    references trace and compile side by side while this process compares
    the ones done.  `cnn_train_pair` takes a case's reference from here, or
    computes it where none was started."""
    for case in cases:
        key = _cnn_key(*case)
        if key not in _CNN_REFERENCES:
            _CNN_REFERENCES[key] = in_processes(cnn_reference, *key)


def selected_params(request, function: str):
    """The `callspec.params` of the collected tests of `request`'s module
    named `function` (parametrised), in run order: what a module's fixture
    prefetches for, so that `-k` computes only the selected cases."""
    return [item.callspec.params for item in request.session.items
            if item.module is request.module and item.originalname == function]


def cnn_train_pair(jcls, tcls, kwargs, size, seed: int, patches=(), **mode):
    """One train-mode call of the JAX CNN backbone `jcls(**kwargs, **mode)`
    and of the port's `tcls(**kwargs, **mode, dtype=torch.float64)` on 2
    seeded frames of `size` (h, w), in float64 on both sides (JAX under
    `enable_x64`, jitted with XLA's optimisations: in float64 they save more
    run time than they cost): random variables of the init's spread with
    every BatchNorm away from the identity (`perturb_batch_norm`), rounded
    to float32 so that the port's float32 parameters hold them exactly,
    carried across by `from_jax_cnn_backbone`; a seeded normal cotangent
    for every stage.  Returns the stage outputs, each parameter's gradient
    (`jax.vjp`; the port's None where no gradient reached it) and the state
    dict after the call (flax's `mutable=["batch_stats"]`) of both, as
    numpy arrays by the port's keys.  The JAX side comes from
    `prefetch_cnn_references` where the case was started there.  `patches`:
    (module, attribute, value) triples that the JAX side runs under
    (`jax_cnn_reference.patched`); the caller patches the port alike."""
    from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_cnn_backbone
    key = _cnn_key(jcls, kwargs, size, seed, mode, patches)
    ref = (_CNN_REFERENCES.pop(key).result() if key in _CNN_REFERENCES
           else cnn_reference(*key))
    variables, x, outs, stats, grads, cots = (ref[k] for k in ("variables", "x", "outs", "stats",
                                                               "grads", "cots"))
    tmodule = tcls(**kwargs, **mode, dtype=torch.float64)
    tmodule.load_state_dict(from_jax_cnn_backbone(variables["params"], variables["batch_stats"]),
                            strict=True)
    tmodule.train()
    got = tmodule(torch.from_numpy(x))
    if any(g.requires_grad for g in got):
        sum((g * torch.from_numpy(c)).sum() for g, c in zip(got, cots)).backward()
    as_sd = lambda p, s: {k: v.double().numpy() for k, v in   # noqa: E731
                          from_jax_cnn_backbone(p, s).items()}
    ref_grads = as_sd(grads, stats)
    return {"outs": [np.asarray(o) for o in outs], "got": [g.detach().numpy() for g in got],
            "grads": {n: None if p.grad is None else p.grad.double().numpy()
                      for n, p in tmodule.named_parameters()},
            "ref_grads": {n: ref_grads[n] for n, _ in tmodule.named_parameters()},
            "state": {k: v.double().numpy() for k, v in tmodule.state_dict().items()},
            "ref_state": as_sd(variables["params"], stats),
            "before": as_sd(variables["params"], variables["batch_stats"])}


def _assert_within(got, ref, atol: float, name: str):
    """`np.testing.assert_allclose(got, ref, atol=atol, rtol=0)`, which
    reports a failure; one vectorised pass first decides the common case
    where every entry is within `atol` (NaN or another shape goes to the
    full check)."""
    if got.shape == ref.shape and float(np.max(np.abs(got - ref), initial=0.0)) <= atol:
        return
    np.testing.assert_allclose(got, ref, atol=atol, rtol=0, err_msg=name)


def check_cnn_train_pair(pair, live: bool):
    """`cnn_train_pair`'s two sides, float64 against float64: each stage
    within 1e-9 * max|ref|; each gradient within 1e-9 * G + 1e-6 * max|g|,
    G the largest gradient entry of the backbone (a bias before a live
    BatchNorm has a true gradient of zero, which leaves each side its own
    rounding noise); the running statistics within 1e-6 * max(1, max|ref|)
    (the port keeps them in float32) and moved exactly when `live`;
    `num_batches_tracked` 1 when `live`, else 0.  Returns the names of the
    parameters that got no gradient (all zero in JAX)."""
    for i, (g, r) in enumerate(zip(pair["got"], pair["outs"])):
        assert g.shape == r.shape and g.dtype == np.float64, f"stage {i}"
        _assert_within(g, r, 1e-9 * float(np.abs(r).max()), f"stage {i}")
    scale = max(float(np.abs(r).max()) for r in pair["ref_grads"].values())
    frozen = []
    for name, g in pair["grads"].items():
        r = pair["ref_grads"][name]
        if g is None:
            assert not r.any(), f"{name}: no gradient in the port, max|g| {np.abs(r).max()} in JAX"
            frozen.append(name)
            continue
        _assert_within(g, r, 1e-9 * scale + 1e-6 * float(np.abs(r).max()), name)
    for name, v in pair["state"].items():
        if name.endswith("num_batches_tracked"):
            assert v == int(live), name
        elif "running" in name:
            r, before = pair["ref_state"][name], pair["before"][name]
            _assert_within(v, r, 1e-6 * max(1.0, float(np.abs(r).max())), name)
            assert (not np.array_equal(v, before)) == live, name
    return frozen
