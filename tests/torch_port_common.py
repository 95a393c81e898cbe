"""Shared pieces of the PyTorch port's parity tests (`test_torch_*.py`).

`single_torch_thread` keeps PyTorch to one CPU thread while a port test
module runs: the suite runs several pytest workers on few cores, beside JAX's
own thread pool.  `quick_jit` compiles a JAX reference without XLA's backend
optimisations: these references run once, so their compile time is their
cost.  `tiny_detector` builds the JAX tiny flagship and the port's copy of
its weights once per process, for every module that needs them.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import DETECTORS, build
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.runtime.checkpoint import from_jax_variables

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


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def random_variables(module, sample, seed: int):
    """Variables of a flax module with the tree of `module.init` (traced for
    its shapes only: compiling the init costs more than any test that uses
    it) and numpy values from `seed` with the spread of the init's: kernels
    normal, cut at 2 sigma (0.02 for Dense, fan_in**-0.5 for convolutions),
    as the sphere-bias tables; biases and means 0, scales and variances 1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), sample)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            std = 0.02 if len(leaf.shape) == 2 else float(np.prod(leaf.shape[:-1])) ** -0.5
            a = rng.standard_normal(leaf.shape).clip(-2, 2) * std
        elif name in ("scale", "var"):
            a = np.ones(leaf.shape)
        elif name in ("bias", "mean"):
            a = np.zeros(leaf.shape)
        else:                                   # the sphere-bias tables
            a = rng.standard_normal(leaf.shape).clip(-2, 2) * 0.02
        return jnp.asarray(a, jnp.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


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
