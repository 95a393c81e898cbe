"""The JAX side of the port's CNN backbone training tests, in a module of
its own that imports neither PyTorch nor the port: the worker processes of
`torch_port_common.in_processes` unpickle `cnn_reference` from here, so
they start with JAX, flax and the JAX package's models only.
`torch_port_common` re-exports what the tests import."""

import contextlib
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def random_variables(module, *samples, seed: int):
    """Variables of a flax module with the tree of `module.init(key, *samples)` (traced for
    its shapes only: compiling the init costs more than any test that uses
    it) and numpy values from `seed` with the spread of the init's: kernels
    normal, cut at 2 sigma (0.02 for Dense, fan_in**-0.5 for convolutions),
    as the sphere-bias tables; biases and means 0, scales and variances 1."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *samples)
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


def perturb_batch_norm(variables, seed: int):
    """numpy `variables` (params, batch_stats) with every BatchNorm drawn
    away from the identity, from `seed`: scales uniform in [0.5, 1.5],
    biases and means N(0, 0.1), variances uniform in [0.5, 2].  A BatchNorm
    is a params dict with a `scale` (flax's LayerNorm and GroupNorm too, so
    this is for trees that hold none) and a batch_stats dict."""
    rng = np.random.default_rng(seed)

    def walk(tree, stats):
        out = {}
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif stats:
                out[k] = (rng.standard_normal(v.shape) * 0.1 if k == "mean"
                          else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
            elif "scale" in tree and k in ("scale", "bias"):
                out[k] = (rng.uniform(0.5, 1.5, v.shape) if k == "scale"
                          else rng.standard_normal(v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = v
        return out

    return dict(variables, params=walk(variables["params"], False),
                batch_stats=walk(variables["batch_stats"], True))


@contextlib.contextmanager
def patched(patches):
    """Each (module, attribute, value) of `patches` set for the block (a
    narrower JAX module patched in at run time), restored after it."""
    saved = []
    try:
        for module, name, value in patches:
            m = importlib.import_module(module)
            saved.append((m, name, getattr(m, name)))
            setattr(m, name, value)
        yield
    finally:
        for m, name, value in reversed(saved):
            setattr(m, name, value)


@functools.lru_cache(maxsize=None)
def _cnn_variables(jcls, kwargs, size, seed, patches=()):
    """numpy variables of the JAX backbone `jcls(**dict(kwargs))` for
    `cnn_reference`, made once a process for every `norm_eval` and
    `frozen_stages`."""
    variables = perturb_batch_norm(to_numpy(random_variables(
        jcls(**dict(kwargs)), jnp.zeros((1,) + size + (3,)), seed=seed)), seed=seed + 1)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), variables)


def cnn_reference(jcls, kwargs, size, seed, mode, patches=()):
    """The JAX side of `cnn_train_pair`: the variables, the frames, and the
    stage outputs, running statistics, `jax.vjp` gradients and cotangents
    of one train-mode call, as numpy arrays; under `patches` (`patched`)."""
    with patched(patches):
        return _cnn_reference(jcls, kwargs, size, seed, mode, patches)


def _cnn_reference(jcls, kwargs, size, seed, mode, patches):
    variables = _cnn_variables(jcls, kwargs, size, seed, patches)
    jmodule = jcls(**dict(kwargs), **dict(mode))
    x = np.random.default_rng(seed + 2).standard_normal((2,) + size + (3,))

    def vjp(params, stats, images, key):
        def run(p):
            outs, updates = jmodule.apply({"params": p, "batch_stats": stats}, images, train=True,
                                          mutable=["batch_stats"])
            return outs, updates["batch_stats"]
        outs, pull, new_stats = jax.vjp(run, params, has_aux=True)
        keys = jax.random.split(key, len(outs))
        cots = tuple(jax.random.normal(k, o.shape, o.dtype) for k, o in zip(keys, outs))
        return outs, new_stats, pull(cots)[0], cots

    with jax.enable_x64(True):
        as64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        outs, stats, grads, cots = to_numpy(jax.jit(vjp)(
            as64["params"], as64["batch_stats"], jnp.asarray(x), jax.random.PRNGKey(seed)))
    return {"variables": variables, "x": x, "outs": outs, "stats": stats, "grads": grads,
            "cots": cots}
