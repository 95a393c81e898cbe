"""The dense RoIAlign route (kernel K4) and the RoIAlign gradients of the
PyTorch port vs JAX.

On the CPU the port's twin `dense_crop_plain` is held against the Pallas
kernel `fused_crop_per_image` in interpret mode and against the einsum pair
`_xla_crop`, forward and gradients; `_axis_weights` and the whole dense
route against `multilevel_roi_align`; and the gradient of the direct
route's twin against `jax.grad` of the JAX op.  The hand-written kernels
are held against their plain versions on a CUDA card in
`test_torch_kernels_cuda.py`.

Tolerances: float32 1e-4 absolute on values of a few units (sums in another
order).  bfloat16: 2 * 2**-8 * max|ref| (one flip in the stage-one rounding
plus one in the result); gradients in bfloat16 4 * 2**-8 * max|ref|, since
the cotangent of the stage-one product is rounded as well.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.ops import roi_align as jra
from panoswintransformerobjectdetection_tpu.ops.roi_align_pallas import (_xla_crop,
                                                                         fused_crop_per_image)
from panoswintransformerobjectdetection_torch.ops import roi_align as tra
from torch_port_common import quick_jit, single_torch_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)
BF16 = 2.0 ** -8


def _tol(ref, dtype, units=2):
    return 1e-4 if dtype == "float32" else units * BF16 * float(np.abs(ref).max())


def _crop_case(seed, B, Hl, Wl, C, P, dtype):
    rng = np.random.default_rng(seed)
    jdt = jnp.dtype(dtype)
    arrays = (rng.standard_normal((B, Hl, Wl, C)), rng.standard_normal((B, P, 7, Hl)) * 0.3,
              rng.standard_normal((B, P, 7, Wl)) * 0.3)
    jarrs = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrays]
    tarrs = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(getattr(torch, dtype))
             for a in jarrs]
    return jarrs, tarrs


@pytest.mark.parametrize("ref_fn", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_crop_twin_matches_jax(dtype, ref_fn):
    """P = 5 with chunk 4 pads the Pallas kernel's last chunk."""
    jarrs, tarrs = _crop_case(0, 2, 12, 8, 128, 5, dtype)
    if ref_fn == "xla":
        ref = quick_jit(_xla_crop, *jarrs)
    else:
        ref = quick_jit(lambda f, wy, wx: fused_crop_per_image(f, wy, wx, 4, True), *jarrs)
    ref = np.asarray(ref.astype(jnp.float32))
    got = tra.dense_crop(*tarrs)
    assert got.shape == (2, 5, 7, 7, 128) and got.dtype == tarrs[0].dtype
    np.testing.assert_allclose(got.float().numpy(), ref, atol=_tol(ref, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_crop_gradients_match_jax(dtype):
    """Gradients of sum(out * g) in the features and both weights, against
    `jax.grad` through the custom VJP of the Pallas crop (which goes through
    the einsum pair)."""
    jarrs, tarrs = _crop_case(1, 1, 10, 6, 128, 4, dtype)
    g = np.random.default_rng(2).standard_normal((1, 4, 7, 7, 128)).astype(np.float32)
    jg = jnp.asarray(g).astype(jarrs[0].dtype)

    def loss(f, wy, wx):
        return (fused_crop_per_image(f, wy, wx, 4, True).astype(jnp.float32)
                * jg.astype(jnp.float32)).sum()

    ref = quick_jit(jax.grad(loss, argnums=(0, 1, 2)), *jarrs)
    tarrs = [t.requires_grad_() for t in tarrs]
    out = tra.dense_crop(*tarrs)
    out.backward(torch.from_numpy(np.array(jg.astype(jnp.float32))).to(out.dtype))
    for t, r in zip(tarrs, ref):
        r = np.asarray(r.astype(jnp.float32))
        np.testing.assert_allclose(t.grad.float().numpy(), r, atol=_tol(r, dtype, 4))


def _rois(rng, B, P, H, W):
    """RoIs of all four levels, some tiny, some elongated, some crossing the border."""
    out = []
    for b in range(B):
        for p in range(P):
            kind = p % 6
            if kind == 0:
                w, h = rng.uniform(0.5, 6, 2)
            elif kind == 1:
                w, h = rng.uniform(150, 240), rng.uniform(8, 16)
            else:
                s = 56 * 2 ** (kind - 2) * rng.uniform(0.8, 1.2)
                r = rng.uniform(0.5, 2)
                w, h = s * np.sqrt(r), s / np.sqrt(r)
            x1 = rng.uniform(-0.2 * w, max(W - 0.8 * w, 1 - 0.2 * w))
            y1 = rng.uniform(-0.2 * h, max(H - 0.8 * h, 1 - 0.2 * h))
            out.append([b, x1, y1, x1 + w, y1 + h])
    return np.asarray(out, np.float32)


def _levels(rng, B, H, W, C):
    return [rng.standard_normal((B, H // s, W // s, C)).astype(np.float32) for s in STRIDES]


def test_axis_weights_match_jax():
    rng = np.random.default_rng(3)
    R, n = 40, 24
    v1 = rng.uniform(-3, 20, R).astype(np.float32)
    bin_sz = rng.uniform(0.05, 4, R).astype(np.float32)
    size = rng.choice([6, 12, 24], R).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        ref = quick_jit(lambda a, b, c: jra._axis_weights(a, b, 7, 2, c, n,
                                                          jnp.zeros(R, jnp.int32),
                                                          jnp.dtype(dtype)),
                        jnp.asarray(v1), jnp.asarray(bin_sz), jnp.asarray(size))
        got = tra._axis_weights(torch.from_numpy(v1), torch.from_numpy(bin_sz),
                                torch.from_numpy(size).float(), n, getattr(torch, dtype))
        assert got.shape == (R, 7, n)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                                   atol=1e-6 if dtype == "float32" else 0)


def _jax_multilevel(feats, rois, dtype, pallas=False):
    old = jra.USE_PALLAS_CROP
    try:
        jra.USE_PALLAS_CROP = pallas
        per_image = rois.shape[0] // feats[0].shape[0]
        out = quick_jit(lambda fs, r: jra.multilevel_roi_align(fs, r, strides=STRIDES,
                                                               per_image=per_image),
                        [jnp.asarray(f, dtype) for f in feats], jnp.asarray(rois))
    finally:
        jra.USE_PALLAS_CROP = old
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "tall"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_route_matches_jax(dtype, wide):
    """`multilevel_roi_align_dense` against JAX's per-image dense path, and
    the port's two routes against each other (same tolerance)."""
    rng = np.random.default_rng(4)
    H, W = (64, 128) if wide else (128, 64)
    feats, rois = _levels(rng, 2, H, W, 16), _rois(rng, 2, 12, H, W)
    ref = _jax_multilevel(feats, rois, jnp.dtype(dtype))
    tdt = getattr(torch, dtype)
    tf = [torch.from_numpy(f).to(tdt) for f in feats]
    got = tra.multilevel_roi_align_dense(tf, torch.from_numpy(rois), STRIDES)
    assert got.shape == ref.shape and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), ref, atol=_tol(ref, dtype))
    direct = tra.roi_align(tf, torch.from_numpy(rois), STRIDES)
    np.testing.assert_allclose(got.float().numpy(), direct.float().numpy(),
                               atol=_tol(ref, dtype))
    assert len(set(tra.roi_levels(torch.from_numpy(rois), 4).tolist())) == 4


def test_dense_route_needs_whole_images():
    feats = [torch.zeros(2, 8, 16, 4)]
    with pytest.raises(ValueError, match="grouped by image"):
        tra.multilevel_roi_align_dense(feats, torch.zeros(3, 5), STRIDES)


@functools.lru_cache(maxsize=None)
def _map_gradient_case(dtype):
    """(maps, rois, cotangent, JAX's gradient of the maps) for one dtype."""
    rng = np.random.default_rng(5)
    feats, rois = _levels(rng, 2, 64, 128, 8), _rois(rng, 2, 6, 64, 128)
    jdt = jnp.dtype(dtype)
    g = jnp.asarray(rng.standard_normal((12, 7, 7, 8)), jnp.float32).astype(jdt)
    g = g.astype(jnp.float32)

    def loss(fs):
        out = jra.multilevel_roi_align(list(fs), jnp.asarray(rois), strides=STRIDES, per_image=6)
        return (out.astype(jnp.float32) * g).sum()

    old = jra.USE_PALLAS_CROP
    try:
        jra.USE_PALLAS_CROP = False
        ref = quick_jit(jax.grad(loss), tuple(jnp.asarray(f, jdt) for f in feats))
    finally:
        jra.USE_PALLAS_CROP = old
    return feats, rois, np.array(g), [np.asarray(r.astype(jnp.float32)) for r in ref]


@pytest.mark.parametrize("route", ["direct", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_roi_align_map_gradients_match_jax(dtype, route):
    """d sum(out * g) / d maps, through the port's twin of either route,
    against `jax.grad` of `multilevel_roi_align` (whose VJP goes through
    the dense einsum pair)."""
    feats, rois, g, ref = _map_gradient_case(dtype)
    tdt = getattr(torch, dtype)
    tf = [torch.from_numpy(f).to(tdt).requires_grad_() for f in feats]
    fn = tra.roi_align if route == "direct" else tra.multilevel_roi_align_dense
    out = fn(tf, torch.from_numpy(rois), STRIDES)
    out.backward(torch.from_numpy(g).to(tdt))
    for t, r in zip(tf, ref):
        assert t.grad.dtype == tdt
        np.testing.assert_allclose(t.grad.float().numpy(), r, atol=_tol(r, dtype, 4))
    if route == "direct":
        plain = tra.roi_align_backward(torch.from_numpy(g).to(tdt), torch.from_numpy(rois),
                                       [f.shape for f in feats], tdt, STRIDES)
        assert all(torch.equal(p, t.grad) for p, t in zip(plain, tf))
