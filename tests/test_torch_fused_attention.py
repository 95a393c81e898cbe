"""Kernel K2's twin, K5's entry point and the fused WindowAttention of the
PyTorch port vs the JAX package, whose Pallas kernels run in interpret mode
on the CPU.

Inputs are made with numpy from a seed and handed to both.  Tolerances:
float32 atol 2e-5, as the JAX package holds its own kernels to the XLA path
(`tests/test_fused_attention.py`); the backward 1e-4 absolute and relative,
as there.  bfloat16: 4 * 2**-8 * max|ref|, four bf16 units at the largest
output: both sides round p and the output to bf16, and a sum taken in
another order can flip one rounding of p, which moves an output by about
one unit.  The module-level bf16 check gets half a unit of max|ref|: its
inputs and projection weights lie on a coarse grid, so q, k, v and the
output projection are exact in bf16 in both frameworks and only the
attention's own arithmetic can differ.  The fused branch agrees there (0 on
this input), while scaling q in bf16 before the product, as the plain route
does, misses by more than one unit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.geometry.sphere import haversine
from panoswintransformerobjectdetection_tpu.models.panoswin import (
    WindowAttention as JaxWindowAttention)
from panoswintransformerobjectdetection_tpu.ops import fused_attention as jfa
from panoswintransformerobjectdetection_tpu.ops.windows import swin_attention_mask
from panoswintransformerobjectdetection_torch.models.panoswin import WindowAttention
from panoswintransformerobjectdetection_torch.ops import fused_attention as tfa
from torch_port_common import quick_jit, single_torch_thread  # noqa: F401

BF16_UNITS = 2.0 ** -8


def _inputs(seed, shape):
    B, nW, h, O, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B * nW, h, O, d)).astype(np.float32) for _ in range(3))
    return q, k, v, rng.standard_normal((nW, h, O, O)).astype(np.float32)


def _jax_padded(fn, q, k, v, bias, scale):
    """`fn` on O padded to a multiple of 8 as the JAX WindowAttention pads it
    (`models/panoswin.py:187-196`), sliced back to O."""
    O = q.shape[2]
    Op = -(-O // 8) * 8
    pad = ((0, 0), (0, 0), (0, Op - O), (0, 0))
    q, k, v = (jnp.pad(t, pad) for t in (q, k, v))
    bias = jnp.pad(bias, ((0, 0), (0, 0), (0, Op - O), (0, Op - O))).at[..., :, O:].set(-1e9)
    return fn(q, k, v, bias, scale)[:, :, :O]


_JAX_ENTRY = {
    "packed": lambda q, k, v, b, s: jfa._packed_forward(q, k, v, b, s, wpack=4, interpret=True),
    "fused": lambda q, k, v, b, s: jfa.fused_window_attention(q, k, v, b, s, interpret=True),
}
_PORT_ENTRY = {"packed": tfa.packed_window_attention, "fused": tfa.fused_window_attention}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["packed", "fused"])
@pytest.mark.parametrize("shape", [(2, 5, 2, 16, 8), (2, 5, 2, 9, 8)], ids=["O16", "O9"])
def test_twin_matches_jax(shape, entry, dtype):
    """nW = 5 is not a multiple of the JAX kernels' window block; O = 9 is
    padded to 16 on the JAX side only."""
    q, k, v, bias = _inputs(0, shape)
    scale = shape[-1] ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = quick_jit(lambda q, k, v, b: _jax_padded(_JAX_ENTRY[entry], q, k, v, b, scale),
                    *(jnp.asarray(t).astype(jdt) for t in (q, k, v)), jnp.asarray(bias))
    got = _PORT_ENTRY[entry](*(torch.from_numpy(t).to(tdt) for t in (q, k, v)),
                             torch.from_numpy(bias), scale)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    tol = 2e-5 if dtype == "float32" else 4 * BF16_UNITS * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)


def test_backward_matches_jax():
    q, k, v, bias = _inputs(1, (1, 4, 2, 8, 8))
    g = np.random.default_rng(2).standard_normal(q.shape).astype(np.float32)
    scale = 8 ** -0.5

    def loss(q, k, v, bias):
        return (jfa.packed_window_attention(q, k, v, bias, scale, 2) * g).sum()

    ref = quick_jit(jax.grad(loss, argnums=(0, 1, 2, 3)),
                    *(jnp.asarray(t) for t in (q, k, v, bias)))
    inputs = [torch.from_numpy(t).requires_grad_() for t in (q, k, v, bias)]
    (tfa.packed_window_attention(*inputs, scale) * torch.from_numpy(g)).sum().backward()
    for name, t, r in zip("qkvb", inputs, ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pano_mode", [True, False], ids=["pano", "planar"])
def test_window_attention_fused_matches_jax(pano_mode, dtype):
    """WindowAttention's fused branch, weights carried across: pano mode with
    a haversine bias, planar mode with the shifted-window mask folded in.
    The scores span several units, where the place of the scale shows."""
    dim, heads, ws, B = 16, 2, 4, 2
    Hp = Wp = 8
    nW, O = (Hp // ws) * (Wp // ws), ws * ws
    rng = np.random.default_rng(3)
    t = (2 * ws - 1) ** 2
    grid = lambda shape, step: rng.integers(-2, 3, shape) * step      # noqa: E731
    params = {"qkv": {"kernel": grid((dim, 3 * dim), 1 / 8), "bias": grid(3 * dim, 1 / 32)},
              "proj": {"kernel": grid((dim, dim), 1 / 8), "bias": np.zeros(dim)},
              "alpha_table": rng.normal(0, 1, (t, heads)),
              "beta_table": rng.normal(0, 1, (t, heads))}
    params = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    x = grid((B * nW, O, dim), 1 / 4).astype(np.float32)
    if pano_mode:
        uv = rng.uniform(-np.pi, np.pi, (nW, O, 2)).astype(np.float32)
        hav, mask = np.array(haversine(jnp.asarray(uv), jnp.asarray(uv))), None
    else:
        uv, hav, mask = np.zeros((nW, O, 2), np.float32), None, swin_attention_mask(Hp, Wp, ws, 2)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jmod = JaxWindowAttention(dim, ws, heads, dtype=jdt, fused=True)
    ref = quick_jit(lambda p, a, u, m, hv: jmod.apply({"params": p}, a, u, mask=m,
                                                      pano_mode=pano_mode, hav=hv),
                    params, jnp.asarray(x), jnp.asarray(uv),
                    None if mask is None else jnp.asarray(mask),
                    None if hav is None else jnp.asarray(hav))
    port = WindowAttention(dim, ws, heads, dtype=tdt, fused=True)
    with torch.no_grad():
        for name in ("qkv", "proj"):
            getattr(port, name).weight.copy_(torch.from_numpy(params[name]["kernel"].T))
            getattr(port, name).bias.copy_(torch.from_numpy(params[name]["bias"]))
        port.sphere_position_alpha_table_Te.copy_(torch.from_numpy(params["alpha_table"]))
        port.sphere_position_beta_table_Te.copy_(torch.from_numpy(params["beta_table"]))
        got = port(torch.from_numpy(x), nW, None if hav is None else torch.from_numpy(hav),
                   None if mask is None else torch.from_numpy(mask))
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    tol = 2e-5 * max(1.0, np.abs(ref).max()) if dtype == "float32" else \
        0.5 * BF16_UNITS * np.abs(ref).max()
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)
