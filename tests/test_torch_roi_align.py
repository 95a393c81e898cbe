"""Kernel K3 (multilevel RoIAlign) of the PyTorch port.

On the CPU the port's plain twin is held against the JAX
`multilevel_roi_align`, both with the windowed Pallas kernel in interpret
mode (including its overflow pass for oversized RoIs) and with the XLA
einsum path.  The hand-written kernel is held against the twin on a CUDA
card in `test_torch_kernels_cuda.py`.

Tolerances: float32 1e-4 absolute.  bfloat16: 2 * 2**-8 * max|ref| against
JAX, since the two round the same f32 sums taken in another order (one
flip in the stage-one rounding plus one in the output); the kernel against
the twin on the card is exact, as both do the same operations in the same
order.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.ops import roi_align as jra
from panoswintransformerobjectdetection_torch.ops import roi_align as tra
from torch_port_common import quick_jit, single_torch_thread  # noqa: F401

STRIDES = (4, 8, 16, 32)


def _rois(rng, B, P, H, W):
    """RPN-like mix: sizes across all four levels, some crossing the
    border, some tiny, and a few elongated ones whose span on their level
    overflows the Pallas window."""
    out = []
    for b in range(B):
        for p in range(P):
            kind = p % 6
            if kind == 0:       # tiny
                w, h = rng.uniform(0.5, 6, 2)
            elif kind == 1:     # elongated: overflows the (32, 40) window
                w, h = rng.uniform(200, 400), rng.uniform(8, 16)
            else:               # one of the four levels
                s = 56 * 2 ** (kind - 2) * rng.uniform(0.8, 1.6)
                r = rng.uniform(0.5, 2)
                w, h = s * np.sqrt(r), s / np.sqrt(r)
            x1 = rng.uniform(-0.2 * w, max(W - 0.8 * w, 1 - 0.2 * w))
            y1 = rng.uniform(-0.2 * h, max(H - 0.8 * h, 1 - 0.2 * h))
            out.append([b, x1, y1, x1 + w, y1 + h])
    return np.asarray(out, np.float32)


def _case(seed, B=2, P=6, H=64, W=256, C=128):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, H // s, W // s, C)).astype(np.float32) for s in STRIDES]
    return feats, _rois(rng, B, P, H, W)


def _jax(feats, rois, dtype, pallas):
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


@pytest.mark.parametrize("pallas", [True, False], ids=["pallas_interpret", "xla"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_jax(dtype, pallas):
    feats, rois = _case(0)
    ref = _jax(feats, rois, jnp.dtype(dtype), pallas)
    tdt = getattr(torch, dtype)
    got = tra.roi_align([torch.from_numpy(f).to(tdt) for f in feats],
                        torch.from_numpy(rois), STRIDES)
    assert got.shape == ref.shape and got.dtype == tdt
    tol = 1e-4 if dtype == "float32" else 2 * 2.0 ** -8 * float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol)


def test_overflow_branch_engaged():
    """The RoI mix above does send RoIs through the Pallas overflow pass."""
    feats, rois = _case(0)
    stats = jra.window_engage_stats([f.shape[1:3] for f in feats], rois,
                                    per_image=rois.shape[0] // 2)
    assert stats["ok_fraction"] < 1.0


def test_tall_maps_contract_h_first():
    """Maps taller than wide take the other stage order, as JAX does."""
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((1, 256 // s, 64 // s, 16)).astype(np.float32)
             for s in STRIDES]
    rois = _rois(rng, 1, 12, 256, 64)
    ref = _jax(feats, rois, jnp.float32, False)
    got = tra.roi_align([torch.from_numpy(f) for f in feats], torch.from_numpy(rois), STRIDES)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


def test_roi_levels_rule():
    s = np.array([10, 56, 111.9, 112.1, 224.5, 1000], np.float32)
    rois = torch.from_numpy(np.stack([np.zeros_like(s), np.zeros_like(s),
                                      np.zeros_like(s), s, s], 1))
    assert tra.roi_levels(rois, 4).tolist() == [0, 0, 0, 1, 2, 3]


def test_bad_batch_index_pools_zeros():
    """A RoI whose batch index lies outside [0, B), or is NaN, gets zeros;
    the kernel does the same on the card (`test_torch_kernels_cuda.py`)."""
    feats, rois = _case(4, P=6)
    tf = [torch.from_numpy(f) for f in feats]
    bad = rois.copy()
    bad[[1, 5, 9], 0] = [2.0, -1.0, np.nan]
    got = tra.roi_align(tf, torch.from_numpy(bad), STRIDES)
    ref = tra.roi_align(tf, torch.from_numpy(rois), STRIDES)
    keep = [i for i in range(len(rois)) if i not in (1, 5, 9)]
    assert not got[[1, 5, 9]].any()
    assert torch.equal(got[keep], ref[keep])


def _reuse_twin(feats, rois):
    """K3's bf16 entry's order of work in PyTorch: for each stage-one bin i,
    walk the (bin j, tap k2) columns of the other axis in order, sum a
    column's stage one only where it differs from the column before, and
    reuse the last sum otherwise.  Returns the output and how many stage-one
    sums were fresh."""
    dtype, C, R = feats[0].dtype, feats[0].shape[-1], rois.shape[0]
    _, _, valid, (ys, _), (xs, _) = tra._roi_taps(feats, rois, STRIDES)
    rows, w1, w2 = tra.tap_rows(feats, rois, STRIDES)
    w_first = tra._w_first(feats)
    i2 = ys if w_first else xs
    table = torch.cat([f.reshape(-1, C) for f in feats]).float()
    out = torch.zeros((R, 7, 7, C))
    fresh_sums = 0
    for i in range(7):
        t = last = None
        for j in range(7):
            acc = None
            for k2 in range(4):
                col = i2[:, j, k2]
                s1 = None
                for k1 in range(4):
                    p = w1[:, i, k1, None] * table[rows[:, i, k1, j, k2]]
                    s1 = p if s1 is None else s1 + p
                s1 = s1.to(dtype).float()
                fresh = torch.ones(R, dtype=torch.bool) if last is None else col != last
                t = s1 if t is None else torch.where(fresh[:, None], s1, t)
                fresh_sums += int(fresh.sum())
                last = col
                p2 = w2[:, j, k2, None] * t
                acc = p2 if acc is None else acc + p2
            out[:, i, j] = acc
    out = torch.where(valid[:, None, None, None], out.to(dtype), torch.zeros((), dtype=dtype))
    return (out.transpose(1, 2) if w_first else out), fresh_sums


@pytest.mark.parametrize("wide", [True, False], ids=["wide", "tall"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reuse_of_stage_one_sums_is_exact(dtype, wide):
    """The bf16 kernel's reuse, written as a twin, equals `roi_align_plain`
    bit for bit: tiny RoIs repeat columns, border RoIs clamp them, and a
    RoI with x2 < x1 walks its columns backwards."""
    rng = np.random.default_rng(9)
    H, W = (64, 128) if wide else (128, 64)
    feats = [torch.from_numpy(rng.standard_normal((2, H // s, W // s, 8)).astype(np.float32))
             .to(getattr(torch, dtype)) for s in STRIDES]
    rois = _rois(rng, 2, 6, H, W)
    rois[3, [1, 3]] = rois[3, [3, 1]]                  # x2 < x1
    rois[4, 0] = 5.0                                   # a bad batch index
    rois = torch.from_numpy(rois)
    got, fresh_sums = _reuse_twin(feats, rois)
    assert torch.equal(got, tra.roi_align_plain(feats, rois, STRIDES))
    _, _, _, (ys, _), (xs, _) = tra._roi_taps(feats, rois, STRIDES)
    i2 = ys if W > H else xs
    flat = i2.reshape(len(rois), -1)
    assert (flat[:, 1:] == flat[:, :-1]).any()          # repeated columns were reused
    assert fresh_sums < 7 * 28 * len(rois)
    assert (flat == 0).any()                            # border columns
