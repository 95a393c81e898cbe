"""Kernel K1 (fused stem) of the PyTorch port.

On the CPU the port's plain twin is held against the Pallas kernel run in
interpret mode, and the port's `ConvStemPatchEmbed` against the JAX module.
The hand-written kernel is held against the twin on a CUDA card in
`test_torch_kernels_cuda.py`.

Tolerances: float32 1e-4 absolute (sums in another order).  bfloat16:
4 * 2**-8 * max|ref|, i.e. a few units in the last place of the largest
value: a different f32 summation order can flip the bf16 rounding of an
h0 value, which moves h1 by about one unit, and h1's own rounding adds one.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from panoswintransformerobjectdetection_tpu.models import layers as jlayers
from panoswintransformerobjectdetection_tpu.ops import stem_conv as jstem
from panoswintransformerobjectdetection_torch.models.layers import ConvStemPatchEmbed
from panoswintransformerobjectdetection_torch.flagship import flagship_config
from panoswintransformerobjectdetection_torch.models.detectors import PanoFasterRCNN
from panoswintransformerobjectdetection_torch.ops import stem_conv as tstem
from panoswintransformerobjectdetection_torch.runtime.checkpoint import fold_batchnorm
from torch_port_common import quick_jit, single_torch_thread  # noqa: F401

F = torch.nn.functional

BF16_ULPS = 4 * 2.0 ** -8


def _oihw(k):
    return torch.tensor(np.asarray(k, np.float32).transpose(3, 2, 0, 1).copy())


def _weights(c0, c1, ce, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((3, 3, 3, c0)).astype(np.float32) * 0.2,
            rng.standard_normal(c0).astype(np.float32),
            rng.standard_normal((3, 3, c0, c1)).astype(np.float32) * 0.1,
            rng.standard_normal(c1).astype(np.float32),
            rng.standard_normal((4, 4, c1, ce)).astype(np.float32) * 0.1,
            rng.standard_normal(ce).astype(np.float32))


def _tol(ref, dtype):
    return 1e-4 if dtype == "float32" else BF16_ULPS * float(np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_twin_matches_pallas_interpret(dtype):
    B, H, W, c0, c1, ce = 2, 64, 256, 8, 16, 24
    x = np.random.default_rng(1).random((B, H, W, 3)).astype(np.float32)
    w0, b0, w1, b1, wp, bp = _weights(c0, c1, ce)
    jdt = jnp.dtype(dtype)
    xj = jnp.asarray(x, jdt)
    ref_h1 = np.asarray(jstem._stem2(xj, w0, b0, w1, b1, interpret=True)
                        [:, :, :, jstem.PAD_L:jstem.PAD_L + W], np.float32)
    ref = np.asarray(jstem.stem_conv_fused(xj, w0, b0, w1, b1, wp, bp, interpret=True),
                     np.float32)

    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt)
    h1 = tstem.stem_conv(xt, tstem.stem_weights(_oihw(w0), torch.from_numpy(b0), _oihw(w1),
                                                torch.from_numpy(b1), tdt))
    got = tstem.patch_projection(h1, _oihw(wp), torch.from_numpy(bp))
    assert h1.shape == (B, c1, H, W) and h1.dtype == tdt
    assert got.shape == (B, H // 4, W // 4, ce) and got.dtype == tdt
    np.testing.assert_allclose(h1.float().numpy(), ref_h1, atol=_tol(ref_h1, dtype))
    np.testing.assert_allclose(got.float().numpy(), ref, atol=_tol(ref, dtype))


def _load_jax_stem(mod: ConvStemPatchEmbed, params, stats):
    sd = mod.state_dict()
    for ci, bi, conv, bn in ((0, 1, "conv0", "bn0"), (3, 4, "conv1", "bn1")):
        sd[f"proj.{ci}.weight"] = _oihw(params[conv]["kernel"])
        sd[f"proj.{ci}.bias"] = torch.tensor(np.asarray(params[conv]["bias"]))
        if bn in params:
            sd[f"proj.{bi}.weight"] = torch.tensor(np.asarray(params[bn]["scale"]))
            sd[f"proj.{bi}.bias"] = torch.tensor(np.asarray(params[bn]["bias"]))
            sd[f"proj.{bi}.running_mean"] = torch.tensor(np.asarray(stats[bn]["mean"]))
            sd[f"proj.{bi}.running_var"] = torch.tensor(np.asarray(stats[bn]["var"]))
        else:   # BN folded away on the JAX side: identity here
            sd[f"proj.{bi}.running_var"] = torch.full_like(sd[f"proj.{bi}.running_var"],
                                                           1.0 - tstem.BN_EPS)
    sd["proj.6.weight"] = _oihw(params["proj"]["kernel"])
    sd["proj.6.bias"] = torch.tensor(np.asarray(params["proj"]["bias"]))
    sd["norm.weight"] = torch.tensor(np.asarray(params["norm"]["scale"]))
    sd["norm.bias"] = torch.tensor(np.asarray(params["norm"]["bias"]))
    mod.load_state_dict(sd)


@pytest.mark.parametrize("fuse_bn", [False, True])
def test_patch_embed_matches_jax(fuse_bn):
    """ConvStemPatchEmbed eval: BN live (random running stats) and BN folded.
    The JAX side runs its XLA conv chain; float32 atol 1e-4."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 40, 3)).astype(np.float32)
    jmod = jlayers.ConvStemPatchEmbed(patch_size=4, embed_dim=24, fuse_bn=fuse_bn)
    variables = quick_jit(lambda k, a: jmod.init(k, a, train=False), jax.random.PRNGKey(0),
                          jnp.asarray(x))
    params = jax.tree.map(np.asarray, variables["params"])
    stats = {}
    if not fuse_bn:
        stats = {k: {"mean": rng.standard_normal(v["mean"].shape).astype(np.float32),
                     "var": rng.uniform(0.5, 2.0, v["var"].shape).astype(np.float32)}
                 for k, v in variables["batch_stats"].items()}
        variables = {"params": variables["params"], "batch_stats": stats}
    old = jlayers.USE_FUSED_STEM
    try:
        jlayers.USE_FUSED_STEM = False
        ref = np.asarray(quick_jit(lambda v, a: jmod.apply(v, a, train=False), variables,
                                   jnp.asarray(x)))
    finally:
        jlayers.USE_FUSED_STEM = old

    mod = ConvStemPatchEmbed(4, 24).eval()
    _load_jax_stem(mod, params, stats)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4)


def test_fold_bn_matches_batchnorm():
    rng = np.random.default_rng(3)
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    bn = torch.nn.BatchNorm2d(8, eps=tstem.BN_EPS).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 2, 8).astype(np.float32)))
        x = torch.from_numpy(rng.standard_normal((1, 3, 8, 8)).astype(np.float32))
        w, b = tstem.fold_bn(conv.weight, conv.bias, bn.weight, bn.bias,
                             bn.running_mean, bn.running_var)
        np.testing.assert_allclose(torch.nn.functional.conv2d(x, w, b, padding=1).numpy(),
                                   bn(conv(x)).numpy(), atol=1e-5)


def _random_bn_stem(mod, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for bi in (1, 4):
            bn = mod.proj[bi]
            bn.weight.uniform_(0.5, 1.5, generator=g)
            bn.bias.normal_(generator=g)
            bn.running_mean.normal_(generator=g)
            bn.running_var.uniform_(0.5, 2.0, generator=g)


def test_stem_kernel_weights_made_once():
    """The folded, laid-out weights are kept across calls and made again
    after load_state_dict or an in-place change of a statistic."""
    mod = ConvStemPatchEmbed(4, 24).eval()
    _random_bn_stem(mod, 0)
    x = torch.rand((1, 8, 16, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y0 = mod(x)
        kw = mod.kernel_weights(torch.float32)
        assert mod(x).equal(y0) and mod.kernel_weights(torch.float32) is kw
        sd = mod.state_dict()
        sd["proj.4.running_mean"] = sd["proj.4.running_mean"] + 1.0
        mod.load_state_dict(sd)
        y1 = mod(x)
        assert mod.kernel_weights(torch.float32) is not kw and not y1.equal(y0)
        kw = mod.kernel_weights(torch.float32)
        mod.proj[1].weight.mul_(2.0)
        assert mod.kernel_weights(torch.float32) is not kw
        assert mod.kernel_weights(torch.bfloat16).w1k.dtype == torch.bfloat16


def test_fold_batchnorm_keeps_the_stem():
    """Folding the state dict's stem BatchNorms leaves the stem's output
    unchanged (float32 atol 1e-5: the fold rounds once more)."""
    model = PanoFasterRCNN(**flagship_config(tiny=True)).eval()
    _random_bn_stem(model.backbone.patch_embed, 2)
    x = torch.rand((1, 16, 32, 3), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ref = model.backbone.patch_embed(x)
        model.load_state_dict(fold_batchnorm(model.state_dict()))
        got = model.backbone.patch_embed(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


def _taps(t, H, W):
    """(B, H, W, 9, C): the 3x3 neighbourhood of each pixel of the zero-padded
    (B, H + 2, W + 2, C) map t, taps in (dy, dx) order."""
    return torch.stack([t[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], 3)


def _stem_from_tensor_core_layout(x, w0k, b0, w1k, b1, c1):
    """K1 from the bfloat16 entry's operands, with plain PyTorch: conv0 as an
    im2col GEMM over K = 27 padded to 32, conv1 as one over K = 9 taps x c0p,
    both f32 sums of compute-type values, rounded where the kernel rounds."""
    dt = x.dtype
    B, H, W, _ = x.shape
    c0p, c1p = w0k.shape[0], w1k.shape[1]
    cols = F.pad(_taps(F.pad(x.float(), (0, 0, 1, 1, 1, 1)), H, W).reshape(B, H, W, 27), (0, 5))
    h0 = torch.relu(cols @ w0k.float().T + F.pad(b0, (0, c0p - b0.shape[0]))).to(dt)
    cols = _taps(F.pad(h0.float(), (0, 0, 1, 1, 1, 1)), H, W).reshape(B, H, W, 9 * c0p)
    w1m = w1k.float().permute(0, 2, 1).reshape(9 * c0p, c1p)          # [(tap, cin), cout]
    h1 = torch.relu(cols @ w1m + F.pad(b1, (0, c1p - c1))).to(dt)
    return h1[..., :c1].permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c0, c1, H, W", [(32, 64, 12, 70), (2, 4, 9, 20), (24, 40, 5, 131)],
                         ids=["flagship", "tiny", "ragged"])
def test_tensor_core_layout_matches_twin(dtype, c0, c1, H, W):
    """`tensor_core_layout` pads c0 and c1 to multiples of 16 with zero
    weights and orders the operands as the tensor-core entry reads them; an
    im2col GEMM over those operands equals the twin: exactly in float32 on
    values whose sums are exact (so no summation order can hide a wrong
    tap), within 4 bf16 units on random values."""
    rng = np.random.default_rng(c0 + c1)
    if dtype == torch.float32:
        dyadic = lambda shape, d: torch.from_numpy(rng.integers(-8, 9, shape) / d).float()  # noqa: E731
        x, w0, b0 = dyadic((2, H, W, 3), 8.0), dyadic((c0, 3, 3, 3), 16.0), dyadic(c0, 4.0)
        w1, b1 = dyadic((c1, c0, 3, 3), 16.0), dyadic(c1, 4.0)
    else:
        g = torch.Generator().manual_seed(c0)
        x = torch.rand((2, H, W, 3), generator=g)
        w0, b0 = torch.randn((c0, 3, 3, 3), generator=g) * 0.3, torch.randn(c0, generator=g)
        w1, b1 = torch.randn((c1, c0, 3, 3), generator=g) * 0.1, torch.randn(c1, generator=g)
    x = x.to(dtype)
    w0k, w1k = tstem.tensor_core_layout(w0, w1, dtype)
    c0p, c1p = -(-c0 // 16) * 16, -(-c1 // 16) * 16
    assert w0k.shape == (c0p, 32) and w1k.shape == (9, c1p, c0p) and w0k.dtype == dtype
    assert not w0k[c0:].any() and not w0k[:, 27:].any()
    assert not w1k[:, c1:].any() and not w1k[:, :, c0:].any()
    packed = tstem.stem_weights(w0, b0, w1, b1, dtype)
    if dtype == torch.bfloat16:
        assert packed.w0k.equal(w0k) and packed.w1k.equal(w1k)
    got = _stem_from_tensor_core_layout(x, w0k, b0, w1k, b1, c1)
    ref = tstem.stem_conv_plain(x, w0, b0, w1, b1)
    assert got.shape == ref.shape == (2, c1, H, W) and got.dtype == dtype
    if dtype == torch.float32:
        assert torch.equal(got, ref)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref.float().numpy(),
                                   atol=BF16_ULPS * float(ref.float().abs().max()))
