"""The PyTorch port's hand-written CUDA kernels against their plain twins.

These need a CUDA card (the kernels have no CPU mode) and skip without one.
The file imports no JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: K1 float32 1e-4 * max(1, max|ref|) (sums in another order);
bfloat16 4 * 2**-8 * max|ref|, since a different f32 summation order can
flip the rounding of an h0 value and h1's own rounding adds one unit.  K3
must be exact: kernel and twin do the same operations in the same order.
K2 float32 1e-5 * max(1, max|ref|) (sums in another order); bfloat16
4 * 2**-8 * max|ref|, since another f32 summation order can flip the bf16
rounding of p, which moves an output by about one unit.  K4 (`dense_crop`)
float32 1e-5 * max(1, max|ref|) * sqrt(Hl) (sums of Hl products in another
order than cuBLAS takes them); bfloat16 2 * 2**-8 * max|ref| (one flip in
the stage-one rounding and one in the result).  K3's backward float32
1e-5 * max(1, max|ref|) (atomic adds in any order); bfloat16 2 * 2**-8 *
max|ref| (the sum is rounded once, after an order of adds that changes
from run to run; the plain version rounds the same sum taken in index
order).
"""

import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_torch.ops import fused_attention as fa
from panoswintransformerobjectdetection_torch.ops import roi_align as ra
from panoswintransformerobjectdetection_torch.ops import stem_conv as stem

STRIDES = (4, 8, 16, 32)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 64, 256, 8, 16), (1, 37, 70, 32, 64), (1, 5, 3, 2, 4)])
def test_stem_kernel_matches_twin(cuda_device, dtype, shape):
    """Ragged H and W, and c1 below one 16-channel pass, are covered."""
    B, H, W, c0, c1 = shape
    g = torch.Generator().manual_seed(0)
    x = torch.rand((B, H, W, 3), generator=g).to(dtype)
    w0 = torch.randn((c0, 3, 3, 3), generator=g) * 0.3
    w1 = torch.randn((c1, c0, 3, 3), generator=g) * 0.1
    b0, b1 = torch.randn(c0, generator=g), torch.randn(c1, generator=g)
    args = [t.to(cuda_device) for t in (x, w0, b0, w1, b1)]
    before = stem.stem_conv.launches
    got = stem.stem_conv(args[0], stem.stem_weights(*args[1:], dtype))
    torch.cuda.synchronize()
    assert stem.stem_conv.launches == before + 1
    ref = stem.stem_conv_plain(*args).float().cpu().numpy()
    scale = float(np.abs(ref).max())
    tol = 1e-4 * max(1.0, scale) if dtype == torch.float32 else 4 * 2.0 ** -8 * scale
    np.testing.assert_allclose(got.float().cpu().numpy(), ref, atol=tol)


def _roi_case(seed, B=2, P=48, H=256, W=512, C=320):
    rng = np.random.default_rng(seed)
    feats = [rng.standard_normal((B, H // s, W // s, C)).astype(np.float32) for s in STRIDES]
    rois = []
    for b in range(B):
        for p in range(P):
            kind = p % 6
            if kind == 0:
                w, h = rng.uniform(0.5, 6, 2)
            elif kind == 1:
                w, h = rng.uniform(200, 400), rng.uniform(8, 16)
            else:
                s = 56 * 2 ** (kind - 2) * rng.uniform(0.8, 1.6)
                w, h = s, s * rng.uniform(0.5, 2)
            x1 = rng.uniform(-0.2 * w, max(W - 0.8 * w, 1 - 0.2 * w))
            y1 = rng.uniform(-0.2 * h, max(H - 0.8 * h, 1 - 0.2 * h))
            rois.append([b, x1, y1, x1 + w, y1 + h])
    return feats, np.asarray(rois, np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wide", [True, False])
def test_roi_align_kernel_matches_twin(cuda_device, dtype, wide):
    """C = 320 leaves a partial 128-channel slice; tall maps take H first."""
    feats, rois = _roi_case(2)
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tf = [torch.from_numpy(f).to(dtype).to(cuda_device) for f in feats]
    tr = torch.from_numpy(rois).to(cuda_device)
    before = ra.roi_align.launches
    got = ra.roi_align(tf, tr, STRIDES)
    torch.cuda.synchronize()
    assert ra.roi_align.launches == before + 1
    assert torch.equal(got, ra.roi_align_plain(tf, tr, STRIDES))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_bad_batch_index(cuda_device, dtype):
    """A RoI whose batch index lies outside [0, B), or is NaN, pools zeros
    in the kernel as in the twin, and the other RoIs are untouched."""
    feats, rois = _roi_case(3, P=8)
    rois[[1, 5, 9], 0] = [2.0, -1.0, np.nan]
    tf = [torch.from_numpy(f).to(dtype).to(cuda_device) for f in feats]
    tr = torch.from_numpy(rois).to(cuda_device)
    got = ra.roi_align(tf, tr, STRIDES)
    assert torch.equal(got, ra.roi_align_plain(tf, tr, STRIDES))
    assert not got[[1, 5, 9]].any() and got[[0, 2, 8]].any()


@pytest.mark.cuda
def test_wrappers_refuse_bad_input(cuda_device):
    x = torch.rand((1, 8, 8, 3), device=cuda_device)
    w0, w1 = torch.rand((2, 3, 3, 3), device=cuda_device), torch.rand((4, 2, 3, 3), device=cuda_device)
    b0, b1 = torch.rand(2, device=cuda_device), torch.rand(4, device=cuda_device)
    with pytest.raises(TypeError):      # float16, and weights laid out for another type
        stem.stem_conv(x.half(), stem.stem_weights(w0, b0, w1, b1, torch.float16))
    with pytest.raises(TypeError):
        stem.stem_conv(x, stem.stem_weights(w0, b0, w1, b1, torch.bfloat16))
    with pytest.raises(ValueError):     # weights left on the host
        stem.stem_conv(x, stem.stem_weights(w0.cpu(), b0.cpu(), w1.cpu(), b1.cpu(), torch.float32))
    feats = [torch.rand((1, 8, 16, 4), device=cuda_device)]
    with pytest.raises(TypeError):
        ra.roi_align(feats, torch.zeros((1, 5), dtype=torch.float64, device=cuda_device), STRIDES)
    with pytest.raises(ValueError):
        ra.roi_align(feats, torch.zeros((1, 4), device=cuda_device), STRIDES)


def _attention_case(seed, B, nW, h, O, d, dtype, device):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn((B * nW, h, O, d), generator=g).to(dtype).to(device)
               for _ in range(3))
    return q, k, v, torch.randn((nW, h, O, O), generator=g).to(device)


def _attention_tol(ref, dtype):
    scale = float(ref.float().abs().max())
    return 1e-5 * max(1.0, scale) if dtype == torch.float32 else 4 * 2.0 ** -8 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("O", [49, 16, 9])
@pytest.mark.parametrize("d", [32, 8])
def test_window_attention_kernel_matches_twin(cuda_device, dtype, O, d):
    """An odd window count (nW = 5), ragged O against the warp's 32 keys."""
    q, k, v, bias = _attention_case(0, 2, 5, 3, O, d, dtype, cuda_device)
    before = fa.window_attention.launches
    got = fa.window_attention(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.window_attention.launches == before + 1
    ref = fa.window_attention_plain(q, k, v, bias, d ** -0.5)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=_attention_tol(ref, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_window_attention_kernel_strided_views(cuda_device, dtype):
    """q, k, v as views of the model's (n, O, 3, h, d) projection and a bias
    broadcast over the windows (stride 0), through both entry points."""
    n, O, h, d, nW = 10, 49, 3, 32, 5
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((n, O, 3, h, d), generator=g).to(dtype).to(cuda_device)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn((1, h, O, O), generator=g).to(cuda_device).expand(nW, h, O, O)
    before = fa.window_attention.launches
    got = fa.packed_window_attention(q, k, v, bias, d ** -0.5)
    got5 = fa.fused_window_attention(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.window_attention.launches == before + 2
    ref = fa.window_attention_plain(q.contiguous(), k.contiguous(), v.contiguous(),
                                    bias.contiguous(), d ** -0.5)
    assert torch.equal(got, got5)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=_attention_tol(ref, dtype))
    assert got.transpose(1, 2).is_contiguous()      # (n, O, h, d), as the projection reads it


@pytest.mark.cuda
def test_window_attention_refuses_bad_input(cuda_device):
    q, k, v, bias = _attention_case(2, 1, 2, 2, 16, 8, torch.float32, cuda_device)
    with pytest.raises(TypeError):      # float16
        fa.window_attention(q.half(), k.half(), v.half(), bias, 1.0)
    with pytest.raises(TypeError):      # a bias that is not float32
        fa.window_attention(q, k, v, bias.bfloat16(), 1.0)
    with pytest.raises(ValueError):     # bias of the wrong shape
        fa.window_attention(q, k, v, bias[:, :, :8], 1.0)
    with pytest.raises(ValueError):     # nW does not divide n
        fa.window_attention(q[:1], k[:1], v[:1], bias, 1.0)
    big = torch.zeros((2, 1, 65, 8), device=cuda_device)
    with pytest.raises(ValueError):     # O > 64
        fa.window_attention(big, big, big, torch.zeros((1, 1, 65, 65), device=cuda_device), 1.0)
    with pytest.raises(ValueError):     # channels not contiguous
        qt = q.transpose(2, 3)
        fa.window_attention(qt, qt, qt, torch.zeros((2, 2, 8, 8), device=cuda_device), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 40, 24, 64, 19), (1, 17, 9, 40, 3), (1, 64, 32, 256, 8)])
def test_dense_crop_kernel_matches_twin(cuda_device, dtype, shape):
    """Ragged P (19 of chunks of 8), C (40 of tiles of 32), Hl (17 of steps
    of 16) and Wl (9 of strips of 8) are covered; random weights, as the
    JAX package tests its Pallas crop."""
    B, Hl, Wl, C, P = shape
    g = torch.Generator().manual_seed(0)
    feat = torch.randn((B, Hl, Wl, C), generator=g).to(dtype).to(cuda_device)
    Wy = (torch.randn((B, P, 7, Hl), generator=g) * 0.3).to(dtype).to(cuda_device)
    Wx = (torch.randn((B, P, 7, Wl), generator=g) * 0.3).to(dtype).to(cuda_device)
    before = ra.dense_crop.launches
    got = ra.dense_crop(feat, Wy, Wx)
    torch.cuda.synchronize()
    assert ra.dense_crop.launches == before + 1
    ref = ra.dense_crop_plain(feat, Wy, Wx)
    assert got.shape == (B, P, 7, 7, C) and got.dtype == dtype
    scale = float(ref.float().abs().max())
    tol = 1e-5 * max(1.0, scale) * Hl ** 0.5 if dtype == torch.float32 else 2 * 2.0 ** -8 * scale
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_dense_crop_kernel_gradients_go_through_the_twin(cuda_device):
    g = torch.Generator().manual_seed(1)
    args = [torch.randn(s, generator=g).to(cuda_device).requires_grad_()
            for s in ((1, 12, 8, 16), (1, 5, 7, 12), (1, 5, 7, 8))]
    cot = torch.randn((1, 5, 7, 7, 16), generator=g).to(cuda_device)
    before = ra.dense_crop.launches
    ra.dense_crop(*args).backward(cot)
    assert ra.dense_crop.launches == before + 1          # the backward launches no kernel
    got = [a.grad.clone() for a in args]
    for a in args:
        a.grad = None
    ra.dense_crop_plain(*args).backward(cot)
    for a, b in zip(got, args):
        torch.testing.assert_close(a, b.grad, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wide", [True, False])
def test_dense_route_matches_direct_route(cuda_device, dtype, wide):
    """K4 on every level against K3, values and map gradients."""
    feats, rois = _roi_case(5, P=16, C=96)
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tr = torch.from_numpy(rois).to(cuda_device)
    cot = torch.randn((rois.shape[0], 7, 7, 96), generator=torch.Generator().manual_seed(2))
    cot = cot.to(dtype).to(cuda_device)
    outs, grads = [], []
    for fn in (ra.roi_align, ra.multilevel_roi_align_dense):
        tf = [torch.from_numpy(f).to(dtype).to(cuda_device).requires_grad_() for f in feats]
        before = ra.dense_crop.launches
        out = fn(tf, tr, STRIDES)
        out.backward(cot)
        outs.append(out.detach().float())
        grads.append([t.grad.float() for t in tf])
    assert ra.dense_crop.launches == before + 4
    units = lambda ref, n: n * 2.0 ** -8 * float(ref.abs().max())    # noqa: E731
    tol = 1e-4 if dtype == torch.float32 else units(outs[0], 2)
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=tol)
    for a, b in zip(grads[1], grads[0]):
        gtol = 1e-4 * max(1.0, float(b.abs().max())) if dtype == torch.float32 else units(b, 4)
        torch.testing.assert_close(a, b, rtol=0, atol=gtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wide", [True, False])
def test_roi_align_backward_kernel_matches_autograd_through_twin(cuda_device, dtype, wide):
    """C = 320 leaves a partial 128-channel slice; overlapping RoIs add into
    the same pixels; a RoI with a bad batch index adds nothing."""
    feats, rois = _roi_case(6, P=24)
    rois[3, 0] = 7.0
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tr = torch.from_numpy(rois).to(cuda_device)
    shapes = [f.shape for f in feats]
    cot = torch.randn((rois.shape[0], 7, 7, 320), generator=torch.Generator().manual_seed(3))
    cot = cot.to(dtype).to(cuda_device)
    before = ra.roi_align_backward.launches
    got = ra.roi_align_backward(cot, tr, shapes, dtype, STRIDES)
    torch.cuda.synchronize()
    assert ra.roi_align_backward.launches == before + 1
    ref = ra.roi_align_backward_plain(cot, tr, shapes, dtype, STRIDES)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == dtype
        scale = float(b.float().abs().max())
        tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2 * 2.0 ** -8 * scale
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=tol)
    # through autograd: the function's backward is the kernel
    tf = [torch.from_numpy(f).to(dtype).to(cuda_device).requires_grad_() for f in feats]
    ra.roi_align(tf, tr, STRIDES).backward(cot)
    assert ra.roi_align_backward.launches == before + 2
    for t, b in zip(tf, ref):
        scale = float(b.float().abs().max())
        tol = 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2 * 2.0 ** -8 * scale
        torch.testing.assert_close(t.grad.float(), b.float(), rtol=0, atol=tol)


@pytest.mark.cuda
def test_training_wrappers_refuse_bad_input(cuda_device):
    feat = torch.rand((1, 8, 16, 4), device=cuda_device)
    Wy, Wx = torch.rand((1, 2, 7, 8), device=cuda_device), torch.rand((1, 2, 7, 16), device=cuda_device)
    with pytest.raises(TypeError):
        ra.dense_crop(feat, Wy.bfloat16(), Wx)
    with pytest.raises(ValueError):
        ra.dense_crop(feat, Wy[:, :, :6], Wx[:, :, :6])
    with pytest.raises(ValueError):
        ra.dense_crop(feat, Wy, Wx[..., :8])
    rois = torch.zeros((2, 5), device=cuda_device)
    with pytest.raises(TypeError):
        ra.roi_align_backward(torch.zeros((2, 7, 7, 4), device=cuda_device).bfloat16(), rois,
                              [feat.shape], torch.float32, STRIDES)
    with pytest.raises(ValueError):
        ra.roi_align_backward(torch.zeros((3, 7, 7, 4), device=cuda_device), rois, [feat.shape],
                              torch.float32, STRIDES)
