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
rounding of p, which moves an output by about one unit.
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
