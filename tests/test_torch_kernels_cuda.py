"""The PyTorch port's hand-written CUDA kernels against their plain twins.

These need a CUDA card (the kernels have no CPU mode) and skip without one.
The file imports no JAX, so it runs on a machine that has none:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: K1 float32 1e-4 * max(1, max|ref|): the entry runs conv1 on
the tensor cores in 3xTF32, which adds in another order and with another
rounding than the twin and drops each product's lo.lo term (about 2**-22
of it), far inside the tolerance (`tests/test_torch_stem_f32.py`); its
first version, on the CUDA cores, is held to the same (sums in another
order).  bfloat16 4 * 2**-8 * max|ref|, since a different f32 summation
order can flip the rounding of an h0 value and h1's own rounding adds one
unit.  K3 must be exact at both types, in both its entries and its first
version: kernel and twin do the same operations in the same order.  K3 at
14 x 14 bins (the mask head) is held to the same.
K2 float32 1e-5 * max(1, max|ref|) (sums in another order); bfloat16
4 * 2**-8 * max|ref|, since another f32 summation order (the tensor cores'
for bf16) can flip the bf16 rounding of p, which moves an output by about
one unit.  K4 (`dense_crop`)
float32 1e-5 * max(1, max|ref|) * sqrt(Hl) (sums of Hl products in another
order than cuBLAS takes them); bfloat16 2 * 2**-8 * max|ref| (one flip in
the stage-one rounding and one in the result).  K3's backward float32
1e-5 * max(1, max|ref|) (atomic adds in any order); bfloat16 2 * 2**-8 *
max|ref| (each pixel's f32 sum is rounded once; the bf16 entry adds w1
times a sum over the bins j, the plain version each product, in another
order).  The bf16 entry must give the same bits on every run.  K3's
backward is held at 7 and 14 bins a side alike.
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from panoswintransformerobjectdetection_torch.ops import cuda_build
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
@pytest.mark.parametrize("shape", [(2, 64, 256, 8, 16), (1, 37, 70, 32, 64), (1, 5, 3, 2, 4),
                                   (1, 13, 131, 32, 64), (2, 6, 72, 24, 40),
                                   (1, 8, 64, 16, 80), (2, 45, 77, 32, 64)])
def test_stem_kernel_matches_twin(cuda_device, dtype, shape):
    """Ragged H and W against both kernels' tiles (4 x 64 on the tensor
    cores; W = 131 also takes the scalar stores; 45 x 77 odd both ways at
    the flagship's widths), c0 and c1 that are not multiples of 16 (2/4,
    8/16, 24/40), the flagship's 32/64, and c1 = 80, two groups of output
    channels.  Both types go through their tensor-core entries."""
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
    assert stem.stem_conv.last_entry == stem.ENTRIES[dtype]
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
@pytest.mark.parametrize("out_size", [7, 14], ids=["o7", "o14"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wide", [True, False])
def test_roi_align_kernel_matches_twin(cuda_device, dtype, wide, out_size):
    """C = 320 leaves a partial 128-channel slice; tall maps take H first;
    7 x 7 bins (the bbox head) and 14 x 14 (the mask head)."""
    feats, rois = _roi_case(2)
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tf = [torch.from_numpy(f).to(dtype).to(cuda_device) for f in feats]
    tr = torch.from_numpy(rois).to(cuda_device)
    before = ra.roi_align.launches
    got = ra.roi_align(tf, tr, STRIDES, out_size)
    torch.cuda.synchronize()
    assert ra.roi_align.launches == before + 1
    assert ra.roi_align.last_entry == ra.ENTRIES[dtype]
    assert got.shape == (rois.shape[0], out_size, out_size, 320)
    assert torch.equal(got, ra.roi_align_plain(tf, tr, STRIDES, out_size))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("C", [16, 20, 256])
def test_roi_align_kernel_channels(cuda_device, dtype, wide, C):
    """C = 16 and 256 take 16-byte chunks in the bf16 entry (2 and 32 lanes
    of a warp), C = 20 8-byte ones; R = 2 x 7 RoIs."""
    feats, rois = _roi_case(7, P=7, H=128, W=256, C=C)
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tf = [torch.from_numpy(f).to(dtype).to(cuda_device) for f in feats]
    tr = torch.from_numpy(rois).to(cuda_device)
    got = ra.roi_align(tf, tr, STRIDES)
    assert ra.roi_align.last_entry == ra.ENTRIES[dtype]
    assert torch.equal(got, ra.roi_align_plain(tf, tr, STRIDES))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_unaligned_levels_and_no_rois(cuda_device, dtype):
    """Levels that start 2 elements into their storage (4-byte chunks in the
    bf16 entry, though C = 64 would allow 16), and R = 0."""
    feats, rois = _roi_case(8, P=5, H=64, W=128, C=64)
    tf = []
    for f in feats:
        store = torch.zeros(f.size + 2, dtype=dtype, device=cuda_device)
        store[2:] = torch.from_numpy(f).to(dtype).reshape(-1).to(cuda_device)
        tf.append(store[2:].view(f.shape))
    assert tf[0].data_ptr() % 16 == 2 * tf[0].element_size()
    tr = torch.from_numpy(rois).to(cuda_device)
    assert torch.equal(ra.roi_align(tf, tr, STRIDES), ra.roi_align_plain(tf, tr, STRIDES))
    none = ra.roi_align(tf, tr[:0], STRIDES)
    torch.cuda.synchronize()
    assert none.shape == (0, 7, 7, 64) and ra.roi_align.last_entry == ra.ENTRIES[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [7, 14], ids=["o7", "o14"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_bad_batch_index(cuda_device, dtype, out_size):
    """A RoI whose batch index lies outside [0, B), or is NaN, pools zeros
    in the kernel as in the twin, and the other RoIs are untouched."""
    feats, rois = _roi_case(3, P=8)
    rois[[1, 5, 9], 0] = [2.0, -1.0, np.nan]
    tf = [torch.from_numpy(f).to(dtype).to(cuda_device) for f in feats]
    tr = torch.from_numpy(rois).to(cuda_device)
    got = ra.roi_align(tf, tr, STRIDES, out_size)
    assert ra.roi_align.last_entry == ra.ENTRIES[dtype]
    assert torch.equal(got, ra.roi_align_plain(tf, tr, STRIDES, out_size))
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
    with pytest.raises(ValueError):     # levels of two types
        ra.roi_align(feats + [torch.rand((1, 4, 8, 4), device=cuda_device).bfloat16()],
                     torch.zeros((1, 5), device=cuda_device), STRIDES)
    # the C entries refuse what they do not take: the vectorised entry any
    # type but bfloat16, no channels, five levels
    fn = cuda_build.function("roi_align", ra.ENTRIES[torch.bfloat16], ra.LAUNCH_ARGTYPES)
    out = torch.empty((1, 7, 7, 4), device=cuda_device)
    rois = torch.zeros((1, 5), device=cuda_device)
    stream = torch.cuda.current_stream().cuda_stream
    levels = ra.level_struct([f.bfloat16() for f in feats], STRIDES)
    # ... and an output size other than 7 and 14
    for dtype_code, C, count, o in ((0, 4, 1, 7), (1, 0, 1, 7), (1, 4, 5, 7), (1, 4, 1, 10)):
        levels.num_levels = count
        assert fn(ctypes.byref(levels), rois.data_ptr(), out.data_ptr(), 1, 1, C, dtype_code, 1,
                  56.0, o, stream) != 0
    # ... and so does the float32 one, any type but float32
    fn32 = cuda_build.function("roi_align", ra.ENTRIES[torch.float32], ra.LAUNCH_ARGTYPES)
    levels = ra.level_struct(feats, STRIDES)
    for dtype_code, C, count, o in ((1, 4, 1, 7), (0, 0, 1, 7), (0, 4, 5, 7), (0, 4, 1, 10)):
        levels.num_levels = count
        assert fn32(ctypes.byref(levels), rois.data_ptr(), out.data_ptr(), 1, 1, C, dtype_code, 1,
                    56.0, o, stream) != 0
    # the first version takes bfloat16 at 7 only, and float32 at 7 and 14
    first = cuda_build.function("roi_align", ra.FIRST_VERSION, ra.LAUNCH_ARGTYPES)
    levels.num_levels = 1
    assert first(ctypes.byref(levels), rois.data_ptr(), out.data_ptr(), 1, 1, 4, 1, 1, 56.0, 14,
                 stream) != 0
    # the backward is built for 7 and 14 bins a side only
    with pytest.raises(ValueError, match="Queue 2"):
        ra.roi_align_backward(torch.zeros((1, 10, 10, 4), device=cuda_device), rois,
                              [(1, 8, 16, 4)], torch.float32, STRIDES)


@pytest.mark.cuda
@pytest.mark.parametrize("out_size", [7, 14], ids=["o7", "o14"])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("C, offset", [(320, 0), (18, 0), (21, 0), (64, 1), (64, 2)],
                         ids=["C320", "C18-vec2", "C21-vec1", "off4", "off8"])
def test_roi_align_f32_entry(cuda_device, out_size, wide, C, offset):
    """K3's float32 entry, bit for bit the twin's, at 7 and 14 bins, wide and
    tall maps: C = 320 (16-byte chunks, a partial second slice of 128
    channels), C = 18 (8-byte chunks), C = 21 (4-byte chunks), and levels
    that start 4 or 8 bytes into their storage (C = 64 would allow 16); a
    RoI with a bad batch index pools zeros, and R = 0 gives an empty result."""
    feats, rois = _roi_case(11, P=12, H=128, W=256, C=C)
    rois[[1, 6], 0] = [5.0, np.nan]
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tf = []
    for f in feats:
        store = torch.zeros(f.size + offset, device=cuda_device)
        store[offset:] = torch.from_numpy(f).reshape(-1).to(cuda_device)
        tf.append(store[offset:].view(f.shape))
    assert tf[0].data_ptr() % 16 == 4 * offset
    tr = torch.from_numpy(rois).to(cuda_device)
    before = ra.roi_align.launches_by_entry.get((ra.ENTRIES[torch.float32], out_size), 0)
    got = ra.roi_align(tf, tr, STRIDES, out_size)
    torch.cuda.synchronize()
    assert ra.roi_align.last_entry == ra.ENTRIES[torch.float32] == "roi_align_f32_launch"
    assert ra.roi_align.launches_by_entry[(ra.ENTRIES[torch.float32], out_size)] == before + 1
    assert torch.equal(got, ra.roi_align_plain(tf, tr, STRIDES, out_size))
    assert not got[[1, 6]].any() and got[[0, 2]].any()
    none = ra.roi_align(tf, tr[:0], STRIDES, out_size)
    torch.cuda.synchronize()
    assert none.shape == (0, out_size, out_size, C)


@pytest.mark.cuda
def test_first_versions_still_callable(cuda_device):
    """K1's and K3's first versions (`FIRST_VERSION`), which no wrapper calls
    but `chip_smoke.py` times the redesigns against: K1 at f32 (dtype code
    0) and bf16 (1) within its tolerances, K3 at f32 (7 and 14 bins) and
    bf16 (7) exact."""
    stream = torch.cuda.current_stream().cuda_stream
    g = torch.Generator().manual_seed(3)
    c0, c1, B, H, W = 32, 64, 2, 37, 70
    x = torch.rand((B, H, W, 3), generator=g)
    w0 = torch.randn((c0, 3, 3, 3), generator=g) * 0.3
    w1 = torch.randn((c1, c0, 3, 3), generator=g) * 0.1
    b0, b1 = torch.randn(c0, generator=g), torch.randn(c1, generator=g)
    fn = cuda_build.function("stem_conv", stem.FIRST_VERSION, stem.LAUNCH_ARGTYPES)
    for code, dt in ((0, torch.float32), (1, torch.bfloat16)):
        args = [t.to(cuda_device) for t in (x.to(dt), w0, b0, w1, b1)]
        w0k, w1k = stem.cuda_core_layout(args[1], args[3], dt)
        out = torch.empty((B, c1, H, W), dtype=dt, device=cuda_device)
        before = stem.stem_conv.launches
        cuda_build.check(fn(args[0].data_ptr(), w0k.data_ptr(), args[2].data_ptr(),
                            w1k.data_ptr(), args[4].data_ptr(), out.data_ptr(), B, H, W, c0, c1,
                            w1k.shape[2], code, stream), stem.FIRST_VERSION)
        torch.cuda.synchronize()
        assert stem.stem_conv.launches == before          # not counted: no wrapper launched it
        ref = stem.stem_conv_plain(*args).float()
        scale = float(ref.abs().max())
        tol = 1e-4 * max(1.0, scale) if dt == torch.float32 else 4 * 2.0 ** -8 * scale
        assert float((out.float() - ref).abs().max()) <= tol
    feats, rois = _roi_case(5, P=10, C=256)
    tr = torch.from_numpy(rois).to(cuda_device)
    first = cuda_build.function("roi_align", ra.FIRST_VERSION, ra.LAUNCH_ARGTYPES)
    for code, dt, o in ((0, torch.float32, 7), (0, torch.float32, 14), (1, torch.bfloat16, 7)):
        tf = [torch.from_numpy(f).to(dt).to(cuda_device) for f in feats]
        out = torch.empty((tr.shape[0], o, o, 256), dtype=dt, device=cuda_device)
        cuda_build.check(first(ctypes.byref(ra.level_struct(tf, STRIDES)), tr.data_ptr(),
                               out.data_ptr(), tr.shape[0], 2, 256, code, 1,
                               float(ra.FINEST_SCALE), o, stream), ra.FIRST_VERSION)
        torch.cuda.synchronize()
        assert torch.equal(out, ra.roi_align_plain(tf, tr, STRIDES, o))


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
@pytest.mark.parametrize("O", [49, 16, 9, 64])
@pytest.mark.parametrize("d", [32, 8, 6, 24, 64])
def test_window_attention_kernel_matches_twin(cuda_device, dtype, O, d):
    """An odd window count (nW = 5), ragged O against the warp's 32 keys and
    the tensor cores' 16 rows, d not a multiple of 16 (padded with zeros)
    and of 8 (narrower loads)."""
    q, k, v, bias = _attention_case(0, 2, 5, 3, O, d, dtype, cuda_device)
    before = fa.window_attention.launches
    got = fa.window_attention(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert fa.window_attention.launches == before + 1
    assert fa.window_attention.last_entry == fa.ENTRIES[dtype]
    ref = fa.window_attention_plain(q, k, v, bias, d ** -0.5)
    assert got.dtype == dtype and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=_attention_tol(ref, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,d", [(3, 32), (1, 6), (2, 6)])
def test_window_attention_kernel_strided_views(cuda_device, dtype, h, d):
    """q, k, v as views of the model's (n, O, 3, h, d) projection and a bias
    broadcast over the windows (stride 0), through both entry points.  With
    d = 6 (the tiny configuration's head width) rows are 12 bytes in bf16
    and the views start 12 or 24 bytes apart: no 16-byte copies."""
    n, O, nW = 10, 49, 5
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_window_attention_kernel_flagship_stages(cuda_device, dtype, stage):
    """The flagship's four stage shapes, B = 2, as the model passes them:
    views of the (n, O, 3, h, 32) projection, output in (n, O, h, d)."""
    n, h, nW = ((1406, 3, 703), (380, 6, 190), (100, 12, 50), (30, 24, 15))[stage]
    O, d = 49, 32
    g = torch.Generator().manual_seed(10 + stage)
    qkv = torch.randn((n, O, 3, h, d), generator=g).to(dtype).to(cuda_device)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    bias = torch.randn((nW, h, O, O), generator=g).to(cuda_device)
    got = fa.packed_window_attention(q, k, v, bias, d ** -0.5)
    assert fa.window_attention.last_entry == fa.ENTRIES[dtype]
    ref = fa.window_attention_plain(q, k, v, bias, d ** -0.5)
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=_attention_tol(ref, dtype))


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
    with pytest.raises(TypeError):      # q in bfloat16, k and v in float32
        fa.window_attention(q.bfloat16(), k, v, bias, 1.0)
    big = torch.zeros((2, 1, 16, 72), device=cuda_device).bfloat16()
    with pytest.raises(ValueError):     # d > 64
        fa.window_attention(big, big, big, torch.zeros((1, 1, 16, 16), device=cuda_device), 1.0)
    # the C entries refuse what they do not take: the tensor-core entry any
    # type but bfloat16, O or d out of range, nW not dividing n
    fn = cuda_build.function("window_attention", fa.ENTRIES[torch.bfloat16], fa.LAUNCH_ARGTYPES)
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    out = torch.empty_like(qb)
    strides = fa.launch_strides(qb, kb, vb, bias, out)
    ptrs = [t.data_ptr() for t in (qb, kb, vb, bias, out)]
    stream = torch.cuda.current_stream().cuda_stream
    for n, O, d, nW, code in ((2, 16, 8, 2, 0), (2, 65, 8, 2, 1), (2, 16, 0, 2, 1),
                              (2, 16, 8, 3, 1)):
        assert fn(*ptrs, strides, n, 2, O, d, nW, 1.0, code, stream) != 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 40, 24, 64, 19, False), (1, 17, 9, 40, 3, False),
                                   (1, 64, 32, 256, 8, False), (1, 33, 20, 24, 40, False),
                                   (1, 12, 10, 12, 5, False), (2, 40, 24, 64, 50, True),
                                   (1, 400, 9, 16, 20, False)])
def test_dense_crop_kernel_matches_twin(cuda_device, dtype, shape):
    """Ragged P (19, 40, 50 against blocks of 8 and 18 RoIs), C (40 against
    tiles of 32 and 16; 24 and 12, padded to 16), Hl (17, 33 against steps
    of 16 and k-tiles of 64; not a multiple of 8, so Wy is padded) and Wl
    (9, 20 against strips and passes of 8);
    random weights, as the JAX package tests its Pallas crop.  The last case
    zeroes Wy for RoIs 18-35, one whole 18-RoI block, as the dense route
    does for the RoIs of other levels, next to dense blocks.  bf16 goes
    through the tensor-core entry; Hl = 400 is past the height up to which
    that entry keeps Wy in shared memory, so it streams Wy's k-tiles."""
    B, Hl, Wl, C, P, zero_block = shape
    g = torch.Generator().manual_seed(0)
    feat = torch.randn((B, Hl, Wl, C), generator=g).to(dtype).to(cuda_device)
    Wy = torch.randn((B, P, 7, Hl), generator=g) * 0.3
    if zero_block:
        Wy[:, 18:36] = 0
    Wy = Wy.to(dtype).to(cuda_device)
    Wx = (torch.randn((B, P, 7, Wl), generator=g) * 0.3).to(dtype).to(cuda_device)
    before = ra.dense_crop.launches
    got = ra.dense_crop(feat, Wy, Wx)
    torch.cuda.synchronize()
    assert ra.dense_crop.launches == before + 1
    assert ra.dense_crop.last_entry == ra.CROP_ENTRIES[dtype]
    ref = ra.dense_crop_plain(feat, Wy, Wx)
    assert got.shape == (B, P, 7, 7, C) and got.dtype == dtype and got.is_contiguous()
    scale = float(ref.float().abs().max())
    tol = 1e-5 * max(1.0, scale) * Hl ** 0.5 if dtype == torch.float32 else 2 * 2.0 ** -8 * scale
    torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=tol)
    if zero_block:
        assert not got[:, 18:36].any() and got[:, :18].any() and got[:, 36:].any()


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


def _backward_tol(ref, dtype):
    scale = float(ref.float().abs().max())
    return 1e-5 * max(1.0, scale) if dtype == torch.float32 else 2 * 2.0 ** -8 * scale


def _untouched(feats, rois, out_size=7):
    """Per level, the pixels that no tap of nonzero weight names, (B, Hl, Wl)."""
    rows, w1, w2 = ra.tap_rows(feats, rois, STRIDES, out_size)
    need = (w1[:, :, :, None, None] != 0) & (w2[:, None, None] != 0)
    _, valid = ra.batch_index(rois, feats[0].shape[0])
    touched = torch.zeros(sum(f.shape[0] * f.shape[1] * f.shape[2] for f in feats),
                          dtype=torch.bool, device=rois.device)
    touched[rows[need & valid[:, None, None, None, None]]] = True
    return [~m.view(f.shape[:3]) for m, f in
            zip(touched.split([f.shape[0] * f.shape[1] * f.shape[2] for f in feats]), feats)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("o", [7, 14])
def test_roi_align_backward_kernel_matches_autograd_through_twin(cuda_device, dtype, wide, o):
    """C = 320 leaves a partial slice of channels; overlapping RoIs add into
    the same pixels; a RoI with a bad batch index adds nothing; pixels no
    RoI touches are exactly 0; the bf16 entry gives the same bits twice; at
    7 and 14 bins a side (the bbox and the mask head)."""
    feats, rois = _roi_case(6, P=24)
    rois[3, 0] = 7.0
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tr = torch.from_numpy(rois).to(cuda_device)
    shapes = [f.shape for f in feats]
    cot = torch.randn((rois.shape[0], o, o, 320), generator=torch.Generator().manual_seed(3))
    cot = cot.to(dtype).to(cuda_device)
    before = ra.roi_align_backward.launches
    by_entry = ra.roi_align_backward.launches_by_entry.get((ra.BACKWARD_ENTRIES[dtype], o), 0)
    got = ra.roi_align_backward(cot, tr, shapes, dtype, STRIDES)
    torch.cuda.synchronize()
    assert ra.roi_align_backward.launches == before + 1
    assert ra.roi_align_backward.last_entry == ra.BACKWARD_ENTRIES[dtype]
    assert ra.roi_align_backward.launches_by_entry[(ra.BACKWARD_ENTRIES[dtype], o)] == by_entry + 1
    ref = ra.roi_align_backward_plain(cot, tr, shapes, dtype, STRIDES)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=_backward_tol(b, dtype))
    tf = [torch.from_numpy(f).to(dtype).to(cuda_device) for f in feats]
    blanks = _untouched(tf, tr, o)
    assert any(blank.any() for blank in blanks)
    for a, blank in zip(got, blanks):
        assert torch.equal(a[blank], torch.zeros_like(a[blank]))
    if dtype == torch.bfloat16:
        again = ra.roi_align_backward(cot, tr, shapes, dtype, STRIDES)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    # through autograd: the function's backward is the kernel
    tf = [t.requires_grad_() for t in tf]
    launched = ra.roi_align_backward.launches
    ra.roi_align(tf, tr, STRIDES, o).backward(cot)
    assert ra.roi_align_backward.launches == launched + 1
    for t, b in zip(tf, ref):
        torch.testing.assert_close(t.grad.float(), b.float(), rtol=0, atol=_backward_tol(b, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("C", [8, 24, 256])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("o", [7, 14])
def test_roi_align_backward_kernel_channels(cuda_device, dtype, wide, C, aligned, o):
    """C = 8, 24 and 256 (one lane, three and all 32 lanes of 16-byte
    chunks in the bf16 entry); a gradient that starts 2 elements into its
    storage forces 4-byte chunks.  64 x 256 maps (wide) and their transpose
    (tall); R = 2 x 9; 7 and 14 bins a side."""
    feats, rois = _roi_case(9, P=9, H=64, W=256, C=C)
    if not wide:
        feats = [f.transpose(0, 2, 1, 3).copy() for f in feats]
        rois = rois[:, [0, 2, 1, 4, 3]].copy()
    tr = torch.from_numpy(rois).to(cuda_device)
    shapes = [f.shape for f in feats]
    g = torch.randn((rois.shape[0], o, o, C), generator=torch.Generator().manual_seed(4))
    store = torch.zeros(g.numel() + 2, dtype=dtype, device=cuda_device)
    cot = store[:g.numel()] if aligned else store[2:]
    cot = cot.view(g.shape)
    cot.copy_(g.to(dtype))
    assert (cot.data_ptr() % 16 == 0) == aligned
    got = ra.roi_align_backward(cot, tr, shapes, dtype, STRIDES)
    assert ra.roi_align_backward.last_entry == ra.BACKWARD_ENTRIES[dtype]
    ref = ra.roi_align_backward_plain(cot, tr, shapes, dtype, STRIDES)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=_backward_tol(b, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("o", [7, 14])
def test_roi_align_backward_kernel_no_rois_and_bad_batch_index(cuda_device, dtype, o):
    """R = 0 gives maps of exact zeros (the bf16 entry writes them itself);
    RoIs whose batch index lies outside [0, B), or is NaN, add nothing."""
    feats, rois = _roi_case(10, P=6, H=64, W=128, C=64)
    shapes = [f.shape for f in feats]
    tr = torch.from_numpy(rois).to(cuda_device)
    cot = torch.randn((rois.shape[0], o, o, 64), device=cuda_device).to(dtype)
    none = ra.roi_align_backward(cot[:0], tr[:0], shapes, dtype, STRIDES)
    torch.cuda.synchronize()
    assert ra.roi_align_backward.last_entry == ra.BACKWARD_ENTRIES[dtype]
    assert all(a.shape == tuple(s) and not a.any() for a, s in zip(none, shapes))
    bad = tr.clone()
    bad[:, 0] = torch.tensor([2.0, -1.0, float("nan")] * 4, device=cuda_device)
    assert not any(a.any() for a in ra.roi_align_backward(cot, bad, shapes, dtype, STRIDES))
    keep = torch.tensor([i % 3 != 0 for i in range(12)], device=cuda_device)
    mixed = torch.where(keep[:, None], tr, bad)
    got = ra.roi_align_backward(cot, mixed, shapes, dtype, STRIDES)
    ref = ra.roi_align_backward(cot[keep], tr[keep], shapes, dtype, STRIDES)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=_backward_tol(b, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("clustered", [False, True], ids=["spread", "clustered"])
@pytest.mark.parametrize("o", [7, 14])
def test_roi_align_backward_bf16_many_rois(cuda_device, clustered, o):
    """More RoIs than a block of the bf16 entry lists at a time (2048), so
    that it lists them in rounds; `clustered` jitters every RoI around one
    box an image, so that a few tiles take them all: the plain version's
    values, and the same bits twice."""
    feats, rois = _roi_case(11, P=1100, H=128, W=256, C=64)
    if clustered:
        rng = np.random.default_rng(12)
        box = np.array([40.0, 24.0, 104.0, 80.0], np.float32)
        rois[:, 1:] = box + rng.uniform(-6, 6, (rois.shape[0], 4)).astype(np.float32)
    shapes = [f.shape for f in feats]
    tr = torch.from_numpy(rois).to(cuda_device)
    cot = torch.randn((rois.shape[0], o, o, 64), generator=torch.Generator().manual_seed(5))
    cot = cot.bfloat16().to(cuda_device)
    got = ra.roi_align_backward(cot, tr, shapes, torch.bfloat16, STRIDES)
    again = ra.roi_align_backward(cot, tr, shapes, torch.bfloat16, STRIDES)
    ref = ra.roi_align_backward_plain(cot, tr, shapes, torch.bfloat16, STRIDES)
    for a, b, c in zip(got, again, ref):
        assert torch.equal(a, b)
        torch.testing.assert_close(a.float(), c.float(), rtol=0,
                                   atol=_backward_tol(c, torch.bfloat16))


def _r50_sampled_rois(seed, B=2, per_image=512, H=800, W=1088):
    """RoIs as an R-50 Faster R-CNN training step samples them on an 800 x
    1088 batch: per image, the ground truth (3 boxes) first, then a quarter
    of the slots jittered around it (IoU above 0.5, the positives) and the
    rest proposals of every size and level, some across the border."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        gt = np.array([[100, 80, 400, 380], [500, 300, 900, 700], [40, 500, 300, 780]], float)
        rows = list(gt)
        for _ in range(per_image // 4 - len(gt)):
            box = gt[rng.integers(0, len(gt))]
            wh = box[2:] - box[:2]
            rows.append(box + rng.uniform(-0.1, 0.1, 4) * np.concatenate([wh, wh]))
        for _ in range(per_image - len(rows)):
            s = float(np.exp(rng.uniform(np.log(8), np.log(700))))
            r = float(np.exp(rng.uniform(np.log(0.3), np.log(3))))
            w, h = min(s * np.sqrt(r), 0.95 * W), min(s / np.sqrt(r), 0.95 * H)
            x, y = rng.uniform(-0.1 * w, W - 0.9 * w), rng.uniform(-0.1 * h, H - 0.9 * h)
            rows.append([x, y, x + w, y + h])
        out.append(np.concatenate([np.full((per_image, 1), b), np.asarray(rows)], 1))
    return np.concatenate(out).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_at_7_on_r50_sampled_rois(cuda_device, dtype):
    """K3's backward at 7 x 7 bins through each entry on 2 x 512 RoIs of an
    R-50 training step's kind (`_r50_sampled_rois`: a quarter clustered on
    the ground truth) over an 800 x 1088 batch's four levels of 256
    channels: against autograd through the twin, the bf16 entry the same
    bits on two launches, one launch counted at (entry, 7)."""
    rois = torch.from_numpy(_r50_sampled_rois(13)).to(cuda_device)
    shapes = [(2, 800 // s, 1088 // s, 256) for s in STRIDES]
    cot = torch.randn((rois.shape[0], 7, 7, 256), generator=torch.Generator().manual_seed(6))
    cot = cot.to(dtype).to(cuda_device)
    key = (ra.BACKWARD_ENTRIES[dtype], 7)
    before = ra.roi_align_backward.launches_by_entry.get(key, 0)
    got = ra.roi_align_backward(cot, rois, shapes, dtype, STRIDES)
    torch.cuda.synchronize()
    assert ra.roi_align_backward.launches_by_entry[key] == before + 1
    ref = ra.roi_align_backward_plain(cot, rois, shapes, dtype, STRIDES)
    levels = ra.roi_levels(rois, len(shapes))
    assert all(int((levels == level).sum()) > 0 for level in range(len(shapes)))
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == dtype
        torch.testing.assert_close(a.float(), b.float(), rtol=0, atol=_backward_tol(b, dtype))
    if dtype == torch.bfloat16:
        again = ra.roi_align_backward(cot, rois, shapes, dtype, STRIDES)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


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
    # the bf16 entry refuses another dtype code and a workspace too small
    cot = torch.zeros((2, 7, 7, 4), device=cuda_device).bfloat16()
    shapes = [feat.shape]
    maps = [torch.empty(feat.shape, device=cuda_device).bfloat16()]
    fn = cuda_build.function("roi_align", ra.BACKWARD_ENTRIES[torch.bfloat16],
                             ra.BACKWARD_BF16_ARGTYPES)
    need = ra.backward_workspace_bytes(2)
    assert ra.backward_workspace_bytes(2, 14) > need
    workspace = torch.empty(ra.backward_workspace_bytes(2, 14), dtype=torch.uint8,
                            device=cuda_device)
    # another dtype code, a workspace too small, an output size other than 7 and 14
    for dtype_code, size, o in ((0, need, 7), (1, need - 1, 7), (1, need, 14), (1, need, 10)):
        assert fn(ctypes.byref(ra.level_struct(maps, STRIDES)), rois.data_ptr(), cot.data_ptr(),
                  2, 1, 4, dtype_code, 1, 56.0, o, workspace.data_ptr(), size,
                  torch.cuda.current_stream().cuda_stream) != 0


@pytest.mark.cuda
def test_single_device_test_on_the_card(cuda_device, tmp_path):
    """The nano demo config, f32, on eight seeded 64 x 128 frames through
    `single_device_test` at batch 2: K1 and K3 launch once a batch, and the
    card's detections equal the CPU's (equal counts an image, each with a
    partner of the same label, box within 1e-3 px and score within 1e-4)."""
    import json
    from chip_smoke import FramesFromMemory, match_detections
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.apis.test import single_device_test
    from panoswintransformerobjectdetection_torch.data.builder import build_dataset
    from panoswintransformerobjectdetection_torch.data.transforms import LoadImageFromFile
    rng = np.random.default_rng(8)
    frames = (rng.random((8, 64, 128, 3)) * 255).astype(np.uint8)
    ann = {"images": [{"id": i, "file_name": f"{i}.jpg", "width": 128, "height": 64}
                      for i in range(8)],
           "annotations": [{"id": i + 1, "image_id": i, "category_id": 1,
                            "bbox": [10.0, 8.0, 30.0, 20.0], "area": 600.0, "iscrowd": 0}
                           for i in range(8)],
           "categories": [{"id": 1, "name": "car"}]}
    ann_file = str(tmp_path / "ann.json")
    with open(ann_file, "w") as f:
        json.dump(ann, f)
    pipeline = [{"type": "LoadImageFromFile"},
                {"type": "Resize", "img_scale": (64, 1333), "keep_ratio": True},
                {"type": "Normalize", "mean": [123.675, 116.28, 103.53],
                 "std": [58.395, 57.12, 57.375], "to_rgb": True},
                {"type": "Pad", "size_divisor": 32}, {"type": "PanoCheck"}]
    dataset = build_dataset({"type": "StreetDataset", "ann_file": ann_file,
                             "img_prefix": str(tmp_path), "pipeline": pipeline,
                             "test_mode": True})
    assert isinstance(dataset.pipeline.transforms[0], LoadImageFromFile)
    dataset.pipeline.transforms[0] = FramesFromMemory(frames)
    config = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                          "panoswin", "faster_rcnn_panoswin_nano_demo.py")
    ref = single_device_test(init_detector(config, seed=1, device="cpu"), dataset,
                             batch_size=2, device="cpu")
    model = init_detector(config, seed=1, device=cuda_device)
    stem.stem_conv.launches = ra.roi_align.launches = 0
    got = single_device_test(model, dataset, batch_size=2, device=cuda_device)
    assert (stem.stem_conv.launches, ra.roi_align.launches) == (4, 4)
    assert stem.stem_conv.last_entry == stem.ENTRIES[torch.float32]
    assert sum(len(r["boxes"]) for r in ref) > 0
    match_detections(got, ref, 1e-3, 1e-4, "single_device_test, card vs CPU")


@pytest.mark.cuda
def test_use_checkpoint_recomputes_k2_and_keeps_the_gradients(cuda_device):
    """The tiny flagship with fused attention, bf16, DropPath 0.2, one
    `forward_train` + backward with and without activation checkpointing from
    the same weights, batch and generators: with it, K2's forward launches
    twice a window block (once more in the backward pass, which recomputes
    the block), without it once; the losses are equal and each gradient is
    within 1e-3 * max|g| + 1e-6 of the plain run's (cuDNN and cuBLAS may
    take other algorithms, in another order, for the recompute's shapes)."""
    from panoswintransformerobjectdetection_torch.flagship import flagship_config, init_weights
    from panoswintransformerobjectdetection_torch.flagship import flagship_train_batch
    from panoswintransformerobjectdetection_torch.models.detectors import PanoFasterRCNN
    batch = flagship_train_batch(2, cuda_device, seed=1, height=64, width=128, num_gt=4)
    blocks = sum(flagship_config(tiny=True)["backbone"]["depths"])
    runs = []
    for use_checkpoint in (False, True):
        cfg = flagship_config(tiny=True, fused_attention=True, drop_path_rate=0.2)
        cfg["backbone"]["use_checkpoint"] = use_checkpoint
        model = PanoFasterRCNN(**cfg, compute_dtype=torch.bfloat16)
        init_weights(model, 2)
        model.to(cuda_device).train()
        model.backbone.set_drop_path_generator(torch.Generator().manual_seed(3))
        fa.window_attention.launches = 0
        out = model.forward_train(**batch, generator=torch.Generator().manual_seed(4))
        sum(v for k, v in out.items() if "loss" in k).backward()
        torch.cuda.synchronize()
        runs.append((fa.window_attention.launches, {k: float(v.detach()) for k, v in out.items()},
                     {n: p.grad.float().cpu() for n, p in model.named_parameters()}))
    (plain_n, plain_out, plain_g), (ckpt_n, ckpt_out, ckpt_g) = runs
    assert (plain_n, ckpt_n) == (blocks, 2 * blocks)
    assert fa.window_attention.last_entry == fa.ENTRIES[torch.bfloat16]
    assert ckpt_out == plain_out
    for name, g in plain_g.items():
        tol = 1e-3 * float(g.abs().max()) + 1e-6
        assert float((ckpt_g[name] - g).abs().max()) <= tol, name


@pytest.mark.cuda
def test_cascade_simple_test_masks_on_the_card(cuda_device, tmp_path):
    """The nano Swin Cascade Mask R-CNN (Shared4Conv1FC heads) in f32 with
    TF32 off, card against CPU from one `.pth` (`chip_smoke` 11c):
    detections within 1e-3 px and 1e-4, mask probabilities within 1e-4;
    one request launches K3 three times at 7 and once at 14."""
    from chip_smoke import NANO_CASCADE_MODEL, cascade_nano_card_vs_cpu
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    errs = cascade_nano_card_vs_cpu(cuda_device, 0, str(tmp_path))
    assert max(errs["box_err"], errs["prob_err"]) <= 1e-3
    model = init_detector({"model": NANO_CASCADE_MODEL}, seed=2, device=cuda_device)
    ra.roi_align.launches_by_entry = {}
    model.simple_test_masks(torch.randn(2, 64, 128, 3, device=cuda_device),
                            torch.tensor([[64.0, 128.0]] * 2, device=cuda_device))
    assert ra.roi_align.launches_by_entry == {(ra.ENTRIES[torch.float32], 7): 3,
                                              (ra.ENTRIES[torch.float32], 14): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_kernel_on_refined_rois(cuda_device, dtype):
    """K3 at 7 on the RoIs that the nano cascade's third stage pools (the
    second stage's refined boxes, clipped to each image), on its FPN maps
    in `dtype`, against its twin: exact."""
    from chip_smoke import NANO_CASCADE_MODEL, captured_roi_inputs
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    model = init_detector({"model": NANO_CASCADE_MODEL}, seed=2, device=cuda_device)
    g = torch.Generator().manual_seed(5)
    inputs = (torch.randn(2, 64, 128, 3, generator=g).to(cuda_device),
              torch.tensor([[64.0, 128.0], [60.0, 100.0]], device=cuda_device))
    captured = captured_roi_inputs(model, inputs)
    assert [o for _, _, o in captured] == [7, 7, 7, 14]
    feats, rois, _ = captured[2]
    assert not torch.equal(rois, captured[0][1])
    feats = [f.to(dtype) for f in feats]
    got = ra.roi_align(feats, rois, STRIDES, 7)
    assert ra.roi_align.last_entry == ra.ENTRIES[dtype]
    assert torch.equal(got, ra.roi_align_plain(feats, rois, STRIDES, 7))


@pytest.mark.cuda
def test_cascade_training_on_the_card(cuda_device):
    """The nano cascade with the GIoU loss, one `forward_train` and backward
    in f32, card against CPU (`chip_smoke` 12b): losses within 1e-4
    relative, every gradient within 1e-5 + 2e-3 * max|g|, the mask head
    without gradient, K3's backward three times at 7 through its f32 entry."""
    from chip_smoke import cascade_train_nano_card_vs_cpu
    rec = cascade_train_nano_card_vs_cpu(cuda_device, ra)
    assert rec["loss_rel_err"] <= 1e-4
    assert rec["backward_by_entry"] == {f"{ra.BACKWARD_ENTRIES[torch.float32]} o=7": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_align_backward_on_refined_rois(cuda_device, dtype):
    """K3's backward at 7 on the RoIs that a training step of the nano cascade
    pools at its stages 1 and 2 (the refined, unclipped boxes of the stage
    before), on its FPN maps' shapes, against autograd through the twin; the
    bf16 entry gives the same bits twice."""
    from chip_smoke import NANO_CASCADE_MODEL
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    model = build_detector_from_cfg({"model": NANO_CASCADE_MODEL})
    init_weights(model, 4)
    model.to(cuda_device).train()
    captured, roi_features = [], model.roi_features

    def capture(feats, rois, out_size=7):
        captured.append((rois.detach().clone(), [tuple(f.shape) for f in feats[:4]], out_size))
        return roi_features(feats, rois, out_size)

    model.roi_features = capture
    g = torch.Generator().manual_seed(5)
    model.forward_train(torch.randn(2, 64, 128, 3, generator=g).to(cuda_device),
                        torch.tensor([[64.0, 128.0], [60.0, 100.0]]),
                        torch.tensor([[[4., 2., 44., 34.], [30., 10., 90., 60.]]] * 2),
                        torch.tensor([[0, 3]] * 2), torch.ones(2, 2, dtype=torch.bool),
                        generator=torch.Generator().manual_seed(6))
    assert [o for _, _, o in captured] == [7, 7, 7]
    for rois, shapes, _ in captured[1:]:
        shapes = [(s[0], s[1], s[2], 24) for s in shapes]
        cot = torch.randn((rois.shape[0], 7, 7, 24), generator=g).to(dtype).to(cuda_device)
        got = ra.roi_align_backward(cot, rois, shapes, dtype, STRIDES)
        assert ra.roi_align_backward.last_entry == ra.BACKWARD_ENTRIES[dtype]
        ref = ra.roi_align_backward_plain(cot, rois, shapes, dtype, STRIDES)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=_backward_tol(b, dtype))
        if dtype == torch.bfloat16:
            again = ra.roi_align_backward(cot, rois, shapes, dtype, STRIDES)
            assert all(torch.equal(a, b) for a, b in zip(got, again))
