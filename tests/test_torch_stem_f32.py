"""The arithmetic of K1's float32 entry, on the CPU.

The entry (`csrc/stem_conv.cu`, `stem_conv_f32_launch`) runs both
convolutions on the tensor cores in 3xTF32: each operand split as a = hi
+ lo, hi its TF32 rounding (to nearest, ties away) and lo that of a - hi,
each product taken as lo.hi + hi.lo + hi.hi with f32 sums.  The kernel itself needs the card
(`tests/test_torch_kernels_cuda.py`); here the weights' layout that
`stem_weights` makes for it is checked, and the arithmetic is emulated in
torch from that layout and held against the stem in float64 at the
flagship's widths (c0 = 32, c1 = 64), with the tolerance the card holds the
kernel to: 1e-4 * max(1, max|ref|).  A single TF32 product is emulated
beside it, to show why it is not enough.
"""

import numpy as np
import torch
import torch.nn.functional as F

from panoswintransformerobjectdetection_torch.ops import stem_conv as tstem
from panoswintransformerobjectdetection_torch.ops import tf32 as ttf32

C0, C1 = 32, 64
TOL = 1e-4        # times max(1, max|ref|), as for the f32 entry on the card


def _tf32(t):
    """float32 t rounded to TF32 by bit masking, to nearest with ties away
    from zero (`cvt.rna.tf32.f32`)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _inputs(c0=C0, c1=C1):
    rng = np.random.default_rng(19)
    x = rng.random((2, 32, 64, 3))
    w0 = rng.standard_normal((c0, 3, 3, 3)) / 27 ** 0.5
    w1 = rng.standard_normal((c1, c0, 3, 3)) / (9 * c0) ** 0.5
    b0, b1 = rng.standard_normal(c0) * 0.1, rng.standard_normal(c1) * 0.1
    return [torch.from_numpy(a) for a in (x, w0, b0, w1, b1)]


def _padded_from_layout(w1k):
    """(hi, lo) of the padded w1, each (9, c1p, c0p) [tap, cout, cin], read
    back from the float32 entry's B-tile layout (9, c0p / 16, 2, 2, c1p /
    64, 8, 2, 8, 4): [tap, cb, h, hi|lo, n, nb, kh, r, j] holds cout = 64n
    + 8nb + r, cin = 16cb + 4j + 2h + kh."""
    _, cb, _, _, ng, _, _, _, _ = w1k.shape
    return [w1k[:, :, :, s].permute(0, 3, 4, 6, 1, 7, 2, 5).reshape(9, ng * 64, cb * 16)
            for s in range(2)]                           # (tap, n, nb, r, cb, j, h, kh)


def _w0_from_layout(w0k, c0):
    """(hi, lo) of w0 (c0, 3, 3, 3) from the float32 entry's B-fragment
    layout (4, c0p / 8, 32, 4): [s, n, 4g + q] holds cout = 8n + g and the
    im2col columns k = 8s + q and k + 4, k = (dy * 3 + dx) * 3 + cin."""
    return [w[:c0, :27].reshape(c0, 3, 3, 3).permute(0, 3, 1, 2)
            for w in _padded_w0_from_layout(w0k)]


def _padded_w0_from_layout(w0k):
    """(hi, lo) of the padded w0 as (c0p, 32) [cout, k] from the layout."""
    _, nt, _, _ = w0k.shape
    t = w0k.reshape(4, nt, 8, 4, 2, 2)                   # (s, n, g, q, hi|lo, j)
    return [t[..., s, :].permute(1, 2, 0, 4, 3).reshape(nt * 8, 32)
            for s in range(2)]                           # (n, g, s, j, q)


def _w1_from_layout(w1k, c0, c1):
    """(hi, lo) of w1 (c1, c0, 3, 3) from the layout."""
    return [w[:, :c1, :c0].permute(1, 2, 0).reshape(c1, c0, 3, 3)
            for w in _padded_from_layout(w1k)]


def test_tf32_split_layout():
    """hi has its low 13 mantissa bits zero, hi + lo gives w back within
    2**-21 |w|, every weight sits where the kernel's lanes read it (the
    layout read back is w), and the padding is zero."""
    for c0, c1 in ((C0, C1), (24, 40)):
        _, w0, b0, w1, b1 = (t.float() for t in _inputs(c0, c1))
        packed = tstem.stem_weights(w0, b0, w1, b1, torch.float32)
        c0p, c1p = -(-c0 // 16) * 16, -(-c1 // 64) * 64
        assert packed.w0k.shape == (4, c0p // 8, 32, 4) and packed.w0k.dtype == torch.float32
        assert packed.w1k.shape == (9, c0p // 16, 2, 2, c1p // 64, 8, 2, 8, 4)
        for k in (packed.w0k, packed.w1k):                        # hi and lo
            assert not (k.view(torch.int32) & 0x1FFF).any()
        hi0, lo0 = _w0_from_layout(packed.w0k, c0)
        assert torch.equal(hi0, _tf32(w0)) and torch.equal(lo0, _tf32(w0 - hi0))
        for w in _padded_w0_from_layout(packed.w0k):         # zero padding
            assert not w[c0:].any() and not w[:, 27:].any()
        assert torch.equal(ttf32.tf32_round(w1), _tf32(w1))
        hi, lo = _w1_from_layout(packed.w1k, c0, c1)
        assert torch.equal(hi, _tf32(w1)) and torch.equal(lo, _tf32(w1 - hi))
        assert ((hi + lo).double() - w1.double()).abs().le(2.0 ** -21 * w1.double().abs()).all()
        for w in _padded_from_layout(packed.w1k):           # zero padding
            assert not w[:, c1:].any() and not w[:, :, c0:].any()


def _stem_f64(x, w0, b0, w1, b1):
    xd = x.double().permute(0, 3, 1, 2)
    h0 = torch.relu(F.conv2d(xd, w0.double(), padding=1) + b0.double()[:, None, None])
    return torch.relu(F.conv2d(h0, w1.double(), padding=1) + b1.double()[:, None, None])


def _conv3(a, w_hi, w_lo):
    """3xTF32: a split into hi and lo, lo.hi + hi.lo + hi.hi, f32 sums of
    exact products."""
    a_hi = _tf32(a)
    a_lo = _tf32(a - a_hi)
    conv = lambda u, w: F.conv2d(u, w, padding=1)          # noqa: E731
    return conv(a_lo, w_hi) + conv(a_hi, w_lo) + conv(a_hi, w_hi)


def test_3xtf32_emulation_holds_the_f32_tolerance():
    """3xTF32 on the layout's hi and lo, both convolutions, lands within
    1e-4 * max(1, max|ref|) of the stem in float64 on a seeded 2 x 32 x 64
    frame; one TF32 product in conv1 does not."""
    x, w0, b0, w1, b1 = _inputs()
    ref = _stem_f64(x, w0, b0, w1, b1)
    x, w0, b0, w1, b1 = (t.float() for t in (x, w0, b0, w1, b1))
    packed = tstem.stem_weights(w0, b0, w1, b1, torch.float32)
    w_hi, w_lo = _w1_from_layout(packed.w1k, C0, C1)
    h0 = torch.relu(_conv3(x.permute(0, 3, 1, 2), *_w0_from_layout(packed.w0k, C0))
                    + b0[:, None, None])
    three = torch.relu(_conv3(h0, w_hi, w_lo) + b1[:, None, None])
    one = torch.relu(F.conv2d(_tf32(h0), w_hi, padding=1) + b1[:, None, None])
    tol = TOL * max(1.0, float(ref.abs().max()))
    err3 = float((three.double() - ref).abs().max())
    err1 = float((one.double() - ref).abs().max())
    print(f"3xTF32 emulation max|diff| {err3:.3g}, one TF32 product {err1:.3g}, "
          f"tolerance {tol:.3g} (max|ref| {float(ref.abs().max()):.4g})")
    assert err3 <= tol
    assert err1 > tol          # one TF32 product misses the f32 tolerance


def test_f32_entries_in_the_sources():
    """K1's float32 entry is a tensor-core kernel in TF32 (`wgmma`, operands
    rounded to nearest, ties away, by `tf32.cuh`); K3's float32 entry is its
    own symbol; both first versions, which `chip_smoke.py` times the
    redesigns against, are still declared; and no wrapper routes a type to a
    first version."""
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    from panoswintransformerobjectdetection_torch.ops import roi_align as ra
    stem_src = (cuda_build.CSRC_DIR / "stem_conv.cu").read_text()
    roi_src = (cuda_build.CSRC_DIR / "roi_align.cu").read_text()
    assert tstem.ENTRIES[torch.float32] == "stem_conv_f32_launch"
    assert ra.ENTRIES[torch.float32] == "roi_align_f32_launch"
    for src, module in ((stem_src, tstem), (roi_src, ra)):
        for symbol in (*module.ENTRIES.values(), module.FIRST_VERSION):
            assert f'extern "C" int {symbol}(' in src
        assert module.FIRST_VERSION not in module.ENTRIES.values()
    tf32 = stem_src[stem_src.index("namespace tf32 {"):stem_src.index("}  // namespace tf32")]
    assert "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32" in tf32
    # the rounding, the split and mma_tf32 come from the header that K2's
    # and K4's f32 entries share
    assert '#include "tf32.cuh"' in stem_src
    header = (cuda_build.CSRC_DIR / "tf32.cuh").read_text()
    assert "(bits + 0x1000u) & 0xffffe000u" in header
