"""The arithmetic of K2's and K4's float32 entries, on the CPU.

Both entries (`csrc/window_attention.cu` `window_attention_f32_launch`,
`csrc/dense_crop.cu` `dense_crop_f32_launch`) run their products on the
tensor cores in 3xTF32 (`csrc/tf32.cuh`): each operand split as a = hi +
lo, hi its TF32 rounding (to nearest, ties away) and lo that of a - hi, each
product taken as lo.hi + hi.lo + hi.hi with f32 sums.  The kernels need the
card (`tests/test_torch_kernels_cuda.py`); here K4's weights, which the
wrapper splits on the host (`roi_align.crop_f32_operands`), are checked
where the kernel's lanes read them, and both entries' arithmetic is
emulated in torch and held against float64 with the tolerances the card
holds the kernels to: K4 1e-5 * max(1, max|ref|) * sqrt(Hl), K2 1e-5 *
max(1, max|ref|).  A single TF32 product is emulated beside each, to show
why it is not enough.
"""

import numpy as np
import torch

from panoswintransformerobjectdetection_torch.ops import cuda_build
from panoswintransformerobjectdetection_torch.ops import fused_attention as tfa
from panoswintransformerobjectdetection_torch.ops import roi_align as tra
from panoswintransformerobjectdetection_torch.ops import stem_conv as tstem

O = 7             # K4's bins a side
RB = 18           # RoIs of a K4 block (`tf32::RB` in dense_crop.cu)


def _tf32(t):
    """float32 t rounded to TF32 by bit masking, to nearest with ties away
    from zero (`cvt.rna.tf32.f32`)."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(t):
    hi = _tf32(t)
    return hi, _tf32(t - hi)


def _crop_case(B=2, P=23, Hl=37, Wl=19, C=24, seed=21):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((B, Hl, Wl, C))).float(),
            torch.from_numpy(rng.standard_normal((B, P, O, Hl)) * 0.3).float(),
            torch.from_numpy(rng.standard_normal((B, P, O, Wl)) * 0.3).float())


def test_crop_f32_operands_where_the_lanes_read_them():
    """Wy (2, B, P, 7, Hp) and Wx (2, B, P, 7, Wl) from `crop_f32_operands`:
    hi has its low 13 mantissa bits zero, hi + lo gives w back within 2**-21
    |w|, Wy is zero past Hl, and gathering them with the kernel's own
    indexing (a block's RoIs p0 .., stage one's A fragment of lane (g, q)
    at rows 16m + g (+ 8), columns kk + q (+ 4); stage two's B fragment
    at (k = w q, n = x g)) returns every weight at its (RoI, bin, column)."""
    feat, Wy, Wx = _crop_case()
    B, P, _, Hl = Wy.shape
    Wl = Wx.shape[-1]
    tiles, wy, wx = tra.crop_f32_operands(feat, Wy, Wx)
    Hp = wy.shape[-1]
    assert tiles.shape == (B, 2, Hl, Wl, 16) and wy.shape == (2, B, P, O, Hp) and Hp % 4 == 0
    assert wx.shape == (2, B, P, O, Wl) and wy.is_contiguous() and wx.is_contiguous()
    for w, full in ((wy[..., :Hl], Wy), (wx, Wx)):
        hi, lo = w
        for half in (hi, lo):
            assert not (half.contiguous().view(torch.int32) & 0x1FFF).any()
        assert torch.equal(hi, _tf32(full)) and torch.equal(lo, _tf32(full - hi))
        assert ((hi + lo).double() - full.double()).abs().le(2.0 ** -21 * full.double().abs()).all()
    assert not wy[..., Hl:].any()
    flat_y, flat_x = wy.reshape(-1), wx.reshape(-1)
    lo_y, lo_x = B * P * O * Hp, B * P * O * Wl
    g, q = np.meshgrid(np.arange(8), np.arange(4), indexing="ij")
    for b in range(B):
        for p0 in range(0, P, RB):
            rows = min(RB, P - p0) * O
            wyb, wxb = (b * P + p0) * O * Hp, (b * P + p0) * O * Wl
            for m in range(8):                       # the M tile's 8 m16 tiles
                for kk in range(0, Hp, 8):
                    for dr, dk in ((0, 0), (8, 0), (0, 4), (8, 4)):   # a0 .. a3
                        r, h = 16 * m + g + dr, kk + q + dk
                        ok = torch.from_numpy(r < rows)
                        idx = torch.from_numpy(wyb + r * Hp + h).clamp(max=lo_y - 1)
                        for s, half in ((0, wy[0]), (1, wy[1])):
                            got = torch.where(ok, flat_y[idx + s * lo_y], 0.0)
                            rr = torch.from_numpy(np.minimum(r, rows - 1))
                            want = half[b, p0 + rr // O, rr % O, torch.from_numpy(h)]
                            assert torch.equal(got, torch.where(ok, want, 0.0))
            for j in range(rows):                    # stage two's tiles (RoI, bin) j
                for w0 in range(0, Wl, 8):
                    for dk in (0, 4):                # b0, b1
                        w = w0 + q + dk
                        ok = torch.from_numpy((g < O) & (w < Wl))
                        idx = torch.from_numpy(wxb + ((j // O) * O + g) * Wl + w)
                        idx = idx.clamp(max=lo_x - 1)
                        for s, half in ((0, wx[0]), (1, wx[1])):
                            got = torch.where(ok, flat_x[idx + s * lo_x], 0.0)
                            x = torch.from_numpy(np.minimum(g, O - 1))
                            want = half[b, p0 + j // O, x, torch.from_numpy(np.minimum(w, Wl - 1))]
                            assert torch.equal(got, torch.where(ok, want, 0.0))


def _mm3(a, b):
    """a @ b in 3xTF32: both split, lo.hi + hi.lo + hi.hi, each product of
    TF32 values exact in f32, f32 sums."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _mm1(a, b):
    return _tf32(a) @ _tf32(b)


def test_dense_crop_3xtf32_emulation_holds_the_f32_tolerance():
    """K4's two contractions in 3xTF32, Wy and Wx from the host split,
    t split as the kernel splits it from shared memory, land within 1e-5 *
    max(1, max|ref|) * sqrt(Hl) of float64 at a small level; one TF32
    product in each stage does not."""
    feat, Wy, Wx = _crop_case(B=1, P=30, Hl=96, Wl=24, C=32)
    _, wy, wx = tra.crop_f32_operands(feat, Wy, Wx)
    Hl = feat.shape[1]
    ref = tra.dense_crop_plain(feat.double(), Wy.double(), Wx.double())
    f = feat[0].reshape(Hl, -1)                          # (h, (w, c))
    wy_hi, wy_lo = wy[0, 0, ..., :Hl], wy[1, 0, ..., :Hl]
    f_hi, f_lo = _split(f)
    t = (wy_lo.reshape(-1, Hl) @ f_hi + wy_hi.reshape(-1, Hl) @ f_lo
         + wy_hi.reshape(-1, Hl) @ f_hi).reshape(30, O, 24, 32)          # (p, i, w, c)
    t_hi, t_lo = _split(t)
    wx_hi, wx_lo = wx[0, 0], wx[1, 0]                                    # (p, x, w)
    stage2 = lambda a, w: torch.einsum("pxw,piwc->pixc", w, a)          # noqa: E731
    three = stage2(t_lo, wx_hi) + stage2(t_hi, wx_lo) + stage2(t_hi, wx_hi)
    t1 = _mm1(Wy[0].reshape(-1, Hl), f).reshape(30, O, 24, 32)
    one = stage2(_tf32(t1), _tf32(Wx[0]))
    tol = 1e-5 * max(1.0, float(ref.abs().max())) * Hl ** 0.5
    err3 = float((three.double() - ref[0]).abs().max())
    err1 = float((one.double() - ref[0]).abs().max())
    print(f"K4 3xTF32 emulation max|diff| {err3:.3g}, one TF32 product {err1:.3g}, "
          f"tolerance {tol:.3g}")
    assert err3 <= tol
    assert err1 > tol          # one TF32 product misses the f32 tolerance


def test_window_attention_3xtf32_emulation_holds_the_f32_tolerance():
    """K2's two products in 3xTF32 at O 49, d 32 (the flagship's windows),
    with the first version's rounding places between them (scale, then the
    f32 bias, max, exp, IEEE e / sum), land within 1e-5 * max(1, max|ref|)
    of float64; one TF32 product in each does not."""
    rng = np.random.default_rng(22)
    n, h, nW, Ot, d = 6, 3, 3, 49, 32
    q, k, v = (torch.from_numpy(rng.standard_normal((n, h, Ot, d))).float() for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((nW, h, Ot, Ot))).float()
    scale = d ** -0.5
    ref = tfa.window_attention_plain(q.double(), k.double(), v.double(), bias.double(), scale)
    bias_n = bias.repeat(n // nW, 1, 1, 1)

    def attend(mm):
        s = mm(q, k.transpose(-1, -2)) * scale + bias_n
        e = torch.exp(s - s.amax(-1, keepdim=True))
        return mm(e / e.sum(-1, keepdim=True), v)

    three, one = attend(_mm3), attend(_mm1)
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    err3 = float((three.double() - ref).abs().max())
    err1 = float((one.double() - ref).abs().max())
    print(f"K2 3xTF32 emulation max|diff| {err3:.3g}, one TF32 product {err1:.3g}, "
          f"tolerance {tol:.3g}")
    assert err3 <= tol
    assert err1 > tol          # one TF32 product misses the f32 tolerance


def test_f32_entries_in_the_sources():
    """K2's and K4's float32 entries are their own symbols, tensor-core
    kernels in 3xTF32 from the shared header; their first versions, which
    `chip_smoke.py` times the redesigns against, are still declared and no
    wrapper routes a type to them; the header's helpers are defined once,
    and every source of an f32 entry includes it."""
    header = (cuda_build.CSRC_DIR / "tf32.cuh").read_text()
    assert "(bits + 0x1000u) & 0xffffe000u" in header
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in header
    assert tfa.ENTRIES[torch.float32] == "window_attention_f32_launch"
    assert tra.CROP_ENTRIES[torch.float32] == "dense_crop_f32_launch"
    for name, entries, first in (("window_attention", tfa.ENTRIES, tfa.FIRST_VERSION),
                                 ("dense_crop", tra.CROP_ENTRIES, tra.CROP_FIRST_VERSION),
                                 ("stem_conv", tstem.ENTRIES, tstem.FIRST_VERSION)):
        src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "tf32.cuh"' in src
        assert "rna_tf32(uint32_t" not in src and "void mma_tf32(" not in src
        for symbol in (*entries.values(), first):
            assert f'extern "C" int {symbol}(' in src
        assert first not in entries.values()
        f32 = src[src.index("namespace tf32 {"):src.index("}  // namespace tf32")]
        assert "mma_3xtf32(" in f32 or "mma_tf32(" in f32


def test_build_hashes_the_headers(tmp_path, monkeypatch):
    """A library's name carries a hash of its source and of every header
    under `csrc/`: editing `tf32.cuh` names new libraries for all sources."""
    for path in cuda_build.CSRC_DIR.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    before = {name: cuda_build._target(name) for name in cuda_build.SOURCES}
    header = tmp_path / "tf32.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: cuda_build._target(name) for name in cuda_build.SOURCES}
    assert all(before[n] != after[n] for n in cuda_build.SOURCES)
