"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain PyTorch twin, run the flagship detector in its
configurations, report.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. environment: the card's name and power limit; TF32 off for f32 checks;
  2. build every kernel from `panoswintransformerobjectdetection_torch/csrc`;
  3. each kernel against its twin at the flagship's shapes, f32 and bf16,
     with its device time (`time_ms`), the twin's and a library call's (K2 at
     all four stage shapes, each in the record's `stages`; K5's entry point
     checked at a small shape).  K1, K2 and K4 run bf16 on the tensor cores
     and f32 on the CUDA cores, K3 bf16 through vectorised gathers and f32
     one thread a channel; their first versions are timed at bf16 beside
     them (`previous_ms`), with each one's share of the bound, and K4 also
     on the dense route's own level-0 weights;
  4. small-input f32 checks of the card's path against the CPU path, plain
     and fused attention; then the flagship (PanoSwin-T Faster R-CNN, random
     weights from seed 0, BN folded, bf16) `simple_test` on 2 x 512 x 1024
     frames with PyTorch's TF32 defaults back: the plain and the fused-
     attention flagship alternate request by request, each request with the
     kernels' launch counts reset just before it and read just after; the
     two backbones' outputs are compared; one request of the planar
     configuration (`pano_mode=False`, fused attention); every fused
     request must launch K2's bf16 entry;
  5. training: the dense RoI route (K4 on every level) against the direct one
     (K3) on the card, values and map gradients; one `forward_train` +
     backward at 64 x 128 in f32 on the card against the CPU, same sampler
     noise, no DropPath: the five outputs and every parameter's gradient;
     then the flagship's training step at full width (bf16, AdamW, lr 1e-4,
     2 frames of 512 x 1024 with 32 boxes each): 1 warm-up and 5 timed
     steps on the direct route, one step on the dense route from the same
     weights and noise, one step with fused attention, each step with the
     launch counts reset just before it and read just after;
  6. a JSON line per kernel, then the result line.
Without a CUDA card it exits with an error and prints no result.
"""

import ctypes
import json
import statistics
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core rate, same source
BF16_ULPS = 4 * 2.0 ** -8       # bf16 tolerance: 4 units in the last place of max|ref|
SLEEP_CYCLES = 100_000_000      # about 50 ms of the card's clock: longer than the host takes
                                # to launch a timed batch
B, H, W = 2, 512, 1024
REQUESTS = 5
# K2 at the flagship's four stages, B = 2: (windows n = B * nW, heads, nW);
# O = 7 * 7 tokens, head width 32 at every stage.
ATTENTION_STAGES = ((1406, 3, 703), (380, 6, 190), (100, 12, 50), (30, 24, 15))
TOKENS, HEAD_DIM = 49, 32
K2_LAUNCHES_BY_STAGE = (2, 2, 6, 2)     # one launch per block
K2_PER_REQUEST = sum(K2_LAUNCHES_BY_STAGE)
TRAIN_STEPS = 5
TRAIN_ROIS = 128 + 512              # sampled RoIs an image: positives' cap + samples
# Feature maps of the four RoI levels as the dense route's kernel sees them:
# transposed, since the maps are wider than tall, so stage one contracts W.
CROP_LEVELS = ((W // 4, H // 4), (W // 8, H // 8), (W // 16, H // 16), (W // 32, H // 32))
F32_OPS_PER_S = 67e12               # f32 outside the tensor cores, same source
# Fused against plain backbone, bf16: the routes round differently (q scaled
# in bf16 or the f32 product scaled; softmax or e / sum), and each of the 12
# blocks carries the difference on: 16 bf16 units of max|ref|.
BACKBONE_TOL_UNITS = 16


def time_ms(fn, reps: int, batches: int = 5) -> float:
    """Device time of one call: the median over `batches` of the mean of
    `reps` back-to-back calls, CUDA events around them.  Each batch is
    queued behind a sleep on the card, so that the host's time to launch the
    calls (tens of microseconds for a small kernel) is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check(name, got, ref, tol):
    err = float((got.float() - ref.float()).abs().max())
    ok = err <= tol
    print(f"  {name}: max|diff| = {err:.3g}, tolerance {tol:.3g}: "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin ({err} > {tol})")
    return err


def rpn_like_rois(rng, n_per_image):
    """Proposals like the RPN's: sizes across all four levels, some crossing
    the border, some tiny, some elongated."""
    rois = []
    for b in range(B):
        kinds = rng.integers(0, 6, n_per_image)
        for kind in kinds:
            if kind == 0:
                w, h = rng.uniform(0.5, 8, 2)
            elif kind == 1:
                w, h = rng.uniform(150, 700), rng.uniform(6, 30)
            else:
                s = 56 * 2 ** (kind - 2) * rng.uniform(0.7, 1.8)
                r = rng.uniform(0.4, 2.5)
                w, h = s * np.sqrt(r), s / np.sqrt(r)
            x1 = rng.uniform(-0.1 * w, max(W - 0.9 * w, 1.0))
            y1 = rng.uniform(-0.1 * h, max(H - 0.9 * h, 1.0))
            rois.append([b, x1, y1, min(x1 + w, W), min(y1 + h, H)])
    return torch.tensor(np.asarray(rois, np.float32))


def previous_kernel(module, entry, argtypes):
    """The first version's CUDA-core entry, called directly at bf16 (dtype
    code 1) so that the redesign is timed against it in the same run; no
    wrapper calls it at bf16."""
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    fn = cuda_build.function(module, entry, argtypes)

    def launch(*args):
        cuda_build.check(fn(*args, 1, torch.cuda.current_stream().cuda_stream),
                         f"{entry} (first version, bf16)")
    return launch


def rates(ops, ms, bound):
    """'x TFLOP/s, y of the bound' for a kernel time."""
    return f"{ops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.3f} of the bound"


def kernel_k1(dev, stem):
    g = torch.Generator().manual_seed(1)
    c0, c1 = 32, 64
    x = torch.rand((B, H, W, 3), generator=g)
    w0 = torch.randn((c0, 3, 3, 3), generator=g) / 27 ** 0.5
    w1 = torch.randn((c1, c0, 3, 3), generator=g) / (9 * c0) ** 0.5
    b0 = torch.randn(c0, generator=g) * 0.1
    b1 = torch.randn(c1, generator=g) * 0.1
    rec = {}
    for dt in (torch.float32, torch.bfloat16):
        args = [x.to(dt).to(dev)] + [t.to(dev) for t in (w0, b0, w1, b1)]
        packed = stem.stem_weights(*args[1:], dt)
        got = stem.stem_conv(args[0], packed)
        ref = stem.stem_conv_plain(*args)
        torch.cuda.synchronize()
        scale = float(ref.float().abs().max())
        tol = 1e-4 * max(1.0, scale) if dt == torch.float32 else BF16_ULPS * scale
        err = check(f"K1 stem_conv {str(dt)[6:]} (2,512,1024,3) c0 32 c1 64, entry "
                    f"{stem.stem_conv.last_entry}", got, ref, tol)
        if dt == torch.bfloat16:
            xn = args[0].permute(0, 3, 1, 2).contiguous()
            w0b, w1b = w0.to(dt).to(dev), w1.to(dt).to(dev)
            b0b, b1b = b0.to(dt).to(dev), b1.to(dt).to(dev)
            conv = torch.nn.functional.conv2d

            def library():
                h0 = torch.relu(conv(xn, w0b, b0b, padding=1))
                return torch.relu(conv(h0, w1b, b1b, padding=1))

            w0k, w1k = stem.cuda_core_layout(args[1], args[3], dt)
            previous = previous_kernel("stem_conv", stem.ENTRIES[torch.float32],
                                       stem.LAUNCH_ARGTYPES)
            prev_out = torch.empty_like(got)

            def first_version():
                previous(args[0].data_ptr(), w0k.data_ptr(), packed.b0.data_ptr(),
                         w1k.data_ptr(), packed.b1.data_ptr(), prev_out.data_ptr(), B, H, W,
                         c0, c1, w1k.shape[2])

            ms = time_ms(lambda: stem.stem_conv(args[0], packed), 20)
            previous_ms = time_ms(first_version, 20)
            check("K1 first version (CUDA cores) bf16, against the twin", prev_out, ref, tol)
            plain_ms = time_ms(lambda: stem.stem_conv_plain(*args), 5)
            library_ms = time_ms(library, 20)
            nbytes = (x.numel() + B * c1 * H * W) * 2
            ops = 2 * B * H * W * (27 * c0 + 9 * c0 * c1)
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
            rec = {"name": "stem_conv (K1)", "route": "cuda",
                   "source": "panoswintransformerobjectdetection_torch/csrc/stem_conv.cu",
                   "replaces": "panoswintransformerobjectdetection_tpu/ops/stem_conv.py:61",
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
                   else "operations", "library_ms": library_ms, "previous_ms": previous_ms}
            print(f"  K1 bf16: tensor-core kernel {ms:.4f} ms ({rates(ops, ms, bound)}), first "
                  f"version {previous_ms:.4f} ms ({rates(ops, previous_ms, bound)}), twin "
                  f"{plain_ms:.4f} ms, two-conv2d chain {library_ms:.4f} ms, bound "
                  f"{bound:.4f} ms ({rec['bound_by']})")
    return rec


def kernel_k3(dev, ra):
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    rng = np.random.default_rng(2)
    C = 256
    rois = rpn_like_rois(rng, 1000).to(dev)
    base = [torch.from_numpy(rng.standard_normal((B, H // s, W // s, C)).astype(np.float32))
            for s in (4, 8, 16, 32)]
    strides = (4, 8, 16, 32)
    previous = cuda_build.function("roi_align", ra.ENTRIES[torch.float32], ra.LAUNCH_ARGTYPES)
    rec = {}
    for dt in (torch.float32, torch.bfloat16):
        feats = [f.to(dt).to(dev) for f in base]
        got = ra.roi_align(feats, rois, strides)
        ref = ra.roi_align_plain(feats, rois, strides)
        torch.cuda.synchronize()
        # same operations in the same order as the twin: exact
        err = check(f"K3 roi_align {str(dt)[6:]} 4 levels C 256, 2 x 1000 RoIs, entry "
                    f"{ra.roi_align.last_entry}", got, ref, 0.0)
        if dt == torch.bfloat16:
            levels = ra.level_struct(feats, strides)
            prev_out = torch.empty_like(got)

            def first_version():
                # the first version's entry at dtype code 1 (bfloat16); no wrapper calls it so
                cuda_build.check(previous(ctypes.byref(levels), rois.data_ptr(),
                                          prev_out.data_ptr(), rois.shape[0], B, C, 1, 1,
                                          float(ra.FINEST_SCALE),
                                          torch.cuda.current_stream().cuda_stream),
                                 "roi_align_launch (first version, bf16)")

            ms = time_ms(lambda: ra.roi_align(feats, rois, strides), 20)
            previous_ms = time_ms(first_version, 20)
            check("K3 first version bf16, against the twin", prev_out, ref, 0.0)
            plain_ms = time_ms(lambda: ra.roi_align_plain(feats, rois, strides), 3)
            # the bytes this run's RoIs need: each feature row that some tap
            # with a nonzero weight reads, once; the rois; the output
            rows, w1, w2 = ra.tap_rows(feats, rois, strides)
            need = (w1[:, :, :, None, None] != 0) & (w2[:, None, None] != 0)
            nbytes = (torch.unique(rows[need]).numel() * C * 2 + rois.numel() * 4
                      + got.numel() * 2)
            ops = rois.shape[0] * 49 * C * (16 + 4) * 2
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
            rec = {"name": "roi_align (K3)", "route": "cuda",
                   "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
                   "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align_pallas.py:205",
                   "entry": ra.roi_align.last_entry, "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
                   else "operations", "library_ms": None, "previous_ms": previous_ms}
    print(f"  K3 bf16: vectorised kernel {rec['ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.3f} "
          f"of the bound), first version {rec['previous_ms']:.4f} ms "
          f"({rec['bound_ms'] / rec['previous_ms']:.3f}), twin {rec['plain_ms']:.3f} ms, no "
          f"single PyTorch call computes it, bound {rec['bound_ms']:.4f} ms")
    return rec


def attention_inputs(dev, dtype, n, h, nW, seed):
    """q, k, v as views of an (n, O, 3, h, d) projection, as the model
    passes them, and an f32 bias (nW, h, O, O)."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((n, TOKENS, 3, h, HEAD_DIM), generator=g).to(dtype).to(dev)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    return q, k, v, torch.randn((nW, h, TOKENS, TOKENS), generator=g).to(dev)


def attention_tol(ref, dtype):
    scale = float(ref.float().abs().max())
    return 1e-5 * max(1.0, scale) if dtype == torch.float32 else BF16_ULPS * scale


def attention_times(fa, entry, q, k, v, bias):
    """(kernel ms, first version ms, twin ms, SDPA ms, bound ms, bound_by)
    in bf16.  SDPA gets 4-D (n, h, O, d) views and the bias cast to bf16 and
    repeated over the batch outside the timing (a 4-D mask cannot repeat
    every nW windows as a view): the port never calls it."""
    n, h, O, d = q.shape
    nW = bias.shape[0]
    scale = d ** -0.5
    mask = bias.to(q.dtype).expand(n // nW, nW, h, O, O).reshape(n, h, O, O)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    previous = previous_kernel("window_attention", fa.ENTRIES[torch.float32],
                               fa.LAUNCH_ARGTYPES)
    out = torch.empty((n, O, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = fa.launch_strides(q, k, v, bias, out)

    def first_version():
        previous(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 strides, n, h, O, d, nW, float(scale))

    ms = time_ms(lambda: entry(q, k, v, bias, scale), 20)
    previous_ms = time_ms(first_version, 20)
    ref = fa.window_attention_plain(q, k, v, bias, scale)
    check(f"K2 first version (CUDA cores) bf16 n {n} h {h}, against the twin", out, ref,
          attention_tol(ref, q.dtype))
    plain_ms = time_ms(lambda: fa.window_attention_plain(q, k, v, bias, scale), 10)
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), 20)
    nbytes = 4 * q.numel() * q.element_size() + bias.numel() * 4
    ops = 4 * n * h * O * O * d
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    return ms, previous_ms, plain_ms, library_ms, bound, "bytes" if by_bytes else "operations"


def kernel_k2(dev, fa):
    """K2 at the flagship's four stage shapes; the record's top-level times
    are stage 0's, every stage's are in `stages`."""
    stages = []
    for stage, (n, h, nW) in enumerate(ATTENTION_STAGES):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, bias = attention_inputs(dev, dt, n, h, nW, 4 + stage)
            got = fa.packed_window_attention(q, k, v, bias, HEAD_DIM ** -0.5)
            ref = fa.window_attention_plain(q, k, v, bias, HEAD_DIM ** -0.5)
            torch.cuda.synchronize()
            err = check(f"K2 window_attention {str(dt)[6:]} stage {stage} (n {n}, h {h}, "
                        f"O {TOKENS}, d {HEAD_DIM}, nW {nW}), entry "
                        f"{fa.window_attention.last_entry}", got, ref, attention_tol(ref, dt))
            if dt != torch.bfloat16:
                continue
            ms, previous_ms, plain_ms, library_ms, bound, by = attention_times(
                fa, fa.packed_window_attention, q, k, v, bias)
            print(f"  K2 bf16 stage {stage}: tensor-core kernel {ms:.4f} ms ({bound / ms:.3f} of "
                  f"the bound), first version {previous_ms:.4f} ms ({bound / previous_ms:.3f}), "
                  f"twin {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            stages.append({"stage": stage, "n": n, "heads": h, "nW": nW,
                           "entry": fa.window_attention.last_entry, "max_abs_err": err,
                           "ms": ms, "previous_ms": previous_ms, "plain_ms": plain_ms,
                           "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
                           "share_of_bound": bound / ms,
                           "launches_per_fused_request": K2_LAUNCHES_BY_STAGE[stage]})
    top = {key: stages[0][key] for key in ("entry", "ms", "previous_ms", "plain_ms",
                                           "library_ms", "bound_ms", "bound_by")}
    return {"name": "window_attention (K2)", "route": "cuda",
            "source": "panoswintransformerobjectdetection_torch/csrc/window_attention.cu",
            "replaces": "panoswintransformerobjectdetection_tpu/ops/fused_attention.py:88",
            "max_abs_err": max(st["max_abs_err"] for st in stages), **top, "stages": stages}


def kernel_k5(dev, fa):
    """K5's entry point (`fused_window_attention`) runs K2's kernel: checked
    at a small shape with an odd window count, timed at stage 0."""
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, bias = attention_inputs(dev, dt, 10, 3, 5, 8)
        got = fa.fused_window_attention(q, k, v, bias, HEAD_DIM ** -0.5)
        ref = fa.window_attention_plain(q, k, v, bias, HEAD_DIM ** -0.5)
        torch.cuda.synchronize()
        err = max(err, check(f"K5 fused_window_attention {str(dt)[6:]} (n 10, h 3, O 49, "
                             f"d 32, nW 5), entry {fa.window_attention.last_entry}", got, ref,
                             attention_tol(ref, dt)))
    n, h, nW = ATTENTION_STAGES[0]
    ms, previous_ms, plain_ms, library_ms, bound, by = attention_times(
        fa, fa.fused_window_attention, *attention_inputs(dev, torch.bfloat16, n, h, nW, 4))
    entry = fa.window_attention.last_entry
    print(f"  K5 bf16 stage 0 ({entry}): kernel {ms:.4f} ms, first version {previous_ms:.4f} "
          f"ms, twin {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "fused_window_attention (K5)", "route": "cuda",
            "source": "panoswintransformerobjectdetection_torch/csrc/window_attention.cu",
            "replaces": "panoswintransformerobjectdetection_tpu/ops/fused_attention.py:27",
            "shares_kernel_of": "window_attention (K2)", "entry": entry, "max_abs_err": err,
            "ms": ms, "previous_ms": previous_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


def crop_times(ra, args, previous):
    """(kernel ms, first version ms, einsum pair ms) of K4 on bf16 (feat, Wy,
    Wx); the pair is cuBLAS's, t written to and read from device memory."""
    feat, Wy, Wx = args
    Bc, Hl, Wl, C = feat.shape
    P = Wy.shape[1]
    out = torch.empty((Bc, P, 7, 7, C), dtype=feat.dtype, device=feat.device)

    def first_version():
        previous(feat.data_ptr(), Wy.data_ptr(), Wx.data_ptr(), out.data_ptr(), Bc, P, Hl, Wl,
                 C, 7)

    def library():
        t = torch.einsum("bpoh,bhwc->bpowc", Wy, feat)
        return torch.einsum("bpxw,bpowc->bpoxc", Wx, t)

    return (time_ms(lambda: ra.dense_crop(*args), 10), time_ms(first_version, 10),
            time_ms(library, 10))


def kernel_k4(dev, ra):
    """K4 against its twin at the four levels of the flagship's training
    step (B 2, P 640, o 7, C 256), random weights.  Tolerance: f32 1e-5 *
    max(1, max|ref|) * sqrt(Hl) (sums of Hl products in another order than
    cuBLAS takes them); bf16 2 units of 2**-8 * max|ref| (one flip in the
    stage-one rounding, one in the result).  Then level 0 on the dense
    route's own weights for 2 x 640 RoIs like the RPN's."""
    C, P = 256, TRAIN_ROIS
    previous = previous_kernel("dense_crop", ra.CROP_ENTRIES[torch.float32], ra.CROP_ARGTYPES)
    rec = {}
    for level, (Hl, Wl) in enumerate(CROP_LEVELS):
        g = torch.Generator().manual_seed(20 + level)
        feat = torch.randn((B, Hl, Wl, C), generator=g)
        Wy = torch.randn((B, P, 7, Hl), generator=g) * 0.3
        Wx = torch.randn((B, P, 7, Wl), generator=g) * 0.3
        for dt in (torch.float32, torch.bfloat16):
            args = [t.to(dt).to(dev) for t in (feat, Wy, Wx)]
            got = ra.dense_crop(*args)
            ref = ra.dense_crop_plain(*args)
            torch.cuda.synchronize()
            scale = float(ref.float().abs().max())
            tol = 1e-5 * max(1.0, scale) * Hl ** 0.5 if dt == torch.float32 else \
                2 * 2.0 ** -8 * scale
            err = check(f"K4 dense_crop {str(dt)[6:]} level {level} (B {B}, P {P}, Hl {Hl}, "
                        f"Wl {Wl}, C {C}), entry {ra.dense_crop.last_entry}", got, ref, tol)
            del got, ref
            if dt != torch.bfloat16:
                continue
            ms, previous_ms, library_ms = crop_times(ra, args, previous)
            plain_ms = time_ms(lambda: ra.dense_crop_plain(*args), 3)
            nbytes = 2 * (sum(a.numel() for a in args) + B * P * 49 * C)
            ops = 2 * B * P * 7 * Hl * Wl * C + 2 * B * P * 49 * Wl * C
            by_bytes = nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
            print(f"  K4 bf16 level {level}: tensor-core kernel {ms:.4f} ms "
                  f"({rates(ops, ms, bound)}), first version {previous_ms:.4f} ms "
                  f"({rates(ops, previous_ms, bound)}), twin {plain_ms:.4f} ms, bf16 einsum "
                  f"pair {library_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'bytes' if by_bytes else 'operations'})")
            if level == 0:
                rec = {"name": "dense_crop (K4)", "route": "cuda",
                       "source": "panoswintransformerobjectdetection_torch/csrc/dense_crop.cu",
                       "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align_pallas.py:52",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "bytes" if by_bytes else "operations",
                       "library_ms": library_ms, "previous_ms": previous_ms}
        del args

    # level 0 as the dense route calls it: every RoI, Wy zero for the RoIs of
    # other levels (the maps are wider than tall, so transposed first)
    rng = np.random.default_rng(41)
    rois = rpn_like_rois(rng, TRAIN_ROIS).to(dev)[:, [0, 2, 1, 4, 3]]
    maps = [torch.from_numpy(rng.standard_normal((B, W // s, H // s, C)).astype(np.float32))
            .bfloat16().to(dev) for s in (4, 8, 16, 32)]
    args = [t.contiguous() for t in ra.dense_level_operands(maps, rois)[0]]
    routed = int((args[1] != 0).any(dim=3).any(dim=2).sum())
    got, ref = ra.dense_crop(*args), ra.dense_crop_plain(*args)
    check("K4 dense_crop bf16 level 0, the dense route's weights", got, ref,
          2 * 2.0 ** -8 * float(ref.float().abs().max()))
    ms, previous_ms, library_ms = crop_times(ra, args, previous)
    print(f"  K4 bf16 level 0 on the dense route's weights ({routed} of {B} x {TRAIN_ROIS} "
          f"RoIs routed here, Wy zero for the rest): tensor-core kernel {ms:.4f} ms, first "
          f"version {previous_ms:.4f} ms, bf16 einsum pair {library_ms:.4f} ms")
    return rec


def level_maps(rng, dev, dt, C=256):
    return [torch.from_numpy(rng.standard_normal((B, H // s, W // s, C)).astype(np.float32))
            .to(dt).to(dev) for s in (4, 8, 16, 32)]


def kernel_k3_backward(dev, ra):
    """K3's backward against autograd through the twin on 2 x 48 RoIs, then
    timed at the training step's 2 x 640.  Tolerance: f32 1e-5 * max(1,
    max|ref|) (atomic adds in any order); bf16 2 units of 2**-8 * max|ref|
    (the f32 sum is rounded once, after adds in another order)."""
    strides = (4, 8, 16, 32)
    C = 256
    shapes = [(B, H // s, W // s, C) for s in strides]
    rec = {}
    for dt in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(30)
        rois = rpn_like_rois(rng, 48).to(dev)
        cot = torch.from_numpy(rng.standard_normal((rois.shape[0], 7, 7, C)).astype(np.float32))
        cot = cot.to(dt).to(dev)
        got = ra.roi_align_backward(cot, rois, shapes, dt, strides)
        ref = ra.roi_align_backward_plain(cot, rois, shapes, dt, strides)
        torch.cuda.synchronize()
        err = 0.0
        for level, (a, b) in enumerate(zip(got, ref)):
            scale = float(b.float().abs().max())
            tol = 1e-5 * max(1.0, scale) if dt == torch.float32 else 2 * 2.0 ** -8 * scale
            err = max(err, check(f"K3 backward {str(dt)[6:]} level {level}, 2 x 48 RoIs "
                                 f"(max|ref| {scale:.3f})", a, b, tol))
        del got, ref
        if dt != torch.bfloat16:
            continue
        rois = rpn_like_rois(rng, TRAIN_ROIS).to(dev)
        cot = torch.randn((rois.shape[0], 7, 7, C), device=dev).to(dt)
        ms = time_ms(lambda: ra.roi_align_backward(cot, rois, shapes, dt, strides), 20)
        plain_ms = time_ms(lambda: ra.roi_align_backward_plain(cot, rois, shapes, dt, strides), 2)
        nbytes = 2 * (cot.numel() + sum(int(np.prod(s)) for s in shapes)) + rois.numel() * 4
        ops = rois.shape[0] * 49 * C * (16 + 4) * 2
        bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
        rec = {"name": "roi_align_backward (K3 backward)", "route": "cuda",
               "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
               "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align.py:356",
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
               "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
               else "operations", "library_ms": None}
        print(f"  K3 backward bf16, 2 x {TRAIN_ROIS} RoIs: kernel with zeroing and cast "
              f"{ms:.4f} ms, autograd through the twin {plain_ms:.4f} ms, no single PyTorch "
              f"call computes it, bound {bound:.4f} ms")
    return rec


def dense_against_direct(dev, ra):
    """The two RoI routes on the card, 2 x 640 RoIs on the flagship's maps:
    values and map gradients.  Tolerance: f32 1e-4 * max(1, max|ref|) (the
    dense route sums with fused multiply-adds and adds its zeros); bf16 2
    units of 2**-8 * max|ref| for values and 4 for gradients (flips of the
    stage-one rounding, forward and backward)."""
    strides = (4, 8, 16, 32)
    for dt in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(40)
        rois = rpn_like_rois(rng, TRAIN_ROIS).to(dev)
        base = level_maps(rng, dev, dt)
        cot = torch.randn((rois.shape[0], 7, 7, 256), device=dev).to(dt)
        outs, grads = [], []
        for fn in (ra.roi_align, ra.multilevel_roi_align_dense):
            feats = [f.clone().requires_grad_() for f in base]
            out = fn(feats, rois, strides)
            out.backward(cot)
            outs.append(out.detach())
            grads.append([f.grad for f in feats])
        torch.cuda.synchronize()
        unit = 1e-4 if dt == torch.float32 else 2.0 ** -8
        scale = float(outs[0].float().abs().max())
        check(f"dense vs direct RoIAlign {str(dt)[6:]}, values", outs[1], outs[0],
              unit * max(1.0, scale) if dt == torch.float32 else 2 * unit * scale)
        for level, (a, b) in enumerate(zip(grads[1], grads[0])):
            scale = float(b.float().abs().max())
            check(f"dense vs direct RoIAlign {str(dt)[6:]}, gradient of level {level}", a, b,
                  unit * max(1.0, scale) if dt == torch.float32 else 4 * unit * scale)


def train_reference_check(dev, build_flagship, flagship_train_batch):
    """64 x 128, f32, TF32 off: one `forward_train` + backward on the card
    (kernels) against the CPU (twins), same weights, same sampler noise (one
    CPU generator seed), no DropPath.  Tolerance: outputs 1e-4 relative;
    each parameter's gradient 1e-5 + 2e-3 * max|g| (f32 sums in another
    order through every layer, and cuDNN's and cuBLAS's own algorithms)."""
    grads, outs = {}, {}
    for where in (dev, torch.device("cpu")):
        model = build_flagship(device=where, seed=1, train=True, drop_path_rate=0.0)
        batch = flagship_train_batch(1, where, seed=3, height=64, width=128, num_gt=4)
        batch["gt_boxes"] = torch.tensor([[[4., 2., 44., 34.], [30., 10., 70., 42.],
                                           [60., 20., 100., 52.], [84., 30., 124., 62.]]],
                                         device=where)
        out = model.forward_train(**batch, generator=torch.Generator().manual_seed(5))
        sum(v for k, v in out.items() if "loss" in k).backward()
        outs[where.type] = {k: float(v.detach()) for k, v in out.items()}
        grads[where.type] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    for k, ref in outs["cpu"].items():
        got = outs["cuda"][k]
        ok = abs(got - ref) <= 1e-4 * max(1.0, abs(ref))
        print(f"  forward_train f32 64x128 {k}: card {got:.7f}, CPU {ref:.7f}: "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"forward_train {k}: card {got} against CPU {ref}")
    worst = (0.0, "")
    for name, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        err = float((grads["cuda"][name] - ref).abs().max())
        if scale > 1e-4:        # a conv bias before a BatchNorm has gradient 0 but for noise
            worst = max(worst, (err / scale, name))
        if not err <= 1e-5 + 2e-3 * scale:
            raise AssertionError(f"gradient of {name}: card against CPU {err}, max|g| {scale}")
    print(f"  gradients of {len(grads['cpu'])} parameters, card vs CPU: all within 1e-5 + "
          f"2e-3 * max|g|; worst, among those with max|g| > 1e-4, {worst[0]:.3g} of max|g| "
          f"({worst[1]}): ok")


def train_step_counted(step, batch, counters, **noise):
    """One synchronised training step: (metrics as floats, seconds, launches)."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch, **noise)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()) or not metrics["grad_norm"] > 0:
        raise AssertionError(f"training step: a loss or the gradient norm is not finite: "
                             f"{metrics}")
    return metrics, seconds, {name: fn.launches for name, fn in counters.items()}


def seeded_noise(model, seed):
    """Sampler noise and DropPath masks from CPU generators of `seed`, so that
    two models get the same draws."""
    model.backbone.set_drop_path_generator(torch.Generator().manual_seed(seed + 1))
    return {"generator": torch.Generator().manual_seed(seed)}


def training_path(dev, ident, build_flagship, flagship_train_batch, counters):
    """The flagship's training step at full width; returns launches per
    kernel over the steps that count for it."""
    from panoswintransformerobjectdetection_torch.runtime.optim import make_optimizer
    from panoswintransformerobjectdetection_torch.runtime.train import make_train_step

    def trainer(**options):
        model = build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0, train=True,
                               **options)
        optimizer, scheduler = make_optimizer(model, base_lr=1e-4)
        return model, make_train_step(model, optimizer, scheduler)

    zero = {name: 0 for name in counters}
    k3 = {"roi_align (K3)": 1, "roi_align_backward (K3 backward)": 1}
    batch = flagship_train_batch(B, dev)
    torch.cuda.reset_peak_memory_stats()
    model, step = trainer()
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    first, _, counts = train_step_counted(step, batch, counters, **seeded_noise(model, 50))
    expect_launches(counts, {**zero, **k3}, "training step, direct route")
    model.backbone.set_drop_path_generator(None)
    gen = torch.Generator(device=dev).manual_seed(51)
    times, total = [], dict(zero)
    for _ in range(TRAIN_STEPS):
        metrics, sec, counts = train_step_counted(step, batch, counters, generator=gen)
        expect_launches(counts, {**zero, **k3}, "training step, direct route")
        times.append(sec)
        for c, v in counts.items():
            total[c] += v
    bad = [n for n, p in model.named_parameters() if p.grad is None
           or not torch.isfinite(p.grad).all()]
    after = model.state_dict()
    still = [n for n, p in model.named_parameters() if torch.equal(before[n], after[n])]
    stats = [n for n in before if "running_" in n and torch.equal(before[n], after[n])]
    if bad or still or stats:
        raise AssertionError(f"training: gradients missing or not finite {bad[:5]}, parameters "
                             f"that did not move {still[:5]}, statistics that did not move "
                             f"{stats}")
    med = statistics.median(times)
    print(f"    direct route (K3 forward and backward): {TRAIN_STEPS} steps of {B} frames after "
          f"1 warm-up: ms {[round(t * 1e3, 3) for t in times]}, median {med * 1e3:.3f} ms, "
          f"{B / med:.3f} images/s; last step {metrics}; every gradient finite, every "
          f"parameter and running statistic moved; launches over the {TRAIN_STEPS} steps "
          f"{total}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"card {ident}")
    del model, step, before, after

    # dense route: the same weights, batch, noise and DropPath masks as the
    # direct route's first step.  bf16: the routes' RoI features differ by
    # rounding flips, which the heads' losses see: 2% of each loss and of the
    # gradient norm, 0.01 of the accuracy.
    model, step = trainer(roi_align="dense")
    dense, sec, counts = train_step_counted(step, batch, counters, **seeded_noise(model, 50))
    expect_launches(counts, {**zero, "dense_crop (K4)": 4}, "training step, dense route")
    total["dense_crop (K4)"] = counts["dense_crop (K4)"]
    for k, ref in first.items():
        ok = abs(dense[k] - ref) <= (0.01 if k == "acc" else 0.02 * max(abs(ref), 1e-3))
        print(f"    dense route (K4 x 4) {k}: {dense[k]:.6f}, direct {ref:.6f}: "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"dense training step: {k} {dense[k]} against {ref}")
    print(f"    dense route: one step {sec * 1e3:.3f} ms (its first), launches {counts}")
    del model, step

    model, step = trainer(fused_attention=True)
    fused, sec, counts = train_step_counted(step, batch, counters, **seeded_noise(model, 50))
    expect_launches(counts, {**zero, **k3, "window_attention (K2)": K2_PER_REQUEST},
                    "training step, fused attention")
    print(f"    fused attention (K2 forward, backward through its twin): one step "
          f"{sec * 1e3:.3f} ms (its first), loss {fused['loss']:.6f} (plain {first['loss']:.6f}), "
          f"launches {counts}")
    return total


def reference_check(dev, build_flagship, **config):
    """Small input, f32: the card's path (kernels) against the CPU path
    (twins) of the same model, stage by stage."""
    x = torch.rand((1, 64, 128, 3), generator=torch.Generator().manual_seed(3))
    shapes = torch.tensor([[64.0, 128.0]])
    gpu = build_flagship(device=dev, seed=1, **config)
    cpu = build_flagship(device="cpu", seed=1, **config)
    with torch.no_grad():
        fg = gpu.extract_feat(x.to(dev))
        fc = cpu.extract_feat(x)
        for i, (a, b) in enumerate(zip(fg, fc)):
            tol = 1e-3 * max(1.0, float(b.abs().max()))
            check(f"flagship {config or ''} f32 64x128 FPN level {i}, card vs CPU", a.cpu(), b,
                  tol)
        rois = cpu.rois(cpu.proposals(fc, shapes))
        rg = gpu.roi_features([f.to(dev) for f in fc], rois.to(dev))
        rc = cpu.roi_features(fc, rois)
        check("flagship f32 RoI features, card vs CPU", rg.cpu(), rc, 1e-5)
        cg, _ = gpu.roi_head.bbox_head(rc.to(dev))
        cc, _ = cpu.roi_head.bbox_head(rc)
        check("flagship f32 class logits, card vs CPU", cg.cpu(), cc,
              1e-3 * max(1.0, float(cc.abs().max())))


def check_detections(det, what):
    K = det.mask.shape[1]
    for t, shape in ((det.boxes, (B, K, 4)), (det.scores, (B, K)), (det.labels, (B, K)),
                     (det.mask, (B, K))):
        if tuple(t.shape) != shape:
            raise AssertionError(f"{what}: DetResult field has shape {tuple(t.shape)}, "
                                 f"not {shape}")
    m = det.mask
    if not (m.any() and torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()
            and ((det.labels[m] >= 0) & (det.labels[m] < 5)).all()
            and ((det.scores[m] > 0.05) & (det.scores[m] <= 1)).all()):
        raise AssertionError(f"{what}: detections are empty, not finite or out of range")
    return int(m.sum())


def timed_request(model, inputs, counters):
    """One synchronised `simple_test`: (DetResult, seconds, launches), with
    every kernel's count set to 0 just before and read just after."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det = model.simple_test(*inputs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return det, seconds, {name: fn.launches for name, fn in counters.items()}


def expect_launches(launches, expected, what):
    """`expected`: kernel -> exact count per request, or None for "at least once"."""
    for name, want in expected.items():
        got = launches[name]
        if (want is None and got == 0) or (want is not None and got != want):
            raise AssertionError(f"{what}: {name} launched {got} times in a request, "
                                 f"expected {'at least 1' if want is None else want}")


def expect_k2_entry(fa, what):
    """A bf16 request's K2 launches went through the tensor-core entry."""
    got = fa.window_attention.last_entry
    if got != fa.ENTRIES[torch.bfloat16]:
        raise AssertionError(f"{what}: K2 launched {got}, not {fa.ENTRIES[torch.bfloat16]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from panoswintransformerobjectdetection_torch.device import gpu_identity
    from panoswintransformerobjectdetection_torch.flagship import (build_flagship,
                                                                   flagship_inputs,
                                                                   flagship_train_batch)
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    from panoswintransformerobjectdetection_torch.ops import fused_attention as fa
    from panoswintransformerobjectdetection_torch.ops import roi_align as ra
    from panoswintransformerobjectdetection_torch.ops import stem_conv as stem

    ident = gpu_identity()
    dev = torch.device("cuda")
    print(f"[1] card: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {ident}")
    tf32_defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("    TF32 is off for cuDNN convolutions and matmuls in phases 3 and 4's checks")

    seconds = cuda_build.build_all()
    print(f"[2] built {', '.join(cuda_build.SOURCES)} for sm_90a in {seconds:.1f} s")
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print("[3] kernels against their twins at the flagship's shapes.  K1 tolerance: f32 "
          "1e-4 * max(1, max|ref|) (sums in another order); bf16 4 units of 2**-8 * "
          "max|ref| (another f32 sum order can flip the bf16 rounding of an h0 value, "
          "and h1's own rounding adds one).  K3 tolerance 0: kernel and twin do the "
          "same operations in the same order.  K2 and K5: f32 1e-5 * max(1, max|ref|); "
          "bf16 4 units of 2**-8 * max|ref| (another sum order can flip the bf16 "
          "rounding of p, which moves an output by about one unit)")
    records = [kernel_k1(dev, stem), kernel_k2(dev, fa), kernel_k3(dev, ra),
               kernel_k5(dev, fa), kernel_k4(dev, ra), kernel_k3_backward(dev, ra)]
    dense_against_direct(dev, ra)

    print("[4] flagship simple_test, bf16, BN folded, random weights (seed 0); before it "
          "the f32 checks of the card's path against the CPU's, training included")
    reference_check(dev, build_flagship)
    reference_check(dev, build_flagship, fused_attention=True)
    train_reference_check(dev, build_flagship, flagship_train_batch)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    print(f"    timed requests with PyTorch's TF32 defaults: cuDNN {tf32_defaults[0]}, "
          f"matmul {tf32_defaults[1]}")
    counters = {"stem_conv (K1)": stem.stem_conv, "roi_align (K3)": ra.roi_align,
                "window_attention (K2)": fa.window_attention,
                "dense_crop (K4)": ra.dense_crop,
                "roi_align_backward (K3 backward)": ra.roi_align_backward}
    inputs = flagship_inputs(B, dev)
    models = {"plain": build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0),
              "fused": build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0,
                                      fused_attention=True)}
    inference = {"stem_conv (K1)": None, "roi_align (K3)": None, "dense_crop (K4)": 0,
                 "roi_align_backward (K3 backward)": 0}
    expected = {"plain": {**inference, "window_attention (K2)": 0},
                "fused": {**inference, "window_attention (K2)": K2_PER_REQUEST}}
    with torch.no_grad():
        feats = {name: m.backbone(inputs[0]) for name, m in models.items()}
    for i, (a, b) in enumerate(zip(feats["fused"], feats["plain"])):
        scale = float(b.abs().max())
        check(f"fused vs plain backbone, bf16, stage {i} (max|ref| {scale:.3f})", a, b,
              BACKBONE_TOL_UNITS * 2.0 ** -8 * scale)
    for model in models.values():
        model.simple_test(*inputs)                                 # warm-up
    latencies = {name: [] for name in models}
    launches = {name: {c: 0 for c in counters} for name in models}
    dets = {}
    for _ in range(REQUESTS):
        for name, model in models.items():
            fa.window_attention.last_entry = None
            dets[name], sec, counts = timed_request(model, inputs, counters)
            expect_launches(counts, expected[name], f"{name} flagship")
            if name == "fused":
                expect_k2_entry(fa, "fused flagship")
            latencies[name].append(sec)
            for c, v in counts.items():
                launches[name][c] += v
    for name in models:
        found = check_detections(dets[name], f"{name} flagship")
        med = statistics.median(latencies[name])
        print(f"    {name}: {REQUESTS} requests of {B} frames, alternating with the other "
              f"configuration: latency ms {[round(t * 1e3, 3) for t in latencies[name]]}, "
              f"median {med * 1e3:.3f} ms, {B / med:.3f} images/s, {found} detections in the "
              f"last request; launches during the requests {launches[name]}; card {ident}")
    del models, feats
    planar = build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0,
                            fused_attention=True, pano_mode=False)
    planar.simple_test(*inputs)                                    # warm-up
    fa.window_attention.last_entry = None
    det, sec, counts = timed_request(planar, inputs, counters)
    expect_launches(counts, expected["fused"], "planar fused flagship")
    expect_k2_entry(fa, "planar fused flagship")
    found = check_detections(det, "planar fused flagship")
    print(f"    planar (pano_mode=False), fused attention: one request {sec * 1e3:.3f} ms, "
          f"{found} detections, launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {ident}")

    del planar, det
    print(f"[5] flagship training step, bf16 compute, f32 parameters, AdamW lr 1e-4, {B} x "
          f"{H} x {W}, 32 boxes a frame, PyTorch's TF32 defaults")
    launches["train"] = training_path(dev, ident, build_flagship, flagship_train_batch,
                                      counters)

    for rec in records:
        key = rec.get("shares_kernel_of", rec["name"])
        if key in ("dense_crop (K4)", "roi_align_backward (K3 backward)"):
            path = "train"
        else:
            path = "fused" if "attention" in rec["name"] else "plain"
        rec["launches"] = launches[path][key]
        if key == "roi_align (K3)":
            rec["launches_training"] = launches["train"][key]
    print(json.dumps({"kernels": records}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
