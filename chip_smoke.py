"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain PyTorch twin, run the flagship detector in its
configurations, report.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. environment: the card's name and power limit; TF32 off for f32 checks;
  2. build every kernel from `panoswintransformerobjectdetection_torch/csrc`;
  3. each kernel against its twin at the flagship's shapes, f32 and bf16,
     with its median time, the twin's time and a library call's time (K2 at
     all four stage shapes; K5's entry point checked at a small shape);
  4. small-input f32 checks of the card's path against the CPU path, plain
     and fused attention; then the flagship (PanoSwin-T Faster R-CNN, random
     weights from seed 0, BN folded, bf16) `simple_test` on 2 x 512 x 1024
     frames with PyTorch's TF32 defaults back: the plain and the fused-
     attention flagship alternate request by request, each request with the
     kernels' launch counts reset just before it and read just after; the
     two backbones' outputs are compared; one request of the planar
     configuration (`pano_mode=False`, fused attention);
  5. a JSON line per kernel, then the result line.
Without a CUDA card it exits with an error and prints no result.
"""

import json
import statistics
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core rate, same source
BF16_ULPS = 4 * 2.0 ** -8       # bf16 tolerance: 4 units in the last place of max|ref|
B, H, W = 2, 512, 1024
REQUESTS = 5
# K2 at the flagship's four stages, B = 2: (windows n = B * nW, heads, nW);
# O = 7 * 7 tokens, head width 32 at every stage.
ATTENTION_STAGES = ((1406, 3, 703), (380, 6, 190), (100, 12, 50), (30, 24, 15))
TOKENS, HEAD_DIM = 49, 32
K2_PER_REQUEST = 2 + 2 + 6 + 2          # one launch per block
# Fused against plain backbone, bf16: the routes round differently (q scaled
# in bf16 or the f32 product scaled; softmax or e / sum), and each of the 12
# blocks carries the difference on: 16 bf16 units of max|ref|.
BACKBONE_TOL_UNITS = 16


def time_ms(fn, reps: int) -> float:
    """Median time of one call, CUDA events around each of `reps` calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
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
        err = check(f"K1 stem_conv {str(dt)[6:]} (2,512,1024,3) c0 32 c1 64", got, ref, tol)
        if dt == torch.bfloat16:
            xn = args[0].permute(0, 3, 1, 2).contiguous()
            w0b, w1b = w0.to(dt).to(dev), w1.to(dt).to(dev)
            b0b, b1b = b0.to(dt).to(dev), b1.to(dt).to(dev)
            conv = torch.nn.functional.conv2d

            def library():
                h0 = torch.relu(conv(xn, w0b, b0b, padding=1))
                return torch.relu(conv(h0, w1b, b1b, padding=1))

            ms = time_ms(lambda: stem.stem_conv(args[0], packed), 20)
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
                   else "operations", "library_ms": library_ms}
    print(f"  K1 bf16: kernel {rec['ms']:.3f} ms, twin {rec['plain_ms']:.3f} ms, "
          f"two-conv2d chain {rec['library_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms")
    return rec


def kernel_k3(dev, ra):
    rng = np.random.default_rng(2)
    C = 256
    rois = rpn_like_rois(rng, 1000).to(dev)
    base = [torch.from_numpy(rng.standard_normal((B, H // s, W // s, C)).astype(np.float32))
            for s in (4, 8, 16, 32)]
    strides = (4, 8, 16, 32)
    rec = {}
    for dt in (torch.float32, torch.bfloat16):
        feats = [f.to(dt).to(dev) for f in base]
        got = ra.roi_align(feats, rois, strides)
        ref = ra.roi_align_plain(feats, rois, strides)
        torch.cuda.synchronize()
        # same operations in the same order as the twin: exact
        err = check(f"K3 roi_align {str(dt)[6:]} 4 levels C 256, 2 x 1000 RoIs", got, ref, 0.0)
        if dt == torch.bfloat16:
            ms = time_ms(lambda: ra.roi_align(feats, rois, strides), 20)
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
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                   "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
                   else "operations", "library_ms": None}
    print(f"  K3 bf16: kernel {rec['ms']:.3f} ms, twin {rec['plain_ms']:.3f} ms, "
          f"no single PyTorch call computes it, bound {rec['bound_ms']:.4f} ms")
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
    """(kernel ms, twin ms, SDPA ms, bound ms, bound_by) in bf16.  SDPA gets
    4-D (n, h, O, d) views and the bias cast to bf16 and repeated over the
    batch outside the timing (a 4-D mask cannot repeat every nW windows as
    a view): the port never calls it."""
    n, h, O, d = q.shape
    nW = bias.shape[0]
    scale = d ** -0.5
    mask = bias.to(q.dtype).expand(n // nW, nW, h, O, O).reshape(n, h, O, O)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: entry(q, k, v, bias, scale), 20)
    plain_ms = time_ms(lambda: fa.window_attention_plain(q, k, v, bias, scale), 10)
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), 20)
    nbytes = 4 * q.numel() * q.element_size() + bias.numel() * 4
    ops = 4 * n * h * O * O * d
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    return ms, plain_ms, library_ms, bound, "bytes" if by_bytes else "operations"


def kernel_k2(dev, fa):
    rec = {}
    for stage, (n, h, nW) in enumerate(ATTENTION_STAGES):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, bias = attention_inputs(dev, dt, n, h, nW, 4 + stage)
            got = fa.packed_window_attention(q, k, v, bias, HEAD_DIM ** -0.5)
            ref = fa.window_attention_plain(q, k, v, bias, HEAD_DIM ** -0.5)
            torch.cuda.synchronize()
            err = check(f"K2 window_attention {str(dt)[6:]} stage {stage} (n {n}, h {h}, "
                        f"O {TOKENS}, d {HEAD_DIM}, nW {nW})", got, ref, attention_tol(ref, dt))
            if dt != torch.bfloat16:
                continue
            ms, plain_ms, library_ms, bound, by = attention_times(
                fa, fa.packed_window_attention, q, k, v, bias)
            print(f"  K2 bf16 stage {stage}: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
                  f"SDPA {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            if stage == 0:
                rec = {"name": "window_attention (K2)", "route": "cuda",
                       "source": "panoswintransformerobjectdetection_torch/csrc/window_attention.cu",
                       "replaces": "panoswintransformerobjectdetection_tpu/ops/fused_attention.py:88",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": by, "library_ms": library_ms}
    return rec


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
                             f"d 32, nW 5)", got, ref, attention_tol(ref, dt)))
    n, h, nW = ATTENTION_STAGES[0]
    ms, plain_ms, library_ms, bound, by = attention_times(
        fa, fa.fused_window_attention, *attention_inputs(dev, torch.bfloat16, n, h, nW, 4))
    print(f"  K5 bf16 stage 0: kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
          f"SDPA {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "fused_window_attention (K5)", "route": "cuda",
            "source": "panoswintransformerobjectdetection_torch/csrc/window_attention.cu",
            "replaces": "panoswintransformerobjectdetection_tpu/ops/fused_attention.py:27",
            "shares_kernel_of": "window_attention (K2)", "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from panoswintransformerobjectdetection_torch.device import gpu_identity
    from panoswintransformerobjectdetection_torch.flagship import build_flagship, flagship_inputs
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
               kernel_k5(dev, fa)]

    print("[4] flagship simple_test, bf16, BN folded, random weights (seed 0)")
    reference_check(dev, build_flagship)
    reference_check(dev, build_flagship, fused_attention=True)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    print(f"    timed requests with PyTorch's TF32 defaults: cuDNN {tf32_defaults[0]}, "
          f"matmul {tf32_defaults[1]}")
    counters = {"stem_conv (K1)": stem.stem_conv, "roi_align (K3)": ra.roi_align,
                "window_attention (K2)": fa.window_attention}
    inputs = flagship_inputs(B, dev)
    models = {"plain": build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0),
              "fused": build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0,
                                      fused_attention=True)}
    expected = {"plain": {"stem_conv (K1)": None, "roi_align (K3)": None,
                          "window_attention (K2)": 0},
                "fused": {"stem_conv (K1)": None, "roi_align (K3)": None,
                          "window_attention (K2)": K2_PER_REQUEST}}
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
            dets[name], sec, counts = timed_request(model, inputs, counters)
            expect_launches(counts, expected[name], f"{name} flagship")
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
    det, sec, counts = timed_request(planar, inputs, counters)
    expect_launches(counts, expected["fused"], "planar fused flagship")
    found = check_detections(det, "planar fused flagship")
    print(f"    planar (pano_mode=False), fused attention: one request {sec * 1e3:.3f} ms, "
          f"{found} detections, launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {ident}")

    for rec in records:
        path = "fused" if "attention" in rec["name"] else "plain"
        key = rec.get("shares_kernel_of", rec["name"])
        rec["launches"] = launches[path][key]
    print(json.dumps({"kernels": records}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
