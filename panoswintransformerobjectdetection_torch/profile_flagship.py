"""Where the flagship's `simple_test` spends its time on one CUDA card.

    python -m panoswintransformerobjectdetection_torch.profile_flagship

Builds the flagship (PanoSwin-T Faster R-CNN, random weights from seed 0,
stem BatchNorm folded, bf16) with plain and with fused attention (kernel
K2), and runs `simple_test` on 2 x 512 x 1024 frames with
PyTorch's default TF32 settings.  For each configuration it prints:
  - each stage's host time (`models/detectors.STAGES`), with a
    `torch.cuda.synchronize()` around each stage (median over 5 requests,
    the two configurations taking turns request by request);
  - from `torch.profiler` over 5 whole requests: the request's wall time,
    the number of device kernels and copies, the device's busy time (union
    of their intervals) and idle share, and the kernels with the most
    device time;
  - the card's name and power limit from `nvidia-smi`.
Without a CUDA card it exits with an error.
"""

import functools
import statistics
import sys
import time
from collections import defaultdict

import torch

from .device import gpu_identity
from .flagship import build_flagship, flagship_inputs

BATCH = 2
REPS = 5
TOP_KERNELS = 15
CONFIGS = (("plain attention", {}), ("fused attention (K2)", {"fused_attention": True}))


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kernel_summary(prof):
    """(busy seconds, {kernel name: (count, seconds)}) from the device events."""
    spans, per_name = [], defaultdict(lambda: [0, 0.0])
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = evt.time_range.start, evt.time_range.end      # microseconds
        spans.append((start, end))
        per_name[evt.name][0] += 1
        per_name[evt.name][1] += (end - start) * 1e-6
    busy, cur_start, cur_end = 0.0, None, None
    for s, e in sorted(spans):
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy * 1e-6, dict(per_name)


def stage_table(label, per_stage, latency, ident):
    print(f"flagship simple_test, {label}, B={BATCH} x 512x1024, bf16, each stage "
          f"synchronised (median of {REPS}, host clock); card {ident}")
    total = 0.0
    for name, v in per_stage.items():
        med = statistics.median(v)
        total += med
        print(f"  {name:12s} {med * 1e3:9.3f} ms")
    print(f"  {'sum':12s} {total * 1e3:9.3f} ms; the request unsynchronised "
          f"{latency * 1e3:.3f} ms (median of {REPS})")


def device_summary(label, model, inputs, latency, ident):
    """`torch.profiler` over REPS requests of one configuration."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(REPS):
            model.simple_test(*inputs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy, per_name = kernel_summary(prof)
    launches = sum(count for count, _ in per_name.values()) / REPS
    print(f"torch.profiler over {REPS} requests, {label}: wall {wall / REPS * 1e3:.3f} ms a "
          f"request (profiler on), {launches:.1f} device kernels and copies a request, "
          f"device busy {busy / REPS * 1e3:.3f} ms a request, "
          f"idle share {1 - busy / wall:.4f} with the profiler on and "
          f"{1 - busy / REPS / latency:.4f} against the unprofiled request; card {ident}")
    if not per_name:
        print("  the profiler recorded no device events: device times not measured")
    for name, (count, sec) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]:
        print(f"  {sec / REPS * 1e3:9.3f} ms  {count // REPS:5d}x  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_flagship: no CUDA device is available", file=sys.stderr)
        return 1
    ident = gpu_identity()
    dev = torch.device("cuda")
    inputs = flagship_inputs(BATCH, dev)
    models = {label: build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0, **options)
              for label, options in CONFIGS}
    latency = {label: [] for label in models}
    per_stage = {label: defaultdict(list) for label in models}

    def timed_stage(label, name, fn):
        out, seconds = _timed(fn)
        per_stage[label][name].append(seconds)
        return out

    for model in models.values():
        model.simple_test(*inputs)                              # warm-up
    # the configurations take turns request by request, so that a drift of
    # the host over the run reaches both alike
    for _ in range(REPS):
        for label, model in models.items():
            latency[label].append(_timed(lambda: model.simple_test(*inputs))[1])
    for _ in range(REPS):
        for label, model in models.items():
            model.simple_test(*inputs, stage=functools.partial(timed_stage, label))
    for label, model in models.items():
        med = statistics.median(latency[label])
        stage_table(label, per_stage[label], med, ident)
        device_summary(label, model, inputs, med, ident)
    print(ident)
    return 0


if __name__ == "__main__":
    sys.exit(main())
