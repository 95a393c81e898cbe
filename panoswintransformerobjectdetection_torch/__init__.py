"""PanoSwin object detection in PyTorch for NVIDIA Hopper.

A port of `panoswintransformerobjectdetection_tpu` (JAX on a TPU, kept in
the repository as the reference).  Its layout mirrors the JAX package:
`geometry/`, `ops/`, `models/`, `core/`, `runtime/`.  Public tensors keep
the JAX layout (NHWC maps, (R, 7, 7, C) RoI features) so each function can
be held against its JAX counterpart.

The hand-written CUDA kernels live in `csrc/` and are built with `nvcc` at
first use (`ops/cuda_build.py`).  Every kernel has a plain PyTorch twin in
the same module; a wrapper runs the twin only for a tensor on the CPU.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
