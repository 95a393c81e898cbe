"""Multilevel RoIAlign (kernel K3): each RoI pooled from its own FPN level.

Counterpart of `multilevel_roi_align` in
`panoswintransformerobjectdetection_tpu/ops/roi_align.py` with its detector
settings: `sampling_ratio=2`, `aligned=True`, `finest_scale=56`.  The JAX
package expresses the pooling as interpolation-matrix GEMMs over whole
maps, with a windowed Pallas kernel and a dense fallback, because the TPU
serialises gathers.  Here the function is computed directly: per axis and
bin at most four distinct taps, gathered from the RoI's own level.  On a
CUDA tensor that is the kernel `csrc/roi_align.cu`; on a CPU tensor the
vectorised twin `roi_align_plain`, which does the same arithmetic in the
same order.

The numerics that the JAX path fixes and both versions reproduce: the
weight of a tap column is (1/2) * sum of its sample weights, rounded to the
feature type; stage one contracts one axis with f32 accumulation and rounds
to the feature type; stage two contracts the other.  Maps that are wider
than tall in total (the 2:1 pano case) contract W first, because the JAX
wrapper transposes them (`roi_align.py:564-579`).
"""

import ctypes
from typing import Sequence

import torch

from . import cuda_build

OUT_SIZE = 7
SAMPLES = 2          # fixed sample grid per bin side (sampling_ratio=2)
FINEST_SCALE = 56
MAX_LEVELS = 4

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class _RoiLevels(ctypes.Structure):
    _fields_ = [("feat", ctypes.c_void_p * MAX_LEVELS),
                ("height", ctypes.c_int * MAX_LEVELS),
                ("width", ctypes.c_int * MAX_LEVELS),
                ("inv_stride", ctypes.c_float * MAX_LEVELS),
                ("num_levels", ctypes.c_int)]


_LAUNCH_ARGTYPES = [ctypes.POINTER(_RoiLevels), ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_void_p]


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """IEEE a / d.  PyTorch's CUDA division by a Python scalar multiplies by
    the reciprocal, which rounds differently from the kernel's division."""
    return a / torch.full_like(a, d)


def _w_first(feats) -> bool:
    return sum(f.shape[2] for f in feats) > sum(f.shape[1] for f in feats)


def roi_levels(rois: torch.Tensor, num_levels: int,
               finest_scale: int = FINEST_SCALE) -> torch.Tensor:
    """(R,) int64 level of each RoI: clamp(floor(log2(sqrt(area) / 56 + 1e-6)))."""
    w = rois[:, 3] - rois[:, 1]
    h = rois[:, 4] - rois[:, 2]
    scale = torch.sqrt(torch.clamp(w * h, min=0.0))
    lvl = torch.floor(torch.log2(_div(scale, finest_scale) + 1e-6)).long()
    return lvl.clamp(0, num_levels - 1)


def _axis_taps(start, bin_sz, size, dtype):
    """Merged taps of each bin along one axis.

    start, bin_sz, size: (R,) float32.  Returns idx (R, 7, 4) int64 and
    weights (R, 7, 4) float32 holding values of `dtype`; a repeated column
    keeps weight 0 after its first occurrence.
    """
    o = torch.arange(OUT_SIZE, dtype=torch.float32, device=start.device)
    off = (torch.arange(SAMPLES, dtype=torch.float32, device=start.device) + 0.5) / SAMPLES
    v = start[:, None, None] + bin_sz[:, None, None] * (o[None, :, None] + off[None, None, :])
    sizef = size[:, None, None]
    inside = ((v > -1.0) & (v < sizef)).float()
    vc = torch.minimum(torch.clamp(v, min=0.0), sizef - 1)
    v0 = torch.floor(vc)
    v1 = torch.minimum(v0 + 1, sizef - 1)
    frac = vc - v0
    # candidates per bin: (sample 0 tap 0, sample 0 tap 1, sample 1 tap 0, ...)
    col = torch.stack([v0, v1], dim=-1).flatten(2)                       # (R, 7, 4)
    wt = torch.stack([(1.0 - frac) * inside, frac * inside], dim=-1).flatten(2)
    zero = torch.zeros((), dtype=torch.float32, device=start.device)
    eq = col[..., :, None] == col[..., None, :]                          # [k, m]
    per_sample = [torch.where(eq[..., 2 * s], wt[..., None, 2 * s], zero)
                  + torch.where(eq[..., 2 * s + 1], wt[..., None, 2 * s + 1], zero)
                  for s in range(SAMPLES)]
    total = per_sample[0]
    for a in per_sample[1:]:
        total = total + a
    w = (total / SAMPLES).to(dtype).float()
    first = torch.ones(col.shape, dtype=torch.bool, device=start.device)
    for k in range(1, col.shape[-1]):
        first[..., k] = ~(eq[..., k, :k].any(-1))
    return col.long(), torch.where(first, w, zero)


def batch_index(rois: torch.Tensor, batch: int):
    """(R,) int64 image index of each RoI and (R,) bool: whether it lies in
    [0, batch).  An index outside (or NaN) reads image 0 and pools zeros."""
    b = rois[:, 0]
    valid = (b >= 0) & (b < batch)
    return torch.where(valid, b, torch.zeros_like(b)).long(), valid


def _roi_taps(feats, rois, strides):
    """Per-RoI level, batch index and the merged taps of both axes."""
    L = len(feats)
    lvl = roi_levels(rois, L)
    bidx, valid = batch_index(rois, feats[0].shape[0])
    dev = rois.device
    inv = torch.tensor([1.0 / float(s) for s in strides[:L]], dtype=torch.float32,
                       device=dev)[lvl]
    heights = torch.tensor([f.shape[1] for f in feats], dtype=torch.float32, device=dev)[lvl]
    widths = torch.tensor([f.shape[2] for f in feats], dtype=torch.float32, device=dev)[lvl]
    dtype = feats[0].dtype
    ys, yw = _axis_taps(rois[:, 2] * inv - 0.5, _div((rois[:, 4] - rois[:, 2]) * inv, OUT_SIZE),
                        heights, dtype)
    xs, xw = _axis_taps(rois[:, 1] * inv - 0.5, _div((rois[:, 3] - rois[:, 1]) * inv, OUT_SIZE),
                        widths, dtype)
    return lvl, bidx, valid, (ys, yw), (xs, xw)


def tap_rows(feats: Sequence[torch.Tensor], rois: torch.Tensor,
             strides: Sequence[int] = (4, 8, 16, 32)):
    """Where every tap reads, and its weights.

    With all levels flattened into one (N, C) table, a tap's row is
    level offset + (b * Hl + y) * Wl + x.  Returns rows (R, 7i, 4k1, 7j, 4k2)
    int64, w1 (R, 7i, 4k1) and w2 (R, 7j, 4k2) float32, where i runs over
    the bins of the axis contracted first (x for wide maps, else y).
    """
    lvl, bidx, _, (ys, yw), (xs, xw) = _roi_taps(feats, rois, strides)
    sizes = [f.shape[0] * f.shape[1] * f.shape[2] for f in feats]
    offsets = torch.tensor([0] + sizes[:-1], device=rois.device).cumsum(0)[lvl]
    Hl = torch.tensor([f.shape[1] for f in feats], device=rois.device)[lvl]
    Wl = torch.tensor([f.shape[2] for f in feats], device=rois.device)[lvl]
    base = offsets + bidx * Hl * Wl
    if _w_first(feats):
        i1, w1, i2, w2 = xs, xw, ys, yw
        row = i2[:, None, None, :, :]               # (R, 1, 1, 7j, 4k2)
        col = i1[:, :, :, None, None]               # (R, 7i, 4k1, 1, 1)
    else:
        i1, w1, i2, w2 = ys, yw, xs, xw
        row = i1[:, :, :, None, None]
        col = i2[:, None, None, :, :]
    rows = base[:, None, None, None, None] + row * Wl[:, None, None, None, None] + col
    return rows, w1, w2


def roi_align_plain(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                    strides: Sequence[int] = (4, 8, 16, 32)) -> torch.Tensor:
    """Plain PyTorch twin of the kernel.

    feats: L <= 4 maps (B, Hl, Wl, C) of one dtype; rois: (R, 5) float32
    (batch, x1, y1, x2, y2) in image pixels.  Returns (R, 7, 7, C); a RoI
    whose batch index lies outside [0, B) gets zeros.
    """
    C = feats[0].shape[-1]
    dtype = feats[0].dtype
    R = rois.shape[0]
    rows, w1, w2 = tap_rows(feats, rois, strides)
    table = torch.cat([f.reshape(-1, C) for f in feats])
    g = table[rows].float()                         # (R, 7i, 4k1, 7j, 4k2, C)
    # stage one over k1 in the kernel's order, then stage two over k2
    t = None
    for k1 in range(w1.shape[-1]):
        p = w1[:, :, k1, None, None, None] * g[:, :, k1]
        t = p if t is None else t + p               # (R, 7i, 7j, 4k2, C)
    t = t.to(dtype).float()
    u = None
    for k2 in range(w2.shape[-1]):
        p = w2[:, None, :, k2, None] * t[:, :, :, k2]
        u = p if u is None else u + p               # (R, 7i, 7j, C)
    _, valid = batch_index(rois, feats[0].shape[0])
    u = torch.where(valid[:, None, None, None], u.to(dtype), torch.zeros((), dtype=dtype))
    if _w_first(feats):
        u = u.transpose(1, 2)
    return u.reshape(R, OUT_SIZE, OUT_SIZE, C)


def roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
              strides: Sequence[int] = (4, 8, 16, 32)) -> torch.Tensor:
    """K3.  Same contract as `roi_align_plain`.

    A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises.
    """
    feats = list(feats)
    if rois.device.type == "cpu":
        return roi_align_plain(feats, rois, strides)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {rois.device}")
    L = len(feats)
    dtype = feats[0].dtype
    C = feats[0].shape[-1]
    if not 1 <= L <= MAX_LEVELS or len(strides) < L:
        raise ValueError(f"roi_align: {L} levels with strides {tuple(strides)}")
    if dtype not in _DTYPE_CODE or rois.dtype != torch.float32:
        raise TypeError(f"roi_align: features {dtype}, rois {rois.dtype}")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"roi_align: rois must be (R, 5), got {tuple(rois.shape)}")
    if any(f.dim() != 4 or f.shape[0] != feats[0].shape[0] for f in feats):
        raise ValueError("roi_align: levels must be (B, H, W, C) with one batch size")
    if any(f.dtype != dtype or f.shape[-1] != C or f.device != rois.device for f in feats):
        raise ValueError("roi_align: levels differ in dtype, channels or device")
    feats = [f.contiguous() for f in feats]
    rois = rois.contiguous()
    R = rois.shape[0]
    out = torch.empty((R, OUT_SIZE, OUT_SIZE, C), dtype=dtype, device=rois.device)
    levels = _RoiLevels()
    for i, (f, s) in enumerate(zip(feats, strides)):
        levels.feat[i] = f.data_ptr()
        levels.height[i] = f.shape[1]
        levels.width[i] = f.shape[2]
        levels.inv_stride[i] = 1.0 / float(s)
    levels.num_levels = L
    fn = cuda_build.function("roi_align", "roi_align_launch", _LAUNCH_ARGTYPES)
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    status = fn(ctypes.byref(levels), rois.data_ptr(), out.data_ptr(), R, feats[0].shape[0],
                C, _DTYPE_CODE[dtype], int(_w_first(feats)), float(FINEST_SCALE), stream)
    cuda_build.check(status, "roi_align kernel launch")
    roi_align.launches += 1
    return out


roi_align.launches = 0
