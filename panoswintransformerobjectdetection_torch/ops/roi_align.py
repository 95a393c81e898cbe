"""Multilevel RoIAlign: each RoI pooled from its own FPN level, by two routes.

Counterpart of `multilevel_roi_align` in
`panoswintransformerobjectdetection_tpu/ops/roi_align.py` with its detector
settings: `sampling_ratio=2`, `aligned=True`, `finest_scale=56`.  The JAX
package expresses the pooling as interpolation-matrix GEMMs over whole
maps, with a windowed Pallas kernel and a dense fallback, because the TPU
serialises gathers.

Direct route (`roi_align`, kernel K3): per axis and bin at most four
distinct taps, gathered from the RoI's own level.  On a CUDA tensor that is
the kernel `csrc/roi_align.cu`, forward and backward (the gradient of the
maps is a scatter-add, `roi_align_backward`); on a CPU tensor the
vectorised twin `roi_align_plain`, which does the same arithmetic in the
same order, with autograd through it.

Dense route (`multilevel_roi_align_dense`, kernel K4): the JAX package's
formulation, which its gradients and its CPU path go through: dense
per-RoI interpolation matrices (`_axis_weights`) and, per level,
`dense_crop`: out = Wx . round(Wy . F).  On a CUDA tensor `dense_crop` is
the kernel `csrc/dense_crop.cu` (its backward goes through the twin, as
the JAX custom VJP goes through the einsum pair); on a CPU tensor the twin
`dense_crop_plain`.  Both routes compute the same function.

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
from .autograd import backward_through_plain

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


LAUNCH_ARGTYPES = [ctypes.POINTER(_RoiLevels), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_void_p]
# K3's forward entries in `csrc/roi_align.cu`: one thread a channel for
# float32 (the first version, whose bfloat16 instantiation only
# `chip_smoke.py` calls, to time the redesign against it), vectorised
# gathers with stage-one reuse for bfloat16.  Both count as launches of K3
# and take the same C arguments (`LAUNCH_ARGTYPES`).
ENTRIES = {torch.float32: "roi_align_launch", torch.bfloat16: "roi_align_bf16_launch"}


def _div(a: torch.Tensor, d: float) -> torch.Tensor:
    """IEEE a / d.  PyTorch's CUDA division by a Python scalar multiplies by
    the reciprocal, which rounds differently from the kernel's division."""
    return a / torch.full_like(a, d)


def _w_first(feats) -> bool:
    """Whether the levels (maps, or their shapes) are wider than tall in total."""
    shapes = [getattr(f, "shape", f) for f in feats]
    return sum(s[2] for s in shapes) > sum(s[1] for s in shapes)


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
    # upcast before the gather: autograd then sums a map's gradient in f32
    table = torch.cat([f.reshape(-1, C) for f in feats]).float()
    g = table[rows]                                 # (R, 7i, 4k1, 7j, 4k2, C)
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


def level_struct(tensors, strides) -> _RoiLevels:
    levels = _RoiLevels()
    for i, (f, s) in enumerate(zip(tensors, strides)):
        levels.feat[i] = f.data_ptr()
        levels.height[i] = f.shape[1]
        levels.width[i] = f.shape[2]
        levels.inv_stride[i] = 1.0 / float(s)
    levels.num_levels = len(tensors)
    return levels


def _check_rois(rois, what):
    if rois.dtype != torch.float32:
        raise TypeError(f"{what}: rois {rois.dtype}, not float32")
    if rois.dim() != 2 or rois.shape[1] != 5:
        raise ValueError(f"{what}: rois must be (R, 5), got {tuple(rois.shape)}")


def _roi_align_forward(feats, rois, strides) -> torch.Tensor:
    """Launch K3's forward kernel on CUDA tensors: the entry for their type
    (`ENTRIES`, recorded in `roi_align.last_entry`)."""
    L = len(feats)
    dtype = feats[0].dtype
    C = feats[0].shape[-1]
    if not 1 <= L <= MAX_LEVELS or len(strides) < L:
        raise ValueError(f"roi_align: {L} levels with strides {tuple(strides)}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"roi_align: features {dtype}")
    _check_rois(rois, "roi_align")
    if any(f.dim() != 4 or f.shape[0] != feats[0].shape[0] for f in feats):
        raise ValueError("roi_align: levels must be (B, H, W, C) with one batch size")
    if any(f.dtype != dtype or f.shape[-1] != C or f.device != rois.device for f in feats):
        raise ValueError("roi_align: levels differ in dtype, channels or device")
    feats = [f.contiguous() for f in feats]
    rois = rois.contiguous()
    R = rois.shape[0]
    out = torch.empty((R, OUT_SIZE, OUT_SIZE, C), dtype=dtype, device=rois.device)
    levels = level_struct(feats, strides)
    fn = cuda_build.function("roi_align", ENTRIES[dtype], LAUNCH_ARGTYPES)
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    status = fn(ctypes.byref(levels), rois.data_ptr(), out.data_ptr(), R, feats[0].shape[0],
                C, _DTYPE_CODE[dtype], int(_w_first(feats)), float(FINEST_SCALE), stream)
    cuda_build.check(status, f"roi_align kernel launch ({ENTRIES[dtype]})")
    roi_align.launches += 1
    roi_align.last_entry = ENTRIES[dtype]
    return out


def roi_align_backward_plain(grad_out: torch.Tensor, rois: torch.Tensor,
                             shapes: Sequence[Sequence[int]], dtype: torch.dtype,
                             strides: Sequence[int] = (4, 8, 16, 32)):
    """Plain version of K3's backward: autograd through `roi_align_plain`.
    The function is linear in the maps, so their values are not needed."""
    feats = [torch.zeros(tuple(s), dtype=dtype, device=rois.device, requires_grad=True)
             for s in shapes]
    with torch.enable_grad():
        out = roi_align_plain(feats, rois, strides)
    return torch.autograd.grad(out, feats, grad_out.to(dtype))


def roi_align_backward(grad_out: torch.Tensor, rois: torch.Tensor,
                       shapes: Sequence[Sequence[int]], dtype: torch.dtype,
                       strides: Sequence[int] = (4, 8, 16, 32)):
    """K3's backward: the gradient of the level maps (B, Hl, Wl, C), of
    `shapes` and `dtype`, given grad_out (R, 7, 7, C): every tap's
    grad_out * w1 * w2 added to its pixel of the RoI's own level.  The sums
    are taken in float32 (atomics, in an order that changes from run to
    run) and cast once.  The rois get no gradient.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    or raises.
    """
    if grad_out.device.type == "cpu":
        return roi_align_backward_plain(grad_out, rois, shapes, dtype, strides)
    if grad_out.device.type != "cuda":
        raise ValueError(f"roi_align_backward: unsupported device {grad_out.device}")
    L = len(shapes)
    B, C = shapes[0][0], shapes[0][3]
    R = rois.shape[0]
    if not 1 <= L <= MAX_LEVELS or len(strides) < L:
        raise ValueError(f"roi_align_backward: {L} levels with strides {tuple(strides)}")
    if dtype not in _DTYPE_CODE or grad_out.dtype != dtype:
        raise TypeError(f"roi_align_backward: maps {dtype}, gradient {grad_out.dtype}")
    _check_rois(rois, "roi_align_backward")
    if tuple(grad_out.shape) != (R, OUT_SIZE, OUT_SIZE, C) or rois.device != grad_out.device:
        raise ValueError(f"roi_align_backward: gradient {tuple(grad_out.shape)} on "
                         f"{grad_out.device} for {R} rois on {rois.device}, C = {C}")
    if any(len(s) != 4 or s[0] != B or s[3] != C for s in shapes):
        raise ValueError("roi_align_backward: levels must be (B, H, W, C) with one B and C")
    grad_out = grad_out.contiguous()
    rois = rois.contiguous()
    sizes = [s[0] * s[1] * s[2] * s[3] for s in shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=grad_out.device)
    grads = [g.view(tuple(s)) for g, s in zip(flat.split(sizes), shapes)]
    levels = level_struct(grads, strides)
    fn = cuda_build.function("roi_align", "roi_align_backward_launch", LAUNCH_ARGTYPES)
    stream = torch.cuda.current_stream(rois.device).cuda_stream
    status = fn(ctypes.byref(levels), rois.data_ptr(), grad_out.data_ptr(), R, B, C,
                _DTYPE_CODE[dtype], int(_w_first(shapes)), float(FINEST_SCALE), stream)
    cuda_build.check(status, "roi_align backward kernel launch")
    roi_align_backward.launches += 1
    return tuple(g.to(dtype) for g in grads)


roi_align_backward.launches = 0


class _RoIAlign(torch.autograd.Function):
    """K3 on the card: forward kernel, backward kernel."""

    @staticmethod
    def forward(ctx, rois, strides, *feats):
        ctx.strides = tuple(strides)
        ctx.shapes = [tuple(f.shape) for f in feats]
        ctx.dtype = feats[0].dtype
        ctx.save_for_backward(rois)
        return _roi_align_forward(list(feats), rois, strides)

    @staticmethod
    def backward(ctx, grad):
        rois, = ctx.saved_tensors
        grads = roi_align_backward(grad, rois, ctx.shapes, ctx.dtype, ctx.strides)
        return (None, None, *grads)


def roi_align(feats: Sequence[torch.Tensor], rois: torch.Tensor,
              strides: Sequence[int] = (4, 8, 16, 32)) -> torch.Tensor:
    """K3.  Same contract as `roi_align_plain`.  Differentiable in the maps
    (`roi_align_backward`), not in the rois.

    A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises.
    """
    feats = list(feats)
    if rois.device.type == "cpu":
        return roi_align_plain(feats, rois.detach(), strides)
    if rois.device.type != "cuda":
        raise ValueError(f"roi_align: unsupported device {rois.device}")
    return _RoIAlign.apply(rois.detach(), tuple(strides), *feats)


roi_align.launches = 0
roi_align.last_entry = None


# ------------------------------------------------------------- dense route

def _axis_weights(v1, bin_sz, size, n_cols: int, dtype) -> torch.Tensor:
    """Dense interpolation matrix of each RoI along one axis, (R, 7, n_cols).

    v1 (R,) start coordinate on the RoI's own level, bin_sz (R,) bin
    extent, size (R,) float extent of that level.  W[r, i, col] = 1/2 * the
    sum over bin i's two samples and their two taps of the tap weight where
    the tap's column is col; taps clamped to the border, samples outside
    (-1, size) zeroed.  Rounded to `dtype`.
    """
    o = torch.arange(OUT_SIZE, dtype=torch.float32, device=v1.device)
    off = (torch.arange(SAMPLES, dtype=torch.float32, device=v1.device) + 0.5) / SAMPLES
    v = v1[:, None, None] + bin_sz[:, None, None] * (o[None, :, None] + off[None, None, :])
    sizef = size[:, None, None]
    inside = ((v > -1.0) & (v < sizef)).float()
    vc = torch.minimum(torch.clamp(v, min=0.0), sizef - 1)
    v0 = torch.floor(vc)
    v1i = torch.minimum(v0 + 1, sizef - 1)
    w1 = (vc - v0) * inside
    w0 = (1.0 - (vc - v0)) * inside
    cols = torch.arange(n_cols, dtype=torch.float32, device=v1.device)
    W = (cols == v0[..., None]) * w0[..., None] + (cols == v1i[..., None]) * w1[..., None]
    return _div(W.sum(dim=2), SAMPLES).to(dtype)


def dense_crop_plain(feat: torch.Tensor, Wy: torch.Tensor, Wx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of K4: out[b,p,i,x,c] = sum_w Wx[b,p,x,w] *
    round(sum_h Wy[b,p,i,h] * feat[b,h,w,c]), both sums in float32, the
    stage-one product and the result rounded to feat's type.

    feat (B, Hl, Wl, C); Wy (B, P, o, Hl); Wx (B, P, o, Wl), all of one
    dtype.  Returns (B, P, o, o, C).
    """
    t = torch.einsum("bpoh,bhwc->bpowc", Wy.float(), feat.float()).to(feat.dtype)
    return torch.einsum("bpxw,bpowc->bpoxc", Wx.float(), t.float()).to(feat.dtype)


# K4's entries in `csrc/dense_crop.cu`: CUDA cores for float32 (the first
# version, whose bfloat16 instantiation only `chip_smoke.py` calls, to time
# the redesign against it), tensor cores for bfloat16.  Both count as
# launches of K4 and take the same C arguments.
CROP_ENTRIES = {torch.float32: "dense_crop_launch", torch.bfloat16: "dense_crop_bf16_launch"}
CROP_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def _pad_last(t: torch.Tensor, multiple: int) -> torch.Tensor:
    """t, zero-padded along its last axis to a multiple of `multiple`."""
    n = t.shape[-1]
    pad = -n % multiple
    return torch.nn.functional.pad(t, (0, pad)) if pad else t


CROP_CHANNEL_TILE = 16      # channels a block of the bfloat16 entry reads: `tc::CT` there


def crop_operands(feat: torch.Tensor, Wy: torch.Tensor):
    """The bfloat16 entry's operands: feat with C zero-padded to a multiple
    of 16 and laid out channel-tile-major, (B, C / 16, Hl, Wl, 16), so that
    the (h, w) rows a block reads for its 16 channels are whole 128-byte
    lines; Wy with its h axis zero-padded to a multiple of 8, so that each
    16-byte copy into shared memory is aligned.  Zero columns add nothing."""
    B, Hl, Wl, _ = feat.shape
    ct = CROP_CHANNEL_TILE
    tiles = _pad_last(feat, ct).reshape(B, Hl, Wl, -1, ct).permute(0, 3, 1, 2, 4)
    return tiles.contiguous(), _pad_last(Wy, 8).contiguous()


def _dense_crop_forward(feat, Wy, Wx) -> torch.Tensor:
    """Launch K4 on CUDA tensors: the entry for their type (`CROP_ENTRIES`)."""
    dt = feat.dtype
    if dt not in CROP_ENTRIES or Wy.dtype != dt or Wx.dtype != dt:
        raise TypeError(f"dense_crop: feat {feat.dtype}, Wy {Wy.dtype}, Wx {Wx.dtype}; "
                        "float32 or bfloat16, all one type")
    if feat.dim() != 4 or Wy.dim() != 4 or Wx.dim() != 4:
        raise ValueError("dense_crop: feat (B, Hl, Wl, C), Wy (B, P, o, Hl), Wx (B, P, o, Wl)")
    B, Hl, Wl, C = feat.shape
    P, o = Wy.shape[1], Wy.shape[2]
    if tuple(Wy.shape) != (B, P, o, Hl) or tuple(Wx.shape) != (B, P, o, Wl) or o != OUT_SIZE:
        raise ValueError(f"dense_crop: feat {tuple(feat.shape)}, Wy {tuple(Wy.shape)}, "
                         f"Wx {tuple(Wx.shape)}; o must be {OUT_SIZE}")
    if Wy.device != feat.device or Wx.device != feat.device:
        raise ValueError("dense_crop: feat, Wy and Wx on different devices")
    Wx = Wx.contiguous()
    if dt == torch.bfloat16:
        feat, Wy = crop_operands(feat, Wy)
        Cp = feat.shape[1] * CROP_CHANNEL_TILE
        sizes = (B, P, Hl, Wy.shape[-1], Wl, Cp, o)
    else:
        feat, Wy, Cp = feat.contiguous(), Wy.contiguous(), C
        sizes = (B, P, Hl, Wl, C, o, 0)       # the CUDA-core entry, at dtype code 0 (float32)
    out = torch.empty((B, P, o, o, Cp), dtype=dt, device=feat.device)
    if out.numel():
        fn = cuda_build.function("dense_crop", CROP_ENTRIES[dt], CROP_ARGTYPES)
        stream = torch.cuda.current_stream(feat.device).cuda_stream
        status = fn(feat.data_ptr(), Wy.data_ptr(), Wx.data_ptr(), out.data_ptr(), *sizes, stream)
        cuda_build.check(status, f"dense_crop kernel launch ({CROP_ENTRIES[dt]})")
    dense_crop.launches += 1
    dense_crop.last_entry = CROP_ENTRIES[dt]
    return out[..., :C].contiguous() if Cp != C else out


class _DenseCrop(torch.autograd.Function):
    """K4 on the card: forward kernel, backward through the twin's einsums."""

    @staticmethod
    def forward(ctx, feat, Wy, Wx):
        ctx.save_for_backward(feat, Wy, Wx)
        return _dense_crop_forward(feat, Wy, Wx)

    @staticmethod
    def backward(ctx, grad):
        return backward_through_plain(dense_crop_plain, ctx.saved_tensors,
                                      ctx.needs_input_grad, grad)


def dense_crop(feat: torch.Tensor, Wy: torch.Tensor, Wx: torch.Tensor) -> torch.Tensor:
    """K4.  Same contract as `dense_crop_plain`; differentiable in all three.

    A CPU tensor takes the twin; a CUDA tensor launches the kernel or raises.
    """
    if feat.device.type == "cpu":
        return dense_crop_plain(feat, Wy, Wx)
    if feat.device.type != "cuda":
        raise ValueError(f"dense_crop: unsupported device {feat.device}")
    return _DenseCrop.apply(feat, Wy, Wx)


dense_crop.launches = 0
dense_crop.last_entry = None


def dense_level_operands(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                         strides: Sequence[int] = (4, 8, 16, 32)):
    """`dense_crop`'s operands on each level, [(feat, Wy, Wx)], for maps that
    are not wider than tall (the dense route transposes wide ones first):
    every level gets all R = B * P RoIs, with Wy zeroed for the RoIs routed
    to other levels."""
    feats = list(feats)
    L = len(feats)
    B = feats[0].shape[0]
    R = rois.shape[0]
    if R % B:
        raise ValueError(f"multilevel_roi_align_dense: {R} rois for {B} images; the rois "
                         "must be grouped by image, R = B * P")
    dtype = feats[0].dtype
    dev = rois.device
    rois = rois.detach()
    lvl = roi_levels(rois, L)
    inv = torch.tensor([1.0 / float(s) for s in strides[:L]], dtype=torch.float32,
                       device=dev)[lvl]
    heights = torch.tensor([f.shape[1] for f in feats], dtype=torch.float32, device=dev)[lvl]
    widths = torch.tensor([f.shape[2] for f in feats], dtype=torch.float32, device=dev)[lvl]
    Wy_all = _axis_weights(rois[:, 2] * inv - 0.5, _div((rois[:, 4] - rois[:, 2]) * inv, OUT_SIZE),
                           heights, max(f.shape[1] for f in feats), dtype)
    Wx_all = _axis_weights(rois[:, 1] * inv - 0.5, _div((rois[:, 3] - rois[:, 1]) * inv, OUT_SIZE),
                           widths, max(f.shape[2] for f in feats), dtype)
    operands = []
    for l, feat in enumerate(feats):
        Hl, Wl = feat.shape[1], feat.shape[2]
        sel = (lvl == l).to(dtype)
        Wy = (Wy_all[:, :, :Hl] * sel[:, None, None]).reshape(B, R // B, OUT_SIZE, Hl)
        Wx = Wx_all[:, :, :Wl].reshape(B, R // B, OUT_SIZE, Wl)
        operands.append((feat, Wy, Wx))
    return operands


def multilevel_roi_align_dense(feats: Sequence[torch.Tensor], rois: torch.Tensor,
                               strides: Sequence[int] = (4, 8, 16, 32)) -> torch.Tensor:
    """The dense route: same values as `roi_align`, through `dense_crop` on
    every level.  The rois must be grouped by image in batch order, R = B *
    P, as `rois.reshape(B * P, 5)` builds them: column 0 is not read.
    Wide maps are transposed, so that stage one contracts W.
    """
    feats = list(feats)
    if _w_first(feats):
        out = multilevel_roi_align_dense([f.transpose(1, 2) for f in feats],
                                         rois[:, [0, 2, 1, 4, 3]], strides)
        return out.transpose(1, 2)
    R, C = rois.shape[0], feats[0].shape[-1]
    out = torch.zeros((R, OUT_SIZE, OUT_SIZE, C), dtype=feats[0].dtype, device=rois.device)
    for feat, Wy, Wx in dense_level_operands(feats, rois, strides):
        out = out + dense_crop(feat, Wy, Wx).reshape(R, OUT_SIZE, OUT_SIZE, C)
    return out
