"""Fused stem convolutions (kernel K1) and the patch projection after them.

Counterpart of `panoswintransformerobjectdetection_tpu/ops/stem_conv.py`.
`stem_conv` computes h1 = relu(conv3x3(relu(conv3x3(x, w0) + b0), w1) + b1)
with BatchNorm folded into (w, b): on a CUDA tensor through the hand-written
kernel `csrc/stem_conv.cu` (bfloat16 on the tensor cores, float32 on them
in 3xTF32), on a CPU tensor through its plain twin `stem_conv_plain`.
`stem_weights` lays the weights out once for the twin and for the kernel's
entry at the compute type, so a caller that keeps the result pays nothing
for it per call.  Both accumulate in f32 with f32 biases and round h0 and
h1 to the compute type, as the Pallas kernel does.  The 4x4/4 projection
(`patch_projection`) is a library convolution in both packages.
"""

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import cuda_build
from .tf32 import tf32_split

# Stem BatchNorm epsilon, shared by the BatchNorm modules and every fold.
BN_EPS = 1e-5


def fold_bn(weight, bias, gamma, beta, mean, var, eps=BN_EPS):
    """Fold BatchNorm running statistics into a conv: returns (w', b') with
    conv(x, w') + b' == BN(conv(x, w) + b).  `weight` is OIHW."""
    scale = gamma / torch.sqrt(var + eps)
    return weight * scale[:, None, None, None], (bias - mean) * scale + beta


def stem_conv_plain(x, w0, b0, w1, b1):
    """Plain PyTorch twin of the kernel.

    x (B, H, W, 3) in the compute type; w0 (c0, 3, 3, 3), w1 (c1, c0, 3, 3)
    OIHW; b0, b1 float32.  Returns h1 (B, c1, H, W) in x.dtype.  The convs
    run in f32 on the compute-type values (exact products, f32 sums).
    """
    dt = x.dtype
    xf = x.permute(0, 3, 1, 2).float()
    h0 = F.conv2d(xf, w0.to(dt).float(), padding=1) + b0.float()[:, None, None]
    h0 = torch.relu(h0).to(dt)
    h1 = F.conv2d(h0.float(), w1.to(dt).float(), padding=1) + b1.float()[:, None, None]
    return torch.relu(h1).to(dt)


class StemWeights(NamedTuple):
    """The stem's folded weights in both versions' layouts, made once.

    w0 (c0, 3, 3, 3) and w1 (c1, c0, 3, 3) OIHW with float32 biases b0, b1,
    as the twin takes them; w0k and w1k for the kernel's entry at the
    compute type: `tf32_split_layout` for float32, `tensor_core_layout` for
    bfloat16.
    """
    w0: torch.Tensor
    b0: torch.Tensor
    w1: torch.Tensor
    b1: torch.Tensor
    w0k: torch.Tensor
    w1k: torch.Tensor


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def cuda_core_layout(w0, w1, dtype):
    """The first version's operands (`FIRST_VERSION`, which no wrapper
    calls): w0k (9, 3, c0) and w1k (9, c0, c1p), [tap, cin, cout] with the
    output channel fastest and c1 zero-padded to c1p, a multiple of 16."""
    c0, c1 = w0.shape[0], w1.shape[0]
    w0k = w0.to(dtype).permute(2, 3, 1, 0).reshape(9, 3, c0).contiguous()
    w1k = torch.zeros((9, c0, _round16(c1)), dtype=dtype, device=w1.device)
    w1k[:, :, :c1] = w1.to(dtype).permute(2, 3, 1, 0).reshape(9, c0, c1)
    return w0k, w1k


def tensor_core_layout(w0, w1, dtype):
    """The bfloat16 entry's operands, as the tensor cores' B fragments read
    them: w0k (c0p, 32), [cout, (tap, cin)] with the 27 im2col columns
    zero-padded to 32; w1k (9, c1p, c0p), [tap, cout, cin].  c0 and c1 are
    zero-padded to c0p and c1p, multiples of 16."""
    c0, c1 = w0.shape[0], w1.shape[0]
    c0p, c1p = _round16(c0), _round16(c1)
    w0k = torch.zeros((c0p, 32), dtype=dtype, device=w0.device)
    w0k[:c0, :27] = w0.to(dtype).permute(0, 2, 3, 1).reshape(c0, 27)
    w1k = torch.zeros((9, c1p, c0p), dtype=dtype, device=w1.device)
    w1k[:, :c1, :c0] = w1.to(dtype).permute(2, 3, 0, 1).reshape(9, c1, c0)
    return w0k, w1k


def tf32_split_layout(w0, w1):
    """The float32 entry's operands, split for 3xTF32 (`tf32.tf32_split`):
    hi = TF32(w) and lo = TF32(w - hi).  w0k (4, c0p / 8, 32, 4), conv0's B
    fragments for `mma.sync.m16n8k8` in the order a lane loads them: entry
    [s, n, lane] holds, for lane = 4g + q, output channel co = 8n + g and
    im2col columns k = 8s + q and k + 4 (k = (dy * 3 + dx) * 3 + cin, zero
    past 27), as (hi(w0[co, k]), hi(w0[co, k + 4]), lo(w0[co, k]),
    lo(w0[co, k + 4])).  w1k (9, c0p / 16, 2, 2, c1p / 64, 8, 2,
    8, 4), conv1's B tiles for 3xTF32, each (n, nb) a 64 x 8 tile of
    8-row x 16-byte core matrices as `wgmma` reads it from shared memory:
    entry [tap, cb, h, s, n, nb, kh, r, j] is hi(w[co, ci]) for s = 0 and
    lo(w[co, ci]) for s = 1, with co = 64n + 8nb + r, ci = 16cb + 4j + 2h +
    kh (the order in which a lane's 16-byte load of h0 feeds two k8 slices
    h).  c0 is zero-padded to c0p, a multiple of 16, and c1 to c1p, one of
    64."""
    c0, c1 = w0.shape[0], w1.shape[0]
    c0p, c1p = _round16(c0), -(-c1 // 64) * 64
    w0m = torch.zeros((c0p, 32), dtype=torch.float32, device=w0.device)
    w0m[:c0, :27] = w0.float().permute(0, 2, 3, 1).reshape(c0, 27)
    # (n, g, s, j, q) -> (s, n, g, q, j), k = 8s + 4j + q
    w0m = w0m.reshape(c0p // 8, 8, 4, 2, 4).permute(2, 0, 1, 4, 3)
    w0k = torch.cat(tuple(tf32_split(w0m)), dim=-1).reshape(4, c0p // 8, 32, 4)
    wt = torch.zeros((9, c1p, c0p), dtype=torch.float32, device=w1.device)
    wt[:, :c1, :c0] = w1.float().permute(2, 3, 0, 1).reshape(9, c1, c0)
    # (tap, n, nb, r, cb, j, h, kh) -> (tap, cb, h, n, nb, kh, r, j)
    wt = wt.reshape(9, c1p // 64, 8, 8, c0p // 16, 4, 2, 2).permute(0, 4, 6, 1, 2, 7, 3, 5)
    return w0k.contiguous(), tf32_split(wt).movedim(0, 3).contiguous()


def stem_weights(w0, b0, w1, b1, dtype) -> StemWeights:
    """Lay out (w0, b0, w1, b1) for `stem_conv` at compute type `dtype`."""
    c0, c1 = w0.shape[0], w1.shape[0]
    if w0.shape[1:] != (3, 3, 3) or w1.shape[1:] != (c0, 3, 3) or b0.shape != (c0,) \
            or b1.shape != (c1,):
        raise ValueError(f"stem_weights: bad shapes w0 {tuple(w0.shape)}, b0 {tuple(b0.shape)}, "
                         f"w1 {tuple(w1.shape)}, b1 {tuple(b1.shape)}")
    if any(t.device != w0.device for t in (b0, w1, b1)):
        raise ValueError("stem_weights: weights and biases on different devices")
    if dtype == torch.bfloat16:
        w0k, w1k = tensor_core_layout(w0, w1, dtype)
    else:
        w0k, w1k = tf32_split_layout(w0, w1)
    return StemWeights(w0, b0.float().contiguous(), w1, b1.float().contiguous(), w0k, w1k)


# The kernel's entries in `csrc/stem_conv.cu`, both on the tensor cores:
# 3xTF32 for float32, bf16 for bfloat16.  Both count as launches of K1 and
# take the same C arguments (x, w0k, b0, w1k, b1, out, B, H, W, c0, c0p, c1,
# c1p, stream).  The first version, on the CUDA cores (`cuda_core_layout`'s
# operands, then c1p and a dtype code in place of c0p and c1p), stays built
# so that `chip_smoke.py` times both redesigns against it; no wrapper calls it.
ENTRIES = {torch.float32: "stem_conv_f32_launch", torch.bfloat16: "stem_conv_bf16_launch"}
FIRST_VERSION = "stem_conv_launch"
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]


def stem_conv(x, weights: StemWeights):
    """K1: the fused two-convolution stem of x (B, H, W, 3) in the compute
    type, with weights from `stem_weights` at that type.  Returns h1
    (B, c1, H, W) in x.dtype, as `stem_conv_plain` does.

    A CPU tensor takes the twin; a CUDA tensor launches the kernel's entry
    for its type (`ENTRIES`, recorded in `stem_conv.last_entry`) or raises.
    """
    if x.device.type == "cpu":
        return stem_conv_plain(x, weights.w0, weights.b0, weights.w1, weights.b1)
    if x.device.type != "cuda":
        raise ValueError(f"stem_conv: unsupported device {x.device}")
    dt = x.dtype
    if dt not in ENTRIES or weights.w0k.dtype != dt:
        raise TypeError(f"stem_conv: input {dt} with weights laid out for {weights.w0k.dtype}; "
                        "float32 or bfloat16")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"stem_conv: x must be (B, H, W, 3), got {tuple(x.shape)}")
    if weights.w0k.device != x.device:
        raise ValueError("stem_conv: weights must be on the input's device")
    B, H, W, _ = x.shape
    c0, c1 = weights.w0.shape[0], weights.w1.shape[0]
    x = x.contiguous()
    out = torch.empty((B, c1, H, W), dtype=dt, device=x.device)
    fn = cuda_build.function("stem_conv", ENTRIES[dt], LAUNCH_ARGTYPES)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if dt == torch.float32:
        c0p, c1p = weights.w0k.shape[1] * 8, weights.w1k.shape[4] * 64
    else:
        c0p, c1p = weights.w1k.shape[2], weights.w1k.shape[1]
    sizes = (B, H, W, c0, c0p, c1, c1p)
    status = fn(x.data_ptr(), weights.w0k.data_ptr(), weights.b0.data_ptr(),
                weights.w1k.data_ptr(), weights.b1.data_ptr(), out.data_ptr(), *sizes, stream)
    cuda_build.check(status, f"stem_conv kernel launch ({ENTRIES[dt]})")
    stem_conv.launches += 1
    stem_conv.last_entry = ENTRIES[dt]
    return out


stem_conv.launches = 0
stem_conv.last_entry = None


def patch_projection(h1, wp, bp):
    """The 4x4/4 projection of h1 (B, c1, H, W) -> (B, H/4, W/4, ce) NHWC:
    f32 accumulation of the compute-type values, f32 bias, cast back."""
    dt = h1.dtype
    out = F.conv2d(h1.float(), wp.to(dt).float(), stride=4) + bp.float()[:, None, None]
    return out.to(dt).permute(0, 2, 3, 1)

