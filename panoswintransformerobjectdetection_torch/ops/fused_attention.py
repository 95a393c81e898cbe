"""Fused window attention (kernel K2, with K5's entry point on the same kernel).

Counterpart of `panoswintransformerobjectdetection_tpu/ops/fused_attention.py`.
For window n and head h it computes
softmax(q[n, h] k[n, h]^T * scale + bias[n mod nW, h]) v[n, h], with the
bias (nW, h, O, O) float32 shared by the batch.  On a CUDA tensor that is the
hand-written kernel `csrc/window_attention.cu` (on the tensor cores: bf16
for bfloat16, 3xTF32 for float32); on a CPU tensor its plain twin
`window_attention_plain`.  Both follow the Pallas kernel's arithmetic
(`_packed_kernel`): q.k in f32 from the inputs' values, then times `scale`,
plus the bias; max, exp and e / sum in f32; p rounded to v's type; p.v in
f32; the output in q's type.

The TPU's window packing, block-diagonal mask and O -> 56 padding are not
ported: the kernel takes O = 49 as it is.  Padding changes nothing in the
JAX result either, since a padded key's exp(-1e9 - m) is 0 in f32.

Entry points:
  `packed_window_attention` (K2): an autograd function whose backward
      recomputes through the twin, as the JAX custom VJP recomputes through
      XLA; the model's fused branch calls it.
  `fused_window_attention` (K5): the same forward, without a VJP.
"""

import ctypes

import torch

from . import cuda_build
from .autograd import backward_through_plain

MAX_TOKENS = 64        # O, tokens per window
MAX_HEAD_DIM = 64      # d

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# The kernel's entries in `csrc/window_attention.cu`, both on the tensor
# cores: 3xTF32 for float32, bfloat16 for bfloat16.  Both count as launches
# of K2 and take the same C arguments.  `FIRST_VERSION` names the first
# version, on the CUDA cores (float32 and bfloat16 by the dtype code), which
# no wrapper calls: `chip_smoke.py` times the redesigns against it.
ENTRIES = {torch.float32: "window_attention_f32_launch",
           torch.bfloat16: "window_attention_bf16_launch"}
FIRST_VERSION = "window_attention_launch"
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def window_attention_plain(q, k, v, bias, scale: float):
    """Plain PyTorch twin of the kernel.

    q, k, v: (n, h, O, d) of one dtype, n = B * nW; bias: (nW, h, O, O)
    float32.  Returns (n, h, O, d) in q.dtype.
    """
    n, h, O, _ = q.shape
    nW = bias.shape[0]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = (s.reshape(n // nW, nW, h, O, O) + bias[None]).reshape(n, h, O, O)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype)
    return torch.matmul(p.float(), v.float()).to(q.dtype)


def _check(q, k, v, bias):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"window_attention: q, k, v must be (n, h, O, d) of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    n, h, O, d = q.shape
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"window_attention: q, k, v {q.dtype}, {k.dtype}, {v.dtype}; "
                        "float32 or bfloat16, all one type")
    if bias.dtype != torch.float32:
        raise TypeError(f"window_attention: bias {bias.dtype}, not float32")
    if bias.dim() != 4 or tuple(bias.shape[1:]) != (h, O, O) or bias.shape[0] == 0 \
            or n % bias.shape[0]:
        raise ValueError(f"window_attention: bias {tuple(bias.shape)} is not (nW, {h}, {O}, {O}) "
                         f"with nW dividing {n}")
    if not (1 <= O <= MAX_TOKENS and 1 <= d <= MAX_HEAD_DIM):
        raise ValueError(f"window_attention: O = {O}, d = {d}; the kernel takes O <= "
                         f"{MAX_TOKENS} and d <= {MAX_HEAD_DIM}")
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("window_attention: q, k, v and bias on different devices")
    if any(t.stride(-1) != 1 for t in (q, k, v, bias)):
        raise ValueError("window_attention: the last dimension of q, k, v and bias must be "
                         "contiguous")


def launch_strides(q, k, v, bias, out):
    """The 15 element strides the kernel takes: (window, head, token) of q,
    k, v, bias and out."""
    return (ctypes.c_longlong * 15)(*(s for t in (q, k, v, bias, out) for s in t.stride()[:3]))


def window_attention(q, k, v, bias, scale: float):
    """K2's kernel.  Same contract as `window_attention_plain`; the result is
    a (n, h, O, d) view of an (n, O, h, d) tensor, the layout that the
    output projection reads.

    A CPU tensor takes the twin; a CUDA tensor launches the kernel's entry
    for its type (`ENTRIES`, recorded in `window_attention.last_entry`) or
    raises.
    """
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, scale)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {q.device}")
    _check(q, k, v, bias)
    n, h, O, d = q.shape
    out = torch.empty((n, O, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    entry = ENTRIES[q.dtype]
    fn = cuda_build.function("window_attention", entry, LAUNCH_ARGTYPES)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                launch_strides(q, k, v, bias, out), n, h, O, d, bias.shape[0], float(scale),
                _DTYPE_CODE[q.dtype], stream)
    cuda_build.check(status, f"window_attention kernel launch ({entry})")
    window_attention.launches += 1
    window_attention.last_entry = entry
    return out


window_attention.launches = 0
window_attention.last_entry = None

# K5 (`fused_window_attention` of the JAX package): the same function with
# no VJP, so its entry point is the kernel's wrapper itself.
fused_window_attention = window_attention


class _PackedWindowAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, bias)
        return window_attention(q, k, v, bias, scale)

    @staticmethod
    def backward(ctx, grad):
        return (*backward_through_plain(window_attention_plain, ctx.saved_tensors,
                                        ctx.needs_input_grad, grad, ctx.scale), None)


def packed_window_attention(q, k, v, bias, scale: float):
    """K2: q, k, v (n, h, O, d), bias (nW, h, O, O) float32 holding any
    shifted-window mask already.  Returns (n, h, O, d) in q.dtype.  The
    backward recomputes through the plain twin with autograd."""
    return _PackedWindowAttention.apply(q, k, v, bias, scale)
