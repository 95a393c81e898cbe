"""The host side of the 3xTF32 entries, whose device side is `csrc/tf32.cuh`:
a float32 operand w split into hi = TF32(w) and lo = TF32(w - hi), so that
hi * hi + hi * lo + lo * hi on the tensor cores keeps float32's accuracy.
K1's and K4's float32 wrappers split their weights here."""

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """float32 t rounded to TF32 as `cvt.rna.tf32.f32` rounds: to nearest,
    ties away from zero, the low 13 mantissa bits cleared."""
    bits = t.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_split(w: torch.Tensor) -> torch.Tensor:
    """w's hi (`tf32_round`) stacked on its lo, the TF32 rounding of w - hi:
    shape (2,) + w.shape."""
    hi = tf32_round(w)
    return torch.stack([hi, tf32_round(w - hi)])
