"""Backward of a kernel whose gradient goes through its plain version."""

from typing import Callable, Sequence

import torch


def backward_through_plain(plain: Callable, saved: Sequence[torch.Tensor],
                           needs_grad: Sequence[bool], grad: torch.Tensor, *args):
    """Gradients of `plain(*saved, *args)` with respect to the tensors of
    `saved` that need one, given the output's gradient: the forward is
    computed again with autograd.  Returns one entry per saved tensor, None
    where no gradient is needed."""
    inputs = [t.detach().requires_grad_(need) for t, need in zip(saved, needs_grad)]
    with torch.enable_grad():
        out = plain(*inputs, *args)
    grads = iter(torch.autograd.grad(out, [t for t in inputs if t.requires_grad], grad))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
