"""The process group of a distributed run, and the few collectives the
training and evaluation entry points need.

Counterpart of `panoswintransformerobjectdetection_tpu/parallel/mesh.py`.
The JAX package runs data parallelism as one program over a mesh: its
step on a sharded batch is the step on the global batch, every sum over
the batch (a loss's normaliser, a BatchNorm's mean) is global, and
`shard_batch` only places each process's rows.  The port runs W processes
(torchrun's `--nproc_per_node W`, one card or the CPU each) that each hold
`batch // W` rows, and keeps JAX's semantics by summing across the
processes where JAX sums over the batch: `all_reduce_sum` for the
normalisers and the BatchNorm statistics, `shard_rows` for the random
draws, which every process makes for the global batch before keeping its
own rows.  Process r holds rows [r * b, (r + 1) * b) of the global batch,
as the JAX package's `make_array_from_process_local_data` lays them out.

With no process group (one process, the default) every helper is the
identity: the single-process path is what it was, bit for bit.
"""

import os
from typing import Optional, Union

import torch
import torch.distributed as dist

from ..device import resolve_device

# What torchrun (`python -m torch.distributed.run`) sets in every process.
LAUNCH_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(launcher: str = "pytorch", backend: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None):
    """Join the process group that torchrun set up; returns (rank, world).

    `launcher` "pytorch" (the reference's name for torchrun) reads
    `LAUNCH_ENV`, each of which must be set.  `backend`: "nccl" on the
    card, "gloo" when the caller passes `device="cpu"`; a caller may name
    "gloo" for CUDA tensors (several processes on one card, which NCCL
    refuses).  `device=None` means the card, as everywhere in the port:
    without one it raises; it never falls back to gloo or the CPU.  On the
    card each process takes card `LOCAL_RANK` (`torch.cuda.set_device`).
    A process group already made with the same rank and world is kept."""
    if launcher != "pytorch":
        raise ValueError(f"launcher {launcher!r}: 'pytorch' (torchrun) is the one launcher")
    missing = [k for k in LAUNCH_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"--launcher pytorch needs torchrun's environment; {missing} not "
                           "set (run under `python -m torch.distributed.run`)")
    rank_, world_ = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ["LOCAL_RANK"])
    dev = resolve_device(device)
    if backend is None:
        backend = "gloo" if dev.type == "cpu" else "nccl"
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    if dist.is_initialized():
        if (dist.get_rank(), dist.get_world_size()) != (rank_, world_):
            raise RuntimeError(f"a process group of rank {dist.get_rank()} in "
                               f"{dist.get_world_size()} exists; the environment says "
                               f"{rank_} in {world_}")
        return rank_, world_
    dist.init_process_group(backend, init_method="env://", rank=rank_, world_size=world_)
    return rank_, world_


def world() -> int:
    """The number of processes, 1 without a process group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def is_main() -> bool:
    """Whether this process writes the run's files (rank 0)."""
    return rank() == 0


def barrier() -> None:
    """Every process waits here for the others; nothing without a group."""
    if world() > 1:
        dist.barrier()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the processes, whose gradient is the sum over the processes
    of the gradients: each process's output is the same sum, so each
    process's input reaches every process's loss."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad)
        return grad


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the processes (differentiable), or `t` itself with
    no process group or a group of one.  Every process must call it in the
    same order."""
    if world() == 1:
        return t
    return _AllReduceSum.apply(t)


def all_gather_object(obj) -> list:
    """Every process's `obj` (picklable), in rank order; [obj] with no
    process group."""
    if world() == 1:
        return [obj]
    out = [None] * world()
    dist.all_gather_object(out, obj)
    return out


def shard_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    """This process's `rows` rows of `t`, a draw for the global batch of
    world() * rows rows: rows [rank * rows, (rank + 1) * rows)."""
    if world() == 1:
        return t
    if t.shape[0] != world() * rows:
        raise ValueError(f"a draw of {t.shape[0]} rows for {world()} processes of {rows}")
    return t[rank() * rows:(rank() + 1) * rows]
