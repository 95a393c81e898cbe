"""The roll of a panorama whose width axis is sharded over the processes.

Counterpart of `panoswintransformerobjectdetection_tpu/parallel/spatial.py`
(`sharded_roll`): the pano-shift's horizontal roll, and the seam's wrap,
for a map split along W in equal shards, process r holding columns
[r * w, (r + 1) * w).  One ring exchange of the `shift`-wide halo: the last
`shift` columns of each shard go to the next process's front.  No model
calls it in either package: whole images a process is the default, as in
the reference's DDP.
"""

from typing import Optional

import torch
import torch.distributed as dist


def sharded_roll(x_local: torch.Tensor, shift: int, group: Optional[dist.ProcessGroup] = None,
                 w_axis: int = 2) -> torch.Tensor:
    """torch.roll(x, shift, w_axis) of the gathered map, for this process's
    shard `x_local` (e.g. (B, H, w, C) with w_axis 2): one send of the (B,
    H, shift, C) tail to the next rank of `group` (the default group when
    None) and one receive from the previous, then a concatenation.  `shift`
    0 returns `x_local`; a shift outside [0, w] raises, as the JAX assert
    does.  Every process of the group must call it with the same shift."""
    w_local = x_local.shape[w_axis]
    if not 0 <= shift <= w_local:
        raise ValueError(f"the halo exchange takes 0 <= shift <= {w_local} (the shard's "
                         f"width), not {shift}")
    if shift == 0:
        return x_local
    n = dist.get_world_size(group)
    if n == 1:
        return torch.roll(x_local, shift, w_axis)
    r = dist.get_rank(group)
    tail = x_local.narrow(w_axis, w_local - shift, shift).contiguous()
    incoming = torch.empty_like(tail)
    peer = lambda i: dist.get_global_rank(group, i) if group is not None else i  # noqa: E731
    ops = [dist.P2POp(dist.isend, tail, peer((r + 1) % n), group),
           dist.P2POp(dist.irecv, incoming, peer((r - 1) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([incoming, x_local.narrow(w_axis, 0, w_local - shift)], dim=w_axis)
