"""One optimizer step of the detector.

Counterpart of `make_train_step` in
`panoswintransformerobjectdetection_tpu/runtime/train.py`: the total loss
is the sum of `forward_train`'s entries whose key contains "loss"; backward;
the optimizer's micro-step (`runtime/optim.AccumulatingAdamW`: accumulation
and clipping, then AdamW on every k-th call); the metrics carry `loss` and
`grad_norm`, the norm of this micro-step's gradient before any clipping,
beside the outputs.
Parameters stay float32; with a bfloat16 compute type the activations are
cast where the inference path casts them, and no loss scaling is needed.

Under a process group of W processes (`parallel/dist`), each holding its
rows of the global batch, the step is the JAX package's step on the
global batch, as on a data mesh: every loss normaliser and live
BatchNorm's statistics are the global batch's (the models sum them over
the processes), so each process's loss is its share of the global loss,
and the gradient is the sum of the processes' gradients.  The detector
runs inside `DistributedDataParallel` (`ddp_wrap`), whose communication
hook sums the gradients rather than averaging them (DDP's default divides
by W); a parameter that no process's loss reached keeps `.grad` None on
every process, one that some process's loss reached gets the sum on all
(`find_unused_parameters`: the cascade's mask head is reached by no loss).
Every micro-step is summed, with accumulation too: JAX's micro-step
gradient is the global one, and so is the logged `grad_norm`.  The logged
losses are the processes' shares summed (one all-reduce a step).
"""

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.nn.parallel import DistributedDataParallel

from ..models.detectors import run_stage
from ..parallel.dist import all_reduce_sum

# The stages of one step after `forward_train`'s own (`TRAIN_STAGES`).
STEP_STAGES = ("backward", "optimizer")


def _sum_gradients(_, bucket):
    """DDP communication hook: the bucket's gradients summed over the
    processes (the default hook's mean would be the gradient over W)."""
    fut = dist.all_reduce(bucket.buffer(), async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


def ddp_wrap(detector: torch.nn.Module) -> DistributedDataParallel:
    """`detector` (whose `forward` is `forward_train`) inside
    `DistributedDataParallel` over the default process group: parameters
    and buffers broadcast from rank 0 once, here; gradients summed
    (`_sum_gradients`); buffers not broadcast again at each step
    (synchronised BatchNorm keeps them equal)."""
    dev = detector.device
    index = (torch.cuda.current_device() if dev.index is None else dev.index
             ) if dev.type == "cuda" else None
    ddp = DistributedDataParallel(detector, device_ids=None if index is None else [index],
                                  broadcast_buffers=False, find_unused_parameters=True)
    ddp.register_comm_hook(None, _sum_gradients)
    return ddp


def make_train_step(detector, optimizer: torch.optim.Optimizer, scheduler=None) -> Callable:
    """Returns step(batch, noise=None, generator=None, stage=...) -> metrics.

    batch: dict of `images` (B, H, W, 3), `img_shapes` (B, 2), `gt_boxes`
    (B, G, 4), `gt_labels` (B, G), `gt_valid` (B, G), and `gt_masks` (B, G,
    H', W') where the loader made them (the mask loss) and `pano_ratio_v`
    (B, 3), which a `PanoSwinTransformerV2` backbone reads (JAX
    `runtime/train.py:44-52`).  `noise` and
    `generator` go to `forward_train`'s samplers.  The step updates the
    detector's parameters and the stem's running statistics in place.
    Under a process group the batch is this process's rows of the global
    batch (`noise` too, where handed in) and the detector is wrapped here
    (`ddp_wrap`, a collective: every process makes its step together);
    `step.ddp` is the wrapper, None without a process group.
    """
    params = [p for p in detector.parameters() if p.requires_grad]
    ddp = ddp_wrap(detector) if dist.is_available() and dist.is_initialized() else None
    forward_train = ddp if ddp is not None else detector.forward_train

    def step(batch: Dict[str, torch.Tensor], noise=None,
             generator: Optional[torch.Generator] = None,
             stage: Callable = run_stage) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        out = forward_train(batch["images"], batch["img_shapes"], batch["gt_boxes"],
                            batch["gt_labels"], batch["gt_valid"], batch.get("gt_masks"),
                            pano_ratio_v=batch.get("pano_ratio_v"), noise=noise,
                            generator=generator, stage=stage)
        total = sum(v for k, v in out.items() if "loss" in k)
        stage("backward", total.backward)

        def update():
            grads = [p.grad for p in params if p.grad is not None]
            norm = torch.nn.utils.get_total_norm(grads)
            if optimizer.step() and scheduler is not None:
                scheduler.step()
            return norm

        norm = stage("optimizer", update)
        metrics = {k: v.detach() for k, v in out.items()}
        metrics["loss"] = total.detach()
        if ddp is not None:
            summed = all_reduce_sum(torch.stack([v.float() for v in metrics.values()]))
            metrics = dict(zip(metrics, summed.unbind()))
        metrics["grad_norm"] = norm
        return metrics

    step.ddp = ddp
    return step
