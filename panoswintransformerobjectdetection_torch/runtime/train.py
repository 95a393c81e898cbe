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
"""

from typing import Callable, Dict, Optional

import torch

from ..models.detectors import run_stage

# The stages of one step after `forward_train`'s own (`TRAIN_STAGES`).
STEP_STAGES = ("backward", "optimizer")


def make_train_step(detector, optimizer: torch.optim.Optimizer, scheduler=None) -> Callable:
    """Returns step(batch, noise=None, generator=None, stage=...) -> metrics.

    batch: dict of `images` (B, H, W, 3), `img_shapes` (B, 2), `gt_boxes`
    (B, G, 4), `gt_labels` (B, G), `gt_valid` (B, G), and `gt_masks` (B, G,
    H', W') where the loader made them (the mask loss).  `noise` and
    `generator` go to `forward_train`'s samplers.  The step updates the
    detector's parameters and the stem's running statistics in place.
    """
    params = [p for p in detector.parameters() if p.requires_grad]

    def step(batch: Dict[str, torch.Tensor], noise=None,
             generator: Optional[torch.Generator] = None,
             stage: Callable = run_stage) -> Dict[str, torch.Tensor]:
        optimizer.zero_grad(set_to_none=True)
        out = detector.forward_train(batch["images"], batch["img_shapes"], batch["gt_boxes"],
                                     batch["gt_labels"], batch["gt_valid"],
                                     batch.get("gt_masks"), noise=noise, generator=generator,
                                     stage=stage)
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
        metrics["grad_norm"] = norm
        return metrics

    return step
