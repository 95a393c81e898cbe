"""The optimizer and its learning-rate schedule.

Counterpart of `no_decay_mask`, `warmup_step_schedule` and `make_optimizer`
in `panoswintransformerobjectdetection_tpu/runtime/optim.py`: AdamW, lr
1e-4, betas (0.9, 0.999), weight decay 0.05 except on biases, norm layers
(LayerNorm, BatchNorm), the sphere-bias tables and absolute position
embeddings; linear warm-up, then stepwise decay.  optax's chain (Adam's
scaling, decayed weights on the mask, the learning rate) is
`torch.optim.AdamW` with two parameter groups and a `LambdaLR`.  Gradient
clipping and accumulation, which the flagship's recipe leaves off, are not
ported.
"""

from typing import Callable, Dict, Sequence, Tuple

import torch
import torch.nn as nn

NO_DECAY_NAMES = ("_Te", "alpha_table", "beta_table", "relative_position_bias_table",
                  "absolute_pos_embed")
_NORMS = (nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._BatchNorm)


def no_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True where weight decay applies: everywhere but on
    biases, the parameters of norm layers, and the tables named in
    `NO_DECAY_NAMES`."""
    norm_params = {f"{name}.{p}" if name else p
                   for name, m in model.named_modules() if isinstance(m, _NORMS)
                   for p, _ in m.named_parameters(recurse=False)}
    return {name: not (name.endswith("bias") or name in norm_params
                       or any(k in name.rsplit(".", 1)[-1] for k in NO_DECAY_NAMES))
            for name, _ in model.named_parameters()}


def warmup_step_schedule(base_lr: float, warmup_iters: int = 500, warmup_ratio: float = 0.001,
                         decay_steps: Sequence[int] = (),
                         gamma: float = 0.1) -> Callable[[int], float]:
    """Step -> learning rate: linear warm-up from base_lr * warmup_ratio
    over `warmup_iters` steps, then base_lr times gamma for every decay
    step passed."""
    def fn(step: int) -> float:
        if step < warmup_iters:
            return base_lr * (warmup_ratio + (1 - warmup_ratio) * step / max(warmup_iters, 1))
        return base_lr * gamma ** sum(step >= s for s in decay_steps)
    return fn


def make_optimizer(model: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.05,
                   betas=(0.9, 0.999), warmup_iters: int = 500, warmup_ratio: float = 0.001,
                   decay_steps: Sequence[int] = ()
                   ) -> Tuple[torch.optim.AdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over `model`'s parameters, decayed where `no_decay_mask` says,
    and the schedule; call `scheduler.step()` after every `optimizer.step()`."""
    mask = no_decay_mask(model)
    params = dict(model.named_parameters())
    groups = [{"params": [p for n, p in params.items() if mask[n]],
               "weight_decay": weight_decay},
              {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0}]
    optimizer = torch.optim.AdamW(groups, lr=base_lr, betas=betas, eps=1e-8)
    sched = warmup_step_schedule(base_lr, warmup_iters, warmup_ratio, decay_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: sched(step) / base_lr)
    return optimizer, scheduler
