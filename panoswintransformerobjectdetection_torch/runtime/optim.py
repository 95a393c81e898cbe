"""The optimizer and its learning-rate schedule.

Counterpart of `no_decay_mask`, `warmup_step_schedule` and `make_optimizer`
in `panoswintransformerobjectdetection_tpu/runtime/optim.py`: AdamW, lr
1e-4, betas (0.9, 0.999), weight decay 0.05 except on biases, norm layers
(LayerNorm, BatchNorm), the sphere-bias tables and absolute position
embeddings; linear warm-up, then stepwise decay.  optax's chain (Adam's
scaling, decayed weights on the mask, the learning rate) is
`torch.optim.AdamW` with two parameter groups and a `LambdaLR`.  optax's
`clip_by_global_norm` and `MultiSteps`, which the JAX package puts in front
of it, are `AccumulatingAdamW`: the running mean of k micro-steps'
gradients, clipped as optax clips, then one AdamW update.
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
    `NO_DECAY_NAMES`.  A bias is a parameter named `bias`: the `'tf'`
    embed's `in_proj_bias` decays, as the JAX mask decays it."""
    norm_params = {f"{name}.{p}" if name else p
                   for name, m in model.named_modules() if isinstance(m, _NORMS)
                   for p, _ in m.named_parameters(recurse=False)}
    return {name: not (name.rsplit(".", 1)[-1] == "bias" or name in norm_params
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


class AccumulatingAdamW(torch.optim.AdamW):
    """AdamW behind optax's `clip_by_global_norm(grad_clip)` (off at 0) and
    `MultiSteps(every_k_schedule=accumulate_steps)`.

    Each `step()` is a micro-step.  It folds the parameters' `.grad` into a
    running mean, acc <- acc + (g - acc) / (n + 1) with n the micro-steps
    already taken, as optax does; on every k-th micro-step the mean is
    clipped (kept when its global norm is below `grad_clip`, else g / norm *
    grad_clip) and AdamW updates the parameters, and the mean starts again
    from zero.  Between those steps the parameters do not move.  `step()`
    returns True when it updated them: the learning-rate schedule counts
    those updates, as optax's inner chain does.  The mean and the
    micro-step count are optimizer state (`state_dict`), so a run resumes
    between micro-steps as it would have gone on.

    A parameter whose `.grad` is None (no loss reaches it) steps with a zero
    gradient, as `jax.grad` hands optax one: its moments stay 0, its Adam
    step is 0, and its weight still decays by lr * weight_decay where its
    group decays.  Its `.grad` is None again after the step.
    """

    def __init__(self, params, grad_clip: float = 0.0, accumulate_steps: int = 1, **adamw):
        if accumulate_steps < 1:
            raise ValueError(f"accumulate_steps must be >= 1, not {accumulate_steps}")
        super().__init__(params, **adamw)
        self.grad_clip = float(grad_clip)
        self.accumulate_steps = int(accumulate_steps)
        self.acc_grads: Dict[torch.Tensor, torch.Tensor] = {}
        for group in self.param_groups:
            group.setdefault("micro_step", 0)

    def _params(self):
        return [p for g in self.param_groups for p in g["params"]]

    def state_dict(self):
        out = super().state_dict()
        out["acc_grads"] = {i: self.acc_grads[p] for i, p in enumerate(self._params())
                            if p in self.acc_grads}
        return out

    def load_state_dict(self, state_dict):
        state_dict = dict(state_dict)
        acc = state_dict.pop("acc_grads", {})
        super().load_state_dict(state_dict)
        params = self._params()
        self.acc_grads = {params[i]: t.to(params[i].device) for i, t in acc.items()}

    @torch.no_grad()
    def step(self, closure=None) -> bool:
        if closure is not None:
            raise ValueError("AccumulatingAdamW.step takes no closure")
        params = self._params()
        unreached = [p for p in params if p.grad is None]
        for p in unreached:
            p.grad = torch.zeros_like(p)
        try:
            return self._step(params, {id(p) for p in unreached})
        finally:
            for p in unreached:
                p.grad = None

    def _step(self, params, unreached) -> bool:
        k = self.accumulate_steps
        if k > 1:
            n = self.param_groups[0].get("micro_step", 0)
            for p in params:
                acc = self.acc_grads.setdefault(p, torch.zeros_like(p))
                acc.add_((p.grad - acc) / (n + 1))
            for group in self.param_groups:
                group["micro_step"] = (n + 1) % k
            if n + 1 < k:
                return False
            for p in params:
                p.grad = self.acc_grads[p].clone()
                self.acc_grads[p].zero_()
        if self.grad_clip > 0:
            norm = global_norm([p.grad for p in params])
            if not norm < self.grad_clip:
                for p in params:
                    p.grad.div_(norm).mul_(self.grad_clip)
        # The decoupled decay, taken out of AdamW's step (which applies it
        # first too), a foreach call a group.  Where a loss reached the
        # parameter, as AdamW rounds it, p * (1 - lr * wd); where none did,
        # the decay is the whole update, and optax's order, p + (-lr) * (wd *
        # p), gives optax's bits.  Either rule for both moves the other's
        # parameters by an ulp: decay-only weights then miss optax's, and
        # the loops held against the JAX package's drift.
        decays = [group["weight_decay"] for group in self.param_groups]
        for group, wd in zip(self.param_groups, decays):
            reached = [p for p in group["params"] if id(p) not in unreached]
            idle = [p for p in group["params"] if id(p) in unreached]
            if wd and reached:
                torch._foreach_mul_(reached, 1 - group["lr"] * wd)
            if wd and idle:
                update = torch._foreach_mul(idle, wd)
                torch._foreach_mul_(update, -group["lr"])
                torch._foreach_add_(idle, update)
            group["weight_decay"] = 0.0
        try:
            super().step()
        finally:
            for group, wd in zip(self.param_groups, decays):
                group["weight_decay"] = wd
        return True


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of every entry's square (optax's `global_norm`)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def make_optimizer(model: nn.Module, base_lr: float = 1e-4, weight_decay: float = 0.05,
                   betas=(0.9, 0.999), warmup_iters: int = 500, warmup_ratio: float = 0.001,
                   decay_steps: Sequence[int] = (), grad_clip: float = 0.0,
                   accumulate_steps: int = 1
                   ) -> Tuple[AccumulatingAdamW, torch.optim.lr_scheduler.LambdaLR]:
    """AdamW over `model`'s parameters, decayed where `no_decay_mask` says,
    behind clipping and accumulation (`AccumulatingAdamW`), and the
    schedule; call `scheduler.step()` after every `optimizer.step()` that
    returns True."""
    mask = no_decay_mask(model)
    params = dict(model.named_parameters())
    groups = [{"params": [p for n, p in params.items() if mask[n]],
               "weight_decay": weight_decay},
              {"params": [p for n, p in params.items() if not mask[n]], "weight_decay": 0.0}]
    optimizer = AccumulatingAdamW(groups, grad_clip=grad_clip,
                                  accumulate_steps=accumulate_steps, lr=base_lr, betas=betas,
                                  eps=1e-8)
    sched = warmup_step_schedule(base_lr, warmup_iters, warmup_ratio, decay_steps)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, lambda step: sched(step) / base_lr)
    return optimizer, scheduler
