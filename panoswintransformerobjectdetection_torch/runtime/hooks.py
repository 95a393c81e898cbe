"""Training hooks: callbacks at the training loop's epoch and step boundaries.

Counterpart of `panoswintransformerobjectdetection_tpu/runtime/hooks.py`
(the role of mmcv's hook system).  `apis/train.train_detector` calls each
hook's methods with one shared `ctx` dict: `work_dir`, `epoch`, `step` (the
micro-steps taken), `model`, `dataset`, after a step `metrics` (floats),
and `logs`, a list of lines that the loop logs and clears after the step's
hooks, and `is_main`.  In a distributed run every process calls its hooks;
the loop's log is rank 0's alone, and a hook that writes files writes them
where `ctx["is_main"]` (rank 0).  None of the hooks here writes a file.
"""

import logging
from typing import Any, Callable, Dict

import torch

logger = logging.getLogger("panoswin_torch")


class Hook:
    def before_train(self, ctx: Dict[str, Any]):
        pass

    def before_epoch(self, ctx: Dict[str, Any]):
        pass

    def after_iter(self, ctx: Dict[str, Any]):
        pass

    def after_epoch(self, ctx: Dict[str, Any]):
        pass

    def after_train(self, ctx: Dict[str, Any]):
        pass


class LrRecordHook(Hook):
    """Put `schedule(step)` into the step's metrics as `lr`, with `step` the
    micro-steps taken, as the JAX hook does."""

    def __init__(self, schedule: Callable[[int], float]):
        self.schedule = schedule

    def after_iter(self, ctx):
        if ctx.get("metrics") is not None:
            ctx["metrics"]["lr"] = float(self.schedule(ctx["step"]))


class EmptyCacheHook(Hook):
    """Every `interval` steps on the card: release the caching allocator's
    unused blocks (`torch.cuda.empty_cache()`) and log the bytes still
    allocated (mmcv's `EmptyCacheHook`; the JAX hook counts live arrays)."""

    def __init__(self, interval: int = 1000):
        self.interval = interval

    def after_iter(self, ctx):
        model = ctx.get("model")
        if ctx["step"] % self.interval or model is None or model.device.type != "cuda":
            return
        torch.cuda.empty_cache()
        ctx.setdefault("logs", []).append(
            f"allocated bytes: {torch.cuda.memory_allocated(model.device)}")


class NumClassCheckHook(Hook):
    """Before training, warn when the detector's `num_classes` differs from
    the length of the dataset's `CLASSES` (mmdet's `NumClassCheckHook`)."""

    def before_train(self, ctx):
        classes = getattr(ctx.get("dataset"), "CLASSES", None)
        nc = getattr(ctx.get("model"), "num_classes", None)
        if classes is None or nc is None:
            return
        if len(classes) != nc:
            logger.warning("model num_classes (%d) != len(dataset.CLASSES) (%d): fix "
                           "model.num_classes or pass classes= to the dataset", nc, len(classes))
