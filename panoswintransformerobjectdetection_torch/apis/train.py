"""Training API: a detector trained over a dataset, epoch by epoch.

Counterpart of `set_random_seed`, `_apply_init_weights` and `train_detector`
in `panoswintransformerobjectdetection_tpu/apis/train.py` (the reference's
`mmdet/apis/train.py:42 train_detector` with mmcv's runner and hooks): the
shuffling `DetDataLoader` on the host, `runtime/train.make_train_step` on
the device, a log line every `log_interval` steps (`train.log`, and
`train.log.json` with the JAX package's keys), an `epoch_{n}` checkpoint
every `checkpoint_interval` epochs with a `latest` link, an optional
`eval_fn` after each epoch, and the hooks (`runtime/hooks.py`) in the JAX
loop's order.  One process a device, the card unless the caller passes
`device="cpu"`.

Distributed (JAX `apis/train.py:99-145`): under a process group of W
processes (`parallel/dist.init_distributed`, torchrun), `batch_size` is the
global batch, which W must divide; each process loads `batch_size // W`
images of its loader shard (`DetDataLoader(num_shards=W, shard_id=rank)`,
which needs `buckets` or `pad_to`), and the step is the global batch's
(`runtime/train.py`).  Rank 0 alone writes `train.log`, `train.log.json`,
the `epoch_{n}` checkpoints and the `latest` link; every process waits at a
barrier after each checkpoint, and a checkpoint keeps every process's host
random states, so that each resumes its own.  `resume_from` loads on every
process; `eval_fn` runs on every process and rank 0 logs what it returns.

Randomness: the weights start from `flagship.init_weights(model, seed)`
(the JAX loop initialises from `PRNGKey(seed)`; the same seed does not give
the same weights), then `load_from` or `pretrained`.  Each step draws its
sampler noise and DropPath masks from two CPU generators seeded by (seed,
step) (`step_randomness`, the role of JAX's `fold_in(PRNGKey(seed + 1),
step)`), so the card and the CPU draw alike and a resumed run draws what
the uninterrupted one did.  The pipeline draws from Python's `random`, as
in JAX, and the loader shuffles with its own `random.Random(seed)`; a
checkpoint keeps both states, so a run resumed from `epoch_{n}` goes on
bit for bit as the uninterrupted one (with `num_workers=0`: worker threads
draw in the order they run).
"""

import json
import logging
import os
import random
import time
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch

from ..data.loader import DetDataLoader
from ..device import resolve_device
from ..flagship import init_weights
from ..models.detectors import BACKBONES, run_stage
from ..parallel.dist import all_gather_object, barrier, is_main, rank, world
from ..runtime.checkpoint import (load_backbone_weights, load_checkpoint, load_torch_state_dict,
                                  save_checkpoint)
from ..runtime.hooks import NumClassCheckHook
from ..runtime.optim import make_optimizer
from ..runtime.train import make_train_step
from .inference import load_weights

logger = logging.getLogger("panoswin_torch")

# The loop's steps, each run through `stage(name, fn)`: the next batch from
# the loader (pipeline and collation on the host unless worker threads made
# it already), its copy to the device, and the training step.
TRAIN_LOOP_STAGES = ("load", "copy", "step")
# What the step reads of a batch; `gt_masks` only where the pipeline loads
# masks; `pano_ratio_v` (the loader's (v0, v1, ori_h) of each image, this
# process's rows of them under a process group) for a v-variant backbone.
BATCH_KEYS = ("images", "img_shapes", "gt_boxes", "gt_labels", "gt_valid", "gt_masks",
              "pano_ratio_v")


def set_random_seed(seed: int, deterministic: bool = False) -> torch.Generator:
    """Seed Python's `random`, numpy and torch (every device), and return a
    CPU `torch.Generator` seeded with `seed`.  `deterministic` asks cuDNN
    for deterministic algorithms and turns its benchmarking off, as the
    reference does."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
    return torch.Generator().manual_seed(seed)


def step_randomness(model, seed: int, step: int, batch: dict) -> dict:
    """The random draws of training step `step` (0-based, micro-steps):
    DropPath's generator, set on the backbone, and the keyword arguments of
    the step function (a sampler generator); both are CPU generators seeded
    by (seed, step).  `batch` (the host batch) is for a replacement that
    hands over noise of the batch's shapes, as the parity tests do."""
    base = ((seed + 1) << 33) + 2 * step
    model.backbone.set_drop_path_generator(torch.Generator().manual_seed(base + 1))
    return {"generator": torch.Generator().manual_seed(base)}


def apply_init_weights(model, load_from: Optional[str] = None,
                       pretrained: Optional[str] = None) -> None:
    """`load_from`: a whole detector's reference `.pth` (or an `epoch_{n}`
    checkpoint) through `apis/inference.load_weights`.  Otherwise
    `pretrained`: a backbone's checkpoint file into `model.backbone`
    (`runtime/checkpoint.load_backbone_weights`): a reference PanoSwin one,
    a stock Swin ImageNet one (its classifier's `head.*` and `norm.*` left
    out), a torchvision or mmdet ResNet(-eXt) one (`fc.*` left out; the
    output of `tools/detectron2pytorch.py` too), a pycls RegNet one (or
    `tools/regnet2pytorch.py`'s output), as the JAX
    `_apply_init_weights` converts each.  A backbone of another type, a URL
    or a `torchvision://` name raises
    (`runtime/checkpoint.load_torch_state_dict`)."""
    if load_from:
        load_weights(model, load_from)
        logger.info("load_from %s", load_from)
        return
    if not pretrained:
        return
    name = type(model.backbone).__name__
    if not isinstance(model.backbone, tuple(BACKBONES.values())):
        raise NotImplementedError(f"pretrained init of a {name} backbone is not ported yet "
                                  "(ROADMAP.md, Queue 1, item 17)")
    load_backbone_weights(model.backbone, load_torch_state_dict(pretrained))
    logger.info("initialized %s backbone from %s", name, pretrained)


def train_detector(model, dataset, *, work_dir: str, total_epochs: int = 12,
                   batch_size: int = 2, base_lr: float = 1e-4, weight_decay: float = 0.05,
                   warmup_iters: int = 500, decay_epochs: Sequence[float] = (8, 11),
                   grad_clip: float = 0.0, accumulate_steps: int = 1, max_gt: int = 100,
                   log_interval: int = 50, checkpoint_interval: int = 1,
                   eval_fn: Optional[Callable] = None, seed: int = 0,
                   resume_from: Optional[str] = None, hooks=None, num_workers: int = 2,
                   buckets=None, pad_to=None, load_from: Optional[str] = None,
                   pretrained: Optional[str] = None,
                   device: Optional[Union[str, torch.device]] = None,
                   stage: Callable = run_stage):
    """Train `model` (a `PanoFasterRCNN`) in place on `device` and return it.

    The schedule: `decay_steps` are `decay_epochs` times the loader's
    batches an epoch, in micro-steps, as in the JAX loop; the schedule
    itself counts optimizer updates, so with `accumulate_steps` k > 1 each
    decay comes k times later than the epoch it names (the JAX package's
    behaviour, kept).  `grad_clip` > 0 clips the accumulated gradient by
    its global norm (`runtime/optim.AccumulatingAdamW`).  `eval_fn(model)`
    runs after each epoch with the model in eval mode; its dict of metrics
    is logged.  Each of `TRAIN_LOOP_STAGES` runs as `stage(name, fn)`.
    Under a process group, every process calls it alike (module docstring)."""
    dev = resolve_device(device)
    if batch_size % world():
        raise ValueError(f"the global batch of {batch_size} does not divide among "
                         f"{world()} processes")
    main = is_main()
    os.makedirs(work_dir, exist_ok=True)
    handler = logging.FileHandler(os.path.join(work_dir, "train.log")) if main else None
    if handler is not None:
        handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    try:
        with (open(os.path.join(work_dir, "train.log.json"), "a") if main
              else open(os.devnull, "w")) as json_log:
            loader = DetDataLoader(dataset, batch_size=batch_size // world(), max_gt=max_gt,
                                   seed=seed, num_workers=num_workers, buckets=buckets,
                                   pad_to=pad_to, num_shards=world(), shard_id=rank())
            steps_per_epoch = max(len(loader), 1)
            decay_steps = tuple(int(e * steps_per_epoch) for e in decay_epochs)
            init_weights(model, seed)
            model.to(dev).train()
            optimizer, scheduler = make_optimizer(
                model, base_lr=base_lr, weight_decay=weight_decay, warmup_iters=warmup_iters,
                decay_steps=decay_steps, grad_clip=grad_clip, accumulate_steps=accumulate_steps)
            host_generators = {"random": random, "loader": loader.rng}
            step, start_epoch = 0, 0
            if resume_from:
                step = load_checkpoint(resume_from, model, optimizer, scheduler,
                                       generators=host_generators)
                start_epoch = step // steps_per_epoch
                logger.info("resumed from %s at step %d", resume_from, step)
            else:
                apply_init_weights(model, load_from=load_from, pretrained=pretrained)
            step_fn = make_train_step(model, optimizer, scheduler)

            hooks = [NumClassCheckHook()] + list(hooks or [])
            ctx = {"work_dir": work_dir, "epoch": start_epoch, "step": step, "model": model,
                   "dataset": dataset, "is_main": main}
            for h in hooks:
                h.before_train(ctx)
            for epoch in range(start_epoch, total_epochs):
                ctx["epoch"] = epoch
                for h in hooks:
                    h.before_epoch(ctx)
                t0 = time.time()
                batches = iter(loader)
                i = 0
                while (batch := stage("load", lambda: next(batches, None))) is not None:
                    tensors = stage("copy", lambda: {k: torch.from_numpy(batch[k]).to(dev)
                                                     for k in BATCH_KEYS if k in batch})
                    kwargs = step_randomness(model, seed, step, batch)
                    metrics = stage("step", lambda: step_fn(tensors, **kwargs))
                    step += 1
                    ctx["step"] = step
                    ctx["metrics"] = {k: float(v) for k, v in metrics.items()}
                    for h in hooks:
                        h.after_iter(ctx)
                    for line in ctx.pop("logs", []):
                        logger.info(line)
                    i += 1
                    if i % log_interval == 0:
                        m = {k: ctx["metrics"][k] for k in metrics}
                        m.update(epoch=epoch + 1, iter=i, time=round((time.time() - t0) / i, 3))
                        logger.info("Epoch [%d][%d/%d] %s", epoch + 1, i, steps_per_epoch,
                                    " ".join(f"{k}: {v:.4f}" for k, v in m.items()
                                             if isinstance(v, float)))
                        json_log.write(json.dumps(m) + "\n")
                        json_log.flush()
                if (epoch + 1) % checkpoint_interval == 0:
                    path = os.path.abspath(os.path.join(work_dir, f"epoch_{epoch + 1}"))
                    states = all_gather_object(
                        {k: g.getstate() for k, g in host_generators.items()})
                    if main:
                        save_checkpoint(path, model, optimizer, scheduler, step=step,
                                        generators=host_generators, rank_generators=states)
                        latest = os.path.join(work_dir, "latest")
                        if os.path.islink(latest):
                            os.unlink(latest)
                        if not os.path.exists(latest):
                            os.symlink(path, latest)
                    barrier()
                if eval_fn is not None:
                    model.eval()
                    results = eval_fn(model)
                    model.train()
                    if results is not None and main:
                        logger.info("Eval epoch %d: %s", epoch + 1, results)
                        json_log.write(json.dumps({"epoch": epoch + 1, **results}) + "\n")
                        json_log.flush()
                for h in hooks:
                    h.after_epoch(ctx)
            for h in hooks:
                h.after_train(ctx)
            return model
    finally:
        if handler is not None:
            logger.removeHandler(handler)
            handler.close()
