"""Train a detector from a config file (the reference's `tools/train.py`).

    python -m panoswintransformerobjectdetection_torch.tools.train <config> \\
        [--work-dir DIR] [--resume-from CKPT] [--seed N] [--cfg-options k=v ...] [--device cpu]
    python -m torch.distributed.run --nproc_per_node N \\
        -m panoswintransformerobjectdetection_torch.tools.train <config> --launcher pytorch \\
        --pad-to H W [...]

Counterpart of the JAX package's `tools/train.py`, reading the config the
same way: `classes` handed to every split's dataset, `runner.max_epochs`
against a legacy `total_epochs` (a config with both, different, is an
error), `optimizer` (lr, weight decay), `lr_config` (warm-up, decay
epochs), `checkpoint_config`, `log_config`, `data.samples_per_gpu` and
`workers_per_gpu`, `load_from` and `model.pretrained`.  Like the JAX CLI it
sets no gradient clipping or accumulation.  With a `data.val` split, each
epoch ends with `single_device_test` and `dataset.evaluate` on it.  Runs on
the card unless `--device cpu` is given.  `--launcher pytorch` (under
torchrun) joins the process group (`parallel/dist.init_distributed`: NCCL
on the cards, gloo with `--device cpu`) and trains the global batch of
`samples_per_gpu * W` images, each process loading its shard, as the
reference's `tools/dist_train.sh` does; every batch is then padded to one
shape, `--pad-to H W`, which must hold the pipeline's largest image, and
evaluation after each epoch is `multi_host_test` (rank 0 evaluates).
"""

import argparse
import ast
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                   help="'pytorch': join torchrun's process group (distributed training)")
    p.add_argument("--pad-to", type=int, nargs=2, default=None, metavar=("H", "W"),
                   help="pad every training batch to H x W (needed with more than one "
                        "process, so that every process's batch has one shape)")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="the detector's device: the CUDA card unless given (e.g. cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..apis.inference import build_detector_from_cfg
    from ..apis.test import multi_host_test
    from ..apis.train import train_detector
    from ..data.builder import build_dataset
    from ..device import resolve_device
    from ..parallel.dist import init_distributed, world
    from ..runtime.config import load_config, set_by_dotted

    device = resolve_device(args.device)
    if args.launcher == "pytorch":
        init_distributed("pytorch", device=device)

    cfg = load_config(args.config)
    for opt in args.cfg_options:
        k, v = opt.split("=", 1)
        try:
            v = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            pass
        set_by_dotted(cfg, k, v)

    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    if "classes" in cfg:
        for split in ("train", "val", "test"):
            if cfg["data"].get(split):
                cfg["data"][split]["classes"] = cfg["classes"]

    model = build_detector_from_cfg(cfg)
    dataset = build_dataset(cfg["data"]["train"])

    eval_fn = None
    if cfg["data"].get("val"):
        val_ds = build_dataset(cfg["data"]["val"])

        def eval_fn(m):
            results = multi_host_test(m, val_ds, device=m.device)
            return None if results is None else val_ds.evaluate(results)

    sched = cfg.get("lr_config", {})
    opt = cfg.get("optimizer", {})
    # runner.max_epochs (the 2.x dialect) against a legacy top-level
    # total_epochs: both, with different values, is an error, never a silent
    # pick (`mmdet/apis/train.py:113-114`)
    runner_epochs = cfg.get("runner", {}).get("max_epochs")
    legacy_epochs = cfg.get("total_epochs")
    if (runner_epochs is not None and legacy_epochs is not None
            and runner_epochs != legacy_epochs):
        raise ValueError(
            f"runner.max_epochs ({runner_epochs}) != total_epochs ({legacy_epochs}); set only "
            "one (a child config overriding a base schedule must override "
            "runner=dict(max_epochs=...))")
    total_epochs = runner_epochs if runner_epochs is not None else (
        legacy_epochs if legacy_epochs is not None else 12)
    return train_detector(
        model, dataset,
        work_dir=work_dir,
        total_epochs=total_epochs,
        batch_size=cfg.get("data", {}).get("samples_per_gpu", 2) * world(),
        num_workers=cfg.get("data", {}).get("workers_per_gpu", 2),
        base_lr=opt.get("lr", 1e-4),
        weight_decay=opt.get("weight_decay", 0.05),
        warmup_iters=sched.get("warmup_iters", 500),
        decay_epochs=tuple(sched.get("step", (8, 11))),
        checkpoint_interval=cfg.get("checkpoint_config", {}).get("interval", 1),
        log_interval=cfg.get("log_config", {}).get("interval", 50),
        eval_fn=eval_fn,
        seed=args.seed,
        resume_from=args.resume_from,
        load_from=cfg.get("load_from"),
        pretrained=cfg.get("model", {}).get("pretrained"),
        device=device,
        **({"pad_to": tuple(args.pad_to)} if args.pad_to else {}),
    )


if __name__ == "__main__":
    main(sys.argv[1:])
