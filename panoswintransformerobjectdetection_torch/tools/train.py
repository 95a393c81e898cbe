"""Train a detector from a config file (the reference's `tools/train.py`).

    python -m panoswintransformerobjectdetection_torch.tools.train <config> \\
        [--work-dir DIR] [--resume-from CKPT] [--seed N] [--cfg-options k=v ...] [--device cpu]

Counterpart of the JAX package's `tools/train.py`, reading the config the
same way: `classes` handed to every split's dataset, `runner.max_epochs`
against a legacy `total_epochs` (a config with both, different, is an
error), `optimizer` (lr, weight decay), `lr_config` (warm-up, decay
epochs), `checkpoint_config`, `log_config`, `data.samples_per_gpu` and
`workers_per_gpu`, `load_from` and `model.pretrained`.  Like the JAX CLI it
sets no gradient clipping or accumulation.  With a `data.val` split, each
epoch ends with `single_device_test` and `dataset.evaluate` on it.  Runs on
the card unless `--device cpu` is given; `--launcher` takes `none` only
(distributed training is ROADMAP.md, Queue 1, item 16b).
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
    p.add_argument("--launcher", default="none",
                   help="'none' (one process); distributed launchers are not ported")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--device", default=None,
                   help="the detector's device: the CUDA card unless given (e.g. cpu)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.launcher != "none":
        raise NotImplementedError(f"--launcher {args.launcher}: distributed training is not "
                                  "ported yet (ROADMAP.md, Queue 1, item 16b)")
    from ..apis.inference import build_detector_from_cfg
    from ..apis.test import single_device_test
    from ..apis.train import train_detector
    from ..data.builder import build_dataset
    from ..device import resolve_device
    from ..runtime.config import load_config, set_by_dotted

    device = resolve_device(args.device)

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
            return val_ds.evaluate(single_device_test(m, val_ds, device=m.device))

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
        batch_size=cfg.get("data", {}).get("samples_per_gpu", 2),
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
    )


if __name__ == "__main__":
    main(sys.argv[1:])
