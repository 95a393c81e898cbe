"""Evaluate a checkpoint on a config's test set (the reference's `tools/test.py`).

    python -m panoswintransformerobjectdetection_torch.tools.test <config> [<checkpoint>] \\
        --eval bbox [segm] [proposal] [--classwise] [--out results.pkl] [--batch-size N] [--tta]

Counterpart of the JAX package's `tools/test.py`: the config (`_base_`
inheritance, `runtime/config.py`), the detector from the config and a
reference `.pth` (`init_detector`; no checkpoint means random weights from
seed 0), the test dataset (`build_dataset`), `single_device_test` (with
masks when `segm` is asked for, which needs a Mask R-CNN config; or, with
`--tta`, `apis/tta.aug_test_detector` on each image at the config's `tta`
scales and flip), then the COCOeval-exact `dataset.evaluate`.  Prints
the metrics as JSON (NaN, a class without ground truth, as null), writes
the per-image results to `--out` as a pickle, and returns the metrics.
Runs on the card unless `--device cpu` is given.  `--launcher pytorch`
(under torchrun, `python -m torch.distributed.run --nproc_per_node N -m
panoswintransformerobjectdetection_torch.tools.test ... --launcher
pytorch`) joins the process group (NCCL on the cards, gloo with `--device
cpu`); with more than one process the records are spread over them by
`multi_host_test`, rank 0 evaluates and prints, and the other ranks
return None, as the JAX CLI does.  `multi_host_test` gathers no masks (nor
does the JAX function): `--eval segm` with more than one process raises.
"""

import argparse
import json
import math
import os
import pickle
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--eval", nargs="*", default=["bbox"], choices=["bbox", "segm", "proposal"])
    p.add_argument("--tta", action="store_true",
                   help="multi-scale + flip test-time augmentation")
    p.add_argument("--classwise", action="store_true")
    p.add_argument("--out", default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--device", default=None,
                   help="the detector's device: the CUDA card unless given (e.g. cpu)")
    p.add_argument("--launcher", choices=["none", "pytorch"], default="none",
                   help="'pytorch': join torchrun's process group (distributed evaluation)")
    args = p.parse_args(argv)

    from ..apis.inference import init_detector
    from ..apis.test import multi_host_test, single_device_test
    from ..data.builder import build_dataset
    from ..device import resolve_device
    from ..parallel.dist import init_distributed, world
    from ..runtime.config import load_config

    if args.launcher == "pytorch":
        init_distributed("pytorch", device=resolve_device(args.device))
        if world() > 1 and "segm" in args.eval:
            raise NotImplementedError("--eval segm with more than one process: multi_host_test "
                                      "gathers no masks, as the JAX package's does not "
                                      "(ROADMAP.md, Queue 1, item 17d)")

    cfg = load_config(args.config)
    if "classes" in cfg:
        cfg["data"]["test"]["classes"] = cfg["classes"]
    model = init_detector(cfg, args.checkpoint, device=args.device)
    dataset = build_dataset(cfg["data"]["test"])
    with_masks = "segm" in args.eval

    if args.tta:
        from ..apis.tta import aug_test_detector
        from ..data.transforms import LoadImageFromFile
        if with_masks:
            raise ValueError("--tta supports bbox evaluation only")
        load = LoadImageFromFile()
        tta_cfg = cfg.get("tta", {})
        results = []
        for rec in dataset.records:
            r = load({"img_path": os.path.join(dataset.img_prefix, rec["filename"]),
                      "img_info": rec})
            results.append(aug_test_detector(
                model, r["img"], scales=tuple(tta_cfg.get("scales", ((800, 1333),))),
                flip=tta_cfg.get("flip", True)))
    elif world() > 1:
        results = multi_host_test(model, dataset, batch_size=args.batch_size,
                                  device=model.device)
        if results is None:         # a rank other than 0
            return None
    else:
        results = single_device_test(model, dataset, batch_size=args.batch_size,
                                     with_masks=with_masks, progress=True, device=model.device)

    metrics = dataset.evaluate(results, metric=args.eval, classwise=args.classwise)
    printable = {k: (None if isinstance(v, float) and math.isnan(v) else v)
                 for k, v in metrics.items()}
    print(json.dumps(printable, indent=2))
    if args.out:
        with open(args.out, "wb") as f:
            pickle.dump(results, f)
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
