"""Which of the repo's model configs the port builds, and why the others do
not.

    python -m panoswintransformerobjectdetection_torch.tools.config_census [configs_dir]

Loads every `configs/**/*.py` outside `_base_` that has a `model`, builds
it with `build_detector_from_cfg` on the meta device (no weights are made)
and prints one JSON object: the number of configs, the number that build,
the names of those, the number and names of the built ones whose training
configuration the port trains (`models/detectors.check_train_cfg`: every
backbone that builds trains), and the refusals counted by their message
(the first cause).  Host only.
"""

import argparse
import collections
import glob
import json
import os
import sys


def census(configs_dir: str) -> dict:
    import torch
    from ..apis.inference import build_detector_from_cfg
    from ..models.detectors import check_train_cfg
    from ..runtime.config import load_config

    built, trainable, refused = [], [], collections.Counter()
    paths = sorted(p for p in glob.glob(os.path.join(configs_dir, "**", "*.py"), recursive=True)
                   if "_base_" not in p.split(os.sep))
    total = 0
    for path in paths:
        cfg = load_config(path)
        if "model" not in cfg:
            continue
        total += 1
        try:
            with torch.device("meta"):
                model = build_detector_from_cfg(cfg)
        except Exception as e:        # every refusal, by its message's first line
            refused[f"{type(e).__name__}: {str(e).splitlines()[0][:120]}"] += 1
            continue
        name = os.path.relpath(path, configs_dir)
        built.append(name)
        try:
            check_train_cfg(model.train_cfg)
        except NotImplementedError:
            continue
        trainable.append(name)
    return {"configs": total, "built": len(built), "built_configs": built,
            "trainable": len(trainable), "trainable_configs": trainable,
            "refused_by_cause": dict(refused.most_common())}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("configs_dir", nargs="?", default="configs")
    result = census(p.parse_args(argv).configs_dir)
    print(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
