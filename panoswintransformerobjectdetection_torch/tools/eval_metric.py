"""Evaluate saved detection results against a config's test set (the
reference's `tools/analysis_tools/eval_metric.py`).

    python -m panoswintransformerobjectdetection_torch.tools.eval_metric <config> <results.pkl>

Counterpart of the JAX package's `tools/eval_metric.py`: `results.pkl` is
the list of per-image dicts (boxes, scores, labels) that `tools.test --out`
writes.  Prints the bbox metrics as JSON and returns them.  Host only.
"""

import argparse
import json
import pickle
import sys


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("config")
    p.add_argument("results", help="pickle from tools.test --out")
    args = p.parse_args(argv)

    from ..data.builder import build_dataset
    from ..runtime.config import load_config

    cfg = load_config(args.config)
    if "classes" in cfg:
        cfg["data"]["test"]["classes"] = cfg["classes"]
    dataset = build_dataset(cfg["data"]["test"])
    with open(args.results, "rb") as f:
        results = pickle.load(f)
    metrics = dataset.evaluate(results)
    print(json.dumps(metrics, indent=2))
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
