"""Dataset wrappers (`mmdet/datasets/dataset_wrappers.py`): Repeat,
ClassBalanced and Concat (with its per-dataset `evaluate`).

The port's own copy of `panoswintransformerobjectdetection_tpu/data/
wrappers.py`, numpy.
"""

import math
from typing import Sequence

import numpy as np


class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times
        self.CLASSES = dataset.CLASSES
        self.flags = np.tile(getattr(dataset, "flags", np.zeros(len(dataset), np.uint8)),
                             times)

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


class ConcatDataset:
    def __init__(self, datasets: Sequence, separate_eval: bool = True):
        self.datasets = list(datasets)
        self.separate_eval = separate_eval
        self.CLASSES = datasets[0].CLASSES
        self.offsets = np.cumsum([0] + [len(d) for d in datasets])
        self.flags = np.concatenate(
            [getattr(d, "flags", np.zeros(len(d), np.uint8)) for d in datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, i):
        di = int(np.searchsorted(self.offsets, i, side="right")) - 1
        return self.datasets[di][i - int(self.offsets[di])]

    def evaluate(self, results, **kwargs):
        """Per-sub-dataset evaluation (`dataset_wrappers.py ConcatDataset
        .evaluate` separate_eval semantics): results are sliced by dataset
        boundary and metric keys prefixed with the slice index."""
        if not self.separate_eval:
            raise NotImplementedError(
                "joint eval across concatenated datasets is not supported; "
                "use separate_eval=True (the reference only joint-evals "
                "same-type datasets and so does this framework)")
        assert len(results) == len(self), (
            f"results ({len(results)}) != dataset size ({len(self)})")
        out = {}
        for di, ds in enumerate(self.datasets):
            lo, hi = int(self.offsets[di]), int(self.offsets[di + 1])
            for k, v in ds.evaluate(results[lo:hi], **kwargs).items():
                out[f"{di}_{k}"] = v
        return out


class ClassBalancedDataset:
    """Oversample images containing rare categories (`ClassBalancedDataset`,
    LVIS-style repeat factors: r(I) = max_c sqrt(t / f(c)))."""

    def __init__(self, dataset, oversample_thr: float = 1e-3):
        self.dataset = dataset
        self.CLASSES = dataset.CLASSES
        n = len(dataset)
        num_classes = len(dataset.CLASSES)
        counts = np.zeros(num_classes)
        img_labels = []
        for r in dataset.records:
            labs = np.unique(r["labels"])
            img_labels.append(labs)
            for l in labs:
                counts[l] += 1
        freq = counts / max(n, 1)
        cat_repeat = np.maximum(1.0, np.sqrt(oversample_thr / np.maximum(freq, 1e-12)))
        self.indices = []
        for i, labs in enumerate(img_labels):
            r = max([cat_repeat[l] for l in labs], default=1.0)
            self.indices.extend([i] * int(math.ceil(r)))
        self.flags = np.asarray(
            [getattr(dataset, "flags", np.zeros(n, np.uint8))[i] for i in self.indices],
            np.uint8)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
