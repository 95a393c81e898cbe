"""Datasets, pipelines and loaders from config dicts (the registries' role).

Counterpart of `panoswintransformerobjectdetection_tpu/data/builder.py`
(`PIPELINES`, `DATASETS`, `build_pipeline`, `build_dataset`,
`build_dataloader`, `replace_ImageToTensor`, `get_loading_pipeline`).
Pipeline steps of the JAX package that the port has not ported (the
photometric distortion and InstaBoost) raise
`NotImplementedError` naming ROADMAP.md, Queue 1, item 17.
`build_dataloader` shards by the `num_shards` and `shard_id` it is given,
or by the process group's (`parallel/dist`) when it is given none.
"""

from typing import Optional, Sequence

from ..parallel.dist import rank, world
from . import datasets as D
from . import transforms as T
from .loader import DetDataLoader
from .wrappers import ClassBalancedDataset, ConcatDataset, RepeatDataset

PIPELINES = {
    "LoadImageFromFile": T.LoadImageFromFile,
    "LoadAnnotations": T.LoadAnnotations,
    "LoadPanoAnnotations": T.LoadAnnotations,   # BFoV conversion at parse time
    "Resize": T.Resize,
    "PanoResize": T.PanoResize,
    "RandomFlip": T.RandomFlip,
    "Normalize": T.Normalize,
    "Pad": T.Pad,
    "PanoStretch": T.PanoStretch,
    "RollAug": T.RollAug,
    "PanoCheck": T.PanoCheck,
    "BasketBallExpand": T.BasketBallExpand,
    "RandomCrop": T.RandomCrop,
    "AutoAugment": T.AutoAugment,
}
# The JAX package's other pipeline steps: OpenCV's HSV (absent on the card's
# machine) and InstaBoost.
UNPORTED_PIPELINES = ("PhotoMetricDistortion", "InstaBoost")
# Steps whose work the loader's collation does.
COLLATION_STEPS = ("DefaultFormatBundle", "Collect", "ImageToTensor", "MultiScaleFlipAug")

DATASETS = {
    "CocoDataset": D.CocoDataset,
    "StreetDataset": D.StreetDataset,
    "Indoor360Dataset": D.Indoor360Dataset,
    "VOCDataset": D.VOCDataset,
    "XMLDataset": D.VOCDataset,        # generic xml_style base: pass classes=
    "LVISDataset": D.LVISDataset,
    "LVISV05Dataset": D.LVISDataset,   # the class list comes from the json
    "LVISV1Dataset": D.LVISDataset,
    "CityscapesDataset": D.CityscapesDataset,
    "WIDERFaceDataset": D.WIDERFaceDataset,
    "DeepFashionDataset": D.DeepFashionDataset,
}


def build_pipeline(cfgs: Sequence[dict]):
    steps = []
    for c in cfgs:
        c = dict(c)
        kind = c.pop("type")
        if kind in COLLATION_STEPS:
            continue
        if kind in UNPORTED_PIPELINES:
            raise NotImplementedError(f"pipeline step {kind!r} is not ported yet "
                                      "(ROADMAP.md, Queue 1, item 17)")
        if kind == "LoadPanoAnnotations":
            c.pop("bb_tangent2sphere", None)
            c.pop("with_mask", None)
        steps.append(PIPELINES[kind](**c))
    return steps


def build_dataset(cfg):
    """`mmdet/datasets/builder.py:53 build_dataset`: wrapper types recurse; a
    list of configs or a list-valued `ann_file` concatenates
    (`builder.py:26 _concat_dataset`)."""
    if isinstance(cfg, (list, tuple)):
        return ConcatDataset([build_dataset(c) for c in cfg])
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind == "ConcatDataset":
        return ConcatDataset([build_dataset(c) for c in cfg["datasets"]],
                             cfg.get("separate_eval", True))
    if kind == "RepeatDataset":
        return RepeatDataset(build_dataset(cfg["dataset"]), cfg.get("times", 1))
    if kind == "ClassBalancedDataset":
        return ClassBalancedDataset(build_dataset(cfg["dataset"]),
                                    cfg.get("oversample_thr", 1e-3))
    if isinstance(cfg.get("ann_file"), (list, tuple)):
        ann_files = cfg.pop("ann_file")
        prefixes = cfg.pop("img_prefix", "")
        separate_eval = cfg.pop("separate_eval", True)
        parts = []
        for i, af in enumerate(ann_files):
            sub = dict(cfg, type=kind, ann_file=af)
            sub["img_prefix"] = prefixes[i] if isinstance(prefixes, (list, tuple)) else prefixes
            parts.append(build_dataset(sub))
        return ConcatDataset(parts, separate_eval)
    pipeline = cfg.pop("pipeline", None)
    if pipeline:
        cfg["pipeline"] = build_pipeline(pipeline)
    return DATASETS[kind](**cfg)


def build_dataloader(dataset, samples_per_gpu: int, workers_per_gpu: int = 0,
                     num_gpus: int = 1, shuffle: bool = True, seed: int = 0,
                     num_shards: Optional[int] = None, shard_id: Optional[int] = None,
                     **kw) -> DetDataLoader:
    """`mmdet/datasets/builder.py:75 build_dataloader`: a `DetDataLoader`
    of `samples_per_gpu * num_gpus` images a batch over shard `shard_id` of
    `num_shards`; where not given, the process group's world and rank (1
    and 0 without one), as the reference's distributed sampler takes them."""
    num_shards = world() if num_shards is None else num_shards
    shard_id = rank() if shard_id is None else shard_id
    return DetDataLoader(dataset, batch_size=samples_per_gpu * num_gpus, shuffle=shuffle,
                         seed=seed, num_shards=num_shards, shard_id=shard_id,
                         num_workers=workers_per_gpu, **kw)


def replace_ImageToTensor(pipelines):
    """`mmdet/datasets/utils.py:13`: ImageToTensor becomes
    DefaultFormatBundle in a pipeline config (inside MultiScaleFlipAug too)."""
    out = []
    for p in pipelines:
        p = dict(p)
        if p.get("type") == "MultiScaleFlipAug":
            p["transforms"] = replace_ImageToTensor(p.get("transforms", []))
        elif p.get("type") == "ImageToTensor":
            p = {"type": "DefaultFormatBundle"}
        out.append(p)
    return out


def get_loading_pipeline(pipeline):
    """`mmdet/datasets/utils.py:73`: the Load* steps of a pipeline config."""
    return [dict(p) for p in pipeline if str(p.get("type", "")).startswith("Load")]
