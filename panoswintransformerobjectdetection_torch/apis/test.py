"""The evaluation loop: a dataset through the detector, batch by batch.

Counterpart of `single_device_test` in
`panoswintransformerobjectdetection_tpu/apis/test.py` (the reference's
`single_gpu_test`).  `DetDataLoader` makes fixed-shape numpy batches on the
host; each goes to the device, through `simple_test` under
`torch.inference_mode()`, and back; the padded slots are dropped by the
result's `mask`, and each image's result is keyed by the record index the
batch carries.  With masks (a Mask R-CNN), `simple_test_masks` runs instead,
each image's detections are pasted into bitmaps of its original size on
the device (`models/mask_head.paste_masks`) and each bitmap is run-length
encoded on the host (`core/rle.encode`).  Runs on the card unless the
caller passes `device="cpu"`.  `multi_host_test` spreads the records over
the processes of a distributed run and gathers the results on rank 0.
"""

from typing import Callable, List, Optional, Union

import torch

from ..core import rle
from ..data.loader import DetDataLoader
from ..device import resolve_device
from ..models.detectors import PanoFasterRCNN, run_stage
from ..models.mask_head import paste_masks
from ..parallel.dist import all_gather_object, rank, world

# The loop's steps, each run through `stage(name, fn)`: the next batch from
# the loader (pipeline and collation on the host), its copy to the device,
# `simple_test` (`simple_test_masks` with masks), and the results' copy back
# and trim.  With masks two more: the paste of each detection's mask into
# its image on the device, with the bitmaps' copy back, and their
# run-length encoding on the host.
EVAL_STAGES = ("load", "copy", "simple_test", "results")
MASK_EVAL_STAGES = EVAL_STAGES + ("paste", "rle")


def single_device_test(model: PanoFasterRCNN, dataset, *, batch_size: int = 1,
                       max_gt: int = 100, with_masks: bool = False, progress: bool = False,
                       device: Optional[Union[str, torch.device]] = None,
                       stage: Callable = run_stage) -> List[dict]:
    """Per-image dicts (boxes (k, 4), scores (k,), labels (k,), and with
    `with_masks` masks: k RLE dicts of the image's original size) in
    original image coordinates, in the dataset's order.  `model` must
    already be on `device` (the card unless "cpu" is passed).  Each of
    `EVAL_STAGES` (`MASK_EVAL_STAGES` with masks) runs as `stage(name,
    fn)`; a caller that times the loop passes one that also times it.  A
    sample that the loader skips raises, rather than shifting every later
    result onto the wrong image."""
    dev = _model_device(model, device)
    loader = DetDataLoader(dataset, batch_size=batch_size, shuffle=False, max_gt=max_gt,
                           drop_last=False)
    by_index = _evaluate(model, loader, dev, with_masks, progress, stage)
    missing = [i for i in range(len(dataset)) if i not in by_index]
    if missing:
        raise RuntimeError(
            f"eval loader skipped {len(missing)} sample(s) (first: {missing[:5]}); results "
            "would misalign with dataset.records")
    return [by_index[i] for i in range(len(dataset))]


def multi_host_test(model: PanoFasterRCNN, dataset, *, batch_size: int = 1, max_gt: int = 100,
                    device: Optional[Union[str, torch.device]] = None,
                    stage: Callable = run_stage) -> Optional[List[dict]]:
    """Distributed evaluation (JAX `apis/test.py:80 multi_host_test`, the
    reference's `multi_gpu_test` and `collect_results`): under a process
    group of W processes each evaluates the records g with g % W == its
    rank (`DetDataLoader(shuffle=False, num_shards=W, shard_id=rank)`), the
    shards, padded to ceil(n / W), are gathered (`all_gather_object`), and
    rank 0 returns the per-image dicts (boxes, scores, labels) in the
    dataset's order, record g from process g % W at position g // W; the
    other processes get None.  With no process group, or a group of one, it
    returns what `single_device_test` does.  No masks: the JAX function
    gathers none (ROADMAP.md, Queue 1, item 17d)."""
    dev = _model_device(model, device)
    W, r, n = world(), rank(), len(dataset)
    loader = DetDataLoader(dataset, batch_size=batch_size, shuffle=False, max_gt=max_gt,
                           drop_last=False, num_shards=W, shard_id=r)
    by_index = _evaluate(model, loader, dev, False, False, stage)
    shard = list(range(n))[r::W]
    if set(by_index) != set(shard):
        raise RuntimeError(f"rank {r} evaluated records {sorted(by_index)[:5]}..., not its "
                           f"shard {shard[:5]}...")
    local = [by_index[g] for g in shard] + [None] * (-(-n // W) - len(shard))
    gathered = all_gather_object(local)
    if r != 0:
        return None
    return [gathered[g % W][g // W] for g in range(n)]


def _model_device(model, device) -> torch.device:
    """The model's device, which must be `device` (the card when None)."""
    dev = resolve_device(device)
    if model.device.type != dev.type or dev.index not in (None, model.device.index):
        raise ValueError(f"the model is on {model.device}, the evaluation on {dev}: move "
                         "the model or pass its device")
    return model.device


def _evaluate(model, loader, dev, with_masks, progress, stage) -> dict:
    """Every batch of `loader` through the model: record index -> result."""
    dataset = loader.dataset
    by_index = {}
    batches = iter(loader)
    bi = 0
    with torch.inference_mode():
        while True:
            batch = stage("load", lambda: next(batches, None))
            if batch is None:
                break
            inputs = stage("copy", lambda: [
                torch.from_numpy(batch[k]).to(dev)
                for k in ("images", "img_shapes", "scale_factors")])
            if with_masks:
                out, probs = stage("simple_test", lambda: model.simple_test_masks(*inputs))
            else:
                out = stage("simple_test", lambda: model.simple_test(*inputs))
            results = stage("results", lambda: _trimmed(out, batch["indices"]))
            if with_masks:
                bitmaps = stage("paste", lambda: _pasted(out, probs, batch["indices"],
                                                         dataset.records))
                stage("rle", lambda: _encoded(results, bitmaps))
            by_index.update(results)
            if progress and bi % 50 == 0:
                print(f"eval batch {bi}/{len(loader)}")
            bi += 1
    return by_index


def _trimmed(out, indices) -> dict:
    boxes, scores, labels, mask = (t.cpu().numpy() for t in out)
    return {int(idx): {"boxes": boxes[i][mask[i]], "scores": scores[i][mask[i]],
                       "labels": labels[i][mask[i]]}
            for i, idx in enumerate(indices)}


def _pasted(out, probs, indices, records) -> dict:
    """Each image's detections' masks pasted at its record's size, as host
    bool arrays (k, height, width)."""
    bitmaps = {}
    for i, idx in enumerate(indices):
        m = out.mask[i]
        rec = records[int(idx)]
        bitmaps[int(idx)] = paste_masks(probs[i][m], out.boxes[i][m], int(rec["height"]),
                                        int(rec["width"])).cpu().numpy()
    return bitmaps


def _encoded(results: dict, bitmaps: dict) -> None:
    """Each result's `masks`: its bitmaps run-length encoded."""
    for idx, res in results.items():
        res["masks"] = [rle.encode(b) for b in bitmaps[idx]]
