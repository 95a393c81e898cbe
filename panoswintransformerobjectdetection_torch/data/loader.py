"""Batched loader: aspect-ratio grouping, fixed shape buckets, gt padding.

The port's own copy of `panoswintransformerobjectdetection_tpu/data/
loader.py` (`DetDataLoader`), the role of the reference's
`build_dataloader` + `GroupSampler` (`mmdet/datasets/builder.py:75`,
`samplers/group_sampler.py:10`).  Batches are numpy, exactly the JAX
loader's: images padded to a size divisor or a fixed set of (H, W) buckets,
gt padded to `max_gt` with validity masks, and the records' `indices`, so
that the evaluation loop checks its results' alignment.  Sharding strides
the records by `shard_id` of `num_shards`; the caller moves a batch to its
device.
"""

import math
import random
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


def _round_up(x, m):
    return int(math.ceil(x / m) * m)


class DetDataLoader:
    def __init__(self, dataset, batch_size: int, max_gt: int = 100,
                 shuffle: bool = True, size_divisor: int = 32,
                 buckets: Optional[Sequence[Tuple[int, int]]] = None,
                 seed: int = 0, num_shards: int = 1, shard_id: int = 0,
                 drop_last: bool = True, num_workers: int = 0,
                 prefetch: int = 2, pad_to: Optional[Tuple[int, int]] = None):
        """num_workers > 0 enables threaded sample loading + background
        batch assembly (the `workers_per_gpu` role of the reference's
        `build_dataloader`, `mmdet/datasets/builder.py:75`) — cv2/numpy
        release the GIL, so threads overlap the host pipeline with device
        steps.  `prefetch` bounds the ready-batch queue.

        `pad_to=(H, W)` forces every batch to one fixed image shape.  It
        is REQUIRED (or `buckets`) for sharded training (num_shards > 1
        with shuffle): each step's global batch is assembled from
        per-process shards, so all processes must pad to identical shapes
        every step — content-dependent bucketing would diverge."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.max_gt = max_gt
        self.shuffle = shuffle
        self.size_divisor = size_divisor
        self.buckets = [tuple(b) for b in buckets] if buckets else None
        self.rng = random.Random(seed)
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = max(prefetch, 1)
        self.pad_to = tuple(pad_to) if pad_to else None
        if num_shards > 1 and shuffle and not (self.buckets or self.pad_to):
            raise ValueError(
                "sharded training needs a fixed pad shape so every process "
                "produces identical batch shapes each step: pass "
                "buckets=[(H, W), ...] or pad_to=(H, W)")

    def _epoch_chunks(self) -> List[List[int]]:
        """Batch-sized index chunks for this shard.

        Training (shuffle): the chunk list is built identically on every
        process from the shared seed — group by aspect-ratio flag
        (GroupSampler), shuffle within groups, batch, shuffle chunks —
        then padded by repeating leading chunks up to a multiple of
        num_shards and strided chunk-wise by shard_id.  Mirrors
        `DistributedGroupSampler` (`samplers/group_sampler.py`), whose
        total_size padding guarantees every process an identical number
        of batches per epoch (no stragglers to hang a collective on).

        Eval (no shuffle) keeps record-strided sharding, so that results
        can be reassembled by `g % num_shards` position.
        """
        if self.shuffle:
            idx = list(range(len(self.dataset)))
            # group by aspect-ratio flag, shuffle within groups (GroupSampler)
            flags = getattr(self.dataset, "flags", np.zeros(len(idx), np.uint8))
            groups = {}
            for i in idx:
                groups.setdefault(int(flags[i]), []).append(i)
            chunks = []
            for g in groups.values():
                self.rng.shuffle(g)
                for s in range(0, len(g) - len(g) % self.batch_size, self.batch_size):
                    chunks.append(g[s:s + self.batch_size])
            self.rng.shuffle(chunks)
            if self.num_shards > 1 and chunks:
                orig, i = len(chunks), 0
                while len(chunks) % self.num_shards:
                    chunks.append(chunks[i % orig])
                    i += 1
                chunks = chunks[self.shard_id::self.num_shards]
            return chunks
        shard = list(range(len(self.dataset)))[self.shard_id::self.num_shards]
        end = len(shard) - len(shard) % self.batch_size if self.drop_last \
            else len(shard)
        return [shard[s:s + self.batch_size]
                for s in range(0, end, self.batch_size)]

    def _bucket_for(self, h, w) -> Tuple[int, int]:
        if self.buckets is None:
            return (_round_up(h, self.size_divisor), _round_up(w, self.size_divisor))
        for bh, bw in sorted(self.buckets):
            if h <= bh and w <= bw:
                return (bh, bw)
        return max(self.buckets)

    def _collate(self, samples: List[dict],
                 indices: Optional[List[int]] = None) -> Dict[str, np.ndarray]:
        B = len(samples)
        hs = [s["img"].shape[0] for s in samples]
        ws = [s["img"].shape[1] for s in samples]
        if self.pad_to is not None:
            bh, bw = self.pad_to
        elif self.num_shards > 1 and self.shuffle:
            # sharded training: every process must emit the same shape each
            # step regardless of content — pad to the largest bucket
            bh, bw = max(self.buckets)
        else:
            bh, bw = self._bucket_for(max(hs), max(ws))
        if max(hs) > bh or max(ws) > bw:
            raise ValueError(
                f"sample shape {(max(hs), max(ws))} exceeds fixed pad shape "
                f"{(bh, bw)}; enlarge pad_to/buckets or cap the resize scale")
        images = np.zeros((B, bh, bw, 3), np.float32)
        img_shapes = np.zeros((B, 2), np.float32)
        scale_factors = np.ones((B, 4), np.float32)
        gt_boxes = np.zeros((B, self.max_gt, 4), np.float32)
        gt_labels = np.zeros((B, self.max_gt), np.int32)
        gt_valid = np.zeros((B, self.max_gt), bool)
        ori_shapes = np.zeros((B, 2), np.float32)
        pano_ratio_v = np.zeros((B, 3), np.float32)
        pano_ratio_v[:, 1] = 1.0
        with_masks = any("gt_masks" in s for s in samples)
        gt_masks = np.zeros((B, self.max_gt, bh, bw), np.uint8) \
            if with_masks else None
        for i, s in enumerate(samples):
            img = s["img"]
            images[i, :img.shape[0], :img.shape[1]] = img
            img_shapes[i] = img.shape[:2]
            scale_factors[i] = s.get("scale_factor", np.ones(4, np.float32))
            ori_shapes[i] = s.get("ori_shape", img.shape)[:2]
            prv = s.get("pano_ratio_v", np.array([0.0, 1.0], np.float32))
            pano_ratio_v[i, :2] = prv[:2]
            pano_ratio_v[i, 2] = img.shape[0]  # ori_h at network scale
            b = s.get("gt_bboxes")
            if b is not None and len(b):
                n = min(len(b), self.max_gt)
                gt_boxes[i, :n] = b[:n]
                gt_labels[i, :n] = s["gt_labels"][:n]
                gt_valid[i, :n] = True
                if gt_masks is not None and "gt_masks" in s and len(s["gt_masks"]):
                    m = s["gt_masks"][:n]
                    gt_masks[i, :n, :m.shape[1], :m.shape[2]] = m
        out = {"images": images, "img_shapes": img_shapes,
               "scale_factors": scale_factors, "ori_shapes": ori_shapes,
               "gt_boxes": gt_boxes, "gt_labels": gt_labels,
               "gt_valid": gt_valid, "pano_ratio_v": pano_ratio_v}
        if gt_masks is not None:
            out["gt_masks"] = gt_masks
        if indices is not None:
            # host-side record indices so eval can verify alignment with
            # dataset.records instead of trusting a running counter
            out["indices"] = np.asarray(indices, np.int64)
        return out

    def _batch_of(self, chunk, pool=None):
        if pool is not None:
            samples = list(pool.map(self.dataset.__getitem__, chunk))
        else:
            samples = [self.dataset[i] for i in chunk]
        kept = [(i, x) for i, x in zip(chunk, samples) if x is not None]
        if len(kept) < len(chunk):
            return None
        return self._collate([x for _, x in kept], indices=[i for i, _ in kept])

    def _chunks(self):
        yield from self._epoch_chunks()

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.num_workers <= 0:
            for chunk in self._chunks():
                b = self._batch_of(chunk)
                if b is not None:
                    yield b
            return
        import queue
        import threading
        from concurrent.futures import ThreadPoolExecutor
        pool = ThreadPoolExecutor(self.num_workers)
        stop = threading.Event()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        DONE = object()

        def put_or_stop(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for chunk in self._chunks():
                    if stop.is_set():
                        return
                    b = self._batch_of(chunk, pool)
                    if b is not None and not put_or_stop(b):
                        return
            finally:
                put_or_stop(DONE)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                b = q.get()
                if b is DONE:
                    break
                yield b
        finally:
            # consumer may abandon mid-epoch (break/exception): signal the
            # producer, drain anything it is blocked putting, then reap —
            # no leaked thread or pool per interrupted epoch
            stop.set()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                t.join(timeout=0.05)
            pool.shutdown(wait=False)

    def __len__(self):
        """Batches this shard yields per epoch — pure arithmetic (consumes
        no rng state, so len() calls never desync the shared shuffle)."""
        n = len(self.dataset)
        if self.shuffle:
            flags = getattr(self.dataset, "flags", np.zeros(n, np.uint8))
            counts: Dict[int, int] = {}
            for f in np.asarray(flags, np.int64):
                counts[int(f)] = counts.get(int(f), 0) + 1
            chunks = sum(c // self.batch_size for c in counts.values())
            if self.num_shards > 1 and chunks:
                chunks = _round_up(chunks, self.num_shards)
                chunks //= self.num_shards
            return chunks
        shard = len(range(n)[self.shard_id::self.num_shards])
        return shard // self.batch_size if self.drop_last \
            else math.ceil(shard / self.batch_size)
