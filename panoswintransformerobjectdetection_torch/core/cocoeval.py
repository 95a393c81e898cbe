"""COCOeval-exact detection and segmentation evaluation, numpy on the host.

The port's own copy of `panoswintransformerobjectdetection_tpu/core/
cocoeval.py` (`COCOEvaluator`, `evaluate_coco`): the pycocotools `COCOeval`
protocol that the reference evaluates bbox, segm and proposal metrics with
(`mmdet/datasets/coco.py:365-478`):

* greedy per-(image, category) matching, detections in score order, each
  taking the best still-available gt at IoU >= t;
* `iscrowd` gt are ignored with rematch: a matched crowd gt can absorb
  further detections, and crowd IoU is intersection over the det's area;
* gt outside the area range are ignored (and detections matched to them);
  unmatched detections outside the area range are ignored too;
* maxDets truncation per image and category at [1, 10, 100];
* 101-point interpolated AP averaged over IoU .50:.05:.95 and the area
  ranges all/small/medium/large; AR at maxDets 1/10/100 and per area;
* segm metrics run the same machinery on RLE mask IoU (the masks of a
  `MaskRCNN`, run-length encoded by `apis/test.single_device_test`).

The per-image matcher is the C++ one (`native/cocoeval.cpp`) when it
builds, else `_match_image`'s numpy loop, its twin; `native.calls` counts
which ran.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native
from . import rle as rle_utils

AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}
AREA_LBLS = ("all", "small", "medium", "large")


def _match_image(iou_thrs: np.ndarray, ious: np.ndarray,
                 gt_ignore: np.ndarray, iscrowd: np.ndarray):
    """Greedy matcher for one (image, category): detections are rows of
    `ious` in descending-score order, gts are columns sorted
    non-ignored-first.  Returns (dt_match (T, D) gt column index or -1,
    dt_ignore (T, D) bool)."""
    T = len(iou_thrs)
    D, G = ious.shape
    dtm = np.full((T, D), -1, np.int64)
    dt_ig = np.zeros((T, D), bool)
    if D == 0 or G == 0:
        return dtm, dt_ig
    out = native.native_match_image(iou_thrs, ious, gt_ignore, iscrowd)
    if out is not None:
        native.record("native")
        return out
    native.record("numpy")
    gtm = np.full((T, G), -1, np.int64)
    for t in range(T):
        thr = min(iou_thrs[t], 1 - 1e-10)
        for d in range(D):
            best = thr
            m = -1
            for g in range(G):
                # gt already matched (and not crowd) can't be used again
                if gtm[t, g] >= 0 and not iscrowd[g]:
                    continue
                # dt matched to a real gt: stop at the first ignored gt
                # (columns are sorted non-ignored-first)
                if m > -1 and not gt_ignore[m] and gt_ignore[g]:
                    break
                if ious[d, g] < best:
                    continue
                best = ious[d, g]
                m = g
            if m == -1:
                continue
            dt_ig[t, d] = gt_ignore[m]
            dtm[t, d] = m
            gtm[t, m] = d
    return dtm, dt_ig


class COCOEvaluator:
    """pycocotools-COCOeval-equivalent evaluator on plain annotation dicts.

    gt_anns: list of {image_id, category_id, bbox xywh, area?, iscrowd?,
    ignore?, segmentation?}.  dt_anns: {image_id, category_id, bbox xywh,
    score, segmentation?}.  `iou_type` in {'bbox', 'segm', 'proposal'}
    ('proposal' = class-agnostic bbox, used for AR).
    """

    def __init__(self, gt_anns: Sequence[dict], dt_anns: Sequence[dict],
                 img_ids: Sequence, cat_ids: Sequence,
                 iou_type: str = "bbox",
                 iou_thrs: Optional[np.ndarray] = None,
                 max_dets: Sequence[int] = (1, 10, 100),
                 img_shapes: Optional[Dict] = None):
        assert iou_type in ("bbox", "segm", "proposal")
        self.iou_type = iou_type
        self.use_cats = iou_type != "proposal"
        self.iou_thrs = (np.arange(0.5, 1.0, 0.05).round(2)
                         if iou_thrs is None else np.asarray(iou_thrs))
        self.rec_thrs = np.linspace(0, 1, 101)
        self.max_dets = sorted(max_dets)
        self.img_ids = list(img_ids)
        self.cat_ids = list(cat_ids) if self.use_cats else [-1]
        self.img_shapes = img_shapes or {}

        self._gts: Dict = {}
        self._dts: Dict = {}
        for a in gt_anns:
            key = (a["image_id"], a["category_id"] if self.use_cats else -1)
            self._gts.setdefault(key, []).append(a)
        for a in dt_anns:
            key = (a["image_id"], a["category_id"] if self.use_cats else -1)
            self._dts.setdefault(key, []).append(a)

    # ------------------------------------------------------------------ areas
    def _gt_area(self, a):
        if "area" in a and a["area"] is not None:
            return float(a["area"])
        if self.iou_type == "segm" and a.get("segmentation") is not None:
            return float(rle_utils.area(self._to_rle(a)))
        b = a["bbox"]
        return float(b[2] * b[3])

    def _dt_area(self, a):
        if self.iou_type == "segm":
            return float(rle_utils.area(self._to_rle(a)))
        b = a["bbox"]
        return float(b[2] * b[3])

    def _to_rle(self, a):
        if "_rle" not in a:
            seg = a.get("segmentation")
            h, w = self.img_shapes.get(a["image_id"], (None, None))
            if h is None and isinstance(seg, dict):
                h, w = seg["size"]
            if seg is None:
                # annotation without a mask (e.g. box-only crowd regions):
                # fall back to the filled bbox rectangle
                x, y, bw, bh = a["bbox"]
                seg = [[x, y, x, y + bh, x + bw, y + bh, x + bw, y]]
            a["_rle"] = rle_utils.ann_to_rle(seg, h, w)
        return a["_rle"]

    # -------------------------------------------------------------- pipeline
    def _compute_iou(self, gts: List[dict], dts: List[dict]) -> np.ndarray:
        """IoU (D, G) with dts already score-sorted/truncated."""
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        if self.iou_type == "segm":
            return rle_utils.iou([self._to_rle(d) for d in dts],
                                 [self._to_rle(g) for g in gts], iscrowd)
        d = np.array([d["bbox"] for d in dts], np.float64).reshape(-1, 4)
        g = np.array([g["bbox"] for g in gts], np.float64).reshape(-1, 4)
        return rle_utils.bbox_iou(d, g, iscrowd)

    def _evaluate_img(self, gts, dts, ious, area_rng, max_det):
        """One (image, category, areaRng, maxDet) cell -> match record."""
        if not gts and not dts:
            return None
        gt_ig = np.array(
            [1 if (g.get("ignore", 0) or g.get("iscrowd", 0) or
                   not (area_rng[0] <= g["_area"] <= area_rng[1])) else 0
             for g in gts])
        # crowd still participates in matching even though ignored:
        # only the *area/ignore-flag* ignoring reorders columns
        gt_order = np.argsort(gt_ig, kind="stable")
        gts = [gts[i] for i in gt_order]
        gt_ig = gt_ig[gt_order]
        iscrowd = np.array([int(g.get("iscrowd", 0)) for g in gts])
        dts = dts[:max_det]
        ious_o = ious[:max_det][:, gt_order] if ious.size else \
            np.zeros((len(dts), len(gts)))

        dtm, dt_ig = _match_image(self.iou_thrs, ious_o, gt_ig.astype(bool),
                                  iscrowd.astype(bool))
        # unmatched dts outside the area range are ignored
        a = np.array([not (area_rng[0] <= d["_area"] <= area_rng[1])
                      for d in dts]).reshape(1, -1)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm < 0, a))
        return {
            "dt_matched": dtm >= 0,
            "dt_scores": np.array([d["score"] for d in dts], np.float64),
            "gt_ignore": gt_ig.astype(bool),
            "dt_ignore": dt_ig,
        }

    def evaluate(self):
        T = len(self.iou_thrs)
        R = len(self.rec_thrs)
        K = len(self.cat_ids)
        A = len(AREA_LBLS)
        M = len(self.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))

        max_det_top = self.max_dets[-1]
        for k, cat in enumerate(self.cat_ids):
            # pre-sort dts and compute IoUs once per (img, cat)
            per_img = []
            for img in self.img_ids:
                gts = self._gts.get((img, cat), [])
                dts = self._dts.get((img, cat), [])
                order = np.argsort([-d["score"] for d in dts], kind="stable")
                dts = [dts[i] for i in order][:max_det_top]
                for g in gts:
                    g["_area"] = self._gt_area(g)
                for d in dts:
                    d["_area"] = self._dt_area(d)
                ious = self._compute_iou(gts, dts) if gts and dts else \
                    np.zeros((len(dts), len(gts)))
                per_img.append((gts, dts, ious))

            for a, lbl in enumerate(AREA_LBLS):
                rng = AREA_RNG[lbl]
                cells = [self._evaluate_img(gts, dts, ious, rng, max_det_top)
                         for gts, dts, ious in per_img]
                for m, max_det in enumerate(self.max_dets):
                    self._accumulate(cells, max_det, precision, recall, k, a, m)
        self.precision = precision
        self.recall = recall
        return self

    def _accumulate(self, cells, max_det, precision, recall, k, a, m):
        cells = [c for c in cells if c is not None]
        if not cells:
            return
        dt_scores = np.concatenate([c["dt_scores"][:max_det] for c in cells])
        order = np.argsort(-dt_scores, kind="mergesort")
        dtm = np.concatenate([c["dt_matched"][:, :max_det] for c in cells],
                             axis=1)[:, order]
        dt_ig = np.concatenate([c["dt_ignore"][:, :max_det] for c in cells],
                               axis=1)[:, order]
        gt_ig = np.concatenate([c["gt_ignore"] for c in cells])
        npig = int((~gt_ig).sum())
        if npig == 0:
            return
        tps = np.logical_and(dtm, ~dt_ig)
        fps = np.logical_and(~dtm, ~dt_ig)
        tp_sum = np.cumsum(tps, axis=1, dtype=np.float64)
        fp_sum = np.cumsum(fps, axis=1, dtype=np.float64)
        for t in range(dtm.shape[0]):
            tp, fp = tp_sum[t], fp_sum[t]
            nd = len(tp)
            rc = tp / npig
            pr = tp / (fp + tp + np.spacing(1))
            recall[t, k, a, m] = rc[-1] if nd else 0
            q = np.zeros(len(self.rec_thrs))
            pr = pr.tolist()
            for i in range(nd - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            inds = np.searchsorted(rc, self.rec_thrs, side="left")
            for ri, pi in enumerate(inds):
                if pi < nd:
                    q[ri] = pr[pi]
            precision[t, :, k, a, m] = q

    # ------------------------------------------------------------- summarize
    def _summ(self, ap=True, iou_thr=None, area="all", max_det=100):
        aind = AREA_LBLS.index(area)
        mind = self.max_dets.index(max_det)
        if ap:
            s = self.precision
            if iou_thr is not None:
                t = np.where(np.isclose(self.iou_thrs, iou_thr))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.recall
            if iou_thr is not None:
                t = np.where(np.isclose(self.iou_thrs, iou_thr))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(valid.mean()) if valid.size else -1.0

    def summarize(self) -> Dict[str, float]:
        md = self.max_dets[-1]
        stats = {
            "mAP": self._summ(True, None, "all", md),
            "mAP_50": self._summ(True, 0.5, "all", md),
            "mAP_75": self._summ(True, 0.75, "all", md),
            "mAP_s": self._summ(True, None, "small", md),
            "mAP_m": self._summ(True, None, "medium", md),
            "mAP_l": self._summ(True, None, "large", md),
        }
        for d in self.max_dets:
            stats[f"AR@{d}"] = self._summ(False, None, "all", d)
        for lbl in ("small", "medium", "large"):
            stats[f"AR_{lbl[0]}@{md}"] = self._summ(False, None, lbl, md)
        return stats

    def per_category_ap(self) -> Dict[int, float]:
        """AP per category id (mmdet `classwise=True` table)."""
        md = self.max_dets.index(self.max_dets[-1])
        aind = AREA_LBLS.index("all")
        out = {}
        for k, cat in enumerate(self.cat_ids):
            s = self.precision[:, :, k, aind, md]
            valid = s[s > -1]
            out[cat] = float(valid.mean()) if valid.size else float("nan")
        return out


def evaluate_coco(gt_anns, dt_anns, img_ids, cat_ids, iou_type="bbox",
                  img_shapes=None, max_dets=(1, 10, 100)) -> Dict[str, float]:
    """One-call evaluate+summarize (the reference's `coco.py:365` shape)."""
    ev = COCOEvaluator(gt_anns, dt_anns, img_ids, cat_ids, iou_type,
                       max_dets=max_dets, img_shapes=img_shapes)
    return ev.evaluate().summarize()
