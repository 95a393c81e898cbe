"""Evaluation metrics: COCO-style mAP and VOC-style mean AP, numpy.

The port's own copy of `panoswintransformerobjectdetection_tpu/core/
evaluation.py` (`eval_map_coco`, `eval_map_voc`, `eval_recalls`,
`average_precision`, `tpfp_default`, `eval_map` and the print and plot
helpers), the roles of the reference's `mean_ap.py` and `recall.py`.
Matching follows COCOeval: detections sorted by score, each greedily matched
to the unmatched gt with the highest IoU >= threshold; AP is the 101-point
interpolated precision integral, averaged over IoU thresholds .50:.05:.95.
Host code; the plots import matplotlib inside the functions that draw.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)


def _match_class(det_boxes, det_scores, gt_boxes, iou_thr, max_dets=100):
    """Returns (tp flags, scores) for one image+class at one IoU threshold.

    Uses the native C++ matcher (`native/cocoeval.cpp`, the mmpycocotools
    role) when available; falls back to the numpy loop."""
    order = np.argsort(-det_scores)[:max_dets]
    det_boxes = det_boxes[order]
    det_scores = det_scores[order]

    tp_native = native.native_match_class(det_boxes, gt_boxes, iou_thr) \
        if len(det_boxes) and len(gt_boxes) else None
    if tp_native is not None:
        native.record("native")
        return tp_native, det_scores
    if len(det_boxes) and len(gt_boxes):
        native.record("numpy")

    iou = _iou_matrix(det_boxes, gt_boxes)
    matched = np.zeros(len(gt_boxes), bool)
    tp = np.zeros(len(det_boxes), bool)
    for i in range(len(det_boxes)):
        if iou.shape[1] == 0:
            break
        j = -1
        best = iou_thr
        for g in range(len(gt_boxes)):
            if matched[g]:
                continue
            if iou[i, g] >= best:
                best = iou[i, g]
                j = g
        if j >= 0:
            matched[j] = True
            tp[i] = True
    return tp, det_scores


def _average_precision(tp, scores, num_gt) -> float:
    """101-point interpolated AP (COCOeval protocol)."""
    if num_gt == 0:
        return np.nan
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = tp[order]
    tp_cum = np.cumsum(tp)
    fp_cum = np.cumsum(~tp)
    recall = tp_cum / num_gt
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
    # precision envelope
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    rec_thrs = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, rec_thrs, side="left")
    p = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0)
    return float(p.mean())


def eval_map_coco(detections: List[dict], gts: List[dict], num_classes: int,
                  iou_thrs: Optional[Sequence[float]] = None,
                  max_dets: int = 100,
                  classwise: bool = False,
                  class_names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """COCO-style mAP.

    detections[i]: dict(boxes (K, 4), scores (K,), labels (K,)) — padded
    entries may be filtered by a 'mask' key or negative labels.
    gts[i]: dict(bboxes (G, 4), labels (G,)).
    """
    if iou_thrs is None:
        iou_thrs = np.arange(0.5, 1.0, 0.05)
    assert len(detections) == len(gts)

    aps = np.full((len(iou_thrs), num_classes), np.nan)
    for c in range(num_classes):
        per_thr_tp = [[] for _ in iou_thrs]
        per_thr_scores = [[] for _ in iou_thrs]
        num_gt = 0
        any_det = False
        for det, gt in zip(detections, gts):
            mask = det.get("mask")
            boxes = np.asarray(det["boxes"], np.float32)
            scores = np.asarray(det["scores"], np.float32)
            labels = np.asarray(det["labels"])
            if mask is not None:
                m = np.asarray(mask, bool)
                boxes, scores, labels = boxes[m], scores[m], labels[m]
            sel = labels == c
            db, ds = boxes[sel], scores[sel]
            gsel = np.asarray(gt["labels"]) == c
            gb = np.asarray(gt["bboxes"], np.float32)[gsel]
            num_gt += len(gb)
            if len(db):
                any_det = True
            for t, thr in enumerate(iou_thrs):
                tp, sc = _match_class(db, ds, gb, thr, max_dets)
                per_thr_tp[t].append(tp)
                per_thr_scores[t].append(sc)
        if num_gt == 0 and not any_det:
            continue
        for t in range(len(iou_thrs)):
            tp = np.concatenate(per_thr_tp[t]) if per_thr_tp[t] else np.zeros(0, bool)
            sc = np.concatenate(per_thr_scores[t]) if per_thr_scores[t] else np.zeros(0)
            aps[t, c] = _average_precision(tp, sc, num_gt)

    valid = ~np.isnan(aps)
    mAP = float(np.nanmean(aps)) if valid.any() else 0.0

    def _at(thr):
        """AP at one IoU threshold, 0.0 if that threshold wasn't computed
        (custom iou_thrs lists may omit 0.5/0.75)."""
        hits = np.where(np.isclose(np.asarray(iou_thrs), thr))[0]
        if len(hits) == 0:
            return 0.0
        t = int(hits[0])
        return float(np.nanmean(aps[t])) if valid[t].any() else 0.0

    mAP50 = _at(0.5)
    mAP75 = _at(0.75)
    out = {"bbox_mAP": mAP, "bbox_mAP_50": mAP50, "bbox_mAP_75": mAP75}
    if classwise:  # per-category AP table (mmdet classwise=True)
        for c in range(num_classes):
            name = class_names[c] if class_names else f"class_{c}"
            col = aps[:, c]
            out[f"AP_{name}"] = float(np.nanmean(col)) \
                if (~np.isnan(col)).any() else float("nan")
    return out


def eval_map_voc(detections: List[dict], gts: List[dict], num_classes: int,
                 iou_thr: float = 0.5) -> Dict[str, float]:
    """VOC-style mAP at a single IoU threshold — exact `mean_ap.py` area
    mode via `eval_map` (reference-protocol tpfp + PR-envelope integral)."""
    m, _ = eval_map(detections, gts, iou_thr=iou_thr,
                    num_classes=num_classes)
    return {"mAP": float(m)}


def eval_recalls(proposals: List[dict], gts: List[dict],
                 proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5,)) -> Dict[str, float]:
    """Proposal recall (`mmdet/core/evaluation/recall.py eval_recalls`):
    fraction of gts covered by a top-k proposal at IoU >= thr."""
    out = {}
    for k in proposal_nums:
        for thr in iou_thrs:
            covered = total = 0
            for prop, gt in zip(proposals, gts):
                boxes = np.asarray(prop["boxes"], np.float32)
                scores = np.asarray(prop.get("scores",
                                             np.ones(len(boxes))), np.float32)
                order = np.argsort(-scores)[:k]
                boxes = boxes[order]
                gb = np.asarray(gt["bboxes"], np.float32)
                total += len(gb)
                if len(gb) == 0 or len(boxes) == 0:
                    continue
                iou = _iou_matrix(boxes, gb)
                covered += int((iou.max(axis=0) >= thr).sum())
            out[f"AR@{k}@{thr:.2f}"] = covered / max(total, 1)
    return out


# ---------------------------------------------------------------------------
# Reference-named helpers (`mmdet/core/evaluation/__init__.py` surface)
# ---------------------------------------------------------------------------

def average_precision(recalls, precisions, mode="area"):
    """`mean_ap.py average_precision`: AP from recall/precision curves.
    recalls/precisions: (num_scales, N) or (N,); mode 'area' (envelope
    integral) or '11points'."""
    recalls = np.asarray(recalls, np.float32)
    precisions = np.asarray(precisions, np.float32)
    squeeze = recalls.ndim == 1
    if squeeze:
        recalls, precisions = recalls[None], precisions[None]
    S, N = recalls.shape
    ap = np.zeros(S, np.float32)
    if mode == "area":
        zeros = np.zeros((S, 1), np.float32)
        ones = np.ones((S, 1), np.float32)
        mrec = np.hstack((zeros, recalls, ones))
        mpre = np.hstack((zeros, precisions, zeros))
        for i in range(mpre.shape[1] - 1, 0, -1):
            mpre[:, i - 1] = np.maximum(mpre[:, i - 1], mpre[:, i])
        for s in range(S):
            ind = np.where(mrec[s, 1:] != mrec[s, :-1])[0]
            ap[s] = np.sum(
                (mrec[s, ind + 1] - mrec[s, ind]) * mpre[s, ind + 1])
    elif mode == "11points":
        for s in range(S):
            for thr in np.arange(0, 1 + 1e-3, 0.1):
                precs = precisions[s, recalls[s, :] >= thr]
                ap[s] += (precs.max() if precs.size > 0 else 0.0)
        ap /= 11
    else:
        raise ValueError('mode must be "area" or "11points"')
    return float(ap[0]) if squeeze else ap


def tpfp_default(det_bboxes, gt_bboxes, gt_bboxes_ignore=None, iou_thr=0.5,
                 area_ranges=None):
    """TP/FP flags for one image+class (`mean_ap.py tpfp_default:153`).

    det_bboxes: (m, 5) with score in the last column; gt_bboxes: (n, 4);
    gt_bboxes_ignore: (k, 4).  Matching follows the reference exactly:
    dets scanned score-descending; a det whose max-IoU gt clears `iou_thr`
    is TP if that gt is unclaimed and not ignored (by flag or area range),
    FP if the gt was already claimed, and neither if the gt is ignored.
    Returns (tp, fp) float arrays of shape (num_scales, m).
    """
    det_bboxes = np.asarray(det_bboxes, np.float32).reshape(-1, 5)
    gt_bboxes = np.asarray(gt_bboxes, np.float32).reshape(-1, 4)
    if gt_bboxes_ignore is None:
        gt_bboxes_ignore = np.empty((0, 4), np.float32)
    gt_bboxes_ignore = np.asarray(gt_bboxes_ignore, np.float32).reshape(-1, 4)

    gt_ignore_inds = np.concatenate(
        (np.zeros(gt_bboxes.shape[0], bool),
         np.ones(gt_bboxes_ignore.shape[0], bool)))
    gt_bboxes = np.vstack((gt_bboxes, gt_bboxes_ignore))

    num_dets = det_bboxes.shape[0]
    num_gts = gt_bboxes.shape[0]
    if area_ranges is None:
        area_ranges = [(None, None)]
    num_scales = len(area_ranges)
    tp = np.zeros((num_scales, num_dets), np.float32)
    fp = np.zeros((num_scales, num_dets), np.float32)

    if num_gts == 0:
        if area_ranges == [(None, None)]:
            fp[...] = 1
        else:
            det_areas = (det_bboxes[:, 2] - det_bboxes[:, 0]) * (
                det_bboxes[:, 3] - det_bboxes[:, 1])
            for i, (min_area, max_area) in enumerate(area_ranges):
                fp[i, (det_areas >= min_area) & (det_areas < max_area)] = 1
        return tp, fp

    ious = _iou_matrix(det_bboxes[:, :4], gt_bboxes)
    ious_max = ious.max(axis=1)
    ious_argmax = ious.argmax(axis=1)
    sort_inds = np.argsort(-det_bboxes[:, -1])
    for k, (min_area, max_area) in enumerate(area_ranges):
        gt_covered = np.zeros(num_gts, bool)
        if min_area is None:
            gt_area_ignore = np.zeros_like(gt_ignore_inds, bool)
        else:
            gt_areas = (gt_bboxes[:, 2] - gt_bboxes[:, 0]) * (
                gt_bboxes[:, 3] - gt_bboxes[:, 1])
            gt_area_ignore = (gt_areas < min_area) | (gt_areas >= max_area)
        for i in sort_inds:
            if ious_max[i] >= iou_thr:
                matched_gt = ious_argmax[i]
                if not (gt_ignore_inds[matched_gt]
                        or gt_area_ignore[matched_gt]):
                    if not gt_covered[matched_gt]:
                        gt_covered[matched_gt] = True
                        tp[k, i] = 1
                    else:
                        fp[k, i] = 1
            elif min_area is None:
                fp[k, i] = 1
            else:
                bbox = det_bboxes[i, :4]
                area = (bbox[2] - bbox[0]) * (bbox[3] - bbox[1])
                if min_area <= area < max_area:
                    fp[k, i] = 1
    return tp, fp


def _to_ref_format(detections, gts, num_classes):
    """Convert this repo's dict-based detections/gts to the reference's
    (det_results, annotations) layout."""
    det_results, annotations = [], []
    for det, gt in zip(detections, gts):
        boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
        scores = np.asarray(det["scores"], np.float32).reshape(-1)
        labels = np.asarray(det["labels"]).reshape(-1)
        mask = det.get("mask")
        if mask is not None:
            m = np.asarray(mask, bool)
            boxes, scores, labels = boxes[m], scores[m], labels[m]
        per_cls = []
        for c in range(num_classes):
            sel = labels == c
            per_cls.append(
                np.hstack([boxes[sel], scores[sel, None]]).astype(np.float32))
        det_results.append(per_cls)
        annotations.append({
            "bboxes": np.asarray(gt["bboxes"], np.float32).reshape(-1, 4),
            "labels": np.asarray(gt["labels"], np.int64).reshape(-1),
            "bboxes_ignore": np.asarray(
                gt.get("bboxes_ignore", np.empty((0, 4))),
                np.float32).reshape(-1, 4),
            "labels_ignore": (np.asarray(gt["labels_ignore"], np.int64)
                              if gt.get("labels_ignore") is not None
                              else None),
        })
    return det_results, annotations


def eval_map(det_results, annotations, scale_ranges=None, iou_thr=0.5,
             dataset=None, logger=None, tpfp_fn=None, num_classes=None,
             **kw):
    """VOC-protocol dataset mAP (`mean_ap.py eval_map:267`), exact numerics.

    det_results: per image, a per-class list of (n, 5) [x1 y1 x2 y2 score]
    arrays (the reference layout) — or this repo's list of
    dict(boxes, scores, labels), auto-converted.  annotations: per image
    dict(bboxes, labels[, bboxes_ignore, labels_ignore]).  scale_ranges:
    [(min, max), ...] in pixels (areas compared against range**2).
    dataset='voc07' switches AP to 11-point mode.  Returns
    (mean_ap, [per-class dict(num_gts, num_dets, recall, precision, ap)]).
    """
    assert len(det_results) == len(annotations)
    if det_results and isinstance(det_results[0], dict):
        if num_classes is None:
            num_classes = int(max(
                int(np.max(g["labels"])) if len(g["labels"]) else 0
                for g in annotations)) + 1
        det_results, annotations = _to_ref_format(
            det_results, annotations, num_classes)

    num_scales = len(scale_ranges) if scale_ranges is not None else 1
    num_classes = len(det_results[0])
    area_ranges = ([(rg[0] ** 2, rg[1] ** 2) for rg in scale_ranges]
                   if scale_ranges is not None else None)
    if tpfp_fn is None:
        tpfp_fn = tpfp_default

    eval_results = []
    for c in range(num_classes):
        cls_dets = [img_res[c] for img_res in det_results]
        cls_gts, cls_gts_ignore = [], []
        for ann in annotations:
            gt_inds = ann["labels"] == c
            cls_gts.append(ann["bboxes"][gt_inds, :])
            if ann.get("labels_ignore") is not None:
                ignore_inds = ann["labels_ignore"] == c
                cls_gts_ignore.append(ann["bboxes_ignore"][ignore_inds, :])
            else:
                cls_gts_ignore.append(np.empty((0, 4), np.float32))

        tpfp = [tpfp_fn(d, g, gi, iou_thr, area_ranges)
                for d, g, gi in zip(cls_dets, cls_gts, cls_gts_ignore)]
        tp, fp = tuple(zip(*tpfp))

        num_gts = np.zeros(num_scales, int)
        for bbox in cls_gts:
            if area_ranges is None:
                num_gts[0] += bbox.shape[0]
            else:
                gt_areas = (bbox[:, 2] - bbox[:, 0]) * (
                    bbox[:, 3] - bbox[:, 1])
                for k, (min_area, max_area) in enumerate(area_ranges):
                    num_gts[k] += np.sum((gt_areas >= min_area)
                                         & (gt_areas < max_area))
        cls_dets = np.vstack([np.asarray(d, np.float32).reshape(-1, 5)
                              for d in cls_dets])
        num_dets = cls_dets.shape[0]
        sort_inds = np.argsort(-cls_dets[:, -1])
        tp = np.cumsum(np.hstack(tp)[:, sort_inds], axis=1)
        fp = np.cumsum(np.hstack(fp)[:, sort_inds], axis=1)
        eps = np.finfo(np.float32).eps
        recalls = tp / np.maximum(num_gts[:, None], eps)
        precisions = tp / np.maximum(tp + fp, eps)
        if scale_ranges is None:
            recalls = recalls[0, :]
            precisions = precisions[0, :]
            num_gts = num_gts.item()
        mode = "area" if dataset != "voc07" else "11points"
        ap = average_precision(recalls, precisions, mode)
        eval_results.append({"num_gts": num_gts, "num_dets": num_dets,
                             "recall": recalls, "precision": precisions,
                             "ap": ap})

    if scale_ranges is not None:
        all_ap = np.vstack([r["ap"] for r in eval_results])
        all_num_gts = np.vstack([r["num_gts"] for r in eval_results])
        mean_ap = []
        for i in range(num_scales):
            if np.any(all_num_gts[:, i] > 0):
                mean_ap.append(all_ap[all_num_gts[:, i] > 0, i].mean())
            else:
                mean_ap.append(0.0)
    else:
        aps = [r["ap"] for r in eval_results if r["num_gts"] > 0]
        mean_ap = float(np.mean(aps)) if aps else 0.0
    return mean_ap, eval_results


def print_map_summary(mean_ap, results, logger=None):
    """`mean_ap.py print_map_summary` role: tabulate per-class AP."""
    lines = ["| class | gts | dets | ap |", "|---|---|---|---|"]
    for r in results:
        lines.append(f"| {r.get('class', '?')} | {r.get('num_gts', '-')} | "
                     f"{r.get('num_dets', '-')} | {r.get('ap', 0.0):.3f} |")
    lines.append(f"| mAP | | | {mean_ap:.3f} |")
    text = "\n".join(lines)
    (logger.info if logger else print)(text)
    return text


def print_recall_summary(recalls, proposal_nums, iou_thrs, logger=None):
    """`recall.py print_recall_summary`: recalls (num_k, num_thr) table."""
    recalls = np.asarray(recalls)
    lines = ["| k \\ iou | " + " | ".join(f"{t:.2f}" for t in iou_thrs) + " |"]
    lines.append("|" + "---|" * (len(iou_thrs) + 1))
    for i, k in enumerate(proposal_nums):
        row = " | ".join(f"{recalls[i, j]:.4f}" for j in range(len(iou_thrs)))
        lines.append(f"| {k} | {row} |")
    text = "\n".join(lines)
    (logger.info if logger else print)(text)
    return text


def plot_num_recall(recalls, proposal_nums, out_file=None):
    """`recall.py plot_num_recall` (Agg-safe; writes out_file if given)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    f = plt.figure()
    plt.plot([0] + list(proposal_nums), [0] + list(np.asarray(recalls).ravel()))
    plt.xlabel("Proposal num")
    plt.ylabel("Recall")
    plt.axis([0, max(proposal_nums), 0, 1])
    if out_file:
        f.savefig(out_file)
    plt.close(f)


def plot_iou_recall(recalls, iou_thrs, out_file=None):
    """`recall.py plot_iou_recall`."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    f = plt.figure()
    plt.plot(list(iou_thrs) + [1.0], list(np.asarray(recalls).ravel()) + [0.])
    plt.xlabel("IoU")
    plt.ylabel("Recall")
    plt.axis([iou_thrs[0], 1, 0, 1])
    if out_file:
        f.savefig(out_file)
    plt.close(f)
