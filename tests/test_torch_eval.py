"""The PyTorch port's evaluator against the JAX package's: COCOeval
(`core/cocoeval.py`), the VOC and COCO mAP helpers and proposal recall
(`core/evaluation.py`), RLE masks (`core/rle.py`), the class tables, and the
C++ matcher (`native/`) against its numpy twin.

Both packages do the same numpy arithmetic, so every number must be equal:
tolerance 0.  Each evaluator case runs twice, with the port's C++ matcher
and with its numpy twin (`native.get_lib` made to return None), and must
take the matcher it was given.  Inputs come from numpy with a seed:
detections and ground truth with crowd RLE regions, tiny and large boxes,
an empty class, an image without ground truth and one without detections.
"""

import copy

import numpy as np
import pytest

from panoswintransformerobjectdetection_tpu.core import class_names as jcn
from panoswintransformerobjectdetection_tpu.core import cocoeval as jce
from panoswintransformerobjectdetection_tpu.core import evaluation as jev
from panoswintransformerobjectdetection_tpu.core import rle as jrle
from panoswintransformerobjectdetection_torch import native
from panoswintransformerobjectdetection_torch.core import class_names as tcn
from panoswintransformerobjectdetection_torch.core import cocoeval as tce
from panoswintransformerobjectdetection_torch.core import evaluation as tev
from panoswintransformerobjectdetection_torch.core import rle as trle

H, W = 96, 160
NUM_CLASSES = 4            # class 3 has neither ground truth nor detections
N_IMAGES = 6               # image 4 has no ground truth, image 5 no detections


def _box(rng, small=False, large=False):
    if small:
        w, h = rng.uniform(2, 12, 2)
    elif large:
        w, h = rng.uniform(100, 150), rng.uniform(80, 95)
    else:
        w, h = rng.uniform(12, 60, 2)
    x, y = rng.uniform(0, W - w), rng.uniform(0, H - h)
    return [float(x), float(y), float(w), float(h)]


def _crowd_rle(rng):
    """A rectangle as an uncompressed RLE (column-major counts)."""
    m = np.zeros((H, W), np.uint8)
    x0, y0 = rng.integers(0, W // 2), rng.integers(0, H // 2)
    m[y0:y0 + rng.integers(10, H // 2), x0:x0 + rng.integers(10, W // 2)] = 1
    rle = jrle.encode(m, compress=False)
    return {"size": [H, W], "counts": [int(c) for c in rle["counts"]]}, m


@pytest.fixture(scope="module")
def case():
    """Ground truth and detections in COCO form, and the same as arrays."""
    rng = np.random.default_rng(11)
    gts, dts, gt_arrays, det_arrays = [], [], [], []
    for img in range(N_IMAGES):
        boxes, labels = [], []
        if img != 4:
            for k in range(int(rng.integers(2, 7))):
                cat = int(rng.integers(0, NUM_CLASSES - 1))
                b = _box(rng, small=k == 0, large=k == 1)
                gts.append({"image_id": img, "category_id": cat, "bbox": b,
                            "area": b[2] * b[3], "iscrowd": 0, "ignore": 0})
                boxes.append([b[0], b[1], b[0] + b[2], b[1] + b[3]])
                labels.append(cat)
            if img in (0, 2):
                seg, m = _crowd_rle(rng)
                ys, xs = np.nonzero(m)
                b = [float(xs.min()), float(ys.min()), float(xs.max() - xs.min() + 1),
                     float(ys.max() - ys.min() + 1)]
                gts.append({"image_id": img, "category_id": 0, "bbox": b,
                            "area": float(m.sum()), "iscrowd": 1, "ignore": 0,
                            "segmentation": seg})
        gt_arrays.append({"bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                          "labels": np.asarray(labels, np.int64)})
        det_b, det_s, det_l = [], [], []
        if img != 5:
            for gb, gl in zip(boxes, labels):
                for _ in range(int(rng.integers(0, 3))):
                    jit = rng.normal(0, 3, 4)
                    det_b.append([gb[0] + jit[0], gb[1] + jit[1], gb[2] + jit[2],
                                  gb[3] + jit[3]])
                    det_s.append(float(rng.uniform(0.05, 1)))
                    det_l.append(gl if rng.random() < 0.85 else int(rng.integers(0, 3)))
            for _ in range(int(rng.integers(1, 5))):
                b = _box(rng, small=rng.random() < 0.3)
                det_b.append([b[0], b[1], b[0] + b[2], b[1] + b[3]])
                det_s.append(float(rng.uniform(0.05, 1)))
                det_l.append(int(rng.integers(0, 3)))
        det_arrays.append({"boxes": np.asarray(det_b, np.float32).reshape(-1, 4),
                           "scores": np.asarray(det_s, np.float32),
                           "labels": np.asarray(det_l, np.int64)})
        for b, s, l in zip(det_b, det_s, det_l):
            dts.append({"image_id": img, "category_id": l, "score": s,
                        "bbox": [b[0], b[1], b[2] - b[0], b[3] - b[1]]})
    return {"gts": gts, "dts": dts, "gt_arrays": gt_arrays, "det_arrays": det_arrays}


@pytest.fixture(params=["native", "numpy"])
def matcher(request, monkeypatch):
    """The port's matcher for the test: the C++ one or its numpy twin.
    Yields a function that checks that only that one ran."""
    if request.param == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    else:
        assert native.get_lib() is not None, native.build_error
    before = dict(native.calls)

    def only_it_ran():
        ran = {k: native.calls[k] - before[k] for k in before}
        other = "numpy" if request.param == "native" else "native"
        assert ran[request.param] > 0 and ran[other] == 0, ran
    yield only_it_ran


def _equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("iou_type", ["bbox", "proposal"])
def test_cocoeval_matches_jax(case, matcher, iou_type):
    """Precision and recall tables and the summary, bit for bit."""
    out = []
    for mod in (jce, tce):
        ev = mod.COCOEvaluator(copy.deepcopy(case["gts"]), copy.deepcopy(case["dts"]),
                               range(N_IMAGES), range(NUM_CLASSES), iou_type,
                               max_dets=(1, 10, 100) if iou_type == "bbox" else (1, 5, 10),
                               img_shapes={i: (H, W) for i in range(N_IMAGES)})
        ev.evaluate()
        out.append((ev.precision, ev.recall, ev.summarize(), ev.per_category_ap()))
    matcher()
    (jp, jr, js, jc), (tp, tr, ts, tc) = out
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tr, jr)
    assert ts == js and 0 < ts["mAP"] < 1
    np.testing.assert_array_equal(np.array(list(tc.values())), np.array(list(jc.values())))
    if iou_type == "bbox":
        assert np.isnan(tc[NUM_CLASSES - 1])        # the class with no ground truth


def test_cocoeval_segm_matches_jax(case, matcher):
    """segm IoU on RLEs: the ground truth's boxes filled as polygons, the
    crowd regions as their RLEs, detections as encoded masks."""
    gts = copy.deepcopy(case["gts"])
    for g in gts:
        if not g["iscrowd"]:
            x, y, w, h = g["bbox"]
            g["segmentation"] = [[x, y, x, y + h, x + w, y + h, x + w, y]]
    dts = copy.deepcopy(case["dts"])
    for d in dts:
        m = np.zeros((H, W), np.uint8)
        x, y, w, h = (int(round(v)) for v in d["bbox"])
        m[max(y, 0):y + h, max(x, 0):x + w] = 1
        d["segmentation"] = trle.encode(m)
    stats = [mod.evaluate_coco(copy.deepcopy(gts), copy.deepcopy(dts), range(N_IMAGES),
                               range(NUM_CLASSES), "segm",
                               img_shapes={i: (H, W) for i in range(N_IMAGES)})
             for mod in (jce, tce)]
    matcher()
    assert stats[1] == stats[0] and 0 < stats[1]["mAP"] < 1


def test_match_image_native_equals_numpy_twin(monkeypatch):
    """The C++ matcher and the numpy loop on random IoU tables with ignored
    and crowd columns, ties included."""
    rng = np.random.default_rng(5)
    thrs = np.arange(0.5, 1.0, 0.05).round(2)
    cases = []
    for _ in range(40):
        D, G = int(rng.integers(1, 12)), int(rng.integers(1, 9))
        ious = np.round(rng.random((D, G)), 1)       # coarse values make ties
        gt_ig = np.sort(rng.random(G) < 0.3)          # ignored columns last
        cases.append((ious, gt_ig, rng.random(G) < 0.3))
    before = dict(native.calls)
    got = [tce._match_image(thrs, *c) for c in cases]
    monkeypatch.setattr(native, "get_lib", lambda: None)
    twin = [tce._match_image(thrs, *c) for c in cases]
    assert {k: native.calls[k] - before[k] for k in before} == {"native": 40, "numpy": 40}
    for (a, b), (c, d) in zip(got, twin):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


def test_eval_map_coco_matches_jax(case, matcher):
    names = [f"c{i}" for i in range(NUM_CLASSES)]
    got, want = (mod.eval_map_coco(case["det_arrays"], case["gt_arrays"], NUM_CLASSES,
                                   classwise=True, class_names=names) for mod in (tev, jev))
    matcher()
    _equal(got, want)
    assert 0 < got["bbox_mAP"] < 1 and np.isnan(got[f"AP_c{NUM_CLASSES - 1}"])


@pytest.mark.parametrize("scale_ranges", [None, [(0, 16), (16, 48), (48, 1e5)]],
                         ids=["whole", "areas"])
@pytest.mark.parametrize("dataset", [None, "voc07"])
def test_eval_map_matches_jax(case, scale_ranges, dataset):
    """The VOC protocol (`eval_map`, area and 11-point AP), with ignored
    ground truth on some images."""
    anns = [dict(g, bboxes_ignore=g["bboxes"][:1] + 1.0, labels_ignore=g["labels"][:1])
            if i % 2 else g for i, g in enumerate(case["gt_arrays"])]
    got, want = (mod.eval_map(case["det_arrays"], anns, scale_ranges=scale_ranges,
                              dataset=dataset, num_classes=NUM_CLASSES)
                 for mod in (tev, jev))
    np.testing.assert_array_equal(got[0], want[0])
    assert len(got[1]) == len(want[1]) == NUM_CLASSES
    for g, w in zip(got[1], want[1]):
        for k in ("num_gts", "num_dets", "recall", "precision", "ap"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_eval_map_voc_and_recalls_match_jax(case):
    for thr in (0.5, 0.75):
        assert tev.eval_map_voc(case["det_arrays"], case["gt_arrays"], NUM_CLASSES, thr) == \
            jev.eval_map_voc(case["det_arrays"], case["gt_arrays"], NUM_CLASSES, thr)
    got, want = (mod.eval_recalls(case["det_arrays"], case["gt_arrays"], (1, 5, 100),
                                  (0.5, 0.7)) for mod in (tev, jev))
    assert got == want and 0 < got["AR@100@0.50"] < 1


def test_average_precision_and_tpfp_match_jax():
    rng = np.random.default_rng(2)
    rec = np.sort(rng.random((3, 20)), 1)
    prec = rng.random((3, 20))
    for mode in ("area", "11points"):
        np.testing.assert_array_equal(tev.average_precision(rec, prec, mode),
                                      jev.average_precision(rec, prec, mode))
        assert tev.average_precision(rec[0], prec[0], mode) == \
            jev.average_precision(rec[0], prec[0], mode)
    det = np.concatenate([rng.random((15, 2)) * 50, rng.random((15, 2)) * 50 + 50,
                          rng.random((15, 1))], 1)
    gt = np.concatenate([rng.random((6, 2)) * 50, rng.random((6, 2)) * 50 + 50], 1)
    for areas in (None, [(0, 2500), (2500, 1e9)]):
        for got, want in zip(tev.tpfp_default(det, gt, gt[:2] + 3, 0.5, areas),
                             jev.tpfp_default(det, gt, gt[:2] + 3, 0.5, areas)):
            np.testing.assert_array_equal(got, want)


def test_summaries_match_jax(capsys):
    results = [{"class": "a", "num_gts": 3, "num_dets": 5, "ap": 0.25}]
    recalls = np.array([[0.5, 0.25], [0.75, 0.5]])
    assert tev.print_map_summary(0.25, results) == jev.print_map_summary(0.25, results)
    assert tev.print_recall_summary(recalls, (10, 100), (0.5, 0.7)) == \
        jev.print_recall_summary(recalls, (10, 100), (0.5, 0.7))


def test_rle_matches_jax():
    """encode (both codecs), decode, area, to_bbox, merge, polygons, iou."""
    rng = np.random.default_rng(3)
    masks = [(rng.random((H, W)) < p).astype(np.uint8) for p in (0.0, 0.02, 0.5, 1.0)]
    for m in masks:
        for compress in (True, False):
            got, want = trle.encode(m, compress), jrle.encode(m, compress)
            assert got == want
            np.testing.assert_array_equal(trle.decode(got), jrle.decode(want))
            assert trle.area(got) == jrle.area(want)
            np.testing.assert_array_equal(trle.to_bbox(got), jrle.to_bbox(want))
    rles = [trle.encode(m) for m in masks]
    for intersect in (False, True):
        assert trle.merge(rles[1:3], intersect) == jrle.merge(rles[1:3], intersect)
    poly = [10.5, 5.0, 60.2, 8.0, 55.0, 70.9, 12.0, 60.0]
    assert trle.polygon_to_rle(poly, H, W) == jrle.polygon_to_rle(poly, H, W)
    assert trle.ann_to_rle([poly], H, W) == jrle.ann_to_rle([poly], H, W)
    np.testing.assert_array_equal(trle.iou(rles[1:], rles[:3], [0, 1, 0]),
                                  jrle.iou(rles[1:], rles[:3], [0, 1, 0]))
    boxes = rng.random((5, 4)) * 50
    np.testing.assert_array_equal(trle.bbox_iou(boxes, boxes[:3] + 2, [1, 0, 0]),
                                  jrle.bbox_iou(boxes, boxes[:3] + 2, [1, 0, 0]))


def test_class_names_match_jax():
    for aliases in jcn.dataset_aliases.values():
        for alias in aliases:
            assert tcn.get_classes(alias) == jcn.get_classes(alias)
    with pytest.raises(ValueError):
        tcn.get_classes("nope")
