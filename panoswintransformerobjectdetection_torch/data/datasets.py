"""Datasets: COCO-format parsing without pycocotools, and the pano variants.

The port's own copy of `panoswintransformerobjectdetection_tpu/data/
datasets.py`: `CocoStyleDataset` (records, `eval_anns`, `get_sample`,
`det2anns`, the COCOeval-exact `evaluate`, `evaluate_fast`), `CocoDataset`,
`StreetDataset`, `Indoor360Dataset` (BFoV boxes turned into equirectangular
xyxy at parse time, `geometry/projection.bfov_to_xyxy`), `VOCDataset`,
`LVISDataset`, `CityscapesDataset`, `WIDERFaceDataset` and
`DeepFashionDataset`, the roles of the reference's `CocoDataset`
(`mmdet/datasets/coco.py:21`), `StreetDataset` (`street.py:21`) and the
360-Indoor tooling.  Records and `eval_anns` are the JAX package's, with
two deliberate departures (ROADMAP.md, known divergences): 360-Indoor's
`eval_anns` carry the converted pixel box (the JAX package keeps the BFoV
box in radians there, which pixel detections cannot match), and
`VOCDataset` finds `Annotations/` in VOC's own layout, three levels above
the split file (`VOC2007/ImageSets/Main/test.txt` -> `VOC2007/`).
"""

import json
import os.path as osp
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.evaluation import eval_map_coco

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella', 'handbag',
    'tie', 'suitcase', 'frisbee', 'skis', 'snowboard', 'sports ball', 'kite',
    'baseball bat', 'baseball glove', 'skateboard', 'surfboard',
    'tennis racket', 'bottle', 'wine glass', 'cup', 'fork', 'knife', 'spoon',
    'bowl', 'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
    'hot dog', 'pizza', 'donut', 'cake', 'chair', 'couch', 'potted plant',
    'bed', 'dining table', 'toilet', 'tv', 'laptop', 'mouse', 'remote',
    'keyboard', 'cell phone', 'microwave', 'oven', 'toaster', 'sink',
    'refrigerator', 'book', 'clock', 'vase', 'scissors', 'teddy bear',
    'hair drier', 'toothbrush')


class CocoStyleDataset:
    """COCO-json annotations -> per-image records with numpy ann arrays."""
    CLASSES: Sequence[str] = COCO_CLASSES

    def __init__(self, ann_file: str, img_prefix: str = "",
                 pipeline: Optional[Sequence] = None,
                 test_mode: bool = False, filter_empty_gt: bool = True,
                 classes: Optional[Sequence[str]] = None):
        if classes is not None:
            self.CLASSES = tuple(classes)
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        from .transforms import Compose
        self.pipeline = Compose(pipeline) if pipeline else None
        self.records = self._parse(ann_file, filter_empty_gt and not test_mode)
        # aspect-ratio group flag (`custom.py` _set_group_flag)
        self.flags = np.array(
            [1 if r["width"] / max(r["height"], 1) > 1 else 0 for r in self.records],
            np.uint8)

    # ------------------------------------------------------------------ parse
    def _parse(self, ann_file, filter_empty) -> List[dict]:
        with open(ann_file) as f:
            coco = json.load(f)
        cats = sorted(coco["categories"], key=lambda c: c["id"])
        name_to_idx = {c: i for i, c in enumerate(self.CLASSES)}
        self.cat_id_to_label = {}
        for c in cats:
            if c["name"] in name_to_idx:
                self.cat_id_to_label[c["id"]] = name_to_idx[c["name"]]
        anns_by_img: Dict[int, list] = {}
        for a in coco.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        records = []
        for im in coco["images"]:
            anns = anns_by_img.get(im["id"], [])
            boxes, labels = [], []
            boxes_ignore = []
            polys = []
            eval_anns = []
            for a in anns:
                if a["category_id"] not in self.cat_id_to_label:
                    continue
                b = self._ann_to_xyxy(a, im)
                label = self.cat_id_to_label[a["category_id"]]
                # evaluation keeps every mapped annotation, crowd and tiny
                # included (pycocotools loads the raw gt json unfiltered;
                # `coco.py:365` evaluates against it) — so eval bboxes come
                # straight from the raw xywh, bypassing the tiny-box gate
                # that only applies to training targets
                x, y, w, h = self._eval_xywh(a, b)
                eval_anns.append({
                    "image_id": im["id"], "category_id": label,
                    "bbox": [x, y, w, h],
                    "area": self._eval_area(a, [x, y, x + w, y + h]),
                    "iscrowd": a.get("iscrowd", 0),
                    "ignore": a.get("ignore", 0),
                    "segmentation": a.get("segmentation"),
                })
                if a.get("iscrowd", 0):
                    # crowd regions train as ignore boxes
                    # (`coco.py _parse_ann_info` gt_bboxes_ignore)
                    if b is not None:
                        boxes_ignore.append(b)
                    continue
                if b is None:
                    continue
                boxes.append(b)
                labels.append(label)
                seg = a.get("segmentation")
                polys.append(seg if isinstance(seg, list) else None)
            if filter_empty and not boxes:
                continue
            records.append({
                "id": im["id"],
                "filename": im["file_name"],
                "width": im["width"],
                "height": im["height"],
                "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                "labels": np.asarray(labels, np.int64),
                "bboxes_ignore": np.asarray(boxes_ignore, np.float32).reshape(-1, 4),
                "polys": polys,
                "eval_anns": eval_anns,
            })
        return records

    def _eval_xywh(self, ann, xyxy):
        """The box that evaluation holds detections against: the raw xywh."""
        return ann["bbox"]

    def _eval_area(self, ann, xyxy):
        """Area used for COCOeval area-range buckets: the annotation's own
        `area` field when present (segmentation area for COCO), else the
        parsed box area."""
        if ann.get("area") is not None:
            return float(ann["area"])
        return float((xyxy[2] - xyxy[0]) * (xyxy[3] - xyxy[1]))

    def _ann_to_xyxy(self, ann, img_info):
        """Training-box gate only (eval keeps every ann): drops degenerate
        boxes like `custom.py _filter_imgs` / `coco.py _parse_ann_info`
        (mmdet uses `w < 1 or h < 1`)."""
        x, y, w, h = ann["bbox"]
        if w < 1 or h < 1:
            return None
        return [x, y, x + w, y + h]

    # ------------------------------------------------------------------ api
    def __len__(self):
        return len(self.records)

    def get_sample(self, idx) -> dict:
        r = self.records[idx]
        results = {
            "img_path": osp.join(self.img_prefix, r["filename"]),
            "img_info": r,
            "ann_info": {"bboxes": r["bboxes"], "labels": r["labels"],
                         "polys": r.get("polys")},
        }
        if self.pipeline is not None:
            results = self.pipeline(results)
        return results

    __getitem__ = get_sample

    def det2anns(self, detections: List[dict]):
        """Per-image result dicts -> flat COCO-format dt annotation list.

        detections[i]: dict(boxes (K, 4) xyxy, scores (K,), labels (K,),
        optional mask (K,) validity, optional masks — (K, H, W) binary
        bitmaps or a list of RLE dicts) in original image coordinates.
        Mirrors `_det2json`/`_segm2json`
        (the reference's `mmdet/datasets/coco.py:205-260`).
        """
        from ..core import rle as rle_utils
        dt_anns = []
        for rec, det in zip(self.records, detections):
            boxes = np.asarray(det["boxes"], np.float32).reshape(-1, 4)
            scores = np.asarray(det["scores"], np.float32)
            labels = np.asarray(det["labels"])
            masks = det.get("masks")
            valid = det.get("mask")
            keep = np.ones(len(boxes), bool) if valid is None \
                else np.asarray(valid, bool)
            for i in np.nonzero(keep)[0]:
                x1, y1, x2, y2 = boxes[i]
                ann = {"image_id": rec["id"], "category_id": int(labels[i]),
                       "bbox": [float(x1), float(y1),
                                float(x2 - x1), float(y2 - y1)],
                       "score": float(scores[i])}
                if masks is not None:
                    m = masks[i]
                    ann["segmentation"] = m if isinstance(m, dict) \
                        else rle_utils.encode(np.asarray(m) > 0.5)
                dt_anns.append(ann)
        return dt_anns

    def evaluate(self, detections: List[dict], metric="bbox",
                 classwise: bool = False, proposal_nums=(100, 300, 1000),
                 **legacy) -> Dict[str, float]:
        """COCOeval-exact evaluation (`coco.py:365-478` `evaluate`).

        metric: 'bbox' | 'segm' | 'proposal' or a list of these.
        detections: see `det2anns`.  Returns mmdet-named keys
        (`bbox_mAP`, `bbox_mAP_50`, ..., `segm_mAP`, `AR@100`, ...).
        """
        from ..core.cocoeval import COCOEvaluator
        metrics = [metric] if isinstance(metric, str) else list(metric)
        gt_anns = [a for r in self.records for a in r["eval_anns"]]
        img_ids = [r["id"] for r in self.records]
        img_shapes = {r["id"]: (r["height"], r["width"]) for r in self.records}
        cat_ids = list(range(len(self.CLASSES)))
        dt_anns = self.det2anns(detections)
        out: Dict[str, float] = {}
        for met in metrics:
            if met == "proposal":
                ev = COCOEvaluator(gt_anns, dt_anns, img_ids, cat_ids,
                                   "proposal", max_dets=sorted(proposal_nums),
                                   img_shapes=img_shapes)
                stats = ev.evaluate().summarize()
                for d in sorted(proposal_nums):
                    out[f"AR@{d}"] = stats[f"AR@{d}"]
                continue
            if met == "segm" and not any("segmentation" in a for a in dt_anns):
                raise ValueError("segm metric requested but detections carry "
                                 "no masks (pass det['masks'])")
            ev = COCOEvaluator(gt_anns, dt_anns, img_ids, cat_ids, met,
                               img_shapes=img_shapes)
            stats = ev.evaluate().summarize()
            for key in ("mAP", "mAP_50", "mAP_75", "mAP_s", "mAP_m", "mAP_l"):
                out[f"{met}_{key}"] = stats[key]
            for d in (1, 10, 100):
                out[f"{met}_AR@{d}"] = stats[f"AR@{d}"]
            if classwise:
                per_cat = ev.per_category_ap()
                for c, ap in per_cat.items():
                    out[f"{met}_AP_{self.CLASSES[c]}"] = ap
        return out

    def evaluate_fast(self, detections: List[dict], iou_thrs=None,
                      classwise: bool = False) -> Dict[str, float]:
        """Legacy quick bbox mAP (no crowd/area handling); kept for
        cheap in-loop eval where exactness doesn't matter."""
        gts = [{"bboxes": r["bboxes"], "labels": r["labels"]} for r in self.records]
        return eval_map_coco(detections, gts, num_classes=len(self.CLASSES),
                             iou_thrs=iou_thrs, classwise=classwise,
                             class_names=self.CLASSES)


class CocoDataset(CocoStyleDataset):
    CLASSES = COCO_CLASSES


class StreetDataset(CocoStyleDataset):
    """OmnidirectionalStreetViewDataset (`street.py:21`)."""
    CLASSES = ("car", "crosswalk", "light", "traffic_sign", "warning_line")


class Indoor360Dataset(CocoStyleDataset):
    """360-Indoor: BFoV (tangent u, v, w, h) boxes converted to equirect
    xyxy at parse time (`lzx/indoor360/view_pano.py:39`, the
    `LoadPanoAnnotations bb_tangent2sphere` hook)."""
    CLASSES = tuple(f"c{i}" for i in range(37))

    def __init__(self, *args, classes=None, **kw):
        super().__init__(*args, classes=classes, **kw)

    @staticmethod
    def _is_bfov(ann) -> bool:
        b = ann["bbox"]
        return len(b) == 4 and max(abs(v) for v in b) <= 2 * np.pi

    def _ann_to_xyxy(self, ann, img_info):
        from ..geometry.projection import bfov_to_xyxy
        if self._is_bfov(ann):
            xyxy = bfov_to_xyxy(torch.tensor([ann["bbox"]], dtype=torch.float32),
                                img_info["width"], img_info["height"]).numpy()[0]
            return xyxy.tolist()
        return super()._ann_to_xyxy(ann, img_info)

    def _eval_xywh(self, ann, xyxy):
        """A BFoV box is evaluated as its converted pixel box (x1, y1, x2 - x1,
        y2 - y1), the frame detections are in; the JAX package keeps it in
        radians here, where no pixel detection can match it."""
        if not self._is_bfov(ann):
            return ann["bbox"]
        x1, y1, x2, y2 = xyxy
        return [x1, y1, x2 - x1, y2 - y1]

    def _eval_area(self, ann, xyxy):
        # the raw `area` field is in BFoV (radian) units; area-range
        # buckets need pixel area of the converted equirect box
        return float((xyxy[2] - xyxy[0]) * (xyxy[3] - xyxy[1]))


VOC_CLASSES = (
    'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car', 'cat',
    'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike', 'person',
    'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor')


class VOCDataset(CocoStyleDataset):
    """Pascal-VOC XML annotations (`mmdet/datasets/voc.py` + `xml_style.py`).

    Expects VOC's own layout: the split file `<year>/ImageSets/Main/<split>.txt`,
    `<year>/Annotations/*.xml` and `<year>/JPEGImages/` (the JAX package
    reads `Annotations/` one level below `<year>/`).  `evaluate` uses
    VOC-style mAP@0.5 (`eval_map_voc`).
    """
    CLASSES = VOC_CLASSES

    def _parse(self, split_file, filter_empty):
        import xml.etree.ElementTree as ET
        root = osp.dirname(osp.dirname(osp.dirname(split_file)))
        with open(split_file) as f:
            ids = [l.strip() for l in f if l.strip()]
        name_to_idx = {c: i for i, c in enumerate(self.CLASSES)}
        records = []
        for i, img_id in enumerate(ids):
            xml_path = osp.join(root, "Annotations", img_id + ".xml")
            tree = ET.parse(xml_path)
            r = tree.getroot()
            size = r.find("size")
            w = int(size.find("width").text)
            h = int(size.find("height").text)
            boxes, labels = [], []
            for obj in r.findall("object"):
                name = obj.find("name").text
                if name not in name_to_idx:
                    continue
                if obj.find("difficult") is not None and \
                        int(obj.find("difficult").text):
                    continue
                bb = obj.find("bndbox")
                boxes.append([float(bb.find(t).text) for t in
                              ("xmin", "ymin", "xmax", "ymax")])
                labels.append(name_to_idx[name])
            if filter_empty and not boxes:
                continue
            records.append({
                "id": i, "filename": osp.join("JPEGImages", img_id + ".jpg"),
                "width": w, "height": h,
                "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                "labels": np.asarray(labels, np.int64),
            })
        return records

    def evaluate(self, detections, iou_thr=0.5):
        from ..core.evaluation import eval_map_voc
        gts = [{"bboxes": r["bboxes"], "labels": r["labels"]} for r in self.records]
        return eval_map_voc(detections, gts, len(self.CLASSES), iou_thr)


class LVISDataset(CocoStyleDataset):
    """LVIS v1 (`mmdet/datasets/lvis.py`): COCO-format json whose images
    carry `coco_url`/`neg_category_ids`; category names come from the json
    itself (1203 classes)."""

    def _parse(self, ann_file, filter_empty):
        with open(ann_file) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.CLASSES = tuple(c["name"] for c in cats)
        self.cat_id_to_label = {c["id"]: i for i, c in enumerate(cats)}
        anns_by_img = {}
        for a in data.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)
        records = []
        for im in data["images"]:
            fn = im.get("file_name")
            if fn is None:  # LVIS v1 images reference coco_url
                fn = "/".join(im["coco_url"].split("/")[-2:])
            boxes, labels = [], []
            for a in anns_by_img.get(im["id"], []):
                b = self._ann_to_xyxy(a, im)
                if b is None or a["category_id"] not in self.cat_id_to_label:
                    continue
                boxes.append(b)
                labels.append(self.cat_id_to_label[a["category_id"]])
            if filter_empty and not boxes:
                continue
            records.append({"id": im["id"], "filename": fn,
                            "width": im["width"], "height": im["height"],
                            "bboxes": np.asarray(boxes, np.float32).reshape(-1, 4),
                            "labels": np.asarray(labels, np.int64)})
        return records


class CityscapesDataset(CocoStyleDataset):
    """Cityscapes instances in COCO-json form (`mmdet/datasets/cityscapes.py`;
    produce the json with tools/dataset_converters upstream)."""
    CLASSES = ("person", "rider", "car", "truck", "bus", "train",
               "motorcycle", "bicycle")


class WIDERFaceDataset(CocoStyleDataset):
    """WIDER-Face single-class detection (`mmdet/datasets/wider_face.py`)."""
    CLASSES = ("face",)


class DeepFashionDataset(CocoStyleDataset):
    """DeepFashion landmark/clothes detection
    (`mmdet/datasets/deepfashion.py`)."""
    CLASSES = ("top", "skirt", "leggings", "dress", "outer", "pants",
               "bag", "neckwear", "headwear", "eyeglass", "belt",
               "footwear", "hair", "skin", "face")
