"""Test-time augmentation: several scales and a horizontal flip, merged.

Counterpart of `aug_test_detector` in
`panoswintransformerobjectdetection_tpu/apis/tta.py` (the roles of the
reference's `MultiScaleFlipAug`, `aug_test` and `merge_aug_bboxes`).  Every
(scale, flip) variant proposes boxes, which are mapped back to the original
image and merged by NMS at IoU 0.7; the shared proposals then go through
each variant's features, class probabilities and decoded boxes are
averaged over the variants, and one class-wise NMS gives the detections.
A cascade raises (its `bbox_for_rois`, `models/cascade.TTA_REFUSAL`).
"""

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..core.bbox import flip_boxes
from ..models.detectors import PanoFasterRCNN
from ..ops.nms import NEG_INF, batched_nms, multiclass_nms
from .inference import default_test_pipeline, prepare


def aug_test_detector(model: PanoFasterRCNN, img: np.ndarray,
                      scales: Sequence[Tuple[int, int]] = ((800, 1333),),
                      flip: bool = True) -> Dict[str, np.ndarray]:
    """img: (H, W, 3) BGR.  Returns numpy `boxes` (k, 4) in original-image
    coordinates, `scores` (k,) and `labels` (k,)."""
    dev = model.device
    augs = []
    for scale in scales:
        r = prepare(img, default_test_pipeline(scale))
        shape = torch.tensor([[float(r["img_shape"][0]), float(r["img_shape"][1])]],
                             device=dev)
        sf = torch.from_numpy(r["scale_factor"]).to(dev)
        for fl in ([False, True] if flip else [False]):
            im = np.ascontiguousarray(r["img"][:, ::-1] if fl else r["img"])
            augs.append((torch.from_numpy(im[None]).to(dev), shape, sf,
                         r["img_shape"][1] if fl else None))

    with torch.inference_mode():
        boxes, scores = [], []
        for images, shape, sf, flip_w in augs:
            p = model.extract_proposals(images, shape)
            b = p.boxes[0] if flip_w is None else flip_boxes(p.boxes[0], flip_w)
            boxes.append(b / sf)
            scores.append(torch.where(p.mask[0], p.scores[0], NEG_INF))
        boxes, scores = torch.cat(boxes)[None], torch.cat(scores)[None]
        n = boxes.shape[1]
        keep = batched_nms(boxes, scores, torch.zeros((1, n), dtype=torch.int32, device=dev),
                           0.7, min(1000, n), scores > -1e9)
        props, prop_mask = keep.boxes, keep.mask

        agg_scores = agg_boxes = 0.0
        for images, shape, sf, flip_w in augs:
            p = props * sf
            if flip_w is not None:
                p = flip_boxes(p, flip_w)
            s, dec = model.bbox_for_rois(images, p, shape)
            dec = dec.reshape(1, props.shape[1], -1, 4)
            if flip_w is not None:
                dec = flip_boxes(dec, flip_w)
            agg_scores = agg_scores + s
            agg_boxes = agg_boxes + (dec / sf).flatten(2)
        r = multiclass_nms(agg_boxes / len(augs), agg_scores / len(augs), score_thr=0.05,
                           iou_threshold=0.5, max_per_img=100, valid=prop_mask)
    m = r.mask[0]
    return {"boxes": r.boxes[0][m].cpu().numpy(), "scores": r.scores[0][m].cpu().numpy(),
            "labels": r.labels[0][m].cpu().numpy()}
