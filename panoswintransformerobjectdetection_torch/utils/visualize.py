"""Drawing detections on an image (the reference's `imshow_det_bboxes` and
`BaseDetector.show_result`).

The port's own copy of `panoswintransformerobjectdetection_tpu/utils/
visualize.py` (`class_color`, `imshow_det_bboxes`, `show_result`): a
fixed colour per class, score text, masks blended at 0.5.  OpenCV is
imported inside the functions that draw: the card's machine has none.
"""

from typing import Optional, Sequence

import numpy as np


def class_color(label: int):
    """Deterministic bright BGR color per class id (mmdet palette role)."""
    rng = np.random.default_rng(label * 7919 + 13)
    c = rng.integers(60, 256, 3)
    return int(c[0]), int(c[1]), int(c[2])


def imshow_det_bboxes(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                      scores: Optional[np.ndarray] = None,
                      masks: Optional[np.ndarray] = None,
                      class_names: Optional[Sequence[str]] = None,
                      score_thr: float = 0.3,
                      color=None, thickness: int = 2,
                      out_file: Optional[str] = None) -> np.ndarray:
    """img: (H, W, 3) BGR uint8; boxes (K, 4) xyxy; labels (K,);
    scores (K,) optional; masks (K, H, W) binary optional.  Draws
    per-class colored boxes + labels and alpha-blends masks; writes
    `out_file` when given.  Returns the drawn image."""
    import cv2
    img = img.copy()
    for i in range(len(boxes)):
        if scores is not None and scores[i] < score_thr:
            continue
        col = color if color is not None else class_color(int(labels[i]))
        if masks is not None:
            m = np.asarray(masks[i], bool)
            if m.shape[:2] == img.shape[:2] and m.any():
                overlay = img[m].astype(np.float32) * 0.5 + \
                    np.asarray(col, np.float32) * 0.5
                img[m] = overlay.astype(img.dtype)
        x1, y1, x2, y2 = [int(v) for v in boxes[i][:4]]
        cv2.rectangle(img, (x1, y1), (x2, y2), col, thickness)
        name = (class_names[labels[i]] if class_names is not None
                else str(int(labels[i])))
        text = f"{name}" + (f" {scores[i]:.2f}" if scores is not None else "")
        (tw, th), _ = cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        ty = max(y1 - 4, th + 2)
        cv2.rectangle(img, (x1, ty - th - 2), (x1 + tw, ty + 2), col, -1)
        cv2.putText(img, text, (x1, ty), cv2.FONT_HERSHEY_SIMPLEX, 0.5,
                    (255, 255, 255), 1)
    if out_file:
        cv2.imwrite(out_file, img)
    return img


def show_result(img: np.ndarray, result: dict,
                class_names: Optional[Sequence[str]] = None,
                score_thr: float = 0.3,
                out_file: Optional[str] = None) -> np.ndarray:
    """Render a `single_device_test`-style per-image result dict
    (`BaseDetector.show_result:272` role): keys boxes/scores/labels and
    optionally masks ((K, H, W) bitmaps or RLE dicts)."""
    masks = result.get("masks")
    if masks is not None and len(masks) and isinstance(masks[0], dict):
        from ..core import rle as rle_utils
        masks = np.stack([rle_utils.decode(m) for m in masks])
    return imshow_det_bboxes(
        img, np.asarray(result["boxes"]), np.asarray(result["labels"]),
        scores=np.asarray(result["scores"]) if "scores" in result else None,
        masks=masks, class_names=class_names, score_thr=score_thr,
        out_file=out_file)
