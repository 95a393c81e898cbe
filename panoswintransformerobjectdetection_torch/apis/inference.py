"""Inference API: a detector from a config file and a reference `.pth`,
and detections for one image.

Counterpart of `build_detector_from_cfg`, `init_detector`, `load_weights`,
`inference_detector` and `async_inference_detector` in
`panoswintransformerobjectdetection_tpu/apis/inference.py`.  The detector
runs on the card unless the caller passes `device="cpu"`; the result is the
reference's per-class list of (k, 5) float32 arrays (x1, y1, x2, y2,
score).  `show_result_pyplot` draws such a result; it imports OpenCV and
matplotlib when it runs (the card's machine has neither).
"""

import asyncio
import functools
from typing import List, Optional, Union

import numpy as np
import torch

from ..data.transforms import Compose, Normalize, Pad, Resize
from ..device import resolve_device
from ..flagship import init_weights
from ..models.cascade import CascadeMaskRCNN, CascadeRCNN
from ..models.detectors import (BACKBONES, NECKS, MaskRCNN, MaskScoringRCNN,
                                PanoFasterRCNN)
from ..models.roi_head import BBOX_HEADS
from ..runtime.checkpoint import load_reference_weights, load_torch_state_dict
from ..runtime.config import load_config

DETECTOR_TYPES = {"PanoFasterRCNN": PanoFasterRCNN, "FasterRCNN": PanoFasterRCNN,
                  "MaskRCNN": MaskRCNN, "CascadeRCNN": CascadeRCNN,
                  "CascadeMaskRCNN": CascadeMaskRCNN, "MaskScoringRCNN": MaskScoringRCNN,
                  # JAX registers it as a plain `TwoStageDetector` (`detectors.py:654`)
                  "TridentFasterRCNN": PanoFasterRCNN}
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# `TwoStageDetector` fields (JAX `models/detectors.py:73-105`) that the port
# takes only at these values: other values select PISA, RoI extractors or
# other RoI sizes, which are not ported.
_DEFAULT_ONLY = {"pisa": None, "roi_extractor": None, "roi_sampling_ratio": 2,
                 "bbox_roi_size": 7}
# The bbox head's options that the port takes (`models/roi_head.BBOX_HEADS`).
_BBOX_HEAD_OPTIONS = {"type", "norm_groups", "conv_out_channels", "fc_out_channels"}
_FPN_DEFAULT_ONLY = {"start_level": 0, "add_extra_convs": False,
                     "relu_before_extra_convs": False}
_ZOO = "is not ported yet (ROADMAP.md, Queue 1, item 17)"


def build_detector_from_cfg(cfg: dict) -> PanoFasterRCNN:
    """A config's `model` dict -> `PanoFasterRCNN` (also for
    `TridentFasterRCNN`), `MaskRCNN`, `MaskScoringRCNN`, `CascadeRCNN` or
    `CascadeMaskRCNN` (random weights as constructed), with a backbone of
    `models/detectors.BACKBONES` and an FPN or HRFPN neck, each computing in
    `compute_dtype` (the JAX package's CNN backbones and HRFPN take none),
    and a Shared2FC or a Shared4Conv1FC bbox head.
    Types and options that the port does not implement raise
    `NotImplementedError`; `pretrained` (a weight-init directive of the
    training API) is dropped."""
    model = dict(cfg["model"])
    model.pop("pretrained", None)
    kind = model.pop("type", "PanoFasterRCNN")
    if kind not in DETECTOR_TYPES:
        raise NotImplementedError(f"detector type {kind!r} {_ZOO}")
    for key, default in _DEFAULT_ONLY.items():
        if model.pop(key, default) != default:
            raise NotImplementedError(f"detector option {key}={cfg['model'][key]!r} {_ZOO}")
    head = model.get("bbox_head")
    if head is not None and (head.get("type") not in BBOX_HEADS
                             or not set(head) <= _BBOX_HEAD_OPTIONS):
        raise NotImplementedError(f"detector option bbox_head={head!r} {_ZOO}")
    backbone = dict(model.pop("backbone"))
    if backbone.get("type", "PanoSwinTransformer") not in BACKBONES:
        raise NotImplementedError(f"backbone type {cfg['model']['backbone']['type']!r} {_ZOO}")
    neck = model.pop("neck", None)
    if neck is not None:
        if not isinstance(neck, dict) or neck.get("type", "FPN") not in NECKS:
            raise NotImplementedError(f"neck {neck!r} {_ZOO}")
        neck = dict(neck)
        defaults = _FPN_DEFAULT_ONLY if neck.get("type", "FPN") == "FPN" else {}
        for key, default in defaults.items():
            if neck.pop(key, default) != default:
                raise NotImplementedError(f"FPN option {key}={cfg['model']['neck'][key]!r} {_ZOO}")
    dtype = model.pop("compute_dtype", None)
    if dtype is not None and dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(f"compute_dtype {dtype!r}: the port's kernels take "
                                  f"{sorted(COMPUTE_DTYPES)}")
    return DETECTOR_TYPES[kind](backbone=backbone, neck=neck,
                                compute_dtype=COMPUTE_DTYPES.get(dtype), **model)


def load_weights(model: PanoFasterRCNN, checkpoint: str) -> None:
    """Load a reference-format `.pth` (or a `save_checkpoint` file) into
    `model` (`runtime/checkpoint.load_reference_weights`)."""
    load_reference_weights(model, load_torch_state_dict(checkpoint))


def init_detector(config: Union[str, dict], checkpoint: Optional[str] = None, seed: int = 0,
                  device: Optional[Union[str, torch.device]] = None) -> PanoFasterRCNN:
    """The detector of `config` (a config file's path or its dict) in eval
    mode on `device` (the card unless "cpu" is asked for), with the weights
    of `checkpoint` or, without one, random weights from `seed`
    (`flagship.init_weights`: the same seed does not give the JAX package's
    weights)."""
    dev = resolve_device(device)
    if isinstance(config, str):
        config = load_config(config)
    model = build_detector_from_cfg(config)
    if checkpoint:
        load_weights(model, checkpoint)
    else:
        init_weights(model, seed)
    return model.to(dev).eval()


def default_test_pipeline(img_scale=(800, 1333), img_norm: Optional[dict] = None) -> Compose:
    """Resize to `img_scale`, normalise (ImageNet's mean and std, BGR to RGB
    unless `img_norm` says otherwise), pad to multiples of 32."""
    img_norm = img_norm or {"mean": [123.675, 116.28, 103.53],
                            "std": [58.395, 57.12, 57.375], "to_rgb": True}
    return Compose([Resize(img_scale), Normalize(**img_norm), Pad(32)])


def prepare(img, pipeline: Optional[Compose] = None) -> dict:
    """Run `pipeline` (the default one if None) on an (H, W, 3) BGR image,
    or on the image at a file path (read with OpenCV, imported here only)."""
    if isinstance(img, str):
        import cv2
        path, img = img, cv2.imread(img, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
    results = {"img": np.asarray(img).astype(np.float32), "img_shape": img.shape,
               "ori_shape": img.shape, "scale_factor": np.ones(4, np.float32)}
    return (pipeline or default_test_pipeline())(results)


def inference_detector(model: PanoFasterRCNN, img, pipeline: Optional[Compose] = None,
                       num_classes: Optional[int] = None) -> List[np.ndarray]:
    """Detections for one image (a path, or an (H, W, 3) BGR array): the
    pipeline on the host, then `simple_test` on the model's device under
    `torch.inference_mode()`.  Returns a list over classes of (k, 5)
    float32 arrays, in original-image coordinates."""
    results = prepare(img, pipeline)
    dev = model.device
    h, w = results["img_shape"][:2]
    images = torch.from_numpy(np.ascontiguousarray(results["img"][None])).to(dev)
    with torch.inference_mode():
        out = model.simple_test(images, torch.tensor([[float(h), float(w)]], device=dev),
                                torch.from_numpy(results["scale_factor"][None]).to(dev))
    boxes, scores, labels, mask = (t[0].cpu().numpy() for t in out)
    per_class = []
    for c in range(num_classes or model.num_classes):
        sel = mask & (labels == c)
        per_class.append(np.concatenate([boxes[sel], scores[sel, None]], 1).astype(np.float32))
    return per_class


async def async_inference_detector(model: PanoFasterRCNN, img,
                                   pipeline: Optional[Compose] = None,
                                   num_classes: Optional[int] = None) -> List[np.ndarray]:
    """`inference_detector` in the event loop's default executor, so that
    the loop stays free while the request runs."""
    loop = asyncio.get_running_loop()
    return await loop.run_in_executor(None, functools.partial(
        inference_detector, model, img, pipeline=pipeline, num_classes=num_classes))


def show_result_pyplot(model: PanoFasterRCNN, img, result: List[np.ndarray],
                       score_thr: float = 0.3, fig_size=(15, 10), title: str = "result",
                       class_names=None, out_file: Optional[str] = None) -> np.ndarray:
    """Draw `inference_detector`'s result (a list over classes of (k, 5)
    arrays) on `img` (a path, or an (H, W, 3) BGR array): boxes and scores
    above `score_thr`, written to `out_file` when given, and shown in a
    matplotlib figure when the backend can show one.  Returns the drawn BGR
    image."""
    import cv2
    from ..utils.visualize import show_result
    if isinstance(img, str):
        img = cv2.imread(img, cv2.IMREAD_COLOR)
    boxes = np.concatenate([r[:, :4] for r in result]) if result else np.zeros((0, 4),
                                                                                 np.float32)
    scores = np.concatenate([r[:, 4] for r in result]) if result else np.zeros(0, np.float32)
    labels = np.concatenate([np.full(len(r), c, np.int64) for c, r in enumerate(result)]) \
        if result else np.zeros(0, np.int64)
    drawn = show_result(img, {"boxes": boxes, "scores": scores, "labels": labels},
                        class_names=class_names or getattr(model, "classes", None),
                        score_thr=score_thr, out_file=out_file)
    import matplotlib
    if matplotlib.get_backend().lower() != "agg":
        import matplotlib.pyplot as plt
        plt.figure(figsize=fig_size)
        plt.imshow(cv2.cvtColor(drawn, cv2.COLOR_BGR2RGB))
        plt.title(title)
        plt.axis("off")
        plt.show()
    return drawn
