"""The flagship detector: PanoSwin-T Faster R-CNN, 5 classes.

Same configuration as `_flagship` in `__graft_entry__.py` (embed 96, depths
2-2-6-2, heads 3-6-12-24, window 7, absolute encoder), which `bench.py`
runs.  `tiny=True` gives a small variant for the tests (embed 6, depths
2-2-2-2, heads 1-1-1-2, window 4, FPN width 16), whose stages run window
attention; the tests take the JAX package's own tiny flagship (depths
1-1-1-1, PitchAttention alone) as a config through `apis/inference.py`.

`build_flagship(train=True)` gives the detector in train mode with the
stem's BatchNorm live, for `runtime/train.make_train_step`;
`flagship_train_batch` makes the training batch that `bench.py` times.

Two options of the JAX backbone select the other configurations that run:
`fused_attention=True` sends every block's attention through kernel K2
(`ops/fused_attention.py`), and `pano_mode=False` is the planar
configuration (`configs/panoswin/faster_rcnn_panoswin_tiny_planar_streetwin.py`).
Both keep the JAX defaults, and every mode has the same parameters.
"""

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from .device import resolve_device
from .models.detectors import PanoFasterRCNN
from .runtime.checkpoint import fold_batchnorm

# The equirectangular frame size that `bench.py` runs the flagship at.
FRAME_H, FRAME_W = 512, 1024


def flagship_config(tiny: bool = False, fused_attention: bool = False,
                    pano_mode: bool = True, drop_path_rate: Optional[float] = None) -> dict:
    """`drop_path_rate` None keeps the configuration's own (0.1; tiny 0)."""
    if tiny:
        backbone = {"embed_dim": 6, "depths": (2, 2, 2, 2), "num_heads": (1, 1, 1, 2),
                    "window_size": 4, "ape": True, "drop_path_rate": 0.0}
        neck = {"in_channels": (6, 12, 24, 48), "out_channels": 16, "num_outs": 5}
    else:
        backbone = {"embed_dim": 96, "depths": (2, 2, 6, 2), "num_heads": (3, 6, 12, 24),
                    "window_size": 7, "ape": True, "drop_path_rate": 0.1}
        neck = {"in_channels": (96, 192, 384, 768), "out_channels": 256, "num_outs": 5}
    backbone.update(fused_attention=fused_attention, pano_mode=pano_mode)
    if drop_path_rate is not None:
        backbone["drop_path_rate"] = drop_path_rate
    return {"backbone": backbone, "neck": neck, "num_classes": 5}


def init_weights(model: nn.Module, seed: int = 0) -> None:
    """Random weights from `seed`: Linear weights, bias tables, Swin's
    absolute position table and the `'tf'` embed's position table and
    input projection N(0, 0.02) clipped at 2 sigma, conv and
    transposed-conv weights N(0, 1/fan_in), biases 0; BatchNorm and
    LayerNorm keep their identity defaults."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("_Te", "_table", "absolute_pos_embed", "pos_embedding",
                              "in_proj_weight")):
                p.copy_(torch.randn(p.shape, generator=g).clamp(-2, 2) * 0.02)
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=g).clamp(-2, 2) * 0.02)
            elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=g) * fan_in ** -0.5)
            else:
                continue
            if m.bias is not None:
                m.bias.zero_()


def build_flagship(tiny: bool = False, compute_dtype: Optional[torch.dtype] = None,
                   device: Optional[Union[str, torch.device]] = None,
                   seed: int = 0, fused_attention: bool = False,
                   pano_mode: bool = True, train: bool = False,
                   roi_align: str = "direct",
                   drop_path_rate: Optional[float] = None) -> PanoFasterRCNN:
    """The flagship on `device` (the card unless "cpu" is asked for), with
    random weights from `seed`: in eval mode with the stem's BatchNorm
    folded, or with `train=True` in train mode with the BatchNorm live.
    The weights depend on `seed` alone, not on the options.  `roi_align`
    goes to `PanoFasterRCNN`."""
    dev = resolve_device(device)
    model = PanoFasterRCNN(**flagship_config(tiny, fused_attention, pano_mode, drop_path_rate),
                           compute_dtype=compute_dtype, roi_align=roi_align)
    init_weights(model, seed)
    if train:
        return model.to(dev).train()
    model.load_state_dict(fold_batchnorm(model.state_dict()))
    return model.to(dev).eval()


def flagship_inputs(batch: int, device: Union[str, torch.device], seed: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(images, img_shapes, scale_factors) of one request: `batch` frames of
    FRAME_H x FRAME_W uniform in [0, 1) from `seed`, on `device`."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((batch, FRAME_H, FRAME_W, 3)).astype(np.float32))
    img_shapes = torch.tensor([[float(FRAME_H), float(FRAME_W)]] * batch)
    return images.to(device), img_shapes.to(device), torch.ones((batch, 4), device=device)


def flagship_train_batch(batch: int, device: Union[str, torch.device], seed: int = 0,
                         height: int = FRAME_H, width: int = FRAME_W,
                         num_gt: int = 32) -> Dict[str, torch.Tensor]:
    """The training batch of `bench.py:88-99`: `batch` frames uniform in
    [0, 1) from `seed`, and `num_gt` ground-truth boxes of class 0 along the
    diagonal of each (at 512 x 1024: from (0, 0, 100, 80) to (400, 200, 500,
    280); scaled with the frame)."""
    rng = np.random.default_rng(seed)
    images = torch.from_numpy(rng.random((batch, height, width, 3)).astype(np.float32))
    sx, sy = width / FRAME_W, height / FRAME_H
    boxes = np.stack([np.linspace(0, 400 * sx, num_gt), np.linspace(0, 200 * sy, num_gt),
                      np.linspace(100 * sx, 500 * sx, num_gt),
                      np.linspace(80 * sy, 280 * sy, num_gt)], -1).astype(np.float32)
    out = {"images": images,
           "img_shapes": torch.tensor([[float(height), float(width)]] * batch),
           "gt_boxes": torch.from_numpy(np.stack([boxes] * batch)),
           "gt_labels": torch.zeros((batch, num_gt), dtype=torch.int64),
           "gt_valid": torch.ones((batch, num_gt), dtype=torch.bool)}
    return {k: v.to(device) for k, v in out.items()}
