"""Drive the PyTorch port on one CUDA card: build its kernels, hold each
against its plain PyTorch twin, run the flagship detector in its
configurations, report.

    python3 chip_smoke.py

Phases (each raises on failure, so any failure exits non-zero):
  1. environment: the card's name and power limit; TF32 off for f32 checks;
  2. build every kernel from `panoswintransformerobjectdetection_torch/csrc`;
  3. each kernel against its twin at the flagship's shapes, f32 and bf16,
     with its device time (`time_ms`), the twin's and a library call's (K2 at
     all four stage shapes, each in the record's `stages`; K5's entry point
     checked at a small shape).  K1 runs bf16 on the tensor cores and f32
     on them in 3xTF32, K2 and K4 bf16 on the tensor cores and f32 on the
     CUDA cores, K3 both types through vectorised gathers, K3's backward
     bf16 owner computes (each pixel written once, deterministic) and f32
     with atomics; their first versions are timed at bf16 beside them
     (`previous_ms`), K1's and K3's at f32 too, with each one's share of the
     bound (K1's f32 against two bounds: FFMA and 3xTF32), K2's and K4's
     f32 entries beside SDPA and cuBLAS in f32, K4 also on the dense route's
     own level-0 weights, K3's backward on random RoIs here and, in phase
     5, on the RoIs that a training step samples;
  4. small-input f32 checks of the card's path against the CPU path, plain
     and fused attention; then the flagship (PanoSwin-T Faster R-CNN, random
     weights from seed 0, BN folded, bf16) `simple_test` on 2 x 512 x 1024
     frames with PyTorch's TF32 defaults back: the plain and the fused-
     attention flagship alternate request by request, each request with the
     kernels' launch counts reset just before it and read just after; the
     two backbones' outputs are compared; one request of the planar
     configuration (`pano_mode=False`, fused attention); every fused
     request must launch K2's bf16 entry;
  5. training: the dense RoI route (K4 on every level) against the direct one
     (K3) on the card, values and map gradients; one `forward_train` +
     backward at 64 x 128 in f32 on the card against the CPU, same sampler
     noise, no DropPath: the five outputs and every parameter's gradient;
     then the flagship's training step at full width (bf16, AdamW, lr 1e-4,
     2 frames of 512 x 1024 with 32 boxes each): 1 warm-up and 5 timed
     steps on the direct route, one step on the dense route from the same
     weights and noise, one step with fused attention, each step with the
     launch counts reset just before it and read just after;
  6. the inference API: the bf16 flagship config
     (`configs/panoswin/faster_rcnn_panoswin_tiny_bf16_streetwin.py`) with
     seed-0 weights written as a reference-format `.pth` in a temporary
     directory, loaded by `init_detector` on the card; `inference_detector`
     on a seeded 512 x 1024 frame through the default pipeline (672 x 1344
     after padding), 1 warm-up and 5 timed requests, each with the launch
     counts reset just before it and read just after (K1 and K3 once a
     request), its result equal to `simple_test` on the same prepared
     tensor, K1 and K3 held against their twins at this path's shapes; the
     nano demo config (PitchAttention in three stages) in f32 at 64 x 128,
     card against CPU from one `.pth`; one `aug_test_detector` call with
     flip on the card;
  7. the evaluation path (`build_dataset` -> `DetDataLoader` ->
     `apis/test.single_device_test` -> COCOeval with the native matcher):
     (a) the indoor360 config (`configs/panoswin/
     faster_rcnn_panoswin_tiny_indoor360.py`: PanoSwin-T, 37 classes, f32)
     with seed-0 weights from a reference `.pth`, on 16 synthetic 512 x 1024
     frames with 1-4 BFoV boxes each (from `--seed`) at the config's batch
     of 2, a warm-up pass then a timed one with the launch counts reset just
     before it and read just after (K1 8 through its f32 entry, K3 8), then
     `evaluate` (bbox, proposal, classwise: every metric finite, NaN exactly
     for the classes without ground truth); eval images/s, the median batch
     and the host time of each step; K1's f32 entry at the eval batch's
     shape beside its twin and cuDNN, K3 on the batch's RoIs against its
     twin; (b) the nano config at 64 x 128 in f32 on 8 frames, CPU then
     card from one `.pth`, scored on ground truth made from the CPU's
     detections (each box moved by a seeded 0-3 px): equal detections
     within 1e-3 px and 1e-4, every bbox metric within 1e-4 and not all 0;
     (c) the 7a set's ground truth as detections: bbox_mAP and AR@100 1
     (within 1e-12, COCOeval's precision rounding), and so the records'
     own pixel boxes, which 360-Indoor's `eval_anns` now carry.
     The card's machine has no OpenCV and cannot decode a JPEG, so the
     frames never go to disk: the test pipeline's first step
     (`LoadImageFromFile`) is replaced by `FramesFromMemory`, which hands
     over the seeded arrays; every later step (Resize, Normalize, Pad,
     PanoCheck) is the config's own.  `LoadImageFromFile` itself is held
     against the JAX package's in the CPU tests;
  8. the training loop (`apis/train.train_detector`): (a) the bf16
     streetwin config at full width with seed-0 weights from a reference
     `.pth` (`load_from`), 8 synthetic 512 x 1024 frames with 1-6 boxes each
     (from `--seed`) through the config's own `train_pipeline` after
     `FramesFromMemory` (PanoStretch, RollAug, RandomFlip, multiscale
     Resize), the shuffling `DetDataLoader` at batch 2 with the CLI's 2
     worker threads, 2 epochs (8 steps), an `epoch_{n}` checkpoint each
     epoch and an `eval_fn` (`single_device_test` + `evaluate`) on 4 frames
     after each; then a run resumed from `epoch_1` (loader in the model's
     thread) whose steps and learning rates must be the first run's; every
     loss finite; each step with the launch counts reset just before it and
     read just after (K3 forward 1, K3 backward 1 through its bf16 entry,
     K2 and K4 0), each eval batch likewise (K1 1, K3 1), and K1's cached
     weights equal to a fresh fold of the just-trained stem; loop images/s
     with the loader, the median step, the loader's host share, peak
     memory; (b) the nano config at 64 x 128 in f32, two loop steps with
     `accumulate_steps=2` and a clip that triggers, card against CPU from
     one `.pth` with the same draws; (c) one full-width bf16
     `forward_train` + backward with `use_checkpoint=True` and one without,
     same weights and generators, DropPath 0.1: losses equal, gradients
     within the stated tolerance, peak memory of both;
  9. Swin-T Mask R-CNN serving (`configs/swin/
     mask_rcnn_swin_tiny_patch4_window7_coco.py`: stock Swin-T, FPN, the
     FCN mask head on 14 x 14 RoIs), with seed-0 weights from a reference
     `.pth` and the detections' `score_thr` lowered to 0.01 (random
     weights give every class about 1/81): (a) f32 as the config is, 8
     synthetic 480 x 640 frames with 1-4 polygon instances each (from
     `--seed`) through the config's test pipeline (800 x 1067, padded to
     800 x 1088) after `FramesFromMemory`, `single_device_test(
     with_masks=True)` at batch 2, a warm-up pass then a timed one with the
     launch counts set to 0 just before it and read just after (K3 once a
     batch at 7 and once at 14, its f32 entry; no other kernel), eval
     images/s, the median batch, the host ms of each step
     (`MASK_EVAL_STAGES`: loader, copy, `simple_test_masks`, results, paste,
     RLE) and peak memory, then `evaluate` (bbox, segm: every metric
     finite), and K3 at 14 on the batch's mask RoIs against its twin; (b)
     the same with `compute_dtype="bfloat16"` (K3's bf16 entry at both
     sizes); (c) a nano Swin Mask R-CNN in f32 at 64 x 128, card against CPU
     from one `.pth`: detections within 1e-3 px and 1e-4, mask
     probabilities within 1e-4, pasted bitmaps equal outside a 1e-4 band
     around 0.5, bbox and segm metrics within 1e-4 on ground truth made
     from the CPU's detections and masks; (d) the 9a set's ground truth as
     detections: segm_mAP and bbox_mAP 1.  Phase 3 holds K3 at 14 against
     its twin on the mask branch's shapes (2 x 100 RoIs on 800 x 1088, C
     256) in f32 and bf16, with its times and bound;
 10. Swin-T Mask R-CNN training: (a) the mstrain config (`configs/swin/
     mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py`:
     Swin-T 2-2-6-2, window 7, FPN 256, 80 classes, the mask head) at full
     width and depth in bf16, random weights from `--seed`, through
     `train_detector` and the config's own `train_pipeline` (masks filled
     from polygons, flip, multi-scale resize 480-800, pad 32) after
     `FramesFromMemory`, batch 2, 8 synthetic 480 x 640 frames with 1-4
     polygons each, 1 epoch of 4 steps: each step's `loss_mask`, loss and
     gradient norm (all finite), step time, loop images/s, and K3's
     launches by entry, the counts set to empty just before each step and
     read just after: once at 7 and once at 14, forward and backward, all
     through the bf16 entries, and no other kernel; (b) a nano Swin Mask
     R-CNN in f32, TF32 off, one `forward_train` with masks and its backward
     on the card (K3's backward at 14 through its f32 entry) and on the CPU
     from the same weights, batch and sampler noise: losses within 1e-4
     relative, every gradient within 1e-5 + 2e-3 * max|g|; then K3's
     backward at 14 against its twin, both entries, on 2 x 128 random RoIs
     over an 800 x 1088 batch's levels and on the RoIs that (a)'s first step
     pooled at 14, the bf16 entry bit-equal on two launches, with the
     times of both entries, the first version at bf16, the twin and the
     bound;
 11. Cascade Mask R-CNN serving, with the detections' `score_thr` lowered
     to 0.01 as in phase 9: (a) the Swin-S 3x config (`configs/swin/
     cascade_mask_rcnn_swin_small_patch4_window7_mstrain_480-800_adamw_3x_coco.py`:
     Swin-S 2-2-18-2, FPN 256, three class-agnostic Shared2FC stages, one
     FCN mask head, bf16) with seed-0 weights from a reference `.pth`, 8
     synthetic 480 x 640 frames with polygon instances (from `--seed`)
     through the config's test pipeline after `FramesFromMemory`,
     `single_device_test(with_masks=True)` at batch 2, a warm-up pass then
     a timed one with the launch counts set to 0 just before it and read
     just after (K3 three times a batch at 7 and once at 14, its bf16 entry;
     no other kernel), eval images/s, the median batch, the host ms of each
     `MASK_EVAL_STAGES` step, peak memory, `evaluate` (bbox, segm: every
     metric finite), a synchronised breakdown of one request by
     `CASCADE_MASK_STAGES`, and K3 against its twin (exact) on the last
     stage's refined RoIs at 7 and the detections' at 14; (b) the Swin-B
     GIoU 4conv1f config (three Shared4Conv1FC GroupNorm stages, bf16,
     random weights from seed 0): 3 timed `simple_test_masks` requests
     with the same launch counts each; (c) a nano cascade with narrow
     Shared4Conv1FC heads in f32, TF32 off, card against CPU from one
     `.pth`: detections within 1e-3 px and 1e-4, mask probabilities within
     1e-4;
 12. Cascade Mask R-CNN training: (a) the Swin-S 3x config in bf16 at full
     width and depth through `train_detector` and the config's own
     `train_pipeline` (masks filled from polygons, flip, multi-scale resize
     480-800, pad 32) after `FramesFromMemory`, from weights with nonzero
     biases (`write_trained_like_pth`), batch 2, 8 synthetic 480 x 640
     frames with polygon instances (from `--seed`), 1 epoch of 4 steps:
     every loss and gradient norm finite, K3's launches by entry each step
     (the counts set to empty just before it and read just after): three
     at 7 forward and three backward, all through the bf16 entries, none at
     14, no other kernel; the mask head, which no loss reaches, only decayed
     (within 1e-6 relative of p0 * prod(1 - lr_k * 0.05)); loop images/s,
     the median step, the loader's share, peak memory, and one synchronised
     step on a shape already seen by `CASCADE_TRAIN_STAGES`; (b) the nano
     cascade (narrow Shared4Conv1FC heads) with the GIoU loss in f32, TF32
     off, one `forward_train` and backward card against CPU from the same
     weights, batch and noise: losses within 1e-4 relative, gradients
     within 1e-5 + 2e-3 * max|g|; (c) K3's backward at 7 on the RoIs that
     (a)'s first step pooled at stages 1 and 2, both entries against the
     twin, the bf16 entry bit-equal on two launches, with the times of both
     entries, the bf16 first version, the twin and the bound;
 13. the ResNet-family detectors' serving, with the detections'
     `score_thr` lowered to 0.01, from reference `.pth` files of random
     weights (`write_cnn_reference_pth`: BatchNorm away from the identity,
     `num_batches_tracked` kept, the regression weights scaled by
     `REG_SCALE`): (a) `configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py`
     (ResNet-50, FPN 256, 80 classes, f32 as the config is) through
     `build_dataset` -> `DetDataLoader` -> `single_device_test` ->
     `evaluate` (bbox) on 16 synthetic 480 x 640 frames with polygon
     instances (from `--seed`) through the config's test pipeline (800 x
     1067, padded to 800 x 1088) at the config's batch of 2, a warm-up pass
     then a timed one with the launch counts set to 0 just before it and
     read just after (K3's f32 entry 8 times at 7, no other kernel), eval
     images/s, the median batch, the host ms of each step, every metric
     finite, K3's f32 entry at 7 against its twin and timed on the first
     batch's RoIs; (b) `configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py` the
     same way with masks (`--eval bbox segm`: K3's f32 entry 8 times at 7
     and 8 at 14), K3's f32 entry at 14 timed on the first batch's mask
     RoIs; (c) `configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py`
     in bf16 as the config asks (the JAX package cannot build it): 1 warm-up
     and 5 timed `simple_test_masks` requests on 2 seeded frames of 800 x
     1344, K3's bf16 entry 3 times at 7 and once at 14 a request and no
     other kernel, the bf16 backbone's stage outputs within 0.05 * max|ref|
     of the same weights in f32 (TF32 off); (d) the caffe-style ResNet-50,
     the ResNeXt-101 32x4d Faster R-CNN and the RegNetX-3.2GF Mask R-CNN
     configs in f32, TF32 off, at 64 x 128, card against CPU from one
     `.pth` each: equal detection counts, partners within 1e-3 px and 1e-4,
     mask probabilities within 1e-4;
 14. ResNet-family training and the Res2Net and ResNeSt detectors, from
     reference `.pth` files of random weights (`write_cnn_reference_pth`)
     through `load_from`, on synthetic 480 x 640 frames with polygon
     instances (from `--seed`) through each config's own train pipeline
     after `FramesFromMemory`, batch 2, the first step a warm-up, each
     step's K3 launches by entry with the counts set to empty just before
     it and read just after: (a) `configs/faster_rcnn/
     faster_rcnn_r50_fpn_1x_coco.py` in f32 through `train_detector`, 4
     steps (800 x 1088 after padding): K3's f32 entry once forward and once
     backward at 7, no other kernel; every loss finite, every parameter
     moved, every running statistic and `num_batches_tracked` as loaded
     (`norm_eval`); loop images/s, the median step, host ms by stage, peak
     memory; (b) `configs/gcnet/mask_rcnn_r50_fpn_syncbn-backbone_1x_coco.py`
     (`norm_eval=False`) the same way with masks loaded (the config's
     pipeline loads boxes only): K3's f32 entry at 7 and 14 forward and
     backward; bn1's running statistics one momentum step a step towards
     `batch_norm_train` of the step's own input; (c) `configs/cascade_rcnn/
     cascade_mask_rcnn_r50_fpn_1x_coco.py` in bf16 as the config asks: K3's
     bf16 entries three times forward and three backward at 7, never at 14;
     one `forward_train`'s losses against the same step in f32 (TF32 off)
     on one batch, weights and noise (`CASCADE_BF16_LOSS_REL`); (d) one
     `forward_train` and backward of a detector on the caffe R-50
     (`norm_eval=False`, `frozen_stages=1`), ResNeXt-101 32x4d, RegNetX-3.2GF,
     Res2Net-101 (its residual branches scaled by 0.2) and ResNeSt-50, f32,
     TF32 off, 64 x 128, card against CPU: losses within 1e-4 relative,
     the neck's and heads' gradients within 1e-5 + 2e-3 * max|g| against
     a CPU pass from the card's backbone maps, running statistics within
     1e-4; each backbone's gradients in f64 card against CPU
     (`f64_backbone_card_vs_cpu`); a
     torchvision, a Detectron (`tools/detectron2pytorch.py`) and a pycls
     backbone file of seeded values through `pretrained`: the same stage
     outputs on the card as on the CPU; (e) the Res2Net-101 and ResNeSt-50
     Faster R-CNN configs in f32: 1 warm-up and 3 timed `simple_test`
     requests on 2 frames of 800 x 1344 (K3's f32 entry once at 7); the
     ResNeSt-50 Mask R-CNN mstrain config with masks loaded, 3 steps (K3's
     f32 entry at 7 and 14, forward and backward); (f) K3's backward at 7 on
     the 2 x 512 RoIs that (a)'s first step sampled: the f32 entry against
     autograd through the twin and timed with its bound, the bf16
     owner-computes entry and its first version on the same RoIs;
 15. distributed training and evaluation, each part's processes children
     of this one with torchrun's environment (`--dist-child PART DIR`),
     each held against the same work here without a process group: (a)
     the bf16 streetwin config through `train_detector` (2 epochs of 4
     frames, global batch 2) and `multi_host_test` under `python -m
     torch.distributed.run --nproc_per_node 1`, NCCL: the same losses,
     parameters and detections; (b) the f32 flagship, two processes on the
     card over gloo, one frame each, 2 steps with handed-over noise against
     the one-process steps on both frames, then `multi_host_test` on 5
     frames against `single_device_test`; (c) the gcnet R-50 Mask R-CNN
     with live BatchNorm and masks, two processes, one step against one
     process: losses, bn1's and layer4.0.bn1's running statistics,
     parameters; K1's and K3's launches in the children counted;
 16. the reference's own PanoSwin, the v-variant (`models/panoswin_v2.py`):
     (a) serving the PanoSwin-v2-T Faster R-CNN config in f32 from a
     seed-0 reference `.pth` under the reference's v2 keys: 2 frames of
     512 x 1024 through its test pipeline (672 x 1344 after Resize and
     Pad), 2 warm-up and 5 timed `simple_test` requests, K1's and K3's f32
     entries once a request each and no other kernel, then one request
     with its stages synchronised and timed; K1 on the model's
     folded stem at that shape and K3 on a request's RoIs against their
     twins, timed; (b) the same config through `train_detector` and its
     own train pipeline after `FramesFromMemory`, 4 steps of 2 frames,
     odd frames with the partial ratio (0.1, 0.9), the first step untimed:
     every loss finite, K3's f32 entry forward and backward once a step at
     7, no other kernel, the stem's BatchNorm statistics moved, every
     parameter that a loss reaches moved; K3 forward and backward at 7 on
     the first step's sampled RoIs against their twins, timed; (c) card
     against CPU in f32, TF32 off: a nano v2 detector's detections with
     per-image ratios (equal counts, 1e-3 px, 1e-5), a nano v1 backbone and
     a nano v2 backbone with the `'tf'` embed and the basketball warp
     (stage outputs within 1e-4 * max(1, max|ref|));
 17. the rest of the CNN-backbone two-stage zoo, from reference `.pth`
     files of random weights (`write_cnn_reference_pth`) on synthetic 480 x
     640 frames with polygon instances (from `--seed`) after
     `FramesFromMemory`: (a) `configs/hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py`
     (HRNet-W32, HRFPN, f32) through the eval loop on 8 frames at batch 2
     (K3's f32 entry 4 times at 7 and 4 at 14, no other kernel), its K3 at
     7 and 14 against the twin and timed on the first batch's RoIs; the
     bf16 `cascade_mask_rcnn_hrnetv2p_w32_20e_coco.py` (the JAX package
     cannot build it): 1 warm-up and 3 timed `simple_test_masks` requests of
     2 x 800 x 1344 (K3's bf16 entry 3 times at 7 and once at 14 each), its
     bf16 backbone within 0.05 * max|ref| a branch of f32 (TF32 off), K3
     timed on each stage's RoIs and the detections'; (b) 4 steps of
     `train_detector` at batch 2, the first untimed, of the HRNet-W32 Mask
     R-CNN and `configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py` with masks
     loaded (K3's f32 entry once at 7 and once at 14 forward and backward
     a step: the mask and mask-IoU heads read one crop at 14, whose summed
     cotangent reaches one backward launch) and
     `configs/tridentnet/tridentnet_r50_caffe_1x_coco.py` (once at 7 each
     way); every loss finite (`loss_mask_iou` included), every parameter
     whose gradient was nonzero moved, the trident's outer-branch
     BatchNorms reached by no loss and unmoved; K3 forward and backward at
     14 against their twins and timed on the Mask Scoring R-CNN's first
     step's sampled positives; (c) the Mask Scoring R-CNN and TridentNet
     configs through the eval loop on 8 frames (K3 at 7, and at 14 once a
     batch with masks), the rescored detections against `simple_test`'s,
     K3 timed on a TridentNet batch's RoIs; (d) card against CPU in f32,
     TF32 off: an HRNet-W18 with HRFPN on 72 x 104 frames, a
     `MaskIoUHead`, a TridentResNet-50 (each within 1e-4 * max(1,
     max|ref|)) and a nano Mask Scoring R-CNN's detections (equal counts,
     1e-3 px, 1e-5);
 18. a JSON line for the evaluation, one for the training loop, one for
     Mask R-CNN serving, one for Mask R-CNN training, one for Cascade Mask
     R-CNN serving, one for its training, one for the ResNet-family
     detectors, one for their training, one for phase 15, one for phase
     16, one for phase 17, a JSON line per kernel (each with its launches
     in phase 11, `launches_cascade`, in phase 12,
     `launches_cascade_training`, in phase 13, `launches_resnet`, in phase
     14, `launches_resnet_training`, in phase 15's children,
     `launches_distributed`, in phase 16, `launches_panoswin_v2`, and in
     phase 17, `launches_cnn_zoo`; K3's f32 entry timed on 13a's and 13b's
     RoIs and its f32 backward on 14a's, K1's f32 entry and K3's f32 entry
     forward and backward on phase 16's inputs, and K3 on phase 17's RoIs
     have rows of their own), the card's name and power limit, then the
     result line.
Without a CUDA card it exits with an error and prints no result.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_OPS_PER_S = 989e12         # dense bf16 tensor-core rate, same source
BF16_ULPS = 4 * 2.0 ** -8       # bf16 tolerance: 4 units in the last place of max|ref|
SLEEP_CYCLES = 100_000_000      # about 50 ms of the card's clock: longer than the host takes
                                # to launch a timed batch
B, H, W = 2, 512, 1024
REQUESTS = 5
# K2 at the flagship's four stages, B = 2: (windows n = B * nW, heads, nW);
# O = 7 * 7 tokens, head width 32 at every stage.
ATTENTION_STAGES = ((1406, 3, 703), (380, 6, 190), (100, 12, 50), (30, 24, 15))
TOKENS, HEAD_DIM = 49, 32
K2_LAUNCHES_BY_STAGE = (2, 2, 6, 2)     # one launch per block
K2_PER_REQUEST = sum(K2_LAUNCHES_BY_STAGE)
TRAIN_STEPS = 5
TRAIN_ROIS = 128 + 512              # sampled RoIs an image: positives' cap + samples
# Feature maps of the four RoI levels as the dense route's kernel sees them:
# transposed, since the maps are wider than tall, so stage one contracts W.
CROP_LEVELS = ((W // 4, H // 4), (W // 8, H // 8), (W // 16, H // 16), (W // 32, H // 32))
F32_OPS_PER_S = 67e12               # f32 outside the tensor cores, same source
TF32_OPS_PER_S = 495e12             # dense TF32 tensor-core rate, same source
# Fused against plain backbone, bf16: the routes round differently (q scaled
# in bf16 or the f32 product scaled; softmax or e / sum), and each of the 12
# blocks carries the difference on: 16 bf16 units of max|ref|.
BACKBONE_TOL_UNITS = 16
API_CONFIG = "configs/panoswin/faster_rcnn_panoswin_tiny_bf16_streetwin.py"
NANO_CONFIG = "configs/panoswin/faster_rcnn_panoswin_nano_demo.py"
EVAL_CONFIG = "configs/panoswin/faster_rcnn_panoswin_tiny_indoor360.py"
EVAL_FRAMES = 16
LOOP_FRAMES, LOOP_EVAL_FRAMES, LOOP_EPOCHS = 8, 4, 2
IMG_NORM = ([123.675, 116.28, 103.53], [58.395, 57.12, 57.375])
MASK_CONFIG = "configs/swin/mask_rcnn_swin_tiny_patch4_window7_coco.py"
MASK_FRAME = (800, 1088)            # the mask config's padded batch from 480 x 640 frames
MASK_FRAMES, MASK_SCORE_THR = 8, 0.01
CASCADE_CONFIG = ("configs/swin/cascade_mask_rcnn_swin_small_patch4_window7_mstrain_480-800_"
                  "adamw_3x_coco.py")
CASCADE_GIOU_CONFIG = ("configs/swin/cascade_mask_rcnn_swin_base_patch4_window7_mstrain_"
                       "480-800_giou_4conv1f_adamw_3x_coco.py")
CASCADE_REQUESTS = 3


def time_ms(fn, reps: int, batches: int = 5) -> float:
    """Device time of one call: the median over `batches` of the mean of
    `reps` back-to-back calls, CUDA events around them.  Each batch is
    queued behind a sleep on the card, so that the host's time to launch the
    calls (tens of microseconds for a small kernel) is not counted."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def check(name, got, ref, tol):
    err = float((got.float() - ref.float()).abs().max())
    ok = err <= tol
    print(f"  {name}: max|diff| = {err:.3g}, tolerance {tol:.3g}: "
          f"{'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its twin ({err} > {tol})")
    return err


def rpn_like_rois(rng, n_per_image, height=H, width=W):
    """Proposals like the RPN's: sizes across all four levels, some crossing
    the border, some tiny, some elongated, on B frames of height x width."""
    H, W = height, width
    rois = []
    for b in range(B):
        kinds = rng.integers(0, 6, n_per_image)
        for kind in kinds:
            if kind == 0:
                w, h = rng.uniform(0.5, 8, 2)
            elif kind == 1:
                w, h = rng.uniform(150, 700), rng.uniform(6, 30)
            else:
                s = 56 * 2 ** (kind - 2) * rng.uniform(0.7, 1.8)
                r = rng.uniform(0.4, 2.5)
                w, h = s * np.sqrt(r), s / np.sqrt(r)
            x1 = rng.uniform(-0.1 * w, max(W - 0.9 * w, 1.0))
            y1 = rng.uniform(-0.1 * h, max(H - 0.9 * h, 1.0))
            rois.append([b, x1, y1, min(x1 + w, W), min(y1 + h, H)])
    return torch.tensor(np.asarray(rois, np.float32))


def previous_kernel(module, entry, argtypes, code=1):
    """The first version's CUDA-core entry, called directly at bf16 (dtype
    code 1) or f32 (0), so that a redesign is timed against it in the same
    run; no wrapper calls it at a type whose redesign exists."""
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    fn = cuda_build.function(module, entry, argtypes)

    def launch(*args):
        cuda_build.check(fn(*args, code, torch.cuda.current_stream().cuda_stream),
                         f"{entry} (first version, {('f32', 'bf16')[code]})")
    return launch


def rates(ops, ms, bound):
    """'x TFLOP/s, y of the bound' for a kernel time."""
    return f"{ops / ms / 1e9:.1f} TFLOP/s, {bound / ms:.3f} of the bound"


def k1_f32_times(stem, x, w, what):
    """K1's f32 entry on x (B, H, W, 3) with `w` (`stem_weights` at f32)
    against its twin, timed beside its first version (`stem.FIRST_VERSION`
    at f32, the CUDA cores, also held against the twin), the twin and
    cuDNN's two-conv chain; the caller turns TF32 off (an f32 comparison).
    Two bounds, each the larger of its operations' time and the bytes' (x
    in, h1 out, at 3.35 TB/s): the f32 operations at the CUDA cores' 67
    TFLOP/s, and three TF32 products of each at the tensor cores' 495 (what
    the 3xTF32 entry runs on); `bound_ms` is the lower and the share is
    given against it."""
    ref = stem.stem_conv_plain(x, w.w0, w.b0, w.w1, w.b1)
    got = stem.stem_conv(x, w)
    entry = stem.stem_conv.last_entry
    if entry != stem.ENTRIES[torch.float32]:
        raise AssertionError(f"K1 at f32 launched {entry}")
    tol = 1e-4 * max(1.0, float(ref.abs().max()))
    err = check(f"K1 f32 {what} {tuple(x.shape)}, entry {entry}, against the twin", got, ref, tol)
    b, h, wd, _ = x.shape
    c0, c1 = w.w0.shape[0], w.w1.shape[0]
    first = previous_kernel("stem_conv", stem.FIRST_VERSION, stem.LAUNCH_ARGTYPES, code=0)
    w0k, w1k = stem.cuda_core_layout(w.w0, w.w1, torch.float32)
    prev_out = torch.empty_like(got)

    def first_version():
        first(x.data_ptr(), w0k.data_ptr(), w.b0.data_ptr(), w1k.data_ptr(), w.b1.data_ptr(),
              prev_out.data_ptr(), b, h, wd, c0, c1, w1k.shape[2])

    xn = x.permute(0, 3, 1, 2).contiguous()
    conv = torch.nn.functional.conv2d

    def library():
        return torch.relu(conv(torch.relu(conv(xn, w.w0, w.b0, padding=1)), w.w1, w.b1,
                               padding=1))

    ms = time_ms(lambda: stem.stem_conv(x, w), 10)
    previous_ms = time_ms(first_version, 10)
    previous_err = check(f"K1 first version (CUDA cores) f32 {what}, against the twin", prev_out,
                         ref, tol)
    plain_ms = time_ms(lambda: stem.stem_conv_plain(x, w.w0, w.b0, w.w1, w.b1), 3)
    library_ms = time_ms(library, 10)
    nbytes = (x.numel() + b * c1 * h * wd) * 4
    ops = 2 * b * h * wd * (27 * c0 + 9 * c0 * c1)
    ffma_ms = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    tf32x3_ms = max(nbytes / HBM_BYTES_PER_S, 3 * ops / TF32_OPS_PER_S) * 1e3
    bound = min(ffma_ms, tf32x3_ms)
    rec = {"shape": list(x.shape), "c0": c0, "c1": c1, "entry": entry, "max_abs_err": err,
           "tolerance": tol, "ms": ms, "previous_entry": stem.FIRST_VERSION,
           "previous_ms": previous_ms, "previous_max_abs_err": previous_err,
           "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= min(
               ops / F32_OPS_PER_S, 3 * ops / TF32_OPS_PER_S) else "operations",
           "bound_ffma_ms": ffma_ms, "bound_3xtf32_ms": tf32x3_ms,
           "share_of_bound": bound / ms, "faster_than_library": ms < library_ms}
    print(f"    K1 f32 entry {what} {tuple(x.shape)}, c0 {c0} c1 {c1}: 3xTF32 kernel {ms:.4f} ms "
          f"(max|diff| {err:.3g}, {rates(ops, ms, bound)}), first version {previous_ms:.4f} ms "
          f"(max|diff| {previous_err:.3g}, {rates(ops, previous_ms, bound)}), twin "
          f"{plain_ms:.4f} ms, cuDNN f32 two-conv chain (TF32 off) {library_ms:.4f} ms "
          f"(kernel {'faster' if ms < library_ms else 'SLOWER'}), bound {bound:.4f} ms (3xTF32 "
          f"at 495 TFLOP/s; {ffma_ms:.4f} ms by FFMA at 67 TFLOP/s, {ffma_ms / ms:.3f} of it)")
    return rec


def kernel_k1(dev, stem):
    g = torch.Generator().manual_seed(1)
    c0, c1 = 32, 64
    x = torch.rand((B, H, W, 3), generator=g)
    w0 = torch.randn((c0, 3, 3, 3), generator=g) / 27 ** 0.5
    w1 = torch.randn((c1, c0, 3, 3), generator=g) / (9 * c0) ** 0.5
    b0 = torch.randn(c0, generator=g) * 0.1
    b1 = torch.randn(c1, generator=g) * 0.1
    weights = [t.to(dev) for t in (w0, b0, w1, b1)]
    f32 = k1_f32_times(stem, x.to(dev), stem.stem_weights(*weights, torch.float32),
                       "at the flagship's shape")
    dt = torch.bfloat16
    args = [x.to(dt).to(dev)] + weights
    packed = stem.stem_weights(*weights, dt)
    got = stem.stem_conv(args[0], packed)
    ref = stem.stem_conv_plain(*args)
    torch.cuda.synchronize()
    tol = BF16_ULPS * float(ref.float().abs().max())
    err = check(f"K1 stem_conv bfloat16 (2,512,1024,3) c0 32 c1 64, entry "
                f"{stem.stem_conv.last_entry}", got, ref, tol)
    xn = args[0].permute(0, 3, 1, 2).contiguous()
    w0b, w1b = w0.to(dt).to(dev), w1.to(dt).to(dev)
    b0b, b1b = b0.to(dt).to(dev), b1.to(dt).to(dev)
    conv = torch.nn.functional.conv2d

    def library():
        h0 = torch.relu(conv(xn, w0b, b0b, padding=1))
        return torch.relu(conv(h0, w1b, b1b, padding=1))

    w0k, w1k = stem.cuda_core_layout(args[1], args[3], dt)
    previous = previous_kernel("stem_conv", stem.FIRST_VERSION, stem.LAUNCH_ARGTYPES)
    prev_out = torch.empty_like(got)

    def first_version():
        previous(args[0].data_ptr(), w0k.data_ptr(), packed.b0.data_ptr(),
                 w1k.data_ptr(), packed.b1.data_ptr(), prev_out.data_ptr(), B, H, W,
                 c0, c1, w1k.shape[2])

    ms = time_ms(lambda: stem.stem_conv(args[0], packed), 20)
    previous_ms = time_ms(first_version, 20)
    check("K1 first version (CUDA cores) bf16, against the twin", prev_out, ref, tol)
    plain_ms = time_ms(lambda: stem.stem_conv_plain(*args), 5)
    library_ms = time_ms(library, 20)
    nbytes = (x.numel() + B * c1 * H * W) * 2
    ops = 2 * B * H * W * (27 * c0 + 9 * c0 * c1)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    rec = {"name": "stem_conv (K1)", "route": "cuda",
           "source": "panoswintransformerobjectdetection_torch/csrc/stem_conv.cu",
           "replaces": "panoswintransformerobjectdetection_tpu/ops/stem_conv.py:61",
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
           else "operations", "library_ms": library_ms, "previous_ms": previous_ms,
           "f32": f32}
    print(f"  K1 bf16: tensor-core kernel {ms:.4f} ms ({rates(ops, ms, bound)}), first "
          f"version {previous_ms:.4f} ms ({rates(ops, previous_ms, bound)}), twin "
          f"{plain_ms:.4f} ms, two-conv2d chain {library_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({rec['bound_by']})")
    return rec


def kernel_k3(dev, ra):
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    rng = np.random.default_rng(2)
    C = 256
    rois = rpn_like_rois(rng, 1000).to(dev)
    base = [torch.from_numpy(rng.standard_normal((B, H // s, W // s, C)).astype(np.float32))
            for s in (4, 8, 16, 32)]
    strides = (4, 8, 16, 32)
    f32 = k3_record(ra, [f.to(dev) for f in base], rois, strides, 7,
                    "roi_align o=7 float32 (K3)", "K3 roi_align float32 4 levels C 256, "
                    "2 x 1000 RoIs")
    feats = [f.bfloat16().to(dev) for f in base]
    got = ra.roi_align(feats, rois, strides)
    ref = ra.roi_align_plain(feats, rois, strides)
    torch.cuda.synchronize()
    # same operations in the same order as the twin: exact
    err = check(f"K3 roi_align bfloat16 4 levels C 256, 2 x 1000 RoIs, entry "
                f"{ra.roi_align.last_entry}", got, ref, 0.0)
    previous = cuda_build.function("roi_align", ra.FIRST_VERSION, ra.LAUNCH_ARGTYPES)
    levels = ra.level_struct(feats, strides)
    prev_out = torch.empty_like(got)

    def first_version():
        # the first version's entry at dtype code 1 (bfloat16); no wrapper calls it so
        cuda_build.check(previous(ctypes.byref(levels), rois.data_ptr(), prev_out.data_ptr(),
                                  rois.shape[0], B, C, 1, 1, float(ra.FINEST_SCALE), 7,
                                  torch.cuda.current_stream().cuda_stream),
                         "roi_align_launch (first version, bf16)")

    ms = time_ms(lambda: ra.roi_align(feats, rois, strides), 20)
    previous_ms = time_ms(first_version, 20)
    check("K3 first version bf16, against the twin", prev_out, ref, 0.0)
    plain_ms = time_ms(lambda: ra.roi_align_plain(feats, rois, strides), 3)
    # the bytes this run's RoIs need: each feature row that some tap with a
    # nonzero weight reads, once; the rois; the output
    rows, w1, w2 = ra.tap_rows(feats, rois, strides)
    need = (w1[:, :, :, None, None] != 0) & (w2[:, None, None] != 0)
    nbytes = torch.unique(rows[need]).numel() * C * 2 + rois.numel() * 4 + got.numel() * 2
    ops = rois.shape[0] * 49 * C * (16 + 4) * 2
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    rec = {"name": "roi_align (K3)", "route": "cuda",
           "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
           "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align_pallas.py:205",
           "entry": ra.roi_align.last_entry, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
           else "operations", "library_ms": None, "previous_ms": previous_ms, "f32": f32}
    print(f"  K3 bf16: vectorised kernel {ms:.4f} ms ({bound / ms:.3f} of the bound), first "
          f"version {previous_ms:.4f} ms ({bound / previous_ms:.3f}), twin {plain_ms:.3f} ms, "
          f"no single PyTorch call computes it, bound {bound:.4f} ms")
    return rec


def k3_record(ra, feats, rois, strides, o, name, what):
    """K3 on `rois` over `feats` at o x o bins against its twin (exact: the
    same operations in the same order), with its device time, the twin's
    and the bound: the bytes this run's RoIs need (each feature row that a
    tap of nonzero weight reads, once; the RoIs; the output) over the
    memory rate, or its operations over the peak rate of its type.  In f32
    its first version (`ra.FIRST_VERSION`, one thread a channel) is held
    against the twin and timed beside it on the same RoIs.  Returns a
    kernel record named `name` that shares K3's row."""
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    got = ra.roi_align(feats, rois, strides, o)
    ref = ra.roi_align_plain(feats, rois, strides, o)
    torch.cuda.synchronize()
    entry = ra.roi_align.last_entry
    err = check(f"{what}, entry {entry}", got, ref, 0.0)
    ms = time_ms(lambda: ra.roi_align(feats, rois, strides, o), 20)
    previous_ms = None
    if got.dtype == torch.float32:
        first = cuda_build.function("roi_align", ra.FIRST_VERSION, ra.LAUNCH_ARGTYPES)
        maps = [f.contiguous() for f in feats]
        levels = ra.level_struct(maps, strides)
        prev_out = torch.empty_like(got)

        def first_version():
            # the first version at dtype code 0 (float32); no wrapper calls it
            cuda_build.check(first(ctypes.byref(levels), rois.data_ptr(), prev_out.data_ptr(),
                                   rois.shape[0], feats[0].shape[0], feats[0].shape[-1], 0,
                                   int(ra._w_first(feats)), float(ra.FINEST_SCALE), o,
                                   torch.cuda.current_stream().cuda_stream),
                             f"{ra.FIRST_VERSION} (first version, f32)")

        previous_ms = time_ms(first_version, 20)
        check(f"{what}, first version {ra.FIRST_VERSION}", prev_out, ref, 0.0)
    plain_ms = time_ms(lambda: ra.roi_align_plain(feats, rois, strides, o), 3)
    rows, w1, w2 = ra.tap_rows(feats, rois, strides, o)
    need = (w1[:, :, :, None, None] != 0) & (w2[:, None, None] != 0)
    size, C = got.element_size(), feats[0].shape[-1]
    nbytes = (torch.unique(rows[need]).numel() * C * size + rois.numel() * 4
              + got.numel() * size)
    ops = rois.shape[0] * o * o * C * (16 + 4) * 2
    peak = BF16_OPS_PER_S if got.dtype == torch.bfloat16 else F32_OPS_PER_S
    bound = max(nbytes / HBM_BYTES_PER_S, ops / peak) * 1e3
    rec = {"name": name, "route": "cuda",
           "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
           "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align_pallas.py:205",
           "shares_kernel_of": "roi_align (K3)", "out_size": o, "entry": entry,
           "rois": rois.shape[0], "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound,
           "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / peak else "operations",
           "library_ms": None}
    first = ""
    if previous_ms is not None:
        rec.update(previous_entry=ra.FIRST_VERSION, previous_ms=previous_ms,
                   faster_than_previous=ms < previous_ms)
        first = (f", first version {previous_ms:.4f} ms ({bound / previous_ms:.3f}; kernel "
                 f"{'faster' if ms < previous_ms else 'SLOWER'})")
    print(f"  {name}: kernel {ms:.4f} ms ({bound / ms:.3f} of the bound){first}, twin "
          f"{plain_ms:.3f} ms, no single PyTorch call computes it, bound {bound:.4f} ms "
          f"({rec['bound_by']}, {nbytes / 1e6:.1f} MB)")
    return rec


def kernel_k3_mask(dev, ra):
    """K3 at 14 x 14 bins on the mask branch's shapes: 2 x 100 RoIs over
    the four FPN levels of an 800 x 1088 batch, C = 256; both entries
    against the twin (exact), each with its device time, the twin's and
    the bound.  Returns the two records (bf16 first)."""
    rng = np.random.default_rng(12)
    C, o = 256, 14
    rois = rpn_like_rois(rng, 100, *MASK_FRAME).to(dev)
    base = [torch.from_numpy(rng.standard_normal((B, MASK_FRAME[0] // s, MASK_FRAME[1] // s, C))
                             .astype(np.float32)) for s in (4, 8, 16, 32)]
    strides = (4, 8, 16, 32)
    records = []
    for dt in (torch.bfloat16, torch.float32):
        feats = [f.to(dt).to(dev) for f in base]
        name = str(dt)[6:]
        records.append(k3_record(ra, feats, rois, strides, o, f"roi_align o=14 {name} (K3)",
                                 f"K3 roi_align o=14 {name} 4 levels C 256, 2 x 100 RoIs on "
                                 "800 x 1088"))
    return records


def attention_inputs(dev, dtype, n, h, nW, seed):
    """q, k, v as views of an (n, O, 3, h, d) projection, as the model
    passes them, and an f32 bias (nW, h, O, O)."""
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn((n, TOKENS, 3, h, HEAD_DIM), generator=g).to(dtype).to(dev)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    return q, k, v, torch.randn((nW, h, TOKENS, TOKENS), generator=g).to(dev)


def attention_tol(ref, dtype):
    scale = float(ref.float().abs().max())
    return 1e-5 * max(1.0, scale) if dtype == torch.float32 else BF16_ULPS * scale


def attention_times(fa, entry, q, k, v, bias):
    """(kernel ms, first version ms, twin ms, SDPA ms, bound ms, bound_by)
    in bf16.  SDPA gets 4-D (n, h, O, d) views and the bias cast to bf16 and
    repeated over the batch outside the timing (a 4-D mask cannot repeat
    every nW windows as a view): the port never calls it."""
    n, h, O, d = q.shape
    nW = bias.shape[0]
    scale = d ** -0.5
    mask = bias.to(q.dtype).expand(n // nW, nW, h, O, O).reshape(n, h, O, O)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    previous = previous_kernel("window_attention", fa.ENTRIES[torch.float32],
                               fa.LAUNCH_ARGTYPES)
    out = torch.empty((n, O, h, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    strides = fa.launch_strides(q, k, v, bias, out)

    def first_version():
        previous(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 strides, n, h, O, d, nW, float(scale))

    ms = time_ms(lambda: entry(q, k, v, bias, scale), 20)
    previous_ms = time_ms(first_version, 20)
    ref = fa.window_attention_plain(q, k, v, bias, scale)
    check(f"K2 first version (CUDA cores) bf16 n {n} h {h}, against the twin", out, ref,
          attention_tol(ref, q.dtype))
    plain_ms = time_ms(lambda: fa.window_attention_plain(q, k, v, bias, scale), 10)
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), 20)
    nbytes = 4 * q.numel() * q.element_size() + bias.numel() * 4
    ops = 4 * n * h * O * O * d
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    return ms, previous_ms, plain_ms, library_ms, bound, "bytes" if by_bytes else "operations"


def attention_f32_times(fa, q, k, v, bias):
    """K2's f32 entry (`fa.ENTRIES[torch.float32]`, through
    `packed_window_attention`) timed beside SDPA in f32 (its bias repeated
    over the batch outside the timing; TF32 off), with the bound: the bytes
    of q, k, v, the output and the bias over the memory rate, or the
    operations at the CUDA cores' f32 rate."""
    n, h, O, d = q.shape
    scale = d ** -0.5
    mask = bias.expand(n // bias.shape[0], *bias.shape).reshape(n, h, O, O)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = time_ms(lambda: fa.packed_window_attention(q, k, v, bias, scale), 20)
    entry = fa.window_attention.last_entry
    library_ms = time_ms(lambda: sdpa(q, k, v, attn_mask=mask, scale=scale), 20)
    nbytes = 4 * q.numel() * 4 + bias.numel() * 4
    ops = 4 * n * h * O * O * d
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
    return {"entry": entry, "ms": ms, "library_ms": library_ms,
            "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
            "bound_by": "bytes" if by_bytes else "operations"}


def kernel_k2(dev, fa):
    """K2 at the flagship's four stage shapes; the record's top-level times
    are stage 0's, every stage's are in `stages`."""
    stages = []
    for stage, (n, h, nW) in enumerate(ATTENTION_STAGES):
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, bias = attention_inputs(dev, dt, n, h, nW, 4 + stage)
            got = fa.packed_window_attention(q, k, v, bias, HEAD_DIM ** -0.5)
            ref = fa.window_attention_plain(q, k, v, bias, HEAD_DIM ** -0.5)
            torch.cuda.synchronize()
            err = check(f"K2 window_attention {str(dt)[6:]} stage {stage} (n {n}, h {h}, "
                        f"O {TOKENS}, d {HEAD_DIM}, nW {nW}), entry "
                        f"{fa.window_attention.last_entry}", got, ref, attention_tol(ref, dt))
            if dt != torch.bfloat16:
                f32 = attention_f32_times(fa, q, k, v, bias)
                print(f"  K2 f32 stage {stage}: f32 entry {f32['ms']:.4f} ms "
                      f"({f32['bound_ms'] / f32['ms']:.3f} of the bound), SDPA f32 "
                      f"{f32['library_ms']:.4f} ms, bound {f32['bound_ms']:.4f} ms "
                      f"({f32['bound_by']})")
                continue
            ms, previous_ms, plain_ms, library_ms, bound, by = attention_times(
                fa, fa.packed_window_attention, q, k, v, bias)
            print(f"  K2 bf16 stage {stage}: tensor-core kernel {ms:.4f} ms ({bound / ms:.3f} of "
                  f"the bound), first version {previous_ms:.4f} ms ({bound / previous_ms:.3f}), "
                  f"twin {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
            stages.append({"stage": stage, "n": n, "heads": h, "nW": nW,
                           "entry": fa.window_attention.last_entry, "max_abs_err": err,
                           "ms": ms, "previous_ms": previous_ms, "plain_ms": plain_ms,
                           "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
                           "share_of_bound": bound / ms,
                           "launches_per_fused_request": K2_LAUNCHES_BY_STAGE[stage],
                           "f32": f32})
    top = {key: stages[0][key] for key in ("entry", "ms", "previous_ms", "plain_ms",
                                           "library_ms", "bound_ms", "bound_by")}
    return {"name": "window_attention (K2)", "route": "cuda",
            "source": "panoswintransformerobjectdetection_torch/csrc/window_attention.cu",
            "replaces": "panoswintransformerobjectdetection_tpu/ops/fused_attention.py:88",
            "max_abs_err": max(st["max_abs_err"] for st in stages), **top, "stages": stages}


def kernel_k5(dev, fa):
    """K5's entry point (`fused_window_attention`) runs K2's kernel: checked
    at a small shape with an odd window count, timed at stage 0."""
    err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, bias = attention_inputs(dev, dt, 10, 3, 5, 8)
        got = fa.fused_window_attention(q, k, v, bias, HEAD_DIM ** -0.5)
        ref = fa.window_attention_plain(q, k, v, bias, HEAD_DIM ** -0.5)
        torch.cuda.synchronize()
        err = max(err, check(f"K5 fused_window_attention {str(dt)[6:]} (n 10, h 3, O 49, "
                             f"d 32, nW 5), entry {fa.window_attention.last_entry}", got, ref,
                             attention_tol(ref, dt)))
    n, h, nW = ATTENTION_STAGES[0]
    ms, previous_ms, plain_ms, library_ms, bound, by = attention_times(
        fa, fa.fused_window_attention, *attention_inputs(dev, torch.bfloat16, n, h, nW, 4))
    entry = fa.window_attention.last_entry
    print(f"  K5 bf16 stage 0 ({entry}): kernel {ms:.4f} ms, first version {previous_ms:.4f} "
          f"ms, twin {plain_ms:.4f} ms, SDPA {library_ms:.4f} ms, bound {bound:.4f} ms ({by})")
    return {"name": "fused_window_attention (K5)", "route": "cuda",
            "source": "panoswintransformerobjectdetection_torch/csrc/window_attention.cu",
            "replaces": "panoswintransformerobjectdetection_tpu/ops/fused_attention.py:27",
            "shares_kernel_of": "window_attention (K2)", "entry": entry, "max_abs_err": err,
            "ms": ms, "previous_ms": previous_ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms}


def crop_times(ra, args, previous):
    """(kernel ms, first version ms, einsum pair ms) of K4 on bf16 (feat, Wy,
    Wx); the pair is cuBLAS's, t written to and read from device memory."""
    feat, Wy, Wx = args
    Bc, Hl, Wl, C = feat.shape
    P = Wy.shape[1]
    out = torch.empty((Bc, P, 7, 7, C), dtype=feat.dtype, device=feat.device)

    def first_version():
        previous(feat.data_ptr(), Wy.data_ptr(), Wx.data_ptr(), out.data_ptr(), Bc, P, Hl, Wl,
                 C, 7)

    def library():
        t = torch.einsum("bpoh,bhwc->bpowc", Wy, feat)
        return torch.einsum("bpxw,bpowc->bpoxc", Wx, t)

    return (time_ms(lambda: ra.dense_crop(*args), 10), time_ms(first_version, 10),
            time_ms(library, 10))


def crop_f32_times(ra, args):
    """K4's f32 entry (`ra.CROP_ENTRIES[torch.float32]`) on f32 (feat, Wy,
    Wx) timed beside cuBLAS's einsum pair in f32 (TF32 off), with the bound:
    the operands and the output over the memory rate, or the operations at
    the CUDA cores' f32 rate."""
    feat, Wy, Wx = args
    Bc, Hl, Wl, C = feat.shape
    P = Wy.shape[1]

    def library():
        t = torch.einsum("bpoh,bhwc->bpowc", Wy, feat)
        return torch.einsum("bpxw,bpowc->bpoxc", Wx, t)

    ms = time_ms(lambda: ra.dense_crop(*args), 10)
    entry = ra.dense_crop.last_entry
    library_ms = time_ms(library, 10)
    nbytes = 4 * (sum(a.numel() for a in args) + Bc * P * 49 * C)
    ops = 2 * Bc * P * 7 * Hl * Wl * C + 2 * Bc * P * 49 * Wl * C
    by_bytes = nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
    rec = {"entry": entry, "ms": ms, "library_ms": library_ms,
           "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
           "bound_by": "bytes" if by_bytes else "operations"}
    print(f"  K4 f32 level 0: f32 entry {ms:.4f} ms ({rec['bound_ms'] / ms:.3f} of the bound), "
          f"cuBLAS f32 einsum pair (TF32 off) {library_ms:.4f} ms, bound "
          f"{rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return rec


def kernel_k4(dev, ra):
    """K4 against its twin at the four levels of the flagship's training
    step (B 2, P 640, o 7, C 256), random weights.  Tolerance: f32 1e-5 *
    max(1, max|ref|) * sqrt(Hl) (sums of Hl products in another order than
    cuBLAS takes them); bf16 2 units of 2**-8 * max|ref| (one flip in the
    stage-one rounding, one in the result).  Then level 0 on the dense
    route's own weights for 2 x 640 RoIs like the RPN's."""
    C, P = 256, TRAIN_ROIS
    previous = previous_kernel("dense_crop", ra.CROP_ENTRIES[torch.float32], ra.CROP_ARGTYPES)
    rec = {}
    for level, (Hl, Wl) in enumerate(CROP_LEVELS):
        g = torch.Generator().manual_seed(20 + level)
        feat = torch.randn((B, Hl, Wl, C), generator=g)
        Wy = torch.randn((B, P, 7, Hl), generator=g) * 0.3
        Wx = torch.randn((B, P, 7, Wl), generator=g) * 0.3
        for dt in (torch.float32, torch.bfloat16):
            args = [t.to(dt).to(dev) for t in (feat, Wy, Wx)]
            got = ra.dense_crop(*args)
            ref = ra.dense_crop_plain(*args)
            torch.cuda.synchronize()
            scale = float(ref.float().abs().max())
            tol = 1e-5 * max(1.0, scale) * Hl ** 0.5 if dt == torch.float32 else \
                2 * 2.0 ** -8 * scale
            err = check(f"K4 dense_crop {str(dt)[6:]} level {level} (B {B}, P {P}, Hl {Hl}, "
                        f"Wl {Wl}, C {C}), entry {ra.dense_crop.last_entry}", got, ref, tol)
            del got, ref
            if dt != torch.bfloat16:
                if level == 0:
                    f32 = crop_f32_times(ra, args)
                continue
            ms, previous_ms, library_ms = crop_times(ra, args, previous)
            plain_ms = time_ms(lambda: ra.dense_crop_plain(*args), 3)
            nbytes = 2 * (sum(a.numel() for a in args) + B * P * 49 * C)
            ops = 2 * B * P * 7 * Hl * Wl * C + 2 * B * P * 49 * Wl * C
            by_bytes = nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
            print(f"  K4 bf16 level {level}: tensor-core kernel {ms:.4f} ms "
                  f"({rates(ops, ms, bound)}), first version {previous_ms:.4f} ms "
                  f"({rates(ops, previous_ms, bound)}), twin {plain_ms:.4f} ms, bf16 einsum "
                  f"pair {library_ms:.4f} ms, bound {bound:.4f} ms "
                  f"({'bytes' if by_bytes else 'operations'})")
            if level == 0:
                rec = {"name": "dense_crop (K4)", "route": "cuda",
                       "source": "panoswintransformerobjectdetection_torch/csrc/dense_crop.cu",
                       "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align_pallas.py:52",
                       "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                       "bound_by": "bytes" if by_bytes else "operations",
                       "library_ms": library_ms, "previous_ms": previous_ms, "f32": f32}
        del args

    # level 0 as the dense route calls it: every RoI, Wy zero for the RoIs of
    # other levels (the maps are wider than tall, so transposed first)
    rng = np.random.default_rng(41)
    rois = rpn_like_rois(rng, TRAIN_ROIS).to(dev)[:, [0, 2, 1, 4, 3]]
    maps = [torch.from_numpy(rng.standard_normal((B, W // s, H // s, C)).astype(np.float32))
            .bfloat16().to(dev) for s in (4, 8, 16, 32)]
    args = [t.contiguous() for t in ra.dense_level_operands(maps, rois)[0]]
    routed = int((args[1] != 0).any(dim=3).any(dim=2).sum())
    got, ref = ra.dense_crop(*args), ra.dense_crop_plain(*args)
    check("K4 dense_crop bf16 level 0, the dense route's weights", got, ref,
          2 * 2.0 ** -8 * float(ref.float().abs().max()))
    ms, previous_ms, library_ms = crop_times(ra, args, previous)
    print(f"  K4 bf16 level 0 on the dense route's weights ({routed} of {B} x {TRAIN_ROIS} "
          f"RoIs routed here, Wy zero for the rest): tensor-core kernel {ms:.4f} ms, first "
          f"version {previous_ms:.4f} ms, bf16 einsum pair {library_ms:.4f} ms")
    return rec


def level_maps(rng, dev, dt, C=256):
    return [torch.from_numpy(rng.standard_normal((B, H // s, W // s, C)).astype(np.float32))
            .to(dt).to(dev) for s in (4, 8, 16, 32)]


def k3_backward_times(ra, rois, cot, shapes, strides):
    """K3's backward in bf16 on one RoI set, at cot's o x o bins: the bf16
    entry held against autograd through the twin and timed beside the first
    version (f32 maps zeroed, its bf16 instantiation, the cast: what the
    wrapper did before) and the twin."""
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    C, o = cot.shape[-1], cot.shape[1]
    got = ra.roi_align_backward(cot, rois, shapes, torch.bfloat16, strides)
    again = ra.roi_align_backward(cot, rois, shapes, torch.bfloat16, strides)
    entry = ra.roi_align_backward.last_entry
    ref = ra.roi_align_backward_plain(cot, rois, shapes, torch.bfloat16, strides)
    first = cuda_build.function("roi_align", ra.BACKWARD_ENTRIES[torch.float32],
                                ra.LAUNCH_ARGTYPES)
    sizes = [int(np.prod(s)) for s in shapes]

    def first_version():
        flat = torch.zeros(sum(sizes), dtype=torch.float32, device=cot.device)
        maps = [g.view(s) for g, s in zip(flat.split(sizes), shapes)]
        # the first version's entry at dtype code 1 (bfloat16); no wrapper calls it so
        cuda_build.check(first(ctypes.byref(ra.level_struct(maps, strides)), rois.data_ptr(),
                               cot.data_ptr(), rois.shape[0], shapes[0][0], C, 1,
                               int(ra._w_first(shapes)), float(ra.FINEST_SCALE), o,
                               torch.cuda.current_stream().cuda_stream),
                         "roi_align_backward_launch (first version, bf16)")
        return [m.bfloat16() for m in maps]

    n = rois.shape[0]
    err = 0.0
    for level, (a, b, c, d) in enumerate(zip(got, again, ref, first_version())):
        tol = 2 * 2.0 ** -8 * float(c.float().abs().max())
        err = max(err, check(f"K3 backward bf16 level {level}, {n} RoIs, entry {entry}", a, c, tol))
        check(f"K3 backward first version bf16 level {level}, {n} RoIs", d, c, tol)
        if not torch.equal(a, b):
            raise AssertionError(f"K3 backward bf16 level {level}: two launches differ")
    ms = time_ms(lambda: ra.roi_align_backward(cot, rois, shapes, torch.bfloat16, strides), 20)
    previous_ms = time_ms(first_version, 20)
    plain_ms = time_ms(lambda: ra.roi_align_backward_plain(cot, rois, shapes, torch.bfloat16,
                                                           strides), 2)
    nbytes = 2 * (cot.numel() + sum(sizes)) + rois.numel() * 4
    ops = n * o * o * C * (16 + 4) * 2
    bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
    levels = ra.roi_levels(rois, len(shapes))
    return {"rois": n, "rois_by_level": [int((levels == l).sum()) for l in range(len(shapes))],
            "entry": entry, "max_abs_err": err, "ms": ms, "previous_ms": previous_ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / BF16_OPS_PER_S
            else "operations", "bitwise_repeatable": True}


def backward_shapes(C=256):
    return [(B, H // s, W // s, C) for s in (4, 8, 16, 32)]


def kernel_k3_backward(dev, ra):
    """K3's backward against autograd through the twin on 2 x 48 RoIs, f32
    (the first version) and bf16 (owner computes); then the bf16 entry at
    the training step's 2 x 640 random RoIs (the RoIs that a training step
    samples follow in phase 5, `k3_backward_sampled`).  Tolerance: f32
    1e-5 * max(1, max|ref|) (atomic adds in any order); bf16 2 units of
    2**-8 * max|ref| (each pixel's f32 sum is rounded once, after adds in
    another order); the bf16 entry must give the same bits twice."""
    strides = (4, 8, 16, 32)
    C = 256
    shapes = backward_shapes(C)
    for dt in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(30)
        rois = rpn_like_rois(rng, 48).to(dev)
        cot = torch.from_numpy(rng.standard_normal((rois.shape[0], 7, 7, C)).astype(np.float32))
        cot = cot.to(dt).to(dev)
        got = ra.roi_align_backward(cot, rois, shapes, dt, strides)
        entry = ra.roi_align_backward.last_entry
        if entry != ra.BACKWARD_ENTRIES[dt]:
            raise AssertionError(f"K3 backward {dt}: launched {entry}")
        ref = ra.roi_align_backward_plain(cot, rois, shapes, dt, strides)
        torch.cuda.synchronize()
        for level, (a, b) in enumerate(zip(got, ref)):
            scale = float(b.float().abs().max())
            tol = 1e-5 * max(1.0, scale) if dt == torch.float32 else 2 * 2.0 ** -8 * scale
            check(f"K3 backward {str(dt)[6:]} level {level}, 2 x 48 RoIs, entry {entry} "
                  f"(max|ref| {scale:.3f})", a, b, tol)
        del got, ref
    rng = np.random.default_rng(31)
    rois = rpn_like_rois(rng, TRAIN_ROIS).to(dev)
    cot = torch.randn((rois.shape[0], 7, 7, C), device=dev).bfloat16()
    times = k3_backward_times(ra, rois, cot, shapes, strides)
    # what the kernel costs when no RoI adds anything: read every header,
    # write zeros
    none = rois.clone()
    none[:, 0] = -1.0
    times["no_roi_ms"] = time_ms(lambda: ra.roi_align_backward(cot, none, shapes,
                                                               torch.bfloat16, strides), 20)
    print(f"  K3 backward bf16, 2 x {TRAIN_ROIS} random RoIs (by level {times['rois_by_level']}): "
          f"owner-computes kernel {times['ms']:.4f} ms (every batch index invalid "
          f"{times['no_roi_ms']:.4f} ms), first version with zeroing and cast {times['previous_ms']:.4f} ms, autograd through "
          f"the twin {times['plain_ms']:.4f} ms, no single PyTorch call computes it, bound "
          f"{times['bound_ms']:.4f} ms")
    return {"name": "roi_align_backward (K3 backward)", "route": "cuda",
            "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
            "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align.py:356",
            **{k: times[k] for k in ("entry", "max_abs_err", "ms", "previous_ms", "plain_ms",
                                     "bound_ms", "bound_by")},
            "library_ms": None, "roi_sets": {"random": times}}


def k3_backward_sampled(dev, ra, rec, rois):
    """K3's backward on the RoIs that a full-width `forward_train` of the
    flagship sampled in this run, clustered around the batch's ground truth
    but chosen by a model of random weights, so not what a trained model
    sends.  The record's top-level numbers stay those of the random RoIs,
    the set every earlier record of this kernel was timed on; these go
    beside them in `roi_sets`."""
    rois = rois.float().contiguous()
    cot = torch.randn((rois.shape[0], 7, 7, 256), device=dev).bfloat16()
    times = k3_backward_times(ra, rois, cot, backward_shapes(), (4, 8, 16, 32))
    print(f"  K3 backward bf16, the {rois.shape[0]} RoIs one training step sampled (by level "
          f"{times['rois_by_level']}): owner-computes kernel {times['ms']:.4f} ms, first version with zeroing and cast "
          f"{times['previous_ms']:.4f} ms, autograd through the twin "
          f"{times['plain_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms")
    rec["roi_sets"]["sampled"] = times
    rec["max_abs_err"] = max(times["max_abs_err"], rec["max_abs_err"])


def dense_against_direct(dev, ra):
    """The two RoI routes on the card, 2 x 640 RoIs on the flagship's maps:
    values and map gradients.  Tolerance: f32 1e-4 * max(1, max|ref|) (the
    dense route sums with fused multiply-adds and adds its zeros); bf16 2
    units of 2**-8 * max|ref| for values and 4 for gradients (flips of the
    stage-one rounding, forward and backward)."""
    strides = (4, 8, 16, 32)
    for dt in (torch.float32, torch.bfloat16):
        rng = np.random.default_rng(40)
        rois = rpn_like_rois(rng, TRAIN_ROIS).to(dev)
        base = level_maps(rng, dev, dt)
        cot = torch.randn((rois.shape[0], 7, 7, 256), device=dev).to(dt)
        outs, grads = [], []
        for fn in (ra.roi_align, ra.multilevel_roi_align_dense):
            feats = [f.clone().requires_grad_() for f in base]
            out = fn(feats, rois, strides)
            out.backward(cot)
            outs.append(out.detach())
            grads.append([f.grad for f in feats])
        torch.cuda.synchronize()
        unit = 1e-4 if dt == torch.float32 else 2.0 ** -8
        scale = float(outs[0].float().abs().max())
        check(f"dense vs direct RoIAlign {str(dt)[6:]}, values", outs[1], outs[0],
              unit * max(1.0, scale) if dt == torch.float32 else 2 * unit * scale)
        for level, (a, b) in enumerate(zip(grads[1], grads[0])):
            scale = float(b.float().abs().max())
            check(f"dense vs direct RoIAlign {str(dt)[6:]}, gradient of level {level}", a, b,
                  unit * max(1.0, scale) if dt == torch.float32 else 4 * unit * scale)


def train_reference_check(dev, build_flagship, flagship_train_batch):
    """64 x 128, f32, TF32 off: one `forward_train` + backward on the card
    (kernels) against the CPU (twins), same weights, same sampler noise (one
    CPU generator seed), no DropPath.  Tolerance: outputs 1e-4 relative;
    each parameter's gradient 1e-5 + 2e-3 * max|g| (f32 sums in another
    order through every layer, and cuDNN's and cuBLAS's own algorithms)."""
    grads, outs = {}, {}
    for where in (dev, torch.device("cpu")):
        model = build_flagship(device=where, seed=1, train=True, drop_path_rate=0.0)
        batch = flagship_train_batch(1, where, seed=3, height=64, width=128, num_gt=4)
        batch["gt_boxes"] = torch.tensor([[[4., 2., 44., 34.], [30., 10., 70., 42.],
                                           [60., 20., 100., 52.], [84., 30., 124., 62.]]],
                                         device=where)
        out = model.forward_train(**batch, generator=torch.Generator().manual_seed(5))
        sum(v for k, v in out.items() if "loss" in k).backward()
        outs[where.type] = {k: float(v.detach()) for k, v in out.items()}
        grads[where.type] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
    for k, ref in outs["cpu"].items():
        got = outs["cuda"][k]
        ok = abs(got - ref) <= 1e-4 * max(1.0, abs(ref))
        print(f"  forward_train f32 64x128 {k}: card {got:.7f}, CPU {ref:.7f}: "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"forward_train {k}: card {got} against CPU {ref}")
    worst = (0.0, "")
    for name, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        err = float((grads["cuda"][name] - ref).abs().max())
        if scale > 1e-4:        # a conv bias before a BatchNorm has gradient 0 but for noise
            worst = max(worst, (err / scale, name))
        if not err <= 1e-5 + 2e-3 * scale:
            raise AssertionError(f"gradient of {name}: card against CPU {err}, max|g| {scale}")
    print(f"  gradients of {len(grads['cpu'])} parameters, card vs CPU: all within 1e-5 + "
          f"2e-3 * max|g|; worst, among those with max|g| > 1e-4, {worst[0]:.3g} of max|g| "
          f"({worst[1]}): ok")


def train_step_counted(step, batch, counters, **noise):
    """One synchronised training step: (metrics as floats, seconds, launches)."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = step(batch, **noise)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in metrics.values()) or not metrics["grad_norm"] > 0:
        raise AssertionError(f"training step: a loss or the gradient norm is not finite: "
                             f"{metrics}")
    return metrics, seconds, {name: fn.launches for name, fn in counters.items()}


def seeded_noise(model, seed):
    """Sampler noise and DropPath masks from CPU generators of `seed`, so that
    two models get the same draws."""
    model.backbone.set_drop_path_generator(torch.Generator().manual_seed(seed + 1))
    return {"generator": torch.Generator().manual_seed(seed)}


def training_path(dev, ident, build_flagship, flagship_train_batch, counters):
    """The flagship's training step at full width; returns launches per
    kernel over the steps that count for it, and the RoIs that the first
    step sampled."""
    from panoswintransformerobjectdetection_torch.ops import roi_align as ra
    from panoswintransformerobjectdetection_torch.runtime.optim import make_optimizer
    from panoswintransformerobjectdetection_torch.runtime.train import make_train_step

    def trainer(**options):
        model = build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0, train=True,
                               **options)
        optimizer, scheduler = make_optimizer(model, base_lr=1e-4)
        return model, make_train_step(model, optimizer, scheduler)

    zero = {name: 0 for name in counters}
    k3 = {"roi_align (K3)": 1, "roi_align_backward (K3 backward)": 1}
    batch = flagship_train_batch(B, dev)
    torch.cuda.reset_peak_memory_stats()
    model, step = trainer()
    before = {n: t.detach().clone() for n, t in model.state_dict().items()}
    sampled, roi_features = [], model.roi_features

    def capture(feats, rois):
        sampled.append(rois.detach().clone())
        return roi_features(feats, rois)

    model.roi_features = capture
    first, _, counts = train_step_counted(step, batch, counters, **seeded_noise(model, 50))
    expect_launches(counts, {**zero, **k3}, "training step, direct route")
    model.roi_features = roi_features
    model.backbone.set_drop_path_generator(None)
    gen = torch.Generator(device=dev).manual_seed(51)
    times, total = [], dict(zero)
    for _ in range(TRAIN_STEPS):
        metrics, sec, counts = train_step_counted(step, batch, counters, generator=gen)
        expect_launches(counts, {**zero, **k3}, "training step, direct route")
        times.append(sec)
        for c, v in counts.items():
            total[c] += v
    if ra.roi_align_backward.last_entry != ra.BACKWARD_ENTRIES[torch.bfloat16]:
        raise AssertionError(f"training step: K3's backward launched "
                             f"{ra.roi_align_backward.last_entry}")
    bad = [n for n, p in model.named_parameters() if p.grad is None
           or not torch.isfinite(p.grad).all()]
    after = model.state_dict()
    still = [n for n, p in model.named_parameters() if torch.equal(before[n], after[n])]
    stats = [n for n in before if "running_" in n and torch.equal(before[n], after[n])]
    if bad or still or stats:
        raise AssertionError(f"training: gradients missing or not finite {bad[:5]}, parameters "
                             f"that did not move {still[:5]}, statistics that did not move "
                             f"{stats}")
    med = statistics.median(times)
    print(f"    direct route (K3 forward and backward): {TRAIN_STEPS} steps of {B} frames after "
          f"1 warm-up: ms {[round(t * 1e3, 3) for t in times]}, median {med * 1e3:.3f} ms, "
          f"{B / med:.3f} images/s; last step {metrics}; every gradient finite, every "
          f"parameter and running statistic moved; launches over the {TRAIN_STEPS} steps "
          f"{total}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"card {ident}")
    del model, step, before, after

    # dense route: the same weights, batch, noise and DropPath masks as the
    # direct route's first step.  bf16: the routes' RoI features differ by
    # rounding flips, which the heads' losses see: 2% of each loss and of the
    # gradient norm, 0.01 of the accuracy.
    model, step = trainer(roi_align="dense")
    dense, sec, counts = train_step_counted(step, batch, counters, **seeded_noise(model, 50))
    expect_launches(counts, {**zero, "dense_crop (K4)": 4}, "training step, dense route")
    total["dense_crop (K4)"] = counts["dense_crop (K4)"]
    for k, ref in first.items():
        ok = abs(dense[k] - ref) <= (0.01 if k == "acc" else 0.02 * max(abs(ref), 1e-3))
        print(f"    dense route (K4 x 4) {k}: {dense[k]:.6f}, direct {ref:.6f}: "
              f"{'ok' if ok else 'FAILED'}")
        if not ok:
            raise AssertionError(f"dense training step: {k} {dense[k]} against {ref}")
    print(f"    dense route: one step {sec * 1e3:.3f} ms (its first), launches {counts}")
    del model, step

    model, step = trainer(fused_attention=True)
    fused, sec, counts = train_step_counted(step, batch, counters, **seeded_noise(model, 50))
    expect_launches(counts, {**zero, **k3, "window_attention (K2)": K2_PER_REQUEST},
                    "training step, fused attention")
    print(f"    fused attention (K2 forward, backward through its twin): one step "
          f"{sec * 1e3:.3f} ms (its first), loss {fused['loss']:.6f} (plain {first['loss']:.6f}), "
          f"launches {counts}")
    return total, sampled[0]


def reference_check(dev, build_flagship, **config):
    """Small input, f32: the card's path (kernels) against the CPU path
    (twins) of the same model, stage by stage."""
    x = torch.rand((1, 64, 128, 3), generator=torch.Generator().manual_seed(3))
    shapes = torch.tensor([[64.0, 128.0]])
    gpu = build_flagship(device=dev, seed=1, **config)
    cpu = build_flagship(device="cpu", seed=1, **config)
    with torch.no_grad():
        fg = gpu.extract_feat(x.to(dev))
        fc = cpu.extract_feat(x)
        for i, (a, b) in enumerate(zip(fg, fc)):
            tol = 1e-3 * max(1.0, float(b.abs().max()))
            check(f"flagship {config or ''} f32 64x128 FPN level {i}, card vs CPU", a.cpu(), b,
                  tol)
        rois = cpu.rois(cpu.proposals(fc, shapes))
        rg = gpu.roi_features([f.to(dev) for f in fc], rois.to(dev))
        rc = cpu.roi_features(fc, rois)
        check("flagship f32 RoI features, card vs CPU", rg.cpu(), rc, 1e-5)
        cg, _ = gpu.roi_head.bbox_head(rc.to(dev))
        cc, _ = cpu.roi_head.bbox_head(rc)
        check("flagship f32 class logits, card vs CPU", cg.cpu(), cc,
              1e-3 * max(1.0, float(cc.abs().max())))


def check_detections(det, what):
    K = det.mask.shape[1]
    for t, shape in ((det.boxes, (B, K, 4)), (det.scores, (B, K)), (det.labels, (B, K)),
                     (det.mask, (B, K))):
        if tuple(t.shape) != shape:
            raise AssertionError(f"{what}: DetResult field has shape {tuple(t.shape)}, "
                                 f"not {shape}")
    m = det.mask
    if not (m.any() and torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()
            and ((det.labels[m] >= 0) & (det.labels[m] < 5)).all()
            and ((det.scores[m] > 0.05) & (det.scores[m] <= 1)).all()):
        raise AssertionError(f"{what}: detections are empty, not finite or out of range")
    return int(m.sum())


def timed_request(model, inputs, counters):
    """One synchronised `simple_test`: (DetResult, seconds, launches), with
    every kernel's count set to 0 just before and read just after."""
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    det = model.simple_test(*inputs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return det, seconds, {name: fn.launches for name, fn in counters.items()}


def expect_launches(launches, expected, what):
    """`expected`: kernel -> exact count per request, or None for "at least once"."""
    for name, want in expected.items():
        got = launches[name]
        if (want is None and got == 0) or (want is not None and got != want):
            raise AssertionError(f"{what}: {name} launched {got} times in a request, "
                                 f"expected {'at least 1' if want is None else want}")


def expect_k2_entry(fa, what):
    """A bf16 request's K2 launches went through the tensor-core entry."""
    got = fa.window_attention.last_entry
    if got != fa.ENTRIES[torch.bfloat16]:
        raise AssertionError(f"{what}: K2 launched {got}, not {fa.ENTRIES[torch.bfloat16]}")


def write_reference_pth(config, directory, seed):
    """Random weights from `seed` (`flagship.init_weights`) for the model of
    `config` (a config file's path or its dict), written as a reference
    checkpoint: {"state_dict": {"module." + key: tensor}}."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    model = build_detector_from_cfg(load_config(config) if isinstance(config, str) else config)
    init_weights(model, seed)
    name = os.path.basename(config)[:-3] if isinstance(config, str) else f"model_{seed}"
    path = os.path.join(directory, name + ".pth")
    torch.save({"state_dict": {"module." + k: v for k, v in model.state_dict().items()}}, path)
    return path


def per_class(det, num_classes):
    """`inference_detector`'s result from a one-image DetResult."""
    boxes, scores, labels, mask = (t[0].cpu().numpy() for t in det)
    return [np.concatenate([boxes[mask & (labels == c)], scores[mask & (labels == c), None]],
                           1).astype(np.float32) for c in range(num_classes)]


def api_nano_card_vs_cpu(dev, directory):
    """The nano demo config (depths 1-1-2-1: PitchAttention ends stages 0, 1
    and 3) through `init_detector` + `inference_detector`, f32, TF32 off, one
    64 x 128 image kept at its size: card against CPU from one `.pth`.
    Tolerance: the same detections per class, boxes within 1e-2 px and
    scores within 1e-4 (f32 sums in another order through the network)."""
    from panoswintransformerobjectdetection_torch.apis.inference import (inference_detector,
                                                                         init_detector)
    from panoswintransformerobjectdetection_torch.data.transforms import (Compose, Normalize,
                                                                          Pad, Resize)
    path = write_reference_pth(NANO_CONFIG, directory, 1)
    img = (np.random.default_rng(4).random((64, 128, 3)) * 255).astype(np.float32)
    pipeline = Compose([Resize((64, 1333)), Normalize(*IMG_NORM), Pad(32)])
    got, ref = (inference_detector(init_detector(NANO_CONFIG, path, device=where), img, pipeline)
                for where in (dev, "cpu"))
    counts = [len(r) for r in ref]
    if [len(g) for g in got] != counts or not sum(counts):
        raise AssertionError(f"nano config through the API: card counts {[len(g) for g in got]}, "
                             f"CPU {counts}")
    box_err = max(float(np.abs(g[:, :4] - r[:, :4]).max(initial=0)) for g, r in zip(got, ref))
    score_err = max(float(np.abs(g[:, 4] - r[:, 4]).max(initial=0)) for g, r in zip(got, ref))
    ok = box_err <= 1e-2 and score_err <= 1e-4
    print(f"    (b) nano config (PitchAttention), f32, 64 x 128, card vs CPU from one .pth: "
          f"detections per class {counts} on both, max|box diff| {box_err:.3g} px (tolerance "
          f"1e-2), max|score diff| {score_err:.3g} (1e-4): {'ok' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("nano config through the API: card and CPU disagree")


def api_path(dev, ident, counters, stem, ra):
    """Phase 6: the inference API on the card; returns the launches of the
    5 timed requests."""
    from panoswintransformerobjectdetection_torch.apis.inference import (inference_detector,
                                                                         init_detector, prepare)
    from panoswintransformerobjectdetection_torch.apis.tta import aug_test_detector
    zero = {name: 0 for name in counters}
    once = {**zero, "stem_conv (K1)": 1, "roi_align (K3)": 1}
    with tempfile.TemporaryDirectory() as directory:
        path = write_reference_pth(API_CONFIG, directory, 0)
        defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        api_nano_card_vs_cpu(dev, directory)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
        model = init_detector(API_CONFIG, path, device=dev)
    frame = (np.random.default_rng(0).random((H, W, 3)) * 255).astype(np.float32)
    inference_detector(model, frame)                               # warm-up
    times, total = [], dict(zero)
    for _ in range(REQUESTS):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = inference_detector(model, frame)
        seconds = time.perf_counter() - t0
        counts = {name: fn.launches for name, fn in counters.items()}
        expect_launches(counts, once, "inference_detector request")
        times.append(seconds)
        for c, v in counts.items():
            total[c] += v
    t0 = time.perf_counter()
    prep = prepare(frame)
    pipeline_ms = (time.perf_counter() - t0) * 1e3
    shape = tuple(prep["img"].shape)
    if shape != (672, 1344, 3) or tuple(prep["img_shape"][:2]) != (667, 1333):
        raise AssertionError(f"default pipeline: {tuple(prep['img_shape'])} padded to {shape}")
    images = torch.from_numpy(np.ascontiguousarray(prep["img"][None])).to(dev)
    img_shapes = torch.tensor([[667.0, 1333.0]], device=dev)
    captured, roi_features = [], model.roi_features

    def capture(feats, rois):
        captured.append(([f.detach() for f in feats[:4]], rois.detach()))
        return roi_features(feats, rois)

    model.roi_features = capture
    det = model.simple_test(images, img_shapes,
                            torch.from_numpy(prep["scale_factor"][None]).to(dev))
    model.roi_features = roi_features
    direct = per_class(det, model.num_classes)
    if [len(r) for r in result] != [len(d) for d in direct] or not all(
            np.array_equal(r, d) for r, d in zip(result, direct)):
        raise AssertionError("inference_detector differs from simple_test on its prepared tensor")
    found = sum(len(r) for r in result)
    if not found or not all(np.isfinite(r).all() for r in result):
        raise AssertionError("inference_detector: no detections, or values that are not finite")
    med = statistics.median(times)
    print(f"    (a) bf16 flagship config through the API ({os.path.basename(API_CONFIG)}, seed-0 "
          f"weights from a reference .pth): {REQUESTS} requests of one 512 x 1024 frame "
          f"(padded to 672 x 1344) after 1 warm-up: latency ms "
          f"{[round(t * 1e3, 3) for t in times]}, median {med * 1e3:.3f} ms, range "
          f"{min(times) * 1e3:.3f}-{max(times) * 1e3:.3f} ms; the pipeline alone (host) "
          f"{pipeline_ms:.3f} ms; launches over the requests {total}; {found} detections, equal "
          f"to simple_test on the prepared tensor; card {ident}")

    weights = model.backbone.patch_embed.kernel_weights(torch.bfloat16)
    x = images.to(torch.bfloat16)
    ref = stem.stem_conv_plain(x, weights.w0, weights.b0, weights.w1, weights.b1)
    check("K1 bf16 at the API path's shape (1, 672, 1344, 3), against the twin",
          stem.stem_conv(x, weights), ref, BF16_ULPS * float(ref.float().abs().max()))
    feats, rois = captured[0]
    check(f"K3 bf16 on the API request's {rois.shape[0]} RoIs, against the twin",
          ra.roi_align(feats, rois, model.featmap_strides),
          ra.roi_align_plain(feats, rois, model.featmap_strides), 0.0)

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = aug_test_detector(model, frame, flip=True)
    seconds = time.perf_counter() - t0
    counts = {name: fn.launches for name, fn in counters.items()}
    expect_launches(counts, {**zero, "stem_conv (K1)": 4, "roi_align (K3)": 2},
                    "aug_test_detector, one scale with flip")
    k = len(out["boxes"])
    if not (k and np.isfinite(out["boxes"]).all() and np.isfinite(out["scores"]).all()
            and ((out["labels"] >= 0) & (out["labels"] < model.num_classes)).all()):
        raise AssertionError("aug_test_detector: no detections, or values out of range")
    print(f"    (c) aug_test_detector, scale (800, 1333) with flip: {k} detections in "
          f"{seconds * 1e3:.3f} ms (its first call), launches {counts}")
    return total


class FramesFromMemory:
    """The test pipeline's first step on the card's machine, which has no
    OpenCV and so cannot decode a JPEG: the seeded uint8 frame drawn for the
    record, in place of `LoadImageFromFile`'s read of its file.  Every later
    step is the config's own."""

    def __init__(self, frames):
        self.frames = frames

    def __call__(self, results):
        img = self.frames[results["img_info"]["id"]].astype(np.float32)
        results.update(img=img, img_shape=img.shape, ori_shape=img.shape)
        results.setdefault("scale_factor", np.ones(4, np.float32))
        return results


def write_ann(path, frames, classes, annotations):
    """A COCO-format `ann.json` for `frames` with `annotations`."""
    n, h, w = frames.shape[:3]
    ann = {"images": [{"id": i, "file_name": f"{i}.jpg", "width": w, "height": h}
                      for i in range(n)],
           "annotations": [dict(a, id=k + 1) for k, a in enumerate(annotations)],
           "categories": [{"id": k + 1, "name": c} for k, c in enumerate(classes)]}
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


def in_memory_dataset(split_cfg, ann_file, frames, img_scale=None):
    """A config's dataset (a test or a training split) through the port's
    `build_dataset`, with its pipeline's first step (`LoadImageFromFile`)
    replaced by `FramesFromMemory`; `img_scale` replaces the Resize step's
    scale (one scale) when given."""
    from panoswintransformerobjectdetection_torch.data.builder import build_dataset
    from panoswintransformerobjectdetection_torch.data.transforms import LoadImageFromFile
    pipeline = [dict(p, img_scale=img_scale) if img_scale and p["type"] == "Resize" else p
                for p in split_cfg["pipeline"]]
    dataset = build_dataset(dict(split_cfg, ann_file=ann_file,
                                 img_prefix=os.path.dirname(ann_file), pipeline=pipeline))
    if not isinstance(dataset.pipeline.transforms[0], LoadImageFromFile):
        raise AssertionError("the config's pipeline does not start with LoadImageFromFile")
    dataset.pipeline.transforms[0] = FramesFromMemory(frames)
    return dataset


def match_detections(got, want, box_tol, score_tol, what):
    """Equal counts an image; each detection of `got` has a partner in
    `want` of the same label with its box and score within the tolerances
    (random weights give scores within rounding of each other, so two
    detections may trade places).  Returns (max|box diff|, max|score diff|)."""
    box_err = score_err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if len(g["boxes"]) != len(w["boxes"]):
            raise AssertionError(f"{what}: image {i} has {len(g['boxes'])} detections, "
                                 f"the reference {len(w['boxes'])}")
        free = np.ones(len(w["boxes"]), bool)
        for box, score, label in zip(g["boxes"], g["scores"], g["labels"]):
            d_box = np.abs(w["boxes"] - box).max(1, initial=0)
            d_score = np.abs(w["scores"] - score)
            near = free & (w["labels"] == label) & (d_score <= score_tol) & (d_box <= box_tol)
            if not near.any():
                raise AssertionError(f"{what}: image {i}, label {label}, score {score}, box "
                                     f"{box} has no partner within the tolerances")
            j = int(np.argmax(near))
            free[j] = False
            box_err, score_err = max(box_err, float(d_box[j])), max(score_err, float(d_score[j]))
    return box_err, score_err


def bfov_annotations(rng, n_frames, num_classes):
    """1-4 360-Indoor BFoV boxes a frame: tangent point (u, v) and extent
    (w, h) in radians, some across the seam or around a pole."""
    out = []
    for i in range(n_frames):
        for _ in range(int(rng.integers(1, 5))):
            box = [float(rng.uniform(-np.pi, np.pi)), float(rng.uniform(-1.2, 1.2)),
                   float(rng.uniform(0.05, 1.2)), float(rng.uniform(0.05, 1.0))]
            out.append({"image_id": i, "category_id": int(rng.integers(1, num_classes + 1)),
                        "bbox": box, "area": box[2] * box[3], "iscrowd": 0})
    return out


def stage_timer(times):
    """A `stage` hook for `single_device_test` that synchronises the card
    around each step and keeps its host time."""
    def stage(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        return out
    return stage


def k1_f32_at_eval_shape(stem, model, images):
    """K1's f32 entry on the model's own folded stem weights at the eval
    batch's shape, against its twin, with its device time beside its first
    version's, the twin's and cuDNN's two-conv chain (TF32 off: an f32
    comparison); see `k1_f32_times`."""
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return k1_f32_times(stem, images.float(),
                            model.backbone.patch_embed.kernel_weights(torch.float32),
                            "at the batch's shape")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults


def eval_indoor360(dev, ident, counters, stem, ra, seed, directory):
    """7a: the indoor360 config as users run it, on the card."""
    from panoswintransformerobjectdetection_torch import native
    from panoswintransformerobjectdetection_torch.apis.test import EVAL_STAGES
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.apis.test import single_device_test
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(EVAL_CONFIG)
    path = write_reference_pth(EVAL_CONFIG, directory, 0)
    model = init_detector(EVAL_CONFIG, path, device=dev)
    rng = np.random.default_rng(seed)
    frames = (rng.random((EVAL_FRAMES, H, W, 3)) * 255).astype(np.uint8)
    classes = tuple(f"c{i}" for i in range(model.num_classes))
    ann_file = write_ann(os.path.join(directory, "indoor360.json"), frames, classes,
                         bfov_annotations(rng, EVAL_FRAMES, len(classes)))
    dataset = in_memory_dataset(cfg["data"]["test"], ann_file, frames)
    batch = cfg["data"]["samples_per_gpu"]
    single_device_test(model, dataset, batch_size=batch, device=dev)       # warm-up
    times = {}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = single_device_test(model, dataset, batch_size=batch, device=dev,
                                 stage=stage_timer(times))
    loop_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    n_batches = EVAL_FRAMES // batch
    expect = {name: 0 for name in counters}
    expect.update({"stem_conv (K1)": n_batches, "roi_align (K3)": n_batches})
    if launches != expect:
        raise AssertionError(f"7a: launches {launches}, expected {expect}")
    if stem.stem_conv.last_entry != stem.ENTRIES[torch.float32]:
        raise AssertionError(f"7a: K1 launched {stem.stem_conv.last_entry}, not its f32 entry")
    if len(results) != EVAL_FRAMES or not all(
            np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all() for r in results):
        raise AssertionError("7a: results missing or not finite")
    native.calls.update(native=0, numpy=0)
    if native.get_lib() is None:
        raise AssertionError(f"7a: the native matcher did not build: {native.build_error}")
    t1 = time.perf_counter()
    metrics = dataset.evaluate(results, metric=["bbox", "proposal"], classwise=True)
    evaluate_s = time.perf_counter() - t1
    if native.calls["numpy"] or not native.calls["native"]:
        raise AssertionError(f"7a: matcher calls {native.calls}: the native matcher must run")
    with_gt = {a["category_id"] for r in dataset.records for a in r["eval_anns"]
               if not a["iscrowd"] and not a["ignore"]}
    for key, v in metrics.items():
        cls = key[len("bbox_AP_c"):] if key.startswith("bbox_AP_c") else None
        nan_expected = cls is not None and int(cls) not in with_gt
        if np.isnan(v) != nan_expected or (not nan_expected and not np.isfinite(v)):
            raise AssertionError(f"7a: metric {key} = {v}, NaN expected: {nan_expected}")
    per_batch = [sum(times[s][i] for s in EVAL_STAGES) for i in range(n_batches)]
    host = {s: sum(times[s]) * 1e3 for s in EVAL_STAGES}
    rec = {"frames": EVAL_FRAMES, "batch": batch, "images_per_s": EVAL_FRAMES / loop_s,
           "loop_ms": loop_s * 1e3, "median_batch_ms": statistics.median(per_batch) * 1e3,
           "stage_ms": host, "evaluate_ms": evaluate_s * 1e3, "launches": launches,
           "matcher_calls": dict(native.calls), "detections": sum(len(r["boxes"])
                                                                  for r in results)}
    print(f"    (a) {os.path.basename(EVAL_CONFIG)} (PanoSwin-T, {model.num_classes} classes, "
          f"f32, seed-0 weights from a reference .pth): {EVAL_FRAMES} frames of {H} x {W}, "
          f"batch {batch}, after a warm-up pass: {rec['images_per_s']:.3f} eval images/s ({loop_s * 1e3:.3f} ms for "
          f"the loop), median batch {rec['median_batch_ms']:.3f} ms; host ms over the loop: "
          f"loader (pipeline + collate) {host['load']:.3f}, copy to the card "
          f"{host['copy']:.3f}, simple_test {host['simple_test']:.3f}, results "
          f"{host['results']:.3f}; evaluate (bbox, proposal, classwise) {evaluate_s * 1e3:.3f} "
          f"ms with the native matcher ({native.calls['native']} matches); launches "
          f"{launches}; {rec['detections']} detections; bbox_mAP {metrics['bbox_mAP']:.6f}, "
          f"AR@1000 {metrics['AR@1000']:.6f}; card {ident}")
    images = torch.from_numpy(np.stack([dataset[i]["img"] for i in range(batch)])).to(dev)
    rec["k1_f32"] = k1_f32_at_eval_shape(stem, model, images)
    captured, roi_features = [], model.roi_features

    def capture(feats, rois):
        captured.append(([f.detach() for f in feats[:4]], rois.detach()))
        return roi_features(feats, rois)

    model.roi_features = capture
    model.simple_test(images, torch.tensor([[float(H), float(W)]] * batch, device=dev))
    model.roi_features = roi_features
    feats, rois = captured[0]
    check(f"K3 f32 on the eval batch's {rois.shape[0]} RoIs, against the twin",
          ra.roi_align(feats, rois, model.featmap_strides),
          ra.roi_align_plain(feats, rois, model.featmap_strides), 0.0)
    return rec, dataset


def eval_nano_card_vs_cpu(dev, seed, directory):
    """7b: the nano config at 64 x 128, f32, card against CPU from one
    `.pth`, on ground truth made from the CPU's detections."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.apis.test import single_device_test
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(NANO_CONFIG)
    path = write_reference_pth(NANO_CONFIG, directory, 1)
    rng = np.random.default_rng(seed + 1)
    frames = (rng.random((8, 64, 128, 3)) * 255).astype(np.uint8)
    classes = cfg["classes"]
    first = write_ann(os.path.join(directory, "nano_first.json"), frames, classes, [])
    ref = single_device_test(init_detector(NANO_CONFIG, path, device="cpu"),
                             in_memory_dataset(cfg["data"]["test"], first, frames, (64, 1333)),
                             batch_size=2, device="cpu")
    gt = []
    for i, r in enumerate(ref):
        for b, s, label in zip(r["boxes"], r["scores"], r["labels"]):
            x1, y1, x2, y2 = (b + rng.uniform(-3, 3, 4)).tolist()
            if s > 0.05 and x2 - x1 >= 1 and y2 - y1 >= 1:
                gt.append({"image_id": i, "category_id": int(label) + 1, "iscrowd": 0,
                           "bbox": [x1, y1, x2 - x1, y2 - y1], "area": (x2 - x1) * (y2 - y1)})
    dataset = in_memory_dataset(cfg["data"]["test"],
                                write_ann(os.path.join(directory, "nano.json"), frames,
                                          classes, gt), frames, (64, 1333))
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    got = single_device_test(init_detector(NANO_CONFIG, path, device=dev), dataset,
                             batch_size=2, device=dev)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    box_err, score_err = match_detections(got, ref, 1e-3, 1e-4, "7b nano card vs CPU")
    m_cpu, m_card = dataset.evaluate(ref), dataset.evaluate(got)
    diffs = {k: abs(m_card[k] - v) for k, v in m_cpu.items()}
    if max(diffs.values()) > 1e-4 or not any(v > 0 for v in m_cpu.values()):
        raise AssertionError(f"7b: metrics card {m_card}, CPU {m_cpu}")
    print(f"    (b) nano config, f32, 8 frames of 64 x 128, card vs CPU from one .pth: "
          f"detections per image {[len(r['boxes']) for r in ref]} on both, max|box diff| "
          f"{box_err:.3g} px (tolerance 1e-3), max|score diff| {score_err:.3g} (1e-4); on "
          f"{len(gt)} ground-truth boxes made from the CPU's detections: bbox_mAP card "
          f"{m_card['bbox_mAP']:.6f}, CPU {m_cpu['bbox_mAP']:.6f}, max|metric diff| "
          f"{max(diffs.values()):.3g} (tolerance 1e-4)")
    return {"box_err": box_err, "score_err": score_err, "bbox_mAP": m_card["bbox_mAP"],
            "max_metric_diff": max(diffs.values())}


def perfect_probe(dataset):
    """7c: the 7a dataset's ground truth as its evaluator holds it
    (`eval_anns`) as detections of score 1: bbox_mAP and AR@100 are 1
    (within 1e-12)."""
    dets = []
    for r in dataset.records:
        anns = [a for a in r["eval_anns"] if not a["iscrowd"]]
        boxes = np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                           a["bbox"][1] + a["bbox"][3]] for a in anns], np.float32)
        dets.append({"boxes": boxes.reshape(-1, 4), "scores": np.ones(len(anns), np.float32),
                     "labels": np.array([a["category_id"] for a in anns], np.int64)})
    metrics = dataset.evaluate(dets)
    # 1 within 1e-12: COCOeval's precision is tp / (tp + fp + spacing(1))
    if abs(metrics["bbox_mAP"] - 1.0) > 1e-12 or abs(metrics["bbox_AR@100"] - 1.0) > 1e-12:
        raise AssertionError(f"7c: perfect detections give {metrics}")
    pixel = dataset.evaluate([{"boxes": r["bboxes"], "labels": r["labels"],
                               "scores": np.ones(len(r["bboxes"]), np.float32)}
                              for r in dataset.records])
    if abs(pixel["bbox_mAP"] - 1.0) > 1e-12:
        raise AssertionError(f"7c: the records' pixel boxes as detections give {pixel}")
    print(f"    (c) perfect-detection probe on the 7a set (host): bbox_mAP "
          f"{metrics['bbox_mAP']}, AR@100 {metrics['bbox_AR@100']}, AR@1 "
          f"{metrics['bbox_AR@1']:.6f}; the records' equirectangular pixel boxes as "
          f"detections give bbox_mAP {pixel['bbox_mAP']} (360-Indoor's eval_anns carry the "
          "converted pixel box, a deliberate departure from the JAX package)")
    return {"bbox_mAP": metrics["bbox_mAP"], "bbox_AR@100": metrics["bbox_AR@100"],
            "pixel_boxes_bbox_mAP": pixel["bbox_mAP"]}


def eval_path(dev, ident, counters, stem, ra, seed):
    """Phase 7: the evaluation path on the card; returns its record."""
    with tempfile.TemporaryDirectory() as directory:
        rec, dataset = eval_indoor360(dev, ident, counters, stem, ra, seed, directory)
        rec["nano_card_vs_cpu"] = eval_nano_card_vs_cpu(dev, seed, directory)
        rec["perfect_probe"] = perfect_probe(dataset)
    return rec



def pixel_annotations(rng, n_frames, height, width, num_classes, most=6):
    """1-`most` pixel boxes a frame (COCO xywh), 16 px to half the frame a side."""
    out = []
    for i in range(n_frames):
        for _ in range(int(rng.integers(1, most + 1))):
            w, h = float(rng.uniform(16, width / 2)), float(rng.uniform(16, height / 2))
            x, y = float(rng.uniform(0, width - w)), float(rng.uniform(0, height - h))
            out.append({"image_id": i, "category_id": int(rng.integers(1, num_classes + 1)),
                        "bbox": [x, y, w, h], "area": w * h, "iscrowd": 0})
    return out


class LoopRecord:
    """A training hook, and `stage` hooks for `train_detector` and
    `single_device_test`, that keep what phase 8 checks: each step's metrics
    and step count, each epoch's loop time (its first batch asked for to its
    last step's hooks), each stage's host time (the card synchronised around
    it), and the launches of each step and each eval batch, the counts set
    to 0 just before and read just after."""

    def __init__(self, counters):
        self.counters = counters
        self.steps, self.epochs, self.times = [], [], {}
        self.step_launches, self.eval_launches = [], []

    def _counted(self, fn, into):
        for c in self.counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        into.append({name: c.launches for name, c in self.counters.items()})
        return out

    def stage(self, name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._counted(fn, self.step_launches) if name == "step" else fn()
        torch.cuda.synchronize()
        self.times.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    def eval_stage(self, name, fn):
        return self._counted(fn, self.eval_launches) if name == "simple_test" else fn()

    # hook methods (`runtime/hooks.Hook`)
    def before_train(self, ctx):
        pass

    def before_epoch(self, ctx):
        self.epochs.append([time.perf_counter(), None, 0])

    def after_iter(self, ctx):
        self.steps.append(dict(ctx["metrics"], step=ctx["step"]))
        self.epochs[-1][1:] = [time.perf_counter(), self.epochs[-1][2] + 1]

    def after_epoch(self, ctx):
        pass

    def after_train(self, ctx):
        pass


def check_stem_cache(stem, model, dtype):
    """K1's cached weights (`ConvStemPatchEmbed.kernel_weights`, keyed on the
    tensors' versions) equal a fresh fold of the stem's current weights and
    statistics: a training step changed them in place since the last eval."""
    pe = model.backbone.patch_embed
    cached = pe.kernel_weights(dtype)
    with torch.no_grad():
        folded = [t for ci, bi in ((0, 1), (3, 4))
                  for t in stem.fold_bn(pe.proj[ci].weight, pe.proj[ci].bias, pe.proj[bi].weight,
                                        pe.proj[bi].bias, pe.proj[bi].running_mean,
                                        pe.proj[bi].running_var, pe.proj[bi].eps)]
        fresh = stem.stem_weights(*folded, dtype)
    if not all(torch.equal(a, b) for a, b in zip(cached, fresh)):
        raise AssertionError("8a: K1's cached stem weights are not the trained stem's")
    return cached


def loop_full_width(dev, ident, counters, stem, ra, seed, directory):
    """8a: the bf16 streetwin config's training loop on the card."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.apis.test import single_device_test
    from panoswintransformerobjectdetection_torch.apis.train import train_detector
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    from panoswintransformerobjectdetection_torch.runtime.hooks import LrRecordHook
    from panoswintransformerobjectdetection_torch.runtime.optim import warmup_step_schedule
    cfg = load_config(API_CONFIG)
    classes = cfg["classes"]
    path = write_reference_pth(API_CONFIG, directory, 0)
    rng = np.random.default_rng(seed + 2)
    frames = (rng.random((LOOP_FRAMES, H, W, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, "loop_train.json"), frames, classes,
                         pixel_annotations(rng, LOOP_FRAMES, H, W, len(classes)))
    train_ds = in_memory_dataset(dict(cfg["data"]["train"], classes=classes), ann_file, frames)
    steps = [p["type"] for p in cfg["data"]["train"]["pipeline"]]
    val_frames = frames[:LOOP_EVAL_FRAMES]
    val_ann = write_ann(os.path.join(directory, "loop_val.json"), val_frames, classes,
                        pixel_annotations(rng, LOOP_EVAL_FRAMES, H, W, len(classes)))
    val_ds = in_memory_dataset(dict(cfg["data"]["val"], classes=classes), val_ann, val_frames)
    batch = cfg["data"]["samples_per_gpu"]
    opt, sched = cfg["optimizer"], cfg["lr_config"]
    steps_per_epoch = LOOP_FRAMES // batch
    schedule = warmup_step_schedule(opt["lr"], sched["warmup_iters"],
                                    decay_steps=[e * steps_per_epoch for e in sched["step"]])
    stems = []

    def run(record, work_dir, **kw):
        def eval_fn(model):
            results = single_device_test(model, val_ds, batch_size=batch, device=dev,
                                         stage=record.eval_stage)
            stems.append(check_stem_cache(stem, model, torch.bfloat16))
            return val_ds.evaluate(results)

        model = build_detector_from_cfg(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        train_detector(model, train_ds, work_dir=work_dir, total_epochs=LOOP_EPOCHS,
                       batch_size=batch, base_lr=opt["lr"], weight_decay=opt["weight_decay"],
                       warmup_iters=sched["warmup_iters"], decay_epochs=sched["step"],
                       log_interval=1, checkpoint_interval=1, eval_fn=eval_fn, seed=seed,
                       hooks=[LrRecordHook(schedule), record], device=dev, stage=record.stage,
                       **kw)
        return time.perf_counter() - t0, torch.cuda.max_memory_allocated()

    first, resumed = LoopRecord(counters), LoopRecord(counters)
    first_dir, resumed_dir = (os.path.join(directory, d) for d in ("loop", "resumed"))
    wall, peak = run(first, first_dir, load_from=path, num_workers=2)
    resumed_wall, resumed_peak = run(resumed, resumed_dir, num_workers=0,
                                     resume_from=os.path.join(first_dir, "epoch_1"))

    zero = {name: 0 for name in counters}
    per_step = {**zero, "roi_align (K3)": 1, "roi_align_backward (K3 backward)": 1}
    per_batch = {**zero, "stem_conv (K1)": 1, "roi_align (K3)": 1}
    for record, n_steps, n_evals in ((first, LOOP_EPOCHS * steps_per_epoch, LOOP_EPOCHS),
                                     (resumed, steps_per_epoch, 1)):
        eval_batches = n_evals * (LOOP_EVAL_FRAMES // batch)
        if (len(record.step_launches), len(record.eval_launches)) != (n_steps, eval_batches):
            raise AssertionError(f"8a: {len(record.step_launches)} steps and "
                                 f"{len(record.eval_launches)} eval batches, expected {n_steps} "
                                 f"and {eval_batches}")
        for counts in record.step_launches:
            expect_launches(counts, per_step, "8a training step")
        for counts in record.eval_launches:
            expect_launches(counts, per_batch, "8a eval batch")
        if not all(np.isfinite(v) for m in record.steps for v in m.values()):
            raise AssertionError(f"8a: a loss is not finite: {record.steps}")
    if ra.roi_align_backward.last_entry != ra.BACKWARD_ENTRIES[torch.bfloat16]:
        raise AssertionError(f"8a: K3's backward launched {ra.roi_align_backward.last_entry}")
    if stems[0] is stems[1]:
        raise AssertionError("8a: K1's stem weights were not folded again after an epoch")
    want = [(m["step"], m["lr"]) for m in first.steps[steps_per_epoch:]]
    got = [(m["step"], m["lr"]) for m in resumed.steps]
    ckpts = [torch.load(os.path.join(d, f"epoch_{LOOP_EPOCHS}"), map_location="cpu",
                        weights_only=True) for d in (first_dir, resumed_dir)]
    if got != want or not ckpts[0]["step"] == ckpts[1]["step"] == LOOP_EPOCHS * steps_per_epoch \
            or ckpts[0]["scheduler"] != ckpts[1]["scheduler"]:
        raise AssertionError(f"8a: resumed steps and lrs {got}, the first run's {want}; "
                             f"schedules {ckpts[0]['scheduler']} and {ckpts[1]['scheduler']}")
    del ckpts

    def summary(record, wall_s, peak_bytes, workers):
        loop_s = sum(end - start for start, end, _ in record.epochs)
        n = sum(k for _, _, k in record.epochs)
        host = {k: sum(v) for k, v in record.times.items()}
        last_start, last_end, last_n = record.epochs[-1]
        return {"steps": n, "images_per_s": n * batch / loop_s,
                "last_epoch_images_per_s": last_n * batch / (last_end - last_start),
                "median_step_ms": statistics.median(record.times["step"]) * 1e3,
                "step_ms": [t * 1e3 for t in record.times["step"]],
                "loader_share": host["load"] / loop_s, "stage_ms": {k: v * 1e3 for k, v in
                                                                  host.items()},
                "loop_ms": loop_s * 1e3, "wall_ms": wall_s * 1e3,
                "peak_memory_gib": peak_bytes / 2**30, "num_workers": workers}

    rec = {"config": os.path.basename(API_CONFIG), "pipeline": steps, "frames": LOOP_FRAMES,
           "batch": batch, "epochs": LOOP_EPOCHS, "card": ident,
           "first": summary(first, wall, peak, 2), "resumed": summary(resumed, resumed_wall,
                                                                      resumed_peak, 0),
           "losses": [{k: m[k] for k in ("loss", "grad_norm", "lr")} for m in first.steps],
           "launches_step": per_step, "launches_eval_batch": per_batch,
           "launches": {name: sum(c[name] for c in first.step_launches + first.eval_launches)
                        for name in counters}}
    for name in ("first", "resumed"):
        r = rec[name]
        origin = ", from epoch_1" if name == "resumed" else ""
        print(f"    (a) {rec['config']} ({name} run{origin}, "
              f"{r['num_workers']} loader threads): {r['steps']} steps of {batch} frames of "
              f"{H} x {W} through {'/'.join(steps[1:])}: {r['images_per_s']:.3f} images/s "
              f"with the loader (last epoch {r['last_epoch_images_per_s']:.3f}), median step "
              f"{r['median_step_ms']:.3f} ms, steps ms {[round(t, 3) for t in r['step_ms']]}, "
              f"host ms {{{', '.join(f'{k}: {v:.3f}' for k, v in r['stage_ms'].items())}}}, "
              f"loader share {r['loader_share']:.3f}, wall with checkpoints and evals "
              f"{r['wall_ms']:.3f} ms, peak memory {r['peak_memory_gib']:.2f} GiB; card {ident}")
    print(f"    (a) every loss finite; launches a step {per_step} and an eval batch {per_batch} "
          f"in both runs; K1's weights folded again after each epoch; the resumed run's steps "
          f"and learning rates {got} are the first run's; losses {rec['losses']}")
    return rec


def loop_nano_card_vs_cpu(dev, seed, directory):
    """8b: two loop steps of the nano config, f32, TF32 off, on the card and
    on the CPU from one `.pth`, with the same pipeline draws (`random.seed`,
    in-thread loader), the same sampler noise and DropPath masks (CPU
    generators), `accumulate_steps=2` and a clip that triggers.  Tolerances:
    losses 1e-4 relative (f32 sums in another order); the gradient norm
    1e-3 relative (its squares sum every gradient, each within 2e-3 of its
    largest entry in `train_reference_check`); the parameters after
    the update within 2 lr + 1e-6 everywhere (AdamW's first step moves an
    entry by lr * g / (|g| + eps): where g lies within rounding of 0, the two
    devices may step opposite ways) and their median difference within
    1e-3 lr; running statistics 1e-4 relative."""
    import random
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.apis.train import train_detector
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(NANO_CONFIG)
    path = write_reference_pth(NANO_CONFIG, directory, 1)
    rng = np.random.default_rng(seed + 3)
    frames = (rng.random((4, 64, 128, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, "nano_train.json"), frames, cfg["classes"],
                         pixel_annotations(rng, 4, 64, 128, len(cfg["classes"])))
    lr, clip = 1e-4, 1e-3
    out = []
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for name, where in (("card", dev), ("cpu", torch.device("cpu"))):
        dataset = in_memory_dataset(dict(cfg["data"]["train"], classes=cfg["classes"]), ann_file,
                                    frames, (64, 1333))
        record = LoopRecord({})
        model = build_detector_from_cfg(cfg)
        random.seed(seed)
        train_detector(model, dataset, work_dir=os.path.join(directory, f"nano_{name}"),
                       total_epochs=1, batch_size=2, base_lr=lr, warmup_iters=0,
                       grad_clip=clip, accumulate_steps=2, num_workers=0, log_interval=1,
                       load_from=path, seed=seed, hooks=[record], device=where)
        out.append((record.steps, {k: v.cpu() for k, v in model.state_dict().items()}))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    (card_steps, card), (cpu_steps, cpu) = out
    if len(card_steps) != 2 or len(cpu_steps) != 2:
        raise AssertionError(f"8b: steps card {card_steps}, CPU {cpu_steps}")
    loss_err = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-6) for g, w in zip(card_steps, cpu_steps)
                   for k in w if k not in ("step", "grad_norm"))
    norm_err = max(abs(g["grad_norm"] - w["grad_norm"]) / w["grad_norm"]
                   for g, w in zip(card_steps, cpu_steps))
    if loss_err > 1e-4 or norm_err > 1e-3 or min(w["grad_norm"] for w in cpu_steps) <= clip:
        raise AssertionError(f"8b: card {card_steps}, CPU {cpu_steps}")
    diffs, stat_err = [], 0.0
    for name, ref in cpu.items():
        if "num_batches" in name:
            continue
        d = (card[name].double() - ref.double()).abs()
        if "running" in name:
            stat_err = max(stat_err, float((d / ref.double().abs().clamp(min=1.0)).max()))
        else:
            diffs.append(d.flatten())
    diffs = torch.cat(diffs)
    max_err, median_err = float(diffs.max()), float(diffs.median())
    if max_err > 2 * lr + 1e-6 or median_err > 1e-3 * lr or stat_err > 1e-4:
        raise AssertionError(f"8b: parameters max|diff| {max_err}, median {median_err}, "
                             f"statistics {stat_err}")
    print(f"    (b) nano config, f32, 2 loop steps of 2 frames of 64 x 128 (accumulate 2, clip "
          f"{clip}: grad norms {[round(w['grad_norm'], 4) for w in cpu_steps]}), card vs CPU from "
          f"one .pth: losses within {loss_err:.3g} relative (tolerance 1e-4), gradient norms "
          f"{norm_err:.3g} (1e-3); parameters after "
          f"the update max|diff| {max_err:.3g} (2 lr + 1e-6 = {2 * lr + 1e-6:.3g}), median "
          f"{median_err:.3g} (1e-3 lr), running statistics {stat_err:.3g} (1e-4): ok")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err,
            "param_max_err": max_err, "param_median_err": median_err,
            "stat_rel_err": stat_err}


def loop_use_checkpoint(dev, ident, directory):
    """8c: one full-width bf16 `forward_train` + backward of the streetwin
    config with activation checkpointing and one without, from the same
    weights, batch, sampler generator and DropPath generator (rate 0.1).
    The losses must be equal; each gradient within 2e-2 * max|g| + 1e-6 of
    the plain run's (the recompute's kernels are the same, but atomic adds in
    the index and scatter backward passes sum in any order, and a bf16
    rounding flipped upstream moves an entry by a unit of 2**-8)."""
    from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                         load_weights)
    from panoswintransformerobjectdetection_torch.flagship import flagship_train_batch
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    path = write_reference_pth(API_CONFIG, directory, 0)
    batch = flagship_train_batch(B, dev)
    runs = {}
    for use_checkpoint in (False, True):
        cfg = load_config(API_CONFIG)
        cfg["model"]["backbone"]["use_checkpoint"] = use_checkpoint
        model = build_detector_from_cfg(cfg)
        load_weights(model, path)
        model.to(dev).train()
        model.backbone.set_drop_path_generator(torch.Generator().manual_seed(7))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model.forward_train(**batch, generator=torch.Generator().manual_seed(8))
        sum(v for k, v in out.items() if "loss" in k).backward()
        torch.cuda.synchronize()
        runs[use_checkpoint] = ({k: float(v.detach()) for k, v in out.items()},
                                {n: p.grad.detach().float().cpu()
                                 for n, p in model.named_parameters()},
                                torch.cuda.max_memory_allocated(), time.perf_counter() - t0)
        del model, out
    (plain, plain_g, plain_mem, plain_s), (ckpt, ckpt_g, ckpt_mem, ckpt_s) = runs[False], runs[True]
    worst = (0.0, "")
    for name, g in plain_g.items():
        scale = float(g.abs().max())
        err = float((ckpt_g[name] - g).abs().max())
        worst = max(worst, (err / max(scale, 1e-30), name))
        if err > 2e-2 * scale + 1e-6:
            raise AssertionError(f"8c: gradient of {name}: {err}, max|g| {scale}")
    if ckpt != plain:
        raise AssertionError(f"8c: losses with use_checkpoint {ckpt}, without {plain}")
    rec = {"losses": plain, "worst_grad_rel_err": worst[0], "worst_grad": worst[1],
           "peak_memory_gib": {"plain": plain_mem / 2**30, "use_checkpoint": ckpt_mem / 2**30},
           "first_step_ms": {"plain": plain_s * 1e3, "use_checkpoint": ckpt_s * 1e3}}
    print(f"    (c) use_checkpoint, bf16, {B} x {H} x {W}, DropPath 0.1: losses equal ({plain}); "
          f"gradients within {worst[0]:.3g} of max|g| at worst ({worst[1]}; tolerance 2e-2); "
          f"peak memory {plain_mem / 2**30:.2f} GiB without, {ckpt_mem / 2**30:.2f} GiB with; "
          f"forward + backward (first call each) {plain_s * 1e3:.3f} / {ckpt_s * 1e3:.3f} ms; "
          f"card {ident}")
    return rec


def training_loop_path(dev, ident, counters, stem, ra, seed):
    """Phase 8: the training loop on the card; returns its record."""
    with tempfile.TemporaryDirectory() as directory:
        rec = loop_full_width(dev, ident, counters, stem, ra, seed, directory)
        rec["nano_card_vs_cpu"] = loop_nano_card_vs_cpu(dev, seed, directory)
        rec["use_checkpoint"] = loop_use_checkpoint(dev, ident, directory)
    return rec


def polygon_annotations(rng, n_frames, height, width, num_classes):
    """1-4 polygon instances a frame: 5-8 vertices around a centre, radius
    12 px to 0.3 of the frame's shorter side; box from the polygon's extent
    and area from its rasterised mask, as COCO keeps them."""
    from panoswintransformerobjectdetection_torch.core import rle
    out = []
    for i in range(n_frames):
        for _ in range(int(rng.integers(1, 5))):
            cx, cy = rng.uniform(0.2, 0.8) * width, rng.uniform(0.2, 0.8) * height
            n = int(rng.integers(5, 9))
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            rad = rng.uniform(12, 0.3 * min(height, width)) * rng.uniform(0.6, 1.0, n)
            xs = np.clip(cx + rad * np.cos(ang), 0, width - 1)
            ys = np.clip(cy + rad * np.sin(ang), 0, height - 1)
            poly = [float(v) for v in np.stack([xs, ys], 1).reshape(-1)]
            area = float(rle.area(rle.polygon_to_rle(poly, height, width)))
            out.append({"image_id": i, "category_id": int(rng.integers(1, num_classes + 1)),
                        "bbox": [float(xs.min()), float(ys.min()), float(xs.max() - xs.min()),
                                 float(ys.max() - ys.min())],
                        "area": area, "iscrowd": 0, "segmentation": [poly]})
    return out


def mask_config(dtype=None, score_thr=MASK_SCORE_THR, path=MASK_CONFIG):
    """A mask config (the Swin-T Mask R-CNN one by default) with the
    detections' score threshold lowered (random weights give every class
    about 1/81) and, when given, a compute type."""
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(path)
    cfg["model"]["test_cfg"]["rcnn"]["score_thr"] = score_thr
    if dtype:
        cfg["model"]["compute_dtype"] = dtype
    return cfg


def mask_pass(model, dataset, dev, counters, ra):
    """One timed `single_device_test(with_masks=True)` pass at the config's
    batch with the launch counts set to 0 just before it and read just
    after: (results, seconds, per-stage host seconds, launches, K3's
    launches by size)."""
    from panoswintransformerobjectdetection_torch.apis.test import single_device_test
    times = {}
    for fn in counters.values():
        fn.launches = 0
    ra.roi_align.launches_by_entry = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = single_device_test(model, dataset, batch_size=2, with_masks=True, device=dev,
                                 stage=stage_timer(times))
    seconds = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    by_size = {o: sum(n for (_, size), n in ra.roi_align.launches_by_entry.items() if size == o)
               for o in ra.KERNEL_OUT_SIZES}
    return results, seconds, times, launches, by_size


def check_mask_launches(launches, by_size, n_batches, entry, ra, what, at_7=1):
    """K3 `at_7` times a batch at 7 (3 for a cascade) and once at 14, through
    `entry`; no other kernel."""
    expect = {name: 0 for name in launches}
    expect["roi_align (K3)"] = (at_7 + 1) * n_batches
    if launches != expect or by_size != {7: at_7 * n_batches, 14: n_batches}:
        raise AssertionError(f"{what}: launches {launches}, K3 by size {by_size}; expected "
                             f"{expect}, {at_7 * n_batches} at 7 and {n_batches} at 14")
    if ra.roi_align.last_entry != entry:
        raise AssertionError(f"{what}: K3 launched {ra.roi_align.last_entry}, not {entry}")


def check_mask_results(results, n, what):
    ok = len(results) == n and all(
        np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all()
        and len(r["masks"]) == len(r["boxes"]) for r in results)
    if not ok or not sum(len(r["boxes"]) for r in results):
        raise AssertionError(f"{what}: results missing, empty or not finite")


def polygon_dataset(cfg, directory, seed, name, what, n_frames=MASK_FRAMES):
    """`n_frames` seeded 480 x 640 frames with polygon instances of COCO's
    classes (`polygon_annotations`) through `cfg`'s test pipeline, which
    must give 800 x 1067 padded to `MASK_FRAME`."""
    from panoswintransformerobjectdetection_torch.data.datasets import CocoDataset
    rng = np.random.default_rng(seed)
    frames = (rng.random((n_frames, 480, 640, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, name), frames, CocoDataset.CLASSES,
                         polygon_annotations(rng, n_frames, 480, 640, len(CocoDataset.CLASSES)))
    dataset = in_memory_dataset(cfg["data"]["test"], ann_file, frames)
    padded = tuple(dataset[0]["img"].shape[:2])
    if padded != MASK_FRAME or tuple(dataset[0]["img_shape"][:2]) != (800, 1067):
        raise AssertionError(f"{what}: the test pipeline gives {dataset[0]['img_shape']} padded "
                             f"to {padded}")
    return dataset


def first_batch(dataset, dev, n=2):
    """The first `n` records of `dataset` as `simple_test`'s inputs on `dev`."""
    batch = [dataset[i] for i in range(n)]
    return (torch.from_numpy(np.stack([b["img"] for b in batch])).to(dev),
            torch.tensor([list(b["img_shape"][:2]) for b in batch], dtype=torch.float32,
                         device=dev),
            torch.from_numpy(np.stack([b["scale_factor"] for b in batch])).to(dev))


def captured_roi_inputs(model, inputs, masks=True):
    """The (FPN maps, RoIs, bins) of each K3 call of one `simple_test_masks`
    (`simple_test` without `masks`)."""
    captured, roi_features = [], model.roi_features

    def capture(feats, rois, out_size=7):
        captured.append(([f.detach() for f in feats[:4]], rois.detach(), out_size))
        return roi_features(feats, rois, out_size)

    model.roi_features = capture
    try:
        (model.simple_test_masks if masks else model.simple_test)(*inputs)
    finally:
        del model.roi_features
    return captured


def mask_full_width(dev, ident, counters, ra, seed, directory):
    """9a and 9b: the Swin-T Mask R-CNN config at full width, f32 then bf16."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.apis.test import MASK_EVAL_STAGES
    cfg = mask_config()
    path = write_reference_pth(cfg, directory, 0)
    dataset = polygon_dataset(cfg, directory, seed + 9, "coco_instance.json", "9a")
    n_batches = MASK_FRAMES // 2
    records = {}
    for label, dtype in (("9a", None), ("9b", "bfloat16")):
        model = init_detector(mask_config(dtype), path, device=dev)
        from panoswintransformerobjectdetection_torch.apis.test import single_device_test
        single_device_test(model, dataset, batch_size=2, with_masks=True, device=dev)  # warm-up
        torch.cuda.reset_peak_memory_stats()
        results, loop_s, times, launches, by_size = mask_pass(model, dataset, dev, counters, ra)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        entry = ra.ENTRIES[torch.bfloat16 if dtype else torch.float32]
        check_mask_launches(launches, by_size, n_batches, entry, ra, label)
        check_mask_results(results, MASK_FRAMES, label)
        per_batch = [sum(times[s][i] for s in MASK_EVAL_STAGES) for i in range(n_batches)]
        host = {s: sum(times[s]) * 1e3 for s in MASK_EVAL_STAGES}
        rec = {"dtype": dtype or "float32", "frames": MASK_FRAMES, "batch": 2,
               "score_thr": MASK_SCORE_THR, "images_per_s": MASK_FRAMES / loop_s,
               "loop_ms": loop_s * 1e3, "median_batch_ms": statistics.median(per_batch) * 1e3,
               "stage_ms": host, "peak_gib": peak, "launches": launches,
               "k3_launches_by_size": by_size,
               "detections": sum(len(r["boxes"]) for r in results)}
        line = (f"    ({label[1]}) {os.path.basename(MASK_CONFIG)} (Swin-T Mask R-CNN, 80 classes, "
                f"{rec['dtype']}, seed-0 weights from a reference .pth, score_thr "
                f"{MASK_SCORE_THR}): {MASK_FRAMES} frames of 480 x 640 (800 x 1067, padded "
                f"to 800 x 1088), batch 2, after a warm-up pass: {rec['images_per_s']:.3f} eval "
                f"images/s ({loop_s * 1e3:.3f} ms for the loop), median batch "
                f"{rec['median_batch_ms']:.3f} ms; host ms over the loop: "
                + ", ".join(f"{s} {v:.3f}" for s, v in host.items())
                + f"; peak memory {peak:.2f} GiB; launches {launches}, K3 by size {by_size}; "
                f"{rec['detections']} detections")
        if label == "9a":
            t1 = time.perf_counter()
            metrics = dataset.evaluate(results, metric=["bbox", "segm"])
            rec["evaluate_ms"] = (time.perf_counter() - t1) * 1e3
            bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
            if bad:
                raise AssertionError(f"9a: metrics not finite: {bad}")
            rec["bbox_mAP"], rec["segm_mAP"] = metrics["bbox_mAP"], metrics["segm_mAP"]
            line += (f"; evaluate (bbox, segm) {rec['evaluate_ms']:.3f} ms, every metric finite, "
                     f"bbox_mAP {metrics['bbox_mAP']:.6f}, segm_mAP {metrics['segm_mAP']:.6f}")
            feats, rois, o = captured_roi_inputs(model, first_batch(dataset, dev))[-1]
            if o != 14:
                raise AssertionError(f"9a: the mask branch pooled at {o}")
            check(f"K3 o=14 f32 on the mask branch's {rois.shape[0]} RoIs, against the twin",
                  ra.roi_align(feats, rois, model.featmap_strides, 14),
                  ra.roi_align_plain(feats, rois, model.featmap_strides, 14), 0.0)
        print(line + f"; card {ident}")
        records[label] = rec
        del model
    return records, dataset


NANO_MASK_MODEL = {
    "type": "MaskRCNN",
    "backbone": {"type": "SwinTransformer", "embed_dim": 16, "depths": (2, 2, 2, 2),
                 "num_heads": (1, 2, 2, 4), "window_size": 4, "drop_path_rate": 0.0},
    "neck": {"type": "FPN", "in_channels": (16, 32, 64, 128), "out_channels": 16,
             "num_outs": 5},
    "num_classes": 5,
    "test_cfg": {"rpn": {"nms_pre": 256, "max_per_img": 64, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
                 "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 16}}}


def mask_nano_card_vs_cpu(dev, seed, directory):
    """9c: a nano Swin Mask R-CNN in f32 at 64 x 128, card against CPU from
    one `.pth`: detections, mask probabilities, pasted bitmaps, segm and
    bbox metrics (on ground truth made from the CPU's detections and
    masks)."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.apis.test import single_device_test
    from panoswintransformerobjectdetection_torch.core import rle
    from panoswintransformerobjectdetection_torch.models.mask_head import (paste_mask_values,
                                                                           paste_masks)
    classes = tuple(f"c{i}" for i in range(5))
    cfg = {"model": NANO_MASK_MODEL}
    split = {"type": "CocoDataset", "classes": classes, "test_mode": True,
             "pipeline": [{"type": "LoadImageFromFile"},
                          {"type": "Resize", "img_scale": (64, 1333), "keep_ratio": True},
                          {"type": "Normalize", "mean": IMG_NORM[0], "std": IMG_NORM[1],
                           "to_rgb": True},
                          {"type": "Pad", "size_divisor": 32}]}
    path = write_reference_pth(cfg, directory, 1)
    rng = np.random.default_rng(seed + 3)
    frames = (rng.random((8, 64, 128, 3)) * 255).astype(np.uint8)
    cpu = init_detector(cfg, path, device="cpu")
    first = write_ann(os.path.join(directory, "nano_mask_first.json"), frames, classes, [])
    ref = single_device_test(cpu, in_memory_dataset(split, first, frames), batch_size=2,
                             with_masks=True, device="cpu")
    gt = []
    for i, r in enumerate(ref):
        for b, s, label, m in zip(r["boxes"], r["scores"], r["labels"], r["masks"]):
            x1, y1, x2, y2 = (b + rng.uniform(-3, 3, 4)).tolist()
            if s > 0.05 and x2 - x1 >= 1 and y2 - y1 >= 1 and rle.area(m) > 0:
                gt.append({"image_id": i, "category_id": int(label) + 1, "iscrowd": 0,
                           "bbox": [x1, y1, x2 - x1, y2 - y1], "area": float(rle.area(m)),
                           "segmentation": m})
    dataset = in_memory_dataset(split, write_ann(os.path.join(directory, "nano_mask.json"),
                                                 frames, classes, gt), frames)
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    card = init_detector(cfg, path, device=dev)
    got = single_device_test(card, dataset, batch_size=2, with_masks=True, device=dev)
    box_err, score_err = match_detections(got, ref, 1e-3, 1e-4, "9c nano Mask R-CNN card vs CPU")
    m_cpu = dataset.evaluate(ref, metric=["bbox", "segm"])
    m_card = dataset.evaluate(got, metric=["bbox", "segm"])
    diffs = {k: abs(m_card[k] - v) for k, v in m_cpu.items()}
    if max(diffs.values()) > 1e-4 or not m_cpu["segm_mAP"] > 0:
        raise AssertionError(f"9c: metrics card {m_card}, CPU {m_cpu}")
    # mask probabilities and pasted bitmaps of one batch, slot by slot
    batch = [dataset[i] for i in range(2)]
    inputs = (np.stack([b["img"] for b in batch]),
              np.array([list(b["img_shape"][:2]) for b in batch], np.float32),
              np.stack([b["scale_factor"] for b in batch]))
    det_c, probs_c = cpu.simple_test_masks(*(torch.from_numpy(a) for a in inputs))
    det_g, probs_g = card.simple_test_masks(*(torch.from_numpy(a).to(dev) for a in inputs))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    prob_err, flips, band = 0.0, 0, 0
    for i in range(2):
        mc, mg = det_c.mask[i], det_g.mask[i].cpu()
        boxes_c, boxes_g = det_c.boxes[i][mc], det_g.boxes[i].cpu()[mg]
        labels_c, labels_g = det_c.labels[i][mc], det_g.labels[i].cpu()[mg]
        if len(boxes_c) != len(boxes_g):
            raise AssertionError(f"9c: image {i} has {len(boxes_g)} detections on the card, "
                                 f"{len(boxes_c)} on the CPU")
        # each card slot's CPU partner: same label, box within 1e-3 px
        d = (boxes_g[:, None] - boxes_c[None]).abs().amax(-1)
        d[labels_g[:, None] != labels_c[None]] = float("inf")
        partner = d.argmin(1)
        if (d.gather(1, partner[:, None]) > 1e-3).any() or len(set(partner.tolist())) < len(d):
            raise AssertionError(f"9c: image {i}: card detections without a CPU partner")
        pc = probs_c[i][mc][partner]
        pg = probs_g[i][mg]
        if len(pc):
            prob_err = max(prob_err, float((pg.cpu() - pc).abs().max()))
        h, w = 64, 128
        values = paste_mask_values(pc, boxes_c[partner], h, w)
        bits_c = values >= 0.5
        bits_g = paste_masks(pg, boxes_c[partner].to(dev), h, w).cpu()
        near = (values - 0.5).abs() <= 1e-4
        flips += int(((bits_c != bits_g) & ~near).sum())
        band += int(near.sum())
    if prob_err > 1e-4 or flips:
        raise AssertionError(f"9c: mask probabilities differ by {prob_err} (tolerance 1e-4), "
                             f"{flips} pasted pixels differ outside the 1e-4 band around 0.5")
    print(f"    (c) nano Swin Mask R-CNN, f32, 8 frames of 64 x 128, card vs CPU from one .pth: "
          f"detections per image {[len(r['boxes']) for r in ref]} on both, max|box diff| "
          f"{box_err:.3g} px (tolerance 1e-3), max|score diff| {score_err:.3g} (1e-4); "
          f"mask probabilities of the first batch max|diff| {prob_err:.3g} (1e-4); pasted "
          f"bitmaps (each device's probabilities on the CPU's boxes) equal outside the 1e-4 "
          f"band around 0.5 ({band} pixels in it); on {len(gt)} ground-truth instances made "
          f"from the CPU's detections and masks: segm_mAP card {m_card['segm_mAP']:.6f}, CPU "
          f"{m_cpu['segm_mAP']:.6f}, bbox_mAP card {m_card['bbox_mAP']:.6f}, max|metric diff| "
          f"{max(diffs.values()):.3g} (tolerance 1e-4)")
    return {"box_err": box_err, "score_err": score_err, "prob_err": prob_err,
            "pixels_in_band": band, "segm_mAP": m_card["segm_mAP"],
            "max_metric_diff": max(diffs.values())}


def mask_perfect_probe(dataset):
    """9d: the 9a set's ground truth (boxes and polygon masks as RLE) as
    detections of score 1: bbox_mAP and segm_mAP 1 (within 1e-12)."""
    from panoswintransformerobjectdetection_torch.core import rle
    dets = []
    for r in dataset.records:
        anns = [a for a in r["eval_anns"] if not a["iscrowd"]]
        boxes = np.array([[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                           a["bbox"][1] + a["bbox"][3]] for a in anns], np.float32)
        dets.append({"boxes": boxes.reshape(-1, 4), "scores": np.ones(len(anns), np.float32),
                     "labels": np.array([a["category_id"] for a in anns], np.int64),
                     "masks": [rle.ann_to_rle(a["segmentation"], r["height"], r["width"])
                               for a in anns]})
    metrics = dataset.evaluate(dets, metric=["bbox", "segm"])
    if abs(metrics["segm_mAP"] - 1.0) > 1e-12 or abs(metrics["bbox_mAP"] - 1.0) > 1e-12:
        raise AssertionError(f"9d: perfect detections give {metrics}")
    print(f"    (d) perfect-mask probe on the 9a set (host): segm_mAP {metrics['segm_mAP']}, "
          f"bbox_mAP {metrics['bbox_mAP']}, segm_AR@100 {metrics['segm_AR@100']}")
    return {"segm_mAP": metrics["segm_mAP"], "bbox_mAP": metrics["bbox_mAP"]}


def mask_rcnn_path(dev, ident, counters, ra, seed):
    """Phase 9: Swin-T Mask R-CNN serving on the card; returns its record."""
    with tempfile.TemporaryDirectory() as directory:
        rec, dataset = mask_full_width(dev, ident, counters, ra, seed, directory)
        rec["nano_card_vs_cpu"] = mask_nano_card_vs_cpu(dev, seed, directory)
        rec["perfect_probe"] = mask_perfect_probe(dataset)
    return rec


MASK_TRAIN_CONFIG = ("configs/swin/"
                     "mask_rcnn_swin_tiny_patch4_window7_mstrain_480-800_adamw_1x_coco.py")
MASK_TRAIN_FRAMES, MASK_TRAIN_BATCH = 8, 2
# A step of Swin-T Mask R-CNN: K3 once at 7 (the bbox head) and once at 14
# (the mask head), forward and backward, each through its bf16 entry.
MASK_TRAIN_BY_ENTRY = {"forward": {("roi_align_bf16_launch", 7): 1,
                                   ("roi_align_bf16_launch", 14): 1},
                       "backward": {("roi_align_backward_bf16_launch", 7): 1,
                                    ("roi_align_backward_bf16_launch", 14): 1}}


class MaskLoopRecord(LoopRecord):
    """`LoopRecord`, and K3's launches of each step by (entry, bins a side),
    forward and backward, the counts set to empty just before the step and
    read just after."""

    def __init__(self, counters, ra):
        super().__init__(counters)
        self.ra, self.by_entry = ra, []

    def _counted(self, fn, into):
        self.ra.roi_align.launches_by_entry = {}
        self.ra.roi_align_backward.launches_by_entry = {}
        out = super()._counted(fn, into)
        self.by_entry.append({"forward": dict(self.ra.roi_align.launches_by_entry),
                              "backward": dict(self.ra.roi_align_backward.launches_by_entry)})
        return out


def by_entry_text(counts):
    return ", ".join(f"{entry} at {o}: {n}" for (entry, o), n in sorted(counts.items()))


def write_trained_like_pth(model, directory, seed):
    """`flagship.init_weights(model, seed)`, then every bias and every
    LayerNorm's shift N(0, 0.02) and scale 1 + N(0, 0.1) from `seed`,
    written as a reference checkpoint.  With `init_weights`' zero biases,
    the tokens of a window that is all padding stay exactly 0 through every
    Swin block, each LayerNorm there divides by sqrt(eps), and the gradient
    grows by about 316 a LayerNorm (a gradient norm of 1e18 after 8 of them
    at a tiny width on the CPU, more than float32 holds at Swin-T's depth);
    a trained model has no such zeros."""
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    init_weights(model, seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".bias"):
                p.add_(torch.randn(p.shape, generator=g) * 0.02)
            elif "norm" in name.split(".")[-2]:
                p.add_(torch.randn(p.shape, generator=g) * 0.1)
    path = os.path.join(directory, f"trained_like_{seed}.pth")
    torch.save({"state_dict": model.state_dict()}, path)
    return path


def mask_train_full_width(dev, ident, counters, ra, seed, directory):
    """10a: the Swin-T Mask R-CNN mstrain config in bf16 through
    `train_detector` and its own `train_pipeline`, from weights with nonzero
    biases (`write_trained_like_pth`); returns the record and the mask RoIs
    (and map shapes) that the first step pooled at 14."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.apis.train import train_detector
    from panoswintransformerobjectdetection_torch.data.datasets import CocoDataset
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(MASK_TRAIN_CONFIG)
    cfg["model"]["compute_dtype"] = "bfloat16"
    classes = CocoDataset.CLASSES
    rng = np.random.default_rng(seed + 10)
    frames = (rng.random((MASK_TRAIN_FRAMES, 480, 640, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, "mask_train.json"), frames, classes,
                         polygon_annotations(rng, MASK_TRAIN_FRAMES, 480, 640, len(classes)))
    dataset = in_memory_dataset(dict(cfg["data"]["train"], classes=classes), ann_file, frames)
    steps = [p["type"] for p in cfg["data"]["train"]["pipeline"]]
    model = build_detector_from_cfg(cfg)
    path = write_trained_like_pth(model, directory, seed)
    captured, roi_features = [], model.roi_features

    def capture(feats, rois, out_size=7):
        if out_size == 14 and not captured:
            captured.append((rois.detach().clone(), [tuple(f.shape) for f in feats[:4]]))
        return roi_features(feats, rois, out_size)

    model.roi_features = capture
    record = MaskLoopRecord(counters, ra)
    opt, sched = cfg["optimizer"], cfg["lr_config"]
    torch.cuda.reset_peak_memory_stats()
    train_detector(model, dataset, work_dir=os.path.join(directory, "mask_train"),
                   total_epochs=1,
                   batch_size=MASK_TRAIN_BATCH, base_lr=opt["lr"],
                   weight_decay=opt["weight_decay"], warmup_iters=sched["warmup_iters"],
                   decay_epochs=sched["step"], log_interval=1, seed=seed, hooks=[record],
                   device=dev, stage=record.stage, num_workers=2, load_from=path)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.roi_features = roi_features
    breakdown = mask_train_stage_times(model, dataset, dev, seed, opt)
    n_steps = MASK_TRAIN_FRAMES // MASK_TRAIN_BATCH
    per_step = {name: 0 for name in counters}
    per_step.update({"roi_align (K3)": 2, "roi_align_backward (K3 backward)": 2})
    if len(record.step_launches) != n_steps or len(record.steps) != n_steps:
        raise AssertionError(f"10a: {len(record.steps)} steps, expected {n_steps}")
    for counts, entries in zip(record.step_launches, record.by_entry):
        expect_launches(counts, per_step, "10a training step")
        if entries != MASK_TRAIN_BY_ENTRY:
            raise AssertionError(f"10a: K3's launches by entry {entries}, expected "
                                 f"{MASK_TRAIN_BY_ENTRY}")
    bad = [m for m in record.steps if not all(np.isfinite(v) for v in m.values())]
    if bad or not all(m["loss_mask"] > 0 for m in record.steps):
        raise AssertionError(f"10a: a loss is not finite or loss_mask is 0: {record.steps}")
    loop_s = sum(end - start for start, end, _ in record.epochs)
    host = {k: sum(v) * 1e3 for k, v in record.times.items()}
    step_ms = [t * 1e3 for t in record.times["step"]]
    rec = {"config": os.path.basename(MASK_TRAIN_CONFIG), "dtype": "bfloat16",
           "pipeline": steps, "frames": MASK_TRAIN_FRAMES, "batch": MASK_TRAIN_BATCH,
           "steps": n_steps, "card": ident, "images_per_s": MASK_TRAIN_FRAMES / loop_s,
           "loop_ms": loop_s * 1e3, "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms), "stage_ms": host,
           "loader_share": host["load"] / (loop_s * 1e3), "peak_memory_gib": peak,
           "losses": [{k: m[k] for k in ("loss_mask", "loss", "grad_norm")}
                      for m in record.steps],
           "stage_breakdown_ms": breakdown, "launches_step": per_step,
           "k3_launches_step_by_entry": {d: {f"{e} o={o}": n for (e, o), n in c.items()}
                                         for d, c in MASK_TRAIN_BY_ENTRY.items()},
           "launches": {name: sum(c[name] for c in record.step_launches) for name in counters},
           **{f"{d}_launches_by_size": {o: sum(n for e in record.by_entry
                                               for (_, size), n in e[d].items() if size == o)
                                        for o in (7, 14)} for d in ("forward", "backward")},
           "first_step_backward_launches_14": sum(
               n for (_, size), n in record.by_entry[0]["backward"].items() if size == 14)}
    for i, (m, sec) in enumerate(zip(record.steps, step_ms)):
        print(f"    (a) step {i + 1}: loss_mask {m['loss_mask']:.6f}, loss {m['loss']:.6f}, "
              f"grad_norm {m['grad_norm']:.6f}, {sec:.3f} ms")
    print(f"    (a) {rec['config']} (Swin-T Mask R-CNN, 80 classes, bf16, random weights with "
          f"nonzero biases from --seed): {n_steps} steps of {MASK_TRAIN_BATCH} frames of 480 x "
          f"640 through "
          f"{'/'.join(steps[1:])}: {rec['images_per_s']:.3f} images/s with the loader (2 "
          f"threads), median step {rec['median_step_ms']:.3f} ms, host ms "
          f"{{{', '.join(f'{k}: {v:.3f}' for k, v in host.items())}}}, loader share "
          f"{rec['loader_share']:.3f}, peak memory {peak:.2f} GiB; every step's K3 launches: "
          f"forward {by_entry_text(MASK_TRAIN_BY_ENTRY['forward'])}; backward "
          f"{by_entry_text(MASK_TRAIN_BY_ENTRY['backward'])}; no other kernel; card {ident}")
    print(f"    (a) where a step goes, the trained model on the loop's first batch, each stage "
          f"synchronised, median of 2 after a warm-up, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()))
    del model
    return rec, captured[0]


def mask_train_stage_times(model, dataset, dev, seed, opt):
    """Host ms of each stage of a Mask R-CNN training step (`forward_train`'s
    `MASK_TRAIN_STAGES`, then backward and optimizer), the card synchronised
    around each: 3 steps of `model` on its loader's first batch, the median
    of the last 2."""
    from panoswintransformerobjectdetection_torch.apis.train import BATCH_KEYS
    from panoswintransformerobjectdetection_torch.data.loader import DetDataLoader
    from panoswintransformerobjectdetection_torch.runtime.optim import make_optimizer
    from panoswintransformerobjectdetection_torch.runtime.train import make_train_step
    batch = next(iter(DetDataLoader(dataset, batch_size=MASK_TRAIN_BATCH, seed=seed,
                                    num_workers=0)))
    tensors = {k: torch.from_numpy(batch[k]).to(dev) for k in BATCH_KEYS if k in batch}
    optimizer, scheduler = make_optimizer(model, base_lr=opt["lr"],
                                          weight_decay=opt["weight_decay"])
    step = make_train_step(model, optimizer, scheduler)
    times = {}
    for i in range(3):
        step(tensors, generator=torch.Generator().manual_seed(seed + i),
             stage=stage_timer(times if i else {}))
    return {k: statistics.median(v) * 1e3 for k, v in times.items()}


def mask_train_nano_card_vs_cpu(dev, ra):
    """10b: a nano Swin Mask R-CNN in f32, TF32 off: one `forward_train`
    with masks and its backward on the card (kernels; K3's backward at 14
    through the f32 entry) and on the CPU (plain versions), the same weights,
    batch and sampler noise (one CPU generator seed).  Tolerances: losses
    1e-4 relative; each gradient 1e-5 + 2e-3 * max|g|, as
    `train_reference_check` holds the flagship's (f32 sums in another order
    through every layer, and cuDNN's and cuBLAS's own algorithms)."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    cfg = {"model": dict(NANO_MASK_MODEL, train_cfg={
        "rpn": {"pos_iou_thr": 0.7, "neg_iou_thr": 0.3, "min_pos_iou": 0.3, "num_samples": 64,
                "pos_fraction": 0.5},
        "rpn_proposal": {"nms_pre": 128, "max_per_img": 32, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
        "rcnn": {"pos_iou_thr": 0.5, "neg_iou_thr": 0.5, "min_pos_iou": 0.5, "num_samples": 32,
                 "pos_fraction": 0.25}})}
    masks = torch.zeros((2, 3, 64, 128), dtype=torch.uint8)
    boxes = torch.tensor([[[4., 2., 44., 34.], [30., 10., 90., 60.], [70., 4., 124., 40.]]] * 2)
    for g, (x1, y1, x2, y2) in enumerate(boxes[0].long().tolist()):
        masks[:, g, y1:y2, x1:x2] = 1
        masks[:, g, y1 + (y2 - y1) // 3:y2 - (y2 - y1) // 3, x1:x1 + (x2 - x1) // 2] = 0
    rng = np.random.default_rng(6)
    batch = {"images": torch.from_numpy(rng.standard_normal((2, 64, 128, 3)).astype(np.float32)),
             "img_shapes": torch.tensor([[64., 128.], [64., 128.]]), "gt_boxes": boxes,
             "gt_labels": torch.tensor([[0, 3, 4], [1, 2, 0]]),
             "gt_valid": torch.ones(2, 3, dtype=torch.bool), "gt_masks": masks}
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    outs, grads = {}, {}
    for where in (dev, torch.device("cpu")):
        model = build_detector_from_cfg(cfg)
        init_weights(model, 3)
        model.to(where).train()
        ra.roi_align_backward.launches_by_entry = {}
        out = model.forward_train(**{k: v.to(where) for k, v in batch.items()},
                                  generator=torch.Generator().manual_seed(7))
        sum(v for k, v in out.items() if "loss" in k).backward()
        outs[where.type] = {k: float(v.detach()) for k, v in out.items()}
        grads[where.type] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        if where.type == "cuda":
            entries = dict(ra.roi_align_backward.launches_by_entry)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    want = {("roi_align_backward_launch", 7): 1, ("roi_align_backward_launch", 14): 1}
    if entries != want:
        raise AssertionError(f"10b: K3's backward launched {entries}, expected {want}")
    loss_err = max(abs(outs["cuda"][k] - v) / max(abs(v), 1e-6) for k, v in outs["cpu"].items())
    if loss_err > 1e-4 or not outs["cpu"]["loss_mask"] > 0:
        raise AssertionError(f"10b: card {outs['cuda']}, CPU {outs['cpu']}")
    worst = (0.0, "")
    for name, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        err = float((grads["cuda"][name] - ref).abs().max())
        worst = max(worst, (err / max(scale, 1e-30), name))
        if not err <= 1e-5 + 2e-3 * scale:
            raise AssertionError(f"10b: gradient of {name}: card against CPU {err}, max|g| "
                                 f"{scale}")
    print(f"    (b) nano Swin Mask R-CNN, f32, TF32 off, 2 frames of 64 x 128 with 3 masks "
          f"each: card vs CPU losses within {loss_err:.3g} relative (tolerance 1e-4; loss_mask "
          f"card {outs['cuda']['loss_mask']:.7f}, CPU {outs['cpu']['loss_mask']:.7f}); "
          f"{len(grads['cpu'])} gradients within 1e-5 + 2e-3 * max|g| (worst "
          f"{worst[0]:.3g} of max|g|, {worst[1]}); K3's backward on the card "
          f"{by_entry_text(entries)}: ok")
    return {"loss_rel_err": loss_err, "worst_grad_rel_err": worst[0], "worst_grad": worst[1],
            "backward_by_entry": {f"{e} o={o}": n for (e, o), n in entries.items()}}


def kernel_k3_backward_mask(dev, ra, sampled):
    """K3's backward at 14 x 14 bins, both entries against autograd through
    the twin (`roi_align_backward_plain`) and timed, on 2 x 128 random RoIs
    over the four FPN levels of an 800 x 1088 batch (C = 256) and on the
    RoIs that 10a's first step pooled for its mask head (on its own maps'
    shapes).  Tolerance: f32 1e-5 * max(1, max|ref|) (atomic adds in any
    order); bf16 2 units of 2**-8 * max|ref| (each pixel's f32 sum rounded
    once, after adds in another order); the bf16 entry the same bits on two
    launches.  Returns the bf16 and the f32 records."""
    strides = (4, 8, 16, 32)
    C, o = 256, 14
    rng = np.random.default_rng(32)
    random_rois = rpn_like_rois(rng, 128, *MASK_FRAME).to(dev)
    sets = {"random": (random_rois, [(B, MASK_FRAME[0] // s, MASK_FRAME[1] // s, C)
                                     for s in strides]),
            "sampled": (sampled[0].float().contiguous(), sampled[1])}
    bf16, f32 = {}, {}
    for label, (rois, shapes) in sets.items():
        cot = torch.from_numpy(rng.standard_normal((rois.shape[0], o, o, C)).astype(np.float32))
        cot = cot.to(dev)
        times = k3_backward_times(ra, rois, cot.bfloat16(), shapes, strides)
        bf16[label] = times
        got = ra.roi_align_backward(cot, rois, shapes, torch.float32, strides)
        entry = ra.roi_align_backward.last_entry
        ref = ra.roi_align_backward_plain(cot, rois, shapes, torch.float32, strides)
        err = 0.0
        for level, (a, b) in enumerate(zip(got, ref)):
            scale = float(b.abs().max())
            err = max(err, check(f"K3 backward o=14 f32 level {level}, {label} RoIs, entry "
                                 f"{entry}", a, b, 1e-5 * max(1.0, scale)))
        del got, ref
        ms = time_ms(lambda: ra.roi_align_backward(cot, rois, shapes, torch.float32, strides),
                     20)
        plain_ms = time_ms(lambda: ra.roi_align_backward_plain(cot, rois, shapes,
                                                               torch.float32, strides), 2)
        nbytes = 4 * (cot.numel() + sum(int(np.prod(s)) for s in shapes)) + rois.numel() * 4
        ops = rois.shape[0] * o * o * C * (16 + 4) * 2
        f32[label] = {"rois": rois.shape[0], "rois_by_level": times["rois_by_level"],
                      "entry": entry, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3,
                      "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
                      else "operations"}
        b, f = bf16[label], f32[label]
        print(f"  K3 backward o=14, {label} RoIs ({b['rois']}, by level {b['rois_by_level']}, "
              f"maps {shapes[0][1]} x {shapes[0][2]} and coarser): bf16 owner-computes "
              f"{b['ms']:.4f} ms ({b['bound_ms'] / b['ms']:.3f} of its {b['bound_ms']:.4f} ms "
              f"bound, {b['bound_by']}), bit-equal on two launches; the first version at bf16 "
              f"with zeroing and cast {b['previous_ms']:.4f} ms; f32 entry {f['ms']:.4f} ms "
              f"(bound {f['bound_ms']:.4f} ms); autograd through the twin bf16 "
              f"{b['plain_ms']:.4f} ms, f32 {f['plain_ms']:.4f} ms; no single PyTorch call "
              f"computes it")
    common = {"route": "cuda",
              "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
              "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align.py:356",
              "shares_kernel_of": "roi_align_backward (K3 backward)", "out_size": o,
              "library_ms": None}
    keys = ("entry", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    return [dict(common, name="roi_align_backward o=14 bf16 (K3 backward)",
                 previous_ms=bf16["random"]["previous_ms"], bitwise_repeatable=True,
                 **{k: bf16["random"][k] for k in keys}, roi_sets=bf16),
            dict(common, name="roi_align_backward o=14 f32 (K3 backward)",
                 **{k: f32["random"][k] for k in keys}, roi_sets=f32)]


def mask_training_path(dev, ident, counters, ra, seed):
    """Phase 10: Swin-T Mask R-CNN training on the card; returns its record
    and the two records of K3's backward at 14."""
    with tempfile.TemporaryDirectory() as directory:
        rec, sampled = mask_train_full_width(dev, ident, counters, ra, seed, directory)
    rec["nano_card_vs_cpu"] = mask_train_nano_card_vs_cpu(dev, ra)
    kernels = kernel_k3_backward_mask(dev, ra, sampled)
    kernels[0]["launches"] = rec["backward_launches_by_size"][14]
    # the launches of 10a's loop that pooled the sampled RoIs: its first step's
    kernels[1]["launches"] = rec["first_step_backward_launches_14"]
    return rec, kernels


def k3_on_cascade_rois(model, inputs, ra, what):
    """K3 against its twin (exact) on the RoIs of the cascade's last stage
    (refined, clipped boxes) at 7 and of its detections at 14."""
    captured = captured_roi_inputs(model, inputs)
    if [o for _, _, o in captured] != [7, 7, 7, 14]:
        raise AssertionError(f"{what}: K3 pooled at {[o for _, _, o in captured]}")
    errs = {}
    for (feats, rois, o), label in ((captured[2], "last stage"), (captured[3], "detections")):
        errs[o] = check(f"{what}: K3 o={o} {str(feats[0].dtype)[6:]} on the {rois.shape[0]} "
                        f"RoIs of the {label}, against the twin",
                        ra.roi_align(feats, rois, model.featmap_strides, o),
                        ra.roi_align_plain(feats, rois, model.featmap_strides, o), 0.0)
    return errs


def cascade_full_width(dev, ident, counters, ra, seed, directory):
    """11a: the Swin-S Cascade Mask R-CNN 3x config at full width in bf16
    from a seed-0 reference `.pth`: the eval loop, its launches, a
    synchronised breakdown of `simple_test_masks` by stage, K3 on the
    cascade's own RoIs.  Returns the record and the dataset."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.apis.test import (MASK_EVAL_STAGES,
                                                                    single_device_test)
    from panoswintransformerobjectdetection_torch.models.cascade import CASCADE_MASK_STAGES
    cfg = mask_config(path=CASCADE_CONFIG)
    path = write_reference_pth(cfg, directory, 0)
    dataset = polygon_dataset(cfg, directory, seed + 11, "cascade.json", "11a")
    n_batches = MASK_FRAMES // 2
    model = init_detector(cfg, path, device=dev)
    single_device_test(model, dataset, batch_size=2, with_masks=True, device=dev)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    results, loop_s, times, launches, by_size = mask_pass(model, dataset, dev, counters, ra)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check_mask_launches(launches, by_size, n_batches, ra.ENTRIES[torch.bfloat16], ra, "11a",
                        at_7=3)
    check_mask_results(results, MASK_FRAMES, "11a")
    per_batch = [sum(times[s][i] for s in MASK_EVAL_STAGES) for i in range(n_batches)]
    host = {s: sum(times[s]) * 1e3 for s in MASK_EVAL_STAGES}
    t1 = time.perf_counter()
    metrics = dataset.evaluate(results, metric=["bbox", "segm"])
    evaluate_ms = (time.perf_counter() - t1) * 1e3
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"11a: metrics not finite: {bad}")
    inputs = first_batch(dataset, dev)
    stage_times = {}
    for i in range(3):
        model.simple_test_masks(*inputs, stage=stage_timer(stage_times if i else {}))
    request_ms = {k: statistics.median(stage_times[k]) * 1e3 for k in CASCADE_MASK_STAGES}
    errs = k3_on_cascade_rois(model, inputs, ra, "11a")
    rec = {"config": CASCADE_CONFIG, "dtype": "bfloat16", "frames": MASK_FRAMES, "batch": 2,
           "score_thr": MASK_SCORE_THR, "images_per_s": MASK_FRAMES / loop_s,
           "loop_ms": loop_s * 1e3, "median_batch_ms": statistics.median(per_batch) * 1e3,
           "stage_ms": host, "request_stage_ms": request_ms, "peak_gib": peak,
           "launches": launches, "k3_launches_by_size": by_size,
           "detections": sum(len(r["boxes"]) for r in results), "evaluate_ms": evaluate_ms,
           "bbox_mAP": metrics["bbox_mAP"], "segm_mAP": metrics["segm_mAP"],
           "k3_err_on_cascade_rois": errs}
    print(f"    (a) {os.path.basename(CASCADE_CONFIG)} (Swin-S 2-2-18-2, three Shared2FC "
          f"stages, 80 classes, bf16, seed-0 weights from a reference .pth, score_thr "
          f"{MASK_SCORE_THR}): {MASK_FRAMES} frames of 480 x 640 (800 x 1067, padded to 800 x "
          f"1088), batch 2, after a warm-up pass: {rec['images_per_s']:.3f} eval images/s "
          f"({loop_s * 1e3:.3f} ms for the loop), median batch {rec['median_batch_ms']:.3f} "
          f"ms; host ms over the loop: " + ", ".join(f"{s} {v:.3f}" for s, v in host.items())
          + "; one synchronised simple_test_masks of the first batch by stage (median of 2, "
          "ms): " + ", ".join(f"{s} {v:.3f}" for s, v in request_ms.items())
          + f"; peak memory {peak:.2f} GiB; launches {launches}, K3 by size {by_size}; "
          f"{rec['detections']} detections; evaluate (bbox, segm) {evaluate_ms:.3f} ms, every "
          f"metric finite, bbox_mAP {metrics['bbox_mAP']:.6f}, segm_mAP "
          f"{metrics['segm_mAP']:.6f}; card {ident}")
    return rec, dataset


def cascade_giou_requests(dev, ident, counters, ra, dataset):
    """11b: the Swin-B GIoU 4conv1f config (its `train_cfg` asks for the GIoU
    loss, which serving does not read) at full width in bf16, random weights
    from seed 0: 1 warm-up and `CASCADE_REQUESTS` timed `simple_test_masks`
    requests on the first two frames of the 11a set, each with the launch
    counts set to 0 just before it and read just after."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    model = init_detector(mask_config(path=CASCADE_GIOU_CONFIG), seed=0, device=dev)
    heads = {type(h).__name__ for h in model.roi_head.bbox_head}
    if heads != {"Shared4Conv1FCBBoxHead"} or len(model.roi_head.bbox_head) != 3:
        raise AssertionError(f"11b: the config built bbox heads {heads}")
    inputs = first_batch(dataset, dev)
    model.simple_test_masks(*inputs)                                # warm-up
    torch.cuda.reset_peak_memory_stats()
    latencies, total = [], {}
    for _ in range(CASCADE_REQUESTS):
        for fn in counters.values():
            fn.launches = 0
        ra.roi_align.launches_by_entry = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det, probs = model.simple_test_masks(*inputs)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        launches = {name: fn.launches for name, fn in counters.items()}
        by_size = {o: sum(n for (_, size), n in ra.roi_align.launches_by_entry.items()
                          if size == o) for o in ra.KERNEL_OUT_SIZES}
        check_mask_launches(launches, by_size, 1, ra.ENTRIES[torch.bfloat16], ra, "11b",
                            at_7=3)
        for o, n in by_size.items():
            total[o] = total.get(o, 0) + n
    if not (det.mask.any() and torch.isfinite(det.boxes).all() and torch.isfinite(probs).all()
            and probs.shape[-2:] == (28, 28)):
        raise AssertionError("11b: detections empty or not finite")
    rec = {"config": CASCADE_GIOU_CONFIG, "dtype": "bfloat16", "batch": 2,
           "latency_ms": [t * 1e3 for t in latencies],
           "median_ms": statistics.median(latencies) * 1e3,
           "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "k3_launches_by_size": total, "detections": int(det.mask.sum())}
    print(f"    (b) {os.path.basename(CASCADE_GIOU_CONFIG)} (Swin-B, three Shared4Conv1FC "
          f"GroupNorm stages, bf16, random weights from seed 0): {CASCADE_REQUESTS} "
          f"simple_test_masks requests of 2 frames (800 x 1088) after a warm-up: latency ms "
          f"{[round(t * 1e3, 3) for t in latencies]}, median {rec['median_ms']:.3f} ms; K3 by "
          f"size over the requests {total}, no other kernel; peak memory {rec['peak_gib']:.2f} "
          f"GiB; {rec['detections']} detections in the last; card {ident}")
    return rec


# A nano Swin Cascade Mask R-CNN with narrow Shared4Conv1FC heads (4 groups
# of 4 channels).
NANO_CASCADE_MODEL = dict(NANO_MASK_MODEL, type="CascadeMaskRCNN", bbox_head={
    "type": "Shared4Conv1FCBBoxHead", "norm_groups": 4, "conv_out_channels": 16,
    "fc_out_channels": 64})


def cascade_nano_card_vs_cpu(dev, seed, directory):
    """11c: the nano cascade in f32, TF32 off, card against CPU from one
    `.pth` on two seeded 64 x 128 frames (the second's image 60 x 120, scale
    factors 1.25): detections of equal count an image, each with a partner
    of the same label, box within 1e-3 px and score within 1e-4, and the
    partners' mask probabilities within 1e-4.  Returns the errors."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    cfg = {"model": NANO_CASCADE_MODEL}
    path = write_reference_pth(cfg, directory, 2)
    rng = np.random.default_rng(seed + 11)
    inputs = (torch.from_numpy(rng.standard_normal((2, 64, 128, 3)).astype(np.float32)),
              torch.tensor([[64.0, 128.0], [60.0, 120.0]]),
              torch.tensor([[1.0] * 4, [1.25] * 4]))
    det_c, probs_c = init_detector(cfg, path, device="cpu").simple_test_masks(*inputs)
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        det_g, probs_g = init_detector(cfg, path, device=dev).simple_test_masks(
            *(t.to(dev) for t in inputs))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    got, want = [], []
    for det, out in ((det_g, got), (det_c, want)):
        for i in range(2):
            m = det.mask[i].cpu()
            out.append({k: getattr(det, k)[i].cpu()[m].numpy()
                        for k in ("boxes", "scores", "labels")})
    box_err, score_err = match_detections(got, want, 1e-3, 1e-4, "11c nano cascade card vs CPU")
    prob_err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        # each card detection's CPU partner: same label, nearest box
        d = np.abs(g["boxes"][:, None] - w["boxes"][None]).max(-1, initial=0)
        d[g["labels"][:, None] != w["labels"][None]] = np.inf
        if len(d):
            diff = probs_g[i][det_g.mask[i]].cpu() - probs_c[i][det_c.mask[i]][d.argmin(1)]
            prob_err = max(prob_err, float(diff.abs().max()))
    if prob_err > 1e-4 or not sum(len(g["boxes"]) for g in got):
        raise AssertionError(f"11c: mask probabilities differ by {prob_err} (tolerance 1e-4), "
                             f"or no detections")
    print(f"    (c) nano Swin Cascade Mask R-CNN (Shared4Conv1FC heads), f32, TF32 off, 2 "
          f"frames of 64 x 128, card vs CPU from one .pth: detections per image "
          f"{[len(g['boxes']) for g in got]} on both, max|box diff| {box_err:.3g} px "
          f"(tolerance 1e-3), max|score diff| {score_err:.3g} (1e-4), mask probabilities "
          f"max|diff| {prob_err:.3g} (1e-4)")
    return {"box_err": box_err, "score_err": score_err, "prob_err": prob_err}


def cascade_path(dev, ident, counters, ra, seed):
    """Phase 11: Cascade Mask R-CNN serving on the card; returns its record."""
    with tempfile.TemporaryDirectory() as directory:
        rec, dataset = cascade_full_width(dev, ident, counters, ra, seed, directory)
        rec = {"11a": rec, "11b": cascade_giou_requests(dev, ident, counters, ra, dataset),
               "11c": cascade_nano_card_vs_cpu(dev, seed, directory)}
    return rec


CASCADE_TRAIN_FRAMES, CASCADE_TRAIN_BATCH = 8, 2
# A step of Cascade Mask R-CNN: K3 three times at 7 (a bbox stage each),
# forward and backward, through the bf16 entries; none at 14 (no mask loss).
CASCADE_TRAIN_BY_ENTRY = {"forward": {("roi_align_bf16_launch", 7): 3},
                          "backward": {("roi_align_backward_bf16_launch", 7): 3}}


def cascade_train_full_width(dev, ident, counters, ra, seed, directory):
    """12a: the Swin-S Cascade Mask R-CNN 3x config in bf16 through
    `train_detector` and its own `train_pipeline` (masks loaded, flip,
    multiscale resize, pad), from weights with nonzero biases
    (`write_trained_like_pth`), batch 2, 8 synthetic 480 x 640 frames with
    polygon instances from `seed`, 1 epoch of 4 steps.  Each step's K3
    launches by entry, the counts set to empty just before it and read just
    after; every loss and gradient norm finite; the mask head, which no loss
    reaches, only decayed: p0 * prod(1 - lr_k * 0.05) within 1e-6 relative
    on its weights, its biases unchanged (an Adam step, about lr_k, would
    move a weight of 0.02 by 5e-6 relative and more).  Returns the record and the RoIs
    (and map shapes) that the first step's stages 1 and 2 pooled."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.apis.train import train_detector
    from panoswintransformerobjectdetection_torch.data.datasets import CocoDataset
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    from panoswintransformerobjectdetection_torch.runtime.optim import (no_decay_mask,
                                                                        warmup_step_schedule)
    cfg = load_config(CASCADE_CONFIG)
    classes = CocoDataset.CLASSES
    rng = np.random.default_rng(seed + 12)
    frames = (rng.random((CASCADE_TRAIN_FRAMES, 480, 640, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, "cascade_train.json"), frames, classes,
                         polygon_annotations(rng, CASCADE_TRAIN_FRAMES, 480, 640, len(classes)))
    dataset = in_memory_dataset(dict(cfg["data"]["train"], classes=classes), ann_file, frames)
    steps = [p["type"] for p in cfg["data"]["train"]["pipeline"]]
    model = build_detector_from_cfg(cfg)
    path = write_trained_like_pth(model, directory, seed)
    decays = no_decay_mask(model)
    mask_head = {n: p.detach().clone() for n, p in model.named_parameters()
                 if n.startswith("roi_head.mask_head.")}
    captured, roi_features = [], model.roi_features
    by_stage, calls = {t: {"forward": 0, "backward": 0} for t in range(3)}, [0]

    def capture(feats, rois, out_size=7):
        # a step calls this once a stage, in order; K3's launches of the
        # stage are read around the call and around its autograd node
        t = calls[0] % 3
        calls[0] += 1
        if len(captured) < 3:
            captured.append((rois.detach().clone(), [tuple(f.shape) for f in feats[:4]],
                             out_size))
        before = ra.roi_align.launches
        out = roi_features(feats, rois, out_size)
        by_stage[t]["forward"] += ra.roi_align.launches - before
        node = out.grad_fn
        if node is None or "_RoIAlign" not in node.name():
            raise AssertionError(f"12a: stage {t}'s pooled features come from {node}, not K3")
        start = []
        node.register_prehook(lambda grads: start.append(ra.roi_align_backward.launches))
        node.register_hook(lambda grads_in, grads_out: by_stage[t].__setitem__(
            "backward", by_stage[t]["backward"] + ra.roi_align_backward.launches - start.pop()))
        return out

    model.roi_features = capture
    record = MaskLoopRecord(counters, ra)
    opt, sched = cfg["optimizer"], cfg["lr_config"]
    torch.cuda.reset_peak_memory_stats()
    train_detector(model, dataset, work_dir=os.path.join(directory, "cascade_train"),
                   total_epochs=1, batch_size=CASCADE_TRAIN_BATCH, base_lr=opt["lr"],
                   weight_decay=opt["weight_decay"], warmup_iters=sched["warmup_iters"],
                   decay_epochs=sched["step"], log_interval=1, seed=seed, hooks=[record],
                   device=dev, stage=record.stage, num_workers=2, load_from=path)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    model.roi_features = roi_features
    n_steps = CASCADE_TRAIN_FRAMES // CASCADE_TRAIN_BATCH
    if len(record.step_launches) != n_steps or len(record.steps) != n_steps:
        raise AssertionError(f"12a: {len(record.steps)} steps, expected {n_steps}")
    per_step = {name: 0 for name in counters}
    per_step.update({"roi_align (K3)": 3, "roi_align_backward (K3 backward)": 3})
    for counts, entries in zip(record.step_launches, record.by_entry):
        expect_launches(counts, per_step, "12a training step")
        if entries != CASCADE_TRAIN_BY_ENTRY:
            raise AssertionError(f"12a: K3's launches by entry {entries}, expected "
                                 f"{CASCADE_TRAIN_BY_ENTRY}")
    if by_stage != {t: {"forward": n_steps, "backward": n_steps} for t in range(3)}:
        raise AssertionError(f"12a: K3's launches by stage {by_stage}, expected one forward "
                             f"and one backward a stage and step")
    bad = [m for m in record.steps if not all(np.isfinite(v) for v in m.values())]
    if bad or [o for _, _, o in captured] != [7, 7, 7]:
        raise AssertionError(f"12a: a loss is not finite, or K3 pooled at "
                             f"{[o for _, _, o in captured]}: {record.steps}")
    lrs = [warmup_step_schedule(opt["lr"], sched["warmup_iters"])(k) for k in range(n_steps)]
    decay_err = 0.0
    for name, p0 in mask_head.items():
        factor = float(np.prod([1 - lr * opt["weight_decay"] for lr in lrs])) \
            if decays[name] else 1.0
        want = p0.double() * factor
        got = dict(model.named_parameters())[name].detach().double().cpu()
        err = float(((got - want).abs() / want.abs().clamp(min=1e-30)).max())
        decay_err = max(decay_err, err)
        if err > 1e-6:
            raise AssertionError(f"12a: mask head {name} is not its decay-only value "
                                 f"(relative error {err})")
    breakdown = cascade_train_stage_times(model, dataset, dev, seed, opt)
    loop_s = sum(end - start for start, end, _ in record.epochs)
    host = {k: sum(v) * 1e3 for k, v in record.times.items()}
    step_ms = [t * 1e3 for t in record.times["step"]]
    keys = [k for k in record.steps[0] if "loss" in k or k == "grad_norm"]
    rec = {"config": os.path.basename(CASCADE_CONFIG), "dtype": "bfloat16",
           "pipeline": steps, "frames": CASCADE_TRAIN_FRAMES, "batch": CASCADE_TRAIN_BATCH,
           "steps": n_steps, "card": ident,
           "images_per_s": CASCADE_TRAIN_FRAMES / loop_s, "loop_ms": loop_s * 1e3,
           "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "stage_ms": host, "loader_share": host["load"] / (loop_s * 1e3),
           "peak_memory_gib": peak, "losses": [{k: m[k] for k in keys} for m in record.steps],
           "mask_head_decay_rel_err": decay_err, "stage_breakdown_ms": breakdown,
           "launches_step": per_step,
           "k3_launches_step_by_entry": {d: {f"{e} o={o}": n for (e, o), n in c.items()}
                                         for d, c in CASCADE_TRAIN_BY_ENTRY.items()},
           "k3_launches_by_stage": by_stage,
           "launches": {name: sum(c[name] for c in record.step_launches) for name in counters}}
    for i, (m, sec) in enumerate(zip(record.steps, step_ms)):
        print(f"    (a) step {i + 1}: " + ", ".join(f"{k} {m[k]:.6f}" for k in keys)
              + f", {sec:.3f} ms")
    print(f"    (a) {rec['config']} (Swin-S 2-2-18-2, three Shared2FC stages, 80 classes, bf16, "
          f"random weights with nonzero biases from --seed): {n_steps} steps of "
          f"{CASCADE_TRAIN_BATCH} frames of 480 x 640 through {'/'.join(steps[1:])}: "
          f"{rec['images_per_s']:.3f} images/s with the loader (2 threads), median step "
          f"{rec['median_step_ms']:.3f} ms, host ms "
          f"{{{', '.join(f'{k}: {v:.3f}' for k, v in host.items())}}}, loader share "
          f"{rec['loader_share']:.3f}, peak memory {peak:.2f} GiB; every step's K3 launches: "
          f"forward {by_entry_text(CASCADE_TRAIN_BY_ENTRY['forward'])}; backward "
          f"{by_entry_text(CASCADE_TRAIN_BY_ENTRY['backward'])}; over the loop, by stage "
          f"{by_stage}; no other kernel; the mask "
          f"head decay-only within {decay_err:.3g} relative (tolerance 1e-6); card {ident}")
    print("    (a) where a step goes, the trained model on the loop's first batch, each stage "
          "synchronised, median of 2 after a warm-up, ms: "
          + ", ".join(f"{k} {v:.3f}" for k, v in breakdown.items()))
    del model
    return rec, captured[1:]


def cascade_train_stage_times(model, dataset, dev, seed, opt):
    """Host ms of each stage of a cascade training step
    (`CASCADE_TRAIN_STAGES`, then backward and optimizer), the card
    synchronised around each: 3 steps of `model` on its loader's first
    batch (a shape already seen), the median of the last 2."""
    from panoswintransformerobjectdetection_torch.models.cascade import CASCADE_TRAIN_STAGES
    from panoswintransformerobjectdetection_torch.runtime.train import STEP_STAGES
    times = mask_train_stage_times(model, dataset, dev, seed, opt)
    if list(times) != list(CASCADE_TRAIN_STAGES + STEP_STAGES):
        raise AssertionError(f"12a: a step ran the stages {list(times)}")
    return times


def cascade_train_nano_card_vs_cpu(dev, ra):
    """12b: the nano cascade (narrow Shared4Conv1FC heads) with the GIoU box
    loss at weight 10, in f32 with TF32 off: one `forward_train` and its
    backward on the card (kernels; K3's backward three times at 7 through
    the f32 entry) and on the CPU (plain versions), the same weights, batch
    and sampler noise (one CPU generator seed).  Tolerances, 10b's: losses
    1e-4 relative; each gradient 1e-5 + 2e-3 * max|g|."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    cfg = {"model": dict(NANO_CASCADE_MODEL, train_cfg={
        "rpn": {"pos_iou_thr": 0.7, "neg_iou_thr": 0.3, "min_pos_iou": 0.3, "num_samples": 64,
                "pos_fraction": 0.5},
        "rpn_proposal": {"nms_pre": 128, "max_per_img": 32, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
        "rcnn": {"pos_iou_thr": 0.5, "neg_iou_thr": 0.5, "min_pos_iou": 0.5, "num_samples": 32,
                 "pos_fraction": 0.25, "reg_loss": "giou", "reg_loss_weight": 10.0}})}
    rng = np.random.default_rng(7)
    batch = {"images": torch.from_numpy(rng.standard_normal((2, 64, 128, 3)).astype(np.float32)),
             "img_shapes": torch.tensor([[64., 128.], [60., 120.]]),
             "gt_boxes": torch.tensor([[[4., 2., 44., 34.], [30., 10., 90., 60.],
                                        [70., 4., 124., 40.]]] * 2),
             "gt_labels": torch.tensor([[0, 3, 4], [1, 2, 0]]),
             "gt_valid": torch.tensor([[True, True, True], [True, True, False]])}
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    outs, grads = {}, {}
    try:
        for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
            model = build_detector_from_cfg(cfg)
            init_weights(model, 3)
            model.to(where).train()
            ra.roi_align_backward.launches_by_entry = {}
            out = model.forward_train(**{k: v.to(where) for k, v in batch.items()},
                                      generator=torch.Generator().manual_seed(7))
            sum(v for k, v in out.items() if "loss" in k).backward()
            outs[side] = {k: float(v.detach()) for k, v in out.items()}
            grads[side] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                           if p.grad is not None}
            if side == "card":
                entries = dict(ra.roi_align_backward.launches_by_entry)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    loss_err = max(abs(outs["card"][k] - v) / max(abs(v), 1e-6) for k, v in outs["cpu"].items())
    if loss_err > 1e-4 or not outs["cpu"]["s0.loss_bbox"] > 0:
        raise AssertionError(f"12b: card {outs['card']}, CPU {outs['cpu']}")
    if set(grads["card"]) != set(grads["cpu"]) or any("mask_head" in n for n in grads["cpu"]):
        raise AssertionError("12b: the card and the CPU reached different parameters, or the "
                             "mask head got a gradient")
    worst = (0.0, "")
    for name, ref in grads["cpu"].items():
        scale = float(ref.abs().max())
        err = float((grads["card"][name] - ref).abs().max())
        worst = max(worst, (err / max(scale, 1e-30), name))
        if not err <= 1e-5 + 2e-3 * scale:
            raise AssertionError(f"12b: gradient of {name}: card against CPU {err}, max|g| "
                                 f"{scale}")
    want = {("roi_align_backward_launch", 7): 3}
    if entries != want:
        raise AssertionError(f"12b: K3's backward launched {entries}, expected {want}")
    print(f"    (b) nano Cascade Mask R-CNN (Shared4Conv1FC heads, GIoU loss at weight 10), f32, "
          f"TF32 off, 2 frames of 64 x 128: card vs CPU losses within {loss_err:.3g} relative "
          f"(tolerance 1e-4; s2.loss_bbox card {outs['card']['s2.loss_bbox']:.7f}, CPU "
          f"{outs['cpu']['s2.loss_bbox']:.7f}); {len(grads['cpu'])} gradients within 1e-5 + "
          f"2e-3 * max|g| (worst {worst[0]:.3g} of max|g|, {worst[1]}); the mask head got none; "
          f"K3's backward on the card {by_entry_text(entries)}: ok")
    return {"loss_rel_err": loss_err, "worst_grad_rel_err": worst[0], "worst_grad": worst[1],
            "backward_by_entry": {f"{e} o={o}": n for (e, o), n in entries.items()}}


def kernel_k3_backward_cascade(dev, ra, sampled):
    """12c: K3's backward at 7 x 7 bins on the RoIs that 12a's first step
    pooled at its stages 1 and 2 (the refined, unclipped boxes of the stage
    before, sampled at IoU 0.6 and 0.7), on that step's map shapes: the bf16
    entry against autograd through the twin, bit-equal on two launches, and
    timed beside its first version and the twin (`k3_backward_times`); the
    f32 entry within 1e-5 * max(1, max|ref|) of the twin, timed.  Returns a
    record for each stage's RoIs."""
    strides = (4, 8, 16, 32)
    rng = np.random.default_rng(33)
    out = []
    for t, (rois, shapes, _) in zip((1, 2), sampled):
        rois = rois.float().contiguous()
        cot = torch.from_numpy(rng.standard_normal((rois.shape[0], 7, 7, 256)).astype(
            np.float32)).to(dev)
        b = k3_backward_times(ra, rois, cot.bfloat16(), shapes, strides)
        got = ra.roi_align_backward(cot, rois, shapes, torch.float32, strides)
        entry = ra.roi_align_backward.last_entry
        ref = ra.roi_align_backward_plain(cot, rois, shapes, torch.float32, strides)
        f32_err = 0.0
        for level, (a, r) in enumerate(zip(got, ref)):
            f32_err = max(f32_err, check(f"K3 backward o=7 f32 level {level}, stage-{t} RoIs, "
                                         f"entry {entry}", a, r,
                                         1e-5 * max(1.0, float(r.abs().max()))))
        del got, ref
        f32_ms = time_ms(lambda: ra.roi_align_backward(cot, rois, shapes, torch.float32,
                                                       strides), 20)
        f32_plain = time_ms(lambda: ra.roi_align_backward_plain(cot, rois, shapes, torch.float32,
                                                                strides), 2)
        print(f"  K3 backward o=7, the {b['rois']} stage-{t} RoIs of 12a's first step (by level "
              f"{b['rois_by_level']}, maps {shapes[0][1]} x {shapes[0][2]} and coarser): bf16 "
              f"owner-computes {b['ms']:.4f} ms ({b['bound_ms'] / b['ms']:.3f} of its "
              f"{b['bound_ms']:.4f} ms bound, {b['bound_by']}), bit-equal on two launches; the "
              f"first version at bf16 with zeroing and cast {b['previous_ms']:.4f} ms; f32 entry "
              f"{f32_ms:.4f} ms; autograd through the twin bf16 {b['plain_ms']:.4f} ms, f32 "
              f"{f32_plain:.4f} ms; no single PyTorch call computes it")
        out.append({"name": f"roi_align_backward o=7 bf16, cascade stage-{t} RoIs (K3 backward)",
                    "route": "cuda",
                    "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
                    "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align.py:356",
                    "shares_kernel_of": "roi_align_backward (K3 backward)", "out_size": 7,
                    **{k: b[k] for k in ("entry", "max_abs_err", "ms", "previous_ms",
                                         "plain_ms", "bound_ms", "bound_by", "rois",
                                         "rois_by_level")},
                    "bitwise_repeatable": True, "library_ms": None,
                    "f32": {"entry": entry, "max_abs_err": f32_err, "ms": f32_ms,
                            "plain_ms": f32_plain}})
    return out


def cascade_training_path(dev, ident, counters, ra, seed):
    """Phase 12: Cascade Mask R-CNN training on the card; returns its record
    and the records of K3's backward on the refined RoIs."""
    with tempfile.TemporaryDirectory() as directory:
        rec, sampled = cascade_train_full_width(dev, ident, counters, ra, seed, directory)
    rec["nano_card_vs_cpu"] = cascade_train_nano_card_vs_cpu(dev, ra)
    kernels = kernel_k3_backward_cascade(dev, ra, sampled)
    for t, k in zip((1, 2), kernels):
        # the launches of 12a's loop that pooled stage t's RoIs
        k["launches"] = k["launches_cascade_training"] = \
            rec["k3_launches_by_stage"][t]["backward"]
    return rec, kernels


RESNET_FASTER_CONFIG = "configs/faster_rcnn/faster_rcnn_r50_fpn_1x_coco.py"
RESNET_MASK_CONFIG = "configs/mask_rcnn/mask_rcnn_r50_fpn_1x_coco.py"
RESNET_CASCADE_CONFIG = "configs/cascade_rcnn/cascade_mask_rcnn_r50_fpn_1x_coco.py"
# 13d: a caffe-style, a grouped and a RegNet backbone, card against CPU.
RESNET_CARD_VS_CPU = ("configs/faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py",
                      "configs/faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py",
                      "configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py")
RESNET_FRAMES = 16
RESNET_CASCADE_FRAME = (800, 1344)
# The RPN's and the bbox heads' regression weights are scaled by this in the
# random ResNet detectors' weights, so that their boxes stay near the
# anchors and proposals they refine (with the init's spread most are
# clipped flat at the border).
REG_SCALE = 0.05


def perturb_batch_norms(model, seed):
    """Every BatchNorm of `model` drawn away from the identity from `seed`:
    scales in [0.5, 1.5], biases and means N(0, 0.1), variances in [0.5,
    2]."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.rand(m.weight.shape, generator=g) + 0.5)
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.1)
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.1)
                m.running_var.copy_(torch.rand(m.running_var.shape, generator=g) * 1.5 + 0.5)


def write_cnn_reference_pth(config, directory, seed, name, residual_scale=1.0):
    """Random weights from `seed` for the CNN-backbone detector of `config`
    (a dict), written as a reference checkpoint with the backbone's
    `num_batches_tracked`: `flagship.init_weights`, then every BatchNorm
    drawn away from the identity (scales in [0.5, 1.5], biases and means
    N(0, 0.1), variances in [0.5, 2]) and the regression weights scaled by
    `REG_SCALE`; the scale and shift of each residual branch's last
    BatchNorm times `residual_scale` (a trained deep network's branches are
    small against the identity; with the draws above the maps of a
    101-layer Res2Net grow until its logits reach tens)."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    model = build_detector_from_cfg(config)
    init_weights(model, seed)
    perturb_batch_norms(model, seed + 1)
    with torch.no_grad():
        for key, m in model.named_modules():
            if key.endswith(("rpn_reg", "fc_reg")):
                m.weight.mul_(REG_SCALE)
        for stage in model.backbone.stages if residual_scale != 1.0 else ():
            for block in stage:
                last = block.bn3 if hasattr(block, "bn3") else block.bn2
                last.weight.mul_(residual_scale)
                last.bias.mul_(residual_scale)
    sd = model.state_dict()
    if not any(k.endswith("num_batches_tracked") for k in sd):
        raise AssertionError("the CNN detector's state dict has no num_batches_tracked")
    path = os.path.join(directory, f"{name}.pth")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}}, path)
    return path


def resnet_eval(dev, ident, counters, ra, seed, directory, config, label, with_masks, timed, *,
                frames=RESNET_FRAMES, name="ResNet-50", extra=None):
    """13a (Faster R-CNN), 13b (Mask R-CNN), and phase 17's serving: a CNN
    config in f32 as it is, from a seed-0 reference `.pth`, through
    `build_dataset` -> `DetDataLoader` -> `single_device_test` -> `evaluate`
    on `frames` synthetic 480 x 640 frames with polygon instances, at the
    config's batch: a warm-up pass, a timed pass with the launch counts set
    to 0 just before it and read just after (K3's f32 entry once a batch at
    7, and at 14 with masks; no other kernel), every metric finite; then K3's
    f32 entry against its twin on the first batch's RoIs at each size, timed
    at the sizes in `timed` (rows named after `name`); `extra(model,
    dataset)`, when given, adds its dict to the record.  Returns the record
    and the K3 records."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.apis.test import (EVAL_STAGES,
                                                                    MASK_EVAL_STAGES,
                                                                    single_device_test)
    cfg = mask_config(path=config)
    batch = cfg["data"]["samples_per_gpu"]
    path = write_cnn_reference_pth(cfg, directory, 0, label)
    model = init_detector(cfg, path, device=dev)
    dataset = polygon_dataset(cfg, directory, seed + 13, f"resnet_{label}.json", label, frames)
    single_device_test(model, dataset, batch_size=batch, with_masks=with_masks,
                       device=dev)                                      # warm-up
    times = {}
    for fn in counters.values():
        fn.launches = 0
    ra.roi_align.launches_by_entry = {}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = single_device_test(model, dataset, batch_size=batch, with_masks=with_masks,
                                 device=dev, stage=stage_timer(times))
    loop_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {name: fn.launches for name, fn in counters.items()}
    by_entry = dict(ra.roi_align.launches_by_entry)
    n_batches = frames // batch
    f32 = ra.ENTRIES[torch.float32]
    want = {(f32, 7): n_batches, **({(f32, 14): n_batches} if with_masks else {})}
    expect = {name: 0 for name in counters}
    expect["roi_align (K3)"] = sum(want.values())
    if launches != expect or by_entry != want:
        raise AssertionError(f"{label}: launches {launches}, K3 by entry {by_entry}; expected "
                             f"{expect}, {want}")
    if with_masks:
        check_mask_results(results, frames, label)
    elif len(results) != frames or not sum(len(r["boxes"]) for r in results) or not all(
            np.isfinite(r["boxes"]).all() and np.isfinite(r["scores"]).all() for r in results):
        raise AssertionError(f"{label}: results missing, empty or not finite")
    stages = MASK_EVAL_STAGES if with_masks else EVAL_STAGES
    per_batch = [sum(times[s][i] for s in stages) for i in range(n_batches)]
    host = {s: sum(times[s]) * 1e3 for s in stages}
    metric = ["bbox", "segm"] if with_masks else ["bbox"]
    t1 = time.perf_counter()
    metrics = dataset.evaluate(results, metric=metric)
    evaluate_ms = (time.perf_counter() - t1) * 1e3
    bad = {k: v for k, v in metrics.items() if not np.isfinite(v)}
    if bad:
        raise AssertionError(f"{label}: metrics not finite: {bad}")
    rec = {"config": config, "dtype": "float32", "frames": frames, "batch": batch,
           "score_thr": MASK_SCORE_THR, "images_per_s": frames / loop_s,
           "loop_ms": loop_s * 1e3, "median_batch_ms": statistics.median(per_batch) * 1e3,
           "stage_ms": host, "evaluate_ms": evaluate_ms, "peak_gib": peak,
           "launches": launches, "k3_launches_by_size": {o: n for (_, o), n in want.items()},
           "detections": sum(len(r["boxes"]) for r in results),
           **{k: metrics[k] for k in ("bbox_mAP", "segm_mAP") if k in metrics}}
    print(f"    ({label}) {os.path.basename(config)} ({name}, {type(model.neck).__name__} 256, "
          f"80 classes, f32, seed-0 weights from a reference .pth, BatchNorm away from the "
          f"identity, score_thr {MASK_SCORE_THR}): {frames} frames of 480 x 640 (800 x 1067, "
          f"padded to "
          f"800 x 1088), batch {batch}, after a warm-up pass: {rec['images_per_s']:.3f} eval "
          f"images/s ({loop_s * 1e3:.3f} ms for the loop), median batch "
          f"{rec['median_batch_ms']:.3f} ms; host ms over the loop: "
          + ", ".join(f"{s} {v:.3f}" for s, v in host.items())
          + f"; evaluate ({', '.join(metric)}) {evaluate_ms:.3f} ms, every metric finite, "
          + ", ".join(f"{k} {metrics[k]:.6f}" for k in ("bbox_mAP", "segm_mAP") if k in metrics)
          + f"; peak memory {peak:.2f} GiB; launches {launches}, K3 by entry {by_entry}; "
          f"{rec['detections']} detections; card {ident}")
    captured = captured_roi_inputs(model, first_batch(dataset, dev, batch), with_masks)
    if [o for _, _, o in captured] != [7, 14][:1 + with_masks]:
        raise AssertionError(f"{label}: K3 pooled at {[o for _, _, o in captured]}")
    kernels = []
    for feats, rois, o in captured:
        what = f"{label}: K3 o={o} f32 on the first batch's {rois.shape[0]} RoIs"
        if o in timed:
            kernels.append(k3_record(ra, feats, rois, model.featmap_strides, o,
                                     f"roi_align o={o} float32 (K3), {name} {label} RoIs",
                                     what))
        else:
            check(f"{what}, against the twin", ra.roi_align(feats, rois, model.featmap_strides, o),
                  ra.roi_align_plain(feats, rois, model.featmap_strides, o), 0.0)
    if extra is not None:
        rec.update(extra(model, dataset))
    del model
    return rec, kernels


def resnet_cascade_requests(dev, ident, counters, ra, directory, config=RESNET_CASCADE_CONFIG,
                            label="13c", requests=REQUESTS, name="ResNet-50", stage_rows=False):
    """13c (and 17a's cascade): a CNN Cascade Mask R-CNN config in bf16 as
    it is (the JAX package cannot build it), from a seed-0 reference `.pth`:
    1 warm-up and `requests` timed `simple_test_masks` requests on 2 seeded
    frames of 800 x 1344, each with the launch counts set to 0 just before
    it and read just after (K3's bf16 entry 3 times at 7 and once at 14, no
    other kernel); then the bf16 backbone's stage outputs against the same
    weights in f32 on the card (TF32 off), within the CPU test's bfloat16
    tolerance, 0.05 * max|ref| a stage.  With `stage_rows`, K3 against its
    twin and timed on each stage's RoIs at 7 and the detections' at 14 (rows
    named after `name`).  Returns the record and those rows."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    cfg = mask_config(path=config)
    if cfg["model"].get("compute_dtype") != "bfloat16":
        raise AssertionError(f"{label}: the cascade config is no longer bf16")
    path = write_cnn_reference_pth(cfg, directory, 0, label)
    model = init_detector(cfg, path, device=dev)
    h, w = RESNET_CASCADE_FRAME
    g = torch.Generator(device=dev).manual_seed(13)
    inputs = (torch.randn((2, h, w, 3), generator=g, device=dev),
              torch.tensor([[float(h), float(w)]] * 2, device=dev), torch.ones((2, 4), device=dev))
    model.simple_test_masks(*inputs)                                # warm-up
    torch.cuda.reset_peak_memory_stats()
    latencies, total = [], {}
    bf16 = ra.ENTRIES[torch.bfloat16]
    for _ in range(requests):
        for fn in counters.values():
            fn.launches = 0
        ra.roi_align.launches_by_entry = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det, probs = model.simple_test_masks(*inputs)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        launches = {name: fn.launches for name, fn in counters.items()}
        by_entry = dict(ra.roi_align.launches_by_entry)
        expect = {name: 0 for name in counters}
        expect["roi_align (K3)"] = 4
        if launches != expect or by_entry != {(bf16, 7): 3, (bf16, 14): 1}:
            raise AssertionError(f"{label}: launches {launches}, K3 by entry {by_entry}")
        for (_, o), n in by_entry.items():
            total[o] = total.get(o, 0) + n
    if not (det.mask.any() and torch.isfinite(det.boxes).all()
            and torch.isfinite(probs.float()).all() and probs.shape[-2:] == (28, 28)):
        raise AssertionError(f"{label}: detections empty or not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reference = init_detector(dict(cfg, model={k: v for k, v in cfg["model"].items()
                                               if k != "compute_dtype"}), path, device=dev)
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.no_grad():
            ref = reference.backbone(inputs[0])
            got = model.backbone(inputs[0])
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    stage_err = []
    for i, (a, b) in enumerate(zip(got, ref)):
        if a.dtype != torch.bfloat16 or b.dtype != torch.float32:
            raise AssertionError(f"{label}: backbone stage {i} is {a.dtype} against {b.dtype}")
        scale = float(b.abs().max())
        stage_err.append(check(f"{label}: bf16 backbone stage {i} against f32 (max|ref| "
                               f"{scale:.3f})", a, b, 0.05 * scale) / scale)
    rec = {"config": config, "dtype": "bfloat16", "batch": 2,
           "frame": list(RESNET_CASCADE_FRAME), "latency_ms": [t * 1e3 for t in latencies],
           "median_ms": statistics.median(latencies) * 1e3, "peak_gib": peak,
           "k3_launches_by_size": total, "detections": int(det.mask.sum()),
           "backbone_rel_err": stage_err}
    print(f"    ({label}) {os.path.basename(config)} ({name}, three Shared2FC "
          f"stages, one mask head, bf16 as the config asks, seed-0 weights from a reference "
          f".pth): {requests} simple_test_masks requests of 2 frames of {h} x {w} after a "
          f"warm-up: latency ms {[round(t * 1e3, 3) for t in latencies]}, median "
          f"{rec['median_ms']:.3f} ms, {2e3 / rec['median_ms']:.3f} images/s; K3 by size over "
          f"the requests {total}, bf16 entry, no other kernel; peak memory {peak:.2f} GiB; "
          f"{rec['detections']} detections in the last; bf16 backbone against f32 (TF32 "
          f"off) max|diff| / max|ref| by stage {[f'{e:.3g}' for e in stage_err]} (tolerance "
          f"0.05); card {ident}")
    rows = []
    if stage_rows:
        captured = captured_roi_inputs(model, inputs)
        if [o for _, _, o in captured] != [7, 7, 7, 14]:
            raise AssertionError(f"{label}: K3 pooled at {[o for _, _, o in captured]}")
        for t, (feats, rois, o) in enumerate(captured):
            what = "detections" if o == 14 else f"stage {t}"
            rows.append(k3_record(ra, feats, rois, model.featmap_strides, o,
                                  f"roi_align o={o} bfloat16 (K3), {name} cascade {what} RoIs",
                                  f"{label}: K3 o={o} bf16 on the {rois.shape[0]} RoIs of the "
                                  f"{what}"))
    del model, reference
    return rec, rows


def resnet_card_vs_cpu(dev, seed, directory):
    """13d: a caffe-style ResNet-50, a ResNeXt-101 32x4d and a RegNetX-3.2GF
    config in f32 as they are, TF32 off, at 64 x 128, card against CPU from
    one `.pth` each, on two seeded frames (the second's image 60 x 120,
    scale factors 1.25): detections of equal count an image, each with a
    partner of the same label, box within 1e-3 px and score within 1e-4
    (the card-against-CPU score tolerance of 7b, 9c and 11c: f32 sums in
    another order through the ResNeXt-101's 33 blocks move a score by about
    7e-6), and the Mask R-CNN's partners' mask probabilities within 1e-4."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    rng = np.random.default_rng(seed + 14)
    inputs = (torch.from_numpy(rng.standard_normal((2, 64, 128, 3)).astype(np.float32)),
              torch.tensor([[64.0, 128.0], [60.0, 120.0]]),
              torch.tensor([[1.0] * 4, [1.25] * 4]))
    records = {}
    for config in RESNET_CARD_VS_CPU:
        cfg = load_config(config)
        name = os.path.basename(config)
        path = write_cnn_reference_pth(cfg, directory, 1, name[:-3])
        masks = cfg["model"]["type"] == "MaskRCNN"

        def run(where):
            model = init_detector(cfg, path, device=where)
            args = [t.to(where) for t in inputs]
            return model.simple_test_masks(*args) if masks else (model.simple_test(*args), None)

        det_c, probs_c = run("cpu")
        defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            det_g, probs_g = run(dev)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
        got, want = [], []
        for det, out in ((det_g, got), (det_c, want)):
            for i in range(2):
                m = det.mask[i].cpu()
                out.append({k: getattr(det, k)[i].cpu()[m].numpy()
                            for k in ("boxes", "scores", "labels")})
        box_err, score_err = match_detections(got, want, 1e-3, 1e-4, f"13d {name}")
        prob_err = 0.0
        for i, (g, w) in enumerate(zip(got, want) if masks else ()):
            d = np.abs(g["boxes"][:, None] - w["boxes"][None]).max(-1, initial=0)
            d[g["labels"][:, None] != w["labels"][None]] = np.inf
            if len(d):
                diff = probs_g[i][det_g.mask[i]].cpu() - probs_c[i][det_c.mask[i]][d.argmin(1)]
                prob_err = max(prob_err, float(diff.abs().max()))
        n = [len(g["boxes"]) for g in got]
        if prob_err > 1e-4 or not sum(n):
            raise AssertionError(f"13d {name}: mask probabilities differ by {prob_err} "
                                 f"(tolerance 1e-4), or no detections ({n})")
        records[name] = {"detections": n, "box_err": box_err, "score_err": score_err,
                         **({"prob_err": prob_err} if masks else {})}
        print(f"    (d) {name}, f32, TF32 off, 2 frames of 64 x 128, card vs CPU from one "
              f".pth: detections per image {n} on both, max|box diff| {box_err:.3g} px "
              f"(tolerance 1e-3), max|score diff| {score_err:.3g} (1e-4)"
              + (f", mask probabilities max|diff| {prob_err:.3g} (1e-4)" if masks else ""))
    return records


def resnet_path(dev, ident, counters, ra, seed):
    """Phase 13: the ResNet-family detectors' serving on the card; returns
    its record and the K3 records of 13a and 13b's RoIs."""
    with tempfile.TemporaryDirectory() as directory:
        faster, k3_faster = resnet_eval(dev, ident, counters, ra, seed, directory,
                                        RESNET_FASTER_CONFIG, "13a", False, (7,))
        mask, k3_mask = resnet_eval(dev, ident, counters, ra, seed, directory,
                                    RESNET_MASK_CONFIG, "13b", True, (14,))
        rec = {"13a": faster, "13b": mask,
               "13c": resnet_cascade_requests(dev, ident, counters, ra, directory)[0],
               "13d": resnet_card_vs_cpu(dev, seed, directory)}
    return rec, k3_faster + k3_mask


RESNET_TRAIN_MASK_CONFIG = "configs/gcnet/mask_rcnn_r50_fpn_syncbn-backbone_1x_coco.py"
RESNET_TRAIN_FRAMES, RESNET_TRAIN_BATCH = 8, 2
# 14d: one `forward_train` of a detector on each backbone, card against CPU
# (config, backbone options, `write_cnn_reference_pth`'s residual_scale).
# Unscaled, the random Res2Net-101's logits reach 45 and its f32 loss_cls
# agreed card against CPU to 4.5e-4 only (NVIDIA H100 80GB HBM3, 700 W);
# its residual branches scaled by 0.2, its logits stay near a trained network's
# (loss_cls 4.9 against log(81) = 4.4) and a 1e-7 relative change of the
# input moves its losses by 1e-7 on the CPU.
RESNET_TRAIN_CARD_VS_CPU = (
    ("configs/faster_rcnn/faster_rcnn_r50_caffe_fpn_1x_coco.py",
     {"norm_eval": False, "frozen_stages": 1}, 1.0),
    ("configs/faster_rcnn/faster_rcnn_x101_32x4d_fpn_1x_coco.py", {}, 1.0),
    ("configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py", {}, 1.0),
    ("configs/res2net/faster_rcnn_r2_101_fpn_2x_coco.py", {}, 0.2),
    ("configs/resnest/faster_rcnn_s50_fpn_1x_coco.py", {}, 1.0))
RES2NET_SERVE_CONFIG = "configs/res2net/faster_rcnn_r2_101_fpn_2x_coco.py"
RESNEST_SERVE_CONFIG = "configs/resnest/faster_rcnn_s50_fpn_1x_coco.py"
RESNEST_TRAIN_CONFIG = ("configs/resnest/"
                        "mask_rcnn_s50_fpn_syncbn-backbone+head_mstrain_1x_coco.py")
# 14c: the bf16 cascade's losses against its own f32 step on the same batch,
# weights and noise.  bf16 keeps 8 bits: the backbone's stages differ from
# f32 by about 1e-2 of their largest value (13c), the RPN's scores by as
# much, so its top-k proposals, and with them the sampled RoIs and their
# targets, can differ; each loss is a mean over the sampled slots.
CASCADE_BF16_LOSS_REL, CASCADE_BF16_ACC_ABS = 0.1, 0.1


def train_config(path, dtype=None, masks=False):
    """A config for a training run on the card: its compute type set when
    given; with `masks`, its train pipeline's `LoadAnnotations` loads the
    instances' masks too (the repo's R-50 and ResNeSt Mask R-CNN configs load
    boxes only, as the JAX package would train them, without a mask loss;
    the reference's `coco_instance` pipeline loads masks)."""
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(path)
    if dtype:
        cfg["model"]["compute_dtype"] = dtype
    if masks:
        cfg["data"]["train"]["pipeline"] = [
            dict(p, with_mask=True) if p["type"] == "LoadAnnotations" else p
            for p in cfg["data"]["train"]["pipeline"]]
    return cfg


class ResNetLoopRecord(MaskLoopRecord):
    """`MaskLoopRecord`, and with `bn_model` each step's check of the first
    BatchNorm's running statistics: one momentum step towards the batch
    statistics of the step's input to it (`layers.batch_norm_train` on a
    copy, recomputed from the batch and the step's own conv1 weights), and
    `num_batches_tracked` one more; with `model`, the names of its
    parameters whose gradient was nonzero in some step (`reached`: those
    that a loss reaches in this run)."""

    def __init__(self, counters, ra, bn_model=None, model=None):
        super().__init__(counters, ra)
        self.bn_model, self.batch, self.bn_err = bn_model, None, []
        self.model, self.reached = model, set()

    def stage(self, name, fn):
        if name == "copy":
            def keep():
                self.batch = fn()
                return self.batch
            return super().stage(name, keep)
        if name != "step":
            return super().stage(name, fn)
        out = self.bn_checked(name, fn) if self.bn_model is not None else super().stage(name, fn)
        if self.model is not None:
            self.reached |= {k for k, p in self.model.named_parameters()
                             if p.grad is not None and bool(p.grad.ne(0).any())}
        return out

    def bn_checked(self, name, fn):
        import copy
        from panoswintransformerobjectdetection_torch.models.layers import batch_norm_train, conv
        bb = self.bn_model.backbone
        want = copy.deepcopy(bb.bn1)
        with torch.no_grad():
            batch_norm_train(want, conv(bb.conv1, self.batch["images"].permute(0, 3, 1, 2),
                                        bb.dtype))
        out = super().stage(name, fn)
        err = 0.0
        for key in ("running_mean", "running_var"):
            got, ref = getattr(bb.bn1, key), getattr(want, key)
            err = max(err, float((got - ref).abs().max()) / max(1.0, float(ref.abs().max())))
        if err > 1e-5 or int(bb.bn1.num_batches_tracked) != int(want.num_batches_tracked):
            raise AssertionError(f"14b: bn1's running statistics are not one momentum step "
                                 f"towards the batch's (relative error {err}), or "
                                 f"num_batches_tracked {int(bb.bn1.num_batches_tracked)} != "
                                 f"{int(want.num_batches_tracked)}")
        self.bn_err.append(err)
        return out


def resnet_train_loop(dev, ident, counters, ra, seed, directory, config, label, by_entry, *,
                      dtype=None, masks=False, frames=RESNET_TRAIN_FRAMES, warmup=1,
                      bn_check=False, capture=False, unreached=lambda key: False):
    """A ResNet-family config through `train_detector` and its own train
    pipeline after `FramesFromMemory`, from a reference `.pth` of random
    weights (`write_cnn_reference_pth`, `load_from`): `frames` synthetic 480
    x 640 frames with polygon instances from `seed`, batch 2, one epoch,
    the first `warmup` steps untimed.  Each step's K3 launches by entry, the
    counts set to empty just before it and read just after, must be
    `by_entry`, and no other kernel may launch; every loss finite; with
    `norm_eval` every running statistic and `num_batches_tracked` as loaded,
    else `num_batches_tracked` one more a step (`bn_check`: bn1's statistics
    one momentum step a step, `ResNetLoopRecord`); every parameter whose
    gradient was nonzero in some step moved, and those for which
    `unreached(key)` holds (which no loss may reach) kept a zero gradient
    and did not move; a parameter that no loss reached is one of those, of
    a mask head, or of HRFPN's stride-64 level (which serves only the
    anchors that a step's 256 RPN samples may all miss).  Returns the
    record, the launches by (direction, entry, size) and, with `capture`
    (True for 7, or the bins), the RoIs, map shapes and maps that the first
    step pooled at that size."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.apis.train import train_detector
    from panoswintransformerobjectdetection_torch.data.datasets import CocoDataset
    cfg = train_config(config, dtype, masks)
    classes = CocoDataset.CLASSES
    rng = np.random.default_rng(seed + 140 + sum(map(ord, label)))
    arrays = (rng.random((frames, 480, 640, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, f"{label}.json"), arrays, classes,
                         polygon_annotations(rng, frames, 480, 640, len(classes)))
    dataset = in_memory_dataset(dict(cfg["data"]["train"], classes=classes), ann_file, arrays)
    model = build_detector_from_cfg(cfg)
    path = write_cnn_reference_pth(cfg, directory, seed, label)
    start = {k[len("module."):]: v for k, v in
             torch.load(path, weights_only=True)["state_dict"].items()}
    captured, roi_features = [], model.roi_features
    if capture:
        def pool(feats, rois, out_size=7):
            if out_size == (7 if capture is True else capture) and not captured:
                captured.append((rois.detach().clone(), [tuple(f.shape) for f in feats[:4]],
                                 [f.detach() for f in feats[:4]]))
            return roi_features(feats, rois, out_size)
        model.roi_features = pool
    record = ResNetLoopRecord(counters, ra, model if bn_check else None, model)
    opt, sched = cfg["optimizer"], cfg["lr_config"]
    torch.cuda.reset_peak_memory_stats()
    train_detector(model, dataset, work_dir=os.path.join(directory, label), total_epochs=1,
                   batch_size=RESNET_TRAIN_BATCH, base_lr=opt["lr"],
                   weight_decay=opt["weight_decay"], warmup_iters=sched["warmup_iters"],
                   decay_epochs=sched["step"], log_interval=1, seed=seed, hooks=[record],
                   device=dev, stage=record.stage, num_workers=2, load_from=path)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if capture:
        del model.roi_features
    n_steps = frames // RESNET_TRAIN_BATCH
    if len(record.step_launches) != n_steps or len(record.steps) != n_steps:
        raise AssertionError(f"{label}: {len(record.steps)} steps, expected {n_steps}")
    per_step = {name: 0 for name in counters}
    per_step["roi_align (K3)"] = sum(by_entry["forward"].values())
    per_step["roi_align_backward (K3 backward)"] = sum(by_entry["backward"].values())
    for counts, entries in zip(record.step_launches, record.by_entry):
        expect_launches(counts, per_step, f"{label} training step")
        if entries != by_entry:
            raise AssertionError(f"{label}: K3's launches by entry {entries}, expected {by_entry}")
    keys = [k for k in record.steps[0] if "loss" in k or k == "grad_norm"]
    if not all(np.isfinite(m[k]) for m in record.steps for k in keys) or (
            masks and not all(m["loss_mask"] > 0 for m in record.steps)):
        raise AssertionError(f"{label}: a loss is not finite, or no mask loss: {record.steps}")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    still = [k for k, _ in model.named_parameters()
             if (torch.equal(state[k], start[k]) and k in record.reached)
             or (unreached(k) and (k in record.reached or not torch.equal(state[k], start[k])))]
    missed = sorted(k for k, _ in model.named_parameters() if k not in record.reached)
    still += [k for k in missed if not (unreached(k) or k.startswith(
        ("roi_head.mask_head.", "neck.fpn_convs.4.")))]
    stats = [k for k in state if "running" in k or "num_batches" in k]
    live = not cfg["model"]["backbone"].get("norm_eval", True)
    moved_stats = [k for k in stats if not torch.equal(state[k], start[k])]
    nbt = {int(state[k]) - int(start[k]) for k in stats if "num_batches" in k}
    if still or (moved_stats if not live else len(moved_stats) != len(stats) or nbt != {n_steps}):
        raise AssertionError(f"{label}: parameters that did not move, moved unreached, or no "
                             f"loss reached {still[:5]}; running "
                             f"statistics moved {len(moved_stats)} of {len(stats)} "
                             f"(norm_eval {not live}), num_batches_tracked + {nbt}")
    timed = range(warmup, n_steps)
    step_ms = [record.times["step"][i] * 1e3 for i in timed]
    loop_ms = sum((record.times["load"][i] + record.times["copy"][i] + record.times["step"][i])
                  * 1e3 for i in timed)
    host = {k: sum(v[i] for i in timed) * 1e3 for k, v in record.times.items()}
    launches = {}
    for entries in record.by_entry:
        for direction, counts in entries.items():
            for (entry, o), n in counts.items():
                launches[(direction, entry, o)] = launches.get((direction, entry, o), 0) + n
    rec = {"config": config, "dtype": dtype or "float32", "backbone": cfg["model"]["backbone"],
           "pipeline": [p["type"] for p in cfg["data"]["train"]["pipeline"]],
           "masks_loaded": masks, "frames": frames, "batch": RESNET_TRAIN_BATCH,
           "steps": n_steps, "warmup_steps": warmup, "card": ident,
           "images_per_s": len(timed) * RESNET_TRAIN_BATCH / (loop_ms / 1e3),
           "loop_ms": loop_ms, "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
           "stage_ms": host, "peak_memory_gib": peak,
           "losses": [{k: m[k] for k in keys} for m in record.steps],
           "launches_step": per_step,
           "k3_launches_step_by_entry": {d: {f"{e} o={o}": n for (e, o), n in c.items()}
                                         for d, c in by_entry.items()},
           "running_statistics": "moved" if live else "unchanged",
           "parameters_no_loss_reached": missed,
           **({"bn1_momentum_step_rel_err": record.bn_err} if bn_check else {})}
    for i, m in enumerate(record.steps):
        print(f"    ({label}) step {i + 1}{' (warm-up)' if i < warmup else ''}: "
              + ", ".join(f"{k} {m[k]:.6f}" for k in keys) + f", {record.times['step'][i] * 1e3:.3f} ms")
    print(f"    ({label}) {os.path.basename(config)} ({type(model.backbone).__name__}, "
          f"{rec['dtype']}, random weights from a reference .pth, BatchNorm away from the "
          f"identity, norm_eval {not live}): {n_steps} steps of {RESNET_TRAIN_BATCH} frames of "
          f"480 x 640 through {'/'.join(rec['pipeline'][1:])}, {len(timed)} timed: "
          f"{rec['images_per_s']:.3f} images/s over the timed steps with the loader (2 "
          f"threads), median step {rec['median_step_ms']:.3f} ms, host ms "
          f"{{{', '.join(f'{k}: {v:.3f}' for k, v in host.items())}}}, peak memory "
          f"{peak:.2f} GiB; every step's K3 launches: forward "
          f"{by_entry_text(by_entry['forward'])}; backward {by_entry_text(by_entry['backward'])};"
          f" no other kernel; every parameter that a loss reached moved; no loss reached "
          f"{len(missed)} ({', '.join(missed[:4])}{' ...' if len(missed) > 4 else ''}); running "
          f"statistics {rec['running_statistics']}"
          + (f", bn1 one momentum step a step within {max(record.bn_err):.3g} (tolerance 1e-5)"
             if bn_check else "") + f"; card {ident}")
    del model
    return rec, launches, (captured[0][:2] if capture is True else captured[0] if capture
                           else None)


def cascade_bf16_against_f32(dev, seed, directory, path):
    """14c's check: one `forward_train` of the R-50 cascade in bf16 and in
    f32 (TF32 off) from the same `.pth`, on the same batch (two seeded
    frames of 800 x 1088 with 3 boxes each) and sampler noise (one CPU
    generator seed): each loss within `CASCADE_BF16_LOSS_REL` relative,
    each accuracy within `CASCADE_BF16_ACC_ABS`."""
    from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                         load_weights)
    rng = np.random.default_rng(seed + 143)
    h, w = MASK_FRAME
    batch = {"images": torch.from_numpy(rng.standard_normal((2, h, w, 3)).astype(np.float32)),
             "img_shapes": torch.tensor([[800.0, 1067.0]] * 2),
             "gt_boxes": torch.tensor([[[100., 80., 400., 380.], [500., 300., 900., 700.],
                                        [40., 500., 300., 780.]]] * 2),
             "gt_labels": torch.tensor([[0, 2, 56], [17, 3, 1]]),
             "gt_valid": torch.ones((2, 3), dtype=torch.bool)}
    outs = {}
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for dtype in ("bfloat16", None):
            cfg = train_config(RESNET_CASCADE_CONFIG)
            if dtype is None:
                cfg["model"].pop("compute_dtype")
            model = build_detector_from_cfg(cfg)
            load_weights(model, path)
            model.to(dev).train()
            with torch.no_grad():
                out = model.forward_train(**{k: v.to(dev) for k, v in batch.items()},
                                          generator=torch.Generator().manual_seed(seed))
            outs[dtype or "float32"] = {k: float(v) for k, v in out.items()}
            del model
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    err = {}
    for k, ref in outs["float32"].items():
        got = outs["bfloat16"][k]
        err[k] = abs(got - ref) if "acc" in k else abs(got - ref) / max(abs(ref), 1e-6)
        tol = CASCADE_BF16_ACC_ABS if "acc" in k else CASCADE_BF16_LOSS_REL
        if not (np.isfinite(got) and err[k] <= tol):
            raise AssertionError(f"14c: bf16 {k} {got} against f32 {ref} (tolerance {tol})")
    print(f"    (c) one forward_train of the cascade in bf16 against f32 (TF32 off), same .pth, "
          f"batch of 2 x 800 x 1088 and sampler noise: "
          + ", ".join(f"{k} {outs['bfloat16'][k]:.5f} / {v:.5f}" for k, v in outs["float32"].items())
          + f"; losses within {max(v for k, v in err.items() if 'acc' not in k):.3g} relative "
          f"(tolerance {CASCADE_BF16_LOSS_REL}), accuracies within "
          f"{max(v for k, v in err.items() if 'acc' in k):.3g} (tolerance {CASCADE_BF16_ACC_ABS})")
    return {"bf16": outs["bfloat16"], "f32": outs["float32"], "err": err}


def seeded_backbone_state(backbone, seed):
    """A state dict of `backbone`'s keys with seeded values: convs N(0,
    1/fan_in), Linear N(0, 0.02), BatchNorm scales in [0.5, 1.5], biases and
    means N(0, 0.1), variances in [0.5, 2]."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in backbone.state_dict().items():
        if k.endswith("num_batches_tracked"):
            out[k] = torch.tensor(5)
        elif k.endswith("running_var"):
            out[k] = torch.rand(v.shape, generator=g) * 1.5 + 0.5
        elif v.dim() == 4:
            out[k] = torch.randn(v.shape, generator=g) * v[0].numel() ** -0.5
        elif v.dim() == 2:
            out[k] = torch.randn(v.shape, generator=g) * 0.02
        elif k.endswith("weight"):
            out[k] = torch.rand(v.shape, generator=g) + 0.5
        else:
            out[k] = torch.randn(v.shape, generator=g) * 0.1
    return out


def pretrained_files(directory, seed):
    """A torchvision ResNet-50 `.pth` (its `fc` classifier included), a
    Detectron R-50 `.pkl` (caffe2 blobs, affine-channel BatchNorm) through
    `tools/detectron2pytorch.py`, and a pycls RegNetX-3.2GF `.pyth`
    (`model_state`, its head), of seeded values: (config, file) pairs."""
    import pickle
    from panoswintransformerobjectdetection_torch.models.backbones_extra import RegNet
    from panoswintransformerobjectdetection_torch.models.resnet import ResNet
    from panoswintransformerobjectdetection_torch.tools import detectron2pytorch
    tv = seeded_backbone_state(ResNet(depth=50), seed)
    tv_path = os.path.join(directory, "resnet50-seeded.pth")
    torch.save(dict(tv, **{"fc.weight": torch.zeros(1000, 2048), "fc.bias": torch.zeros(1000)}),
               tv_path)
    blobs = {"pred_w": np.zeros((1000, 2048), np.float32)}
    caffe = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c",
             "downsample.0": "branch1"}
    for k, v in seeded_backbone_state(ResNet(depth=50), seed + 1).items():
        module, leaf = k.rsplit(".", 1)
        if leaf not in ("weight", "bias"):
            continue
        if module in ("conv1", "bn1"):
            name = "conv1" if module == "conv1" else "res_conv1_bn"
        else:
            layer, j, sub = module.split(".", 2)
            stem = f"res{int(layer[5:]) + 1}_{j}"
            name = (f"{stem}_{caffe[sub]}" if sub in caffe else
                    f"{stem}_{caffe['downsample.0' if sub == 'downsample.1' else 'conv' + sub[-1]]}_bn")
        suffix = "_b" if leaf == "bias" else ("_s" if name.endswith("_bn") else "_w")
        blobs[name + suffix] = v.numpy()
    pkl = os.path.join(directory, "R-50.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"blobs": blobs}, f)
    det_path = os.path.join(directory, "R-50-detectron.pth")
    detectron2pytorch.main([pkl, det_path, "50"])
    pycls = {}
    for k, v in seeded_backbone_state(RegNet(arch="regnetx_3.2gf"), seed + 2).items():
        if k.endswith("num_batches_tracked"):
            continue
        if k.startswith(("conv1.", "bn1.")):
            pycls[k.replace("conv1.", "stem.conv.").replace("bn1.", "stem.bn.")] = v
            continue
        layer, j, rest = k.split(".", 2)
        for n, sub in ((1, "a"), (2, "b"), (3, "c")):
            rest = rest.replace(f"conv{n}.", f"f.{sub}.").replace(f"bn{n}.", f"f.{sub}_bn.")
        rest = rest.replace("downsample.0.", "proj.").replace("downsample.1.", "bn.")
        pycls[f"s{layer[5:]}.b{int(j) + 1}.{rest}"] = v
    pycls["head.fc.weight"] = torch.zeros(1000, 1008)
    pycls_path = os.path.join(directory, "RegNetX-3.2GF-seeded.pyth")
    torch.save({"model_state": pycls, "epoch": 100}, pycls_path)
    return [(RESNET_FASTER_CONFIG, tv_path), (RESNET_FASTER_CONFIG, det_path),
            ("configs/regnet/mask_rcnn_regnetx-3.2GF_fpn_1x_coco.py", pycls_path)]


def f64_backbone_card_vs_cpu(dev, cfg, path, seed):
    """The detector's backbone alone in float64 on the card (cuDNN's f64
    convolutions) and on the CPU, in train mode as the config has it, from
    the `.pth`'s weights, on 2 seeded frames of 64 x 128 with a seeded
    cotangent a stage: stages within 1e-9 * max|ref|, every gradient within
    1e-9 * G + 1e-6 * max|g| (G the largest entry of any), the running
    statistics within 1e-6 relative.  Returns the worst gradient error as a
    share of max|g|."""
    from panoswintransformerobjectdetection_torch.models.detectors import BACKBONES
    options = dict(cfg["model"]["backbone"])
    sd = {k[len("module.backbone."):]: v for k, v in
          torch.load(path, weights_only=True)["state_dict"].items()
          if k.startswith("module.backbone.")}
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((2, 64, 128, 3), generator=g, dtype=torch.float64)
    runs = {}
    for side, where in (("card", dev), ("cpu", torch.device("cpu"))):
        bb = BACKBONES[options["type"]](**{k: v for k, v in options.items() if k != "type"},
                                        dtype=torch.float64)
        bb.load_state_dict(sd)
        bb.to(where).train()
        outs = bb(x.to(where))
        cots = [torch.randn(o.shape, generator=torch.Generator().manual_seed(seed + i),
                            dtype=torch.float64) for i, o in enumerate(outs)]
        sum((o * c.to(where)).sum() for o, c in zip(outs, cots)).backward()
        runs[side] = ([o.detach().cpu() for o in outs],
                      {n: p.grad.detach().cpu() for n, p in bb.named_parameters()
                       if p.grad is not None},
                      {k: v.cpu() for k, v in bb.state_dict().items() if "running" in k})
    (o_g, g_g, s_g), (o_c, g_c, s_c) = runs["card"], runs["cpu"]
    for i, (a, b) in enumerate(zip(o_g, o_c)):
        if float((a - b).abs().max()) > 1e-9 * float(b.abs().max()):
            raise AssertionError(f"14d f64 backbone stage {i}: card against CPU "
                                 f"{float((a - b).abs().max())}")
    scale = max(float(v.abs().max()) for v in g_c.values())
    if set(g_g) != set(g_c):
        raise AssertionError("14d f64 backbone: the card and the CPU reached different parameters")
    worst = 0.0
    for n, ref in g_c.items():
        err = float((g_g[n] - ref).abs().max())
        worst = max(worst, err / max(float(ref.abs().max()), 1e-300))
        if err > 1e-9 * scale + 1e-6 * float(ref.abs().max()):
            raise AssertionError(f"14d f64 backbone gradient {n}: {err}, max|g| "
                                 f"{float(ref.abs().max())}")
    for k, ref in s_c.items():
        if float((s_g[k] - ref).abs().max()) > 1e-6 * max(1.0, float(ref.abs().max())):
            raise AssertionError(f"14d f64 backbone running statistic {k}")
    return worst


def resnet_train_card_vs_cpu(dev, counters, ra, seed, directory):
    """14d: one `forward_train` and its backward of a detector on each of
    `RESNET_TRAIN_CARD_VS_CPU` (80 classes, the configs' training
    configuration) in f32, TF32 off, at 64 x 128 on the card (K3's f32 entry
    once at 7 forward and backward, the counts set to 0 just before and read
    just after) and on the CPU, from one `.pth` (`write_cnn_reference_pth`),
    the same batch and sampler noise: every loss within 1e-4 relative; every
    gradient of the neck and heads within 1e-5 + 2e-3 * max|g| against a
    second CPU pass that starts from the card's backbone maps (the neck and
    heads on their own; from the CPU's own maps they inherit the backbone's
    sensitivity, up to 0.62 of that tolerance under a 1e-7 input change on
    the caffe R-50 with live BatchNorm, 0.93 seen card against CPU); the running
    statistics within 1e-4 of 1 + |ref| and `num_batches_tracked` equal.
    The backbones' gradients are held in float64 (`f64_backbone_card_vs_cpu`,
    the statistics there within 1e-6): in f32 a 50- to 101-layer backbone of
    random weights moves its gradients by up to 160 times 1e-5 + 2e-3 *
    max|g| when its input moves by 1e-7 relative (measured on the CPU with
    these weights: the caffe R-50 with live BatchNorm, and Res2Net-101 by
    4.8 times), and the caffe R-50's live statistics by 1.4e-5 of 1 + |ref|
    (2.6e-5 at 1e-6), so a card-against-CPU difference of that size says
    nothing of a fault.  Then the three backbone
    files of `pretrained_files` through `apis.train.apply_init_weights`:
    the same stage outputs on the card as on the CPU (f32, TF32 off,
    1e-4 * max|ref|).  Returns the records and the launches."""
    from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                         load_weights)
    from panoswintransformerobjectdetection_torch.apis.train import apply_init_weights
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    rng = np.random.default_rng(seed + 144)
    batch = {"images": torch.from_numpy(rng.standard_normal((2, 64, 128, 3)).astype(np.float32)),
             "img_shapes": torch.tensor([[64., 128.], [60., 120.]]),
             "gt_boxes": torch.tensor([[[4., 2., 44., 34.], [30., 10., 90., 60.],
                                        [70., 4., 124., 40.]]] * 2),
             "gt_labels": torch.tensor([[0, 3, 4], [1, 2, 0]]),
             "gt_valid": torch.tensor([[True, True, True], [True, True, False]])}
    f32 = (ra.ENTRIES[torch.float32], 7)
    f32_back = (ra.BACKWARD_ENTRIES[torch.float32], 7)
    records, launches = {}, {}
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for config, options, residual_scale in RESNET_TRAIN_CARD_VS_CPU:
            cfg = load_config(config)
            cfg["model"]["backbone"].update(options)
            name = os.path.basename(config)[:-3]
            path = write_cnn_reference_pth(cfg, directory, 1, "14d_" + name,
                                           residual_scale=residual_scale)
            outs, grads, stats, maps = {}, {}, {}, []
            for side, where in (("card", dev), ("cpu", torch.device("cpu")),
                                ("cpu_from_card_maps", torch.device("cpu"))):
                model = build_detector_from_cfg(cfg)
                load_weights(model, path)
                model.to(where).train()
                stages = model.backbone.forward_from_embed
                if side == "card":
                    def keep(x, stages=stages):
                        feats = stages(x)
                        maps[:] = [f.detach().cpu() for f in feats]
                        return feats
                    model.backbone.forward_from_embed = keep
                    for fn in counters.values():
                        fn.launches = 0
                    ra.roi_align.launches_by_entry = {}
                    ra.roi_align_backward.launches_by_entry = {}
                elif side == "cpu_from_card_maps":
                    model.backbone.forward_from_embed = lambda x: tuple(maps)
                out = model.forward_train(**{k: v.to(where) for k, v in batch.items()},
                                          generator=torch.Generator().manual_seed(7))
                sum(v for k, v in out.items() if "loss" in k).backward()
                if side == "card":
                    torch.cuda.synchronize()
                    counts = {n: fn.launches for n, fn in counters.items()}
                    entries = (dict(ra.roi_align.launches_by_entry),
                               dict(ra.roi_align_backward.launches_by_entry))
                    expect = {n: 0 for n in counters}
                    expect.update({"roi_align (K3)": 1, "roi_align_backward (K3 backward)": 1})
                    if counts != expect or entries != ({f32: 1}, {f32_back: 1}):
                        raise AssertionError(f"14d {name}: launches {counts}, by entry {entries}")
                    for key in (("forward",) + f32, ("backward",) + f32_back):
                        launches[key] = launches.get(key, 0) + 1
                outs[side] = {k: float(v.detach()) for k, v in out.items()}
                grads[side] = {n: p.grad.detach().cpu() for n, p in model.named_parameters()
                               if p.grad is not None}
                stats[side] = {k: v.cpu() for k, v in model.state_dict().items()
                               if "running" in k or "num_batches" in k}
                if side == "cpu":
                    names = [n for n, _ in model.named_parameters()]
                del model
            loss_err = max(abs(outs["card"][k] - v) / max(abs(v), 1e-6)
                           for k, v in outs["cpu"].items())
            if loss_err > 1e-4 or not all(np.isfinite(v) for v in outs["card"].values()):
                raise AssertionError(f"14d {name}: card {outs['card']}, CPU {outs['cpu']}")
            if set(grads["card"]) != set(grads["cpu"]):
                raise AssertionError(f"14d {name}: the card and the CPU reached different "
                                     "parameters")
            # no masks in the batch: a mask head gets no gradient
            frozen = [n for n in names if n not in grads["cpu"]
                      and not n.startswith("roi_head.mask_head.")]
            want_frozen = [n for n in frozen if n.startswith(
                ("backbone.conv1.", "backbone.bn1.", "backbone.layer1."))]
            if frozen != (want_frozen if options.get("frozen_stages") == 1 else []):
                raise AssertionError(f"14d {name}: parameters without a gradient {frozen[:4]}")
            worst = (0.0, "")
            for n, ref in grads["cpu_from_card_maps"].items():
                scale = float(ref.abs().max())
                err = float((grads["card"][n] - ref).abs().max())
                worst = max(worst, (err / max(scale, 1e-30), n))
                if err > 1e-5 + 2e-3 * scale:
                    raise AssertionError(f"14d {name}: gradient of {n}: card against CPU {err}, "
                                         f"max|g| {scale}")
            if set(grads["cpu_from_card_maps"]) != {n for n in grads["cpu"]
                                                   if not n.startswith("backbone.")}:
                raise AssertionError(f"14d {name}: the neck and heads reached other parameters "
                                     "from the card's maps")
            stat_err = 0.0
            for k, ref in stats["cpu"].items():
                got = stats["card"][k]
                if "num_batches" in k:
                    if not torch.equal(got, ref):
                        raise AssertionError(f"14d {name}: {k} {got} against {ref}")
                    continue
                err = float(((got - ref).abs() / (1.0 + ref.abs())).max())
                stat_err = max(stat_err, err)
                if err > 1e-4:
                    raise AssertionError(f"14d {name}: running statistic {k} differs by {err}")
            live = not cfg["model"]["backbone"].get("norm_eval", True)
            f64_worst = f64_backbone_card_vs_cpu(dev, cfg, path, seed + 145)
            records[name] = {"backbone": cfg["model"]["backbone"],
                             "residual_scale": residual_scale, "loss_rel_err": loss_err,
                             "head_grad_worst_rel": worst[0], "head_grad_worst": worst[1],
                             "running_stat_err": stat_err, "live_batch_norm": live,
                             "frozen_params": len(frozen), "f64_backbone_grad_worst_rel": f64_worst}
            print(f"    (d) {name} ({cfg['model']['backbone']['type']}"
                  f"{', norm_eval False, frozen_stages 1' if live else ''}), f32, TF32 off, 2 "
                  f"frames of 64 x 128, card vs CPU: losses within {loss_err:.3g} relative "
                  f"(tolerance 1e-4), neck and head gradients within {worst[0]:.3g} of max|g| "
                  f"({worst[1]}; tolerance 1e-5 + 2e-3 * max|g|), running statistics within "
                  f"{stat_err:.3g} of 1 + |ref| (1e-4), {len(frozen)} frozen parameters without a gradient; "
                  f"the backbone in f64 card vs CPU: gradients within {f64_worst:.3g} of max|g| "
                  f"(tolerance 1e-9 * G + 1e-6 * max|g|)")
        files = {}
        with tempfile.TemporaryDirectory() as files_dir:
            for config, path in pretrained_files(files_dir, seed + 146):
                model = build_detector_from_cfg(load_config(config))
                apply_init_weights(model, pretrained=path)
                bb = model.backbone.eval()
                x = torch.from_numpy(rng.standard_normal((1, 64, 128, 3)).astype(np.float32))
                with torch.no_grad():
                    ref = bb(x)
                    got = bb.to(dev)(x.to(dev))
                err = 0.0
                for i, (a, b) in enumerate(zip(got, ref)):
                    e = float((a.cpu() - b).abs().max()) / float(b.abs().max())
                    err = max(err, e)
                    if e > 1e-4:
                        raise AssertionError(f"14d {os.path.basename(path)} stage {i}: card "
                                             f"against CPU {e} of max|ref|")
                files[os.path.basename(path)] = err
                print(f"    (d) pretrained {os.path.basename(path)} into "
                      f"{type(bb).__name__}: stage outputs card vs CPU within {err:.3g} of "
                      f"max|ref| (tolerance 1e-4)")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    return {"detectors": records, "pretrained_files": files}, launches


def resnet_family_requests(dev, ident, counters, ra, directory, config, label):
    """14e: a Res2Net or ResNeSt Faster R-CNN config in f32 as it is, from a
    reference `.pth` of random weights: 1 warm-up and `CASCADE_REQUESTS`
    timed `simple_test` requests on 2 seeded frames of 800 x 1344, each with
    the launch counts set to 0 just before it and read just after (K3's f32
    entry once at 7, no other kernel); detections finite."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    cfg = mask_config(path=config)
    path = write_cnn_reference_pth(cfg, directory, 0, label)
    model = init_detector(cfg, path, device=dev)
    h, w = RESNET_CASCADE_FRAME
    g = torch.Generator(device=dev).manual_seed(14)
    inputs = (torch.randn((2, h, w, 3), generator=g, device=dev),
              torch.tensor([[float(h), float(w)]] * 2, device=dev), torch.ones((2, 4), device=dev))
    model.simple_test(*inputs)                                      # warm-up
    torch.cuda.reset_peak_memory_stats()
    latencies, launches = [], {}
    f32 = (ra.ENTRIES[torch.float32], 7)
    for _ in range(CASCADE_REQUESTS):
        for fn in counters.values():
            fn.launches = 0
        ra.roi_align.launches_by_entry = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        det = model.simple_test(*inputs)
        torch.cuda.synchronize()
        latencies.append(time.perf_counter() - t0)
        counts = {name: fn.launches for name, fn in counters.items()}
        expect = {name: 0 for name in counters}
        expect["roi_align (K3)"] = 1
        if counts != expect or ra.roi_align.launches_by_entry != {f32: 1}:
            raise AssertionError(f"{label}: launches {counts}, K3 by entry "
                                 f"{ra.roi_align.launches_by_entry}")
        launches[("forward",) + f32] = launches.get(("forward",) + f32, 0) + 1
    if not (det.mask.any() and torch.isfinite(det.boxes).all()
            and torch.isfinite(det.scores).all()):
        raise AssertionError(f"{label}: detections empty or not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rec = {"config": config, "backbone": cfg["model"]["backbone"]["type"], "dtype": "float32",
           "batch": 2, "frame": list(RESNET_CASCADE_FRAME),
           "latency_ms": [t * 1e3 for t in latencies],
           "median_ms": statistics.median(latencies) * 1e3, "peak_gib": peak,
           "detections": int(det.mask.sum())}
    print(f"    (e) {os.path.basename(config)} ({rec['backbone']}, f32, random weights from a "
          f"reference .pth): {CASCADE_REQUESTS} simple_test requests of 2 frames of {h} x {w} "
          f"after a warm-up: latency ms {[round(t * 1e3, 3) for t in latencies]}, median "
          f"{rec['median_ms']:.3f} ms, {2e3 / rec['median_ms']:.3f} images/s; K3's f32 entry "
          f"once at 7 a request, no other kernel; peak memory {peak:.2f} GiB; "
          f"{rec['detections']} detections in the last; card {ident}")
    del model
    return rec, launches


def kernel_k3_backward_resnet(dev, ra, sampled):
    """14f: K3's backward at 7 x 7 bins on the RoIs that 14a's first step
    sampled (2 x 512 over an 800 x 1088 batch's maps, R-50): the f32 entry
    (the first version, atomics) against autograd through the twin within
    1e-5 * max(1, max|ref|), timed beside the twin, with its bound (f32
    bytes over the memory rate, or its operations over the f32 rate); the
    bf16 owner-computes entry on the same RoIs against the twin and
    bit-equal twice, and the first version at bf16 (`k3_backward_times`).
    Returns the record."""
    strides = (4, 8, 16, 32)
    rois, shapes = sampled
    rois = rois.float().contiguous()
    C, o = 256, 7
    rng = np.random.default_rng(34)
    cot = torch.from_numpy(rng.standard_normal((rois.shape[0], o, o, C)).astype(np.float32))
    cot = cot.to(dev)
    b = k3_backward_times(ra, rois, cot.bfloat16(), shapes, strides)
    rec = k3_backward_f32_record(ra, cot, rois, shapes, strides,
                                 "roi_align_backward o=7 f32 (K3 backward), ResNet-50 sampled RoIs",
                                 "K3 backward o=7 f32, 14a's sampled RoIs")
    print(f"  K3 backward o=7 f32, the {b['rois']} RoIs 14a's first step sampled (by level "
          f"{b['rois_by_level']}, maps {shapes[0][1]} x {shapes[0][2]} and coarser): f32 entry "
          f"{rec['ms']:.4f} ms ({rec['bound_ms'] / rec['ms']:.3f} of its {rec['bound_ms']:.4f} "
          f"ms bound, {rec['bound_by']}), autograd through the twin {rec['plain_ms']:.4f} ms; "
          f"the bf16 owner-computes entry {b['ms']:.4f} ms, bit-equal on two launches, its first "
          f"version at bf16 with zeroing and cast {b['previous_ms']:.4f} ms; no single PyTorch "
          "call computes it")
    return dict(rec, rois_by_level=b["rois_by_level"], previous_ms=b["previous_ms"],
                bf16={k: b[k] for k in ("entry", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "bitwise_repeatable")})


def k3_backward_f32_record(ra, cot, rois, shapes, strides, name, what):
    """K3's f32 backward at cot's o x o bins on `rois` over maps of `shapes`:
    the entry against autograd through the twin within 1e-5 * max(1,
    max|ref|), timed beside it, with its bound (f32 bytes over the memory
    rate, or its operations over the f32 rate).  Returns a kernel row named
    `name` that shares K3's backward's."""
    C, o = cot.shape[-1], cot.shape[1]
    got = ra.roi_align_backward(cot, rois, shapes, torch.float32, strides)
    entry = ra.roi_align_backward.last_entry
    if entry != ra.BACKWARD_ENTRIES[torch.float32]:
        raise AssertionError(f"{what}: K3's backward launched {entry} at f32")
    ref = ra.roi_align_backward_plain(cot, rois, shapes, torch.float32, strides)
    err = 0.0
    for level, (a, r) in enumerate(zip(got, ref)):
        err = max(err, check(f"{what}, level {level}, entry {entry}", a, r,
                             1e-5 * max(1.0, float(r.abs().max()))))
    del got, ref
    ms = time_ms(lambda: ra.roi_align_backward(cot, rois, shapes, torch.float32, strides), 20)
    plain_ms = time_ms(lambda: ra.roi_align_backward_plain(cot, rois, shapes, torch.float32,
                                                           strides), 2)
    nbytes = 4 * (cot.numel() + sum(int(np.prod(s)) for s in shapes)) + rois.numel() * 4
    ops = rois.shape[0] * o * o * C * (16 + 4) * 2
    bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
    return {"name": name, "route": "cuda",
            "source": "panoswintransformerobjectdetection_torch/csrc/roi_align.cu",
            "replaces": "panoswintransformerobjectdetection_tpu/ops/roi_align.py:356",
            "shares_kernel_of": "roi_align_backward (K3 backward)", "out_size": o,
            "entry": entry, "rois": rois.shape[0], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "bytes" if nbytes / HBM_BYTES_PER_S >= ops / F32_OPS_PER_S
            else "operations", "library_ms": None}


def resnet_training_path(dev, ident, counters, ra, seed):
    """Phase 14: ResNet-family training and the Res2Net and ResNeSt
    detectors on the card; returns its record, the launches of its main
    paths by (direction, entry, bins) and the record of K3's f32 backward on
    14a's RoIs."""
    f32, bf16 = ra.ENTRIES[torch.float32], ra.ENTRIES[torch.bfloat16]
    f32_b, bf16_b = ra.BACKWARD_ENTRIES[torch.float32], ra.BACKWARD_ENTRIES[torch.bfloat16]
    launches, rec, seconds = {}, {}, {}
    at7 = {"forward": {(f32, 7): 1}, "backward": {(f32_b, 7): 1}}
    at7_14 = {"forward": {(f32, 7): 1, (f32, 14): 1}, "backward": {(f32_b, 7): 1, (f32_b, 14): 1}}

    def run(label, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = time.perf_counter() - t0
        for k, n in out[1].items():
            launches[k] = launches.get(k, 0) + n
        return out

    with tempfile.TemporaryDirectory() as directory:
        rec["14a"], _, sampled = run("14a", lambda: resnet_train_loop(
            dev, ident, counters, ra, seed, directory, RESNET_FASTER_CONFIG, "14a", at7,
            capture=True))
        rec["14b"], _, _ = run("14b", lambda: resnet_train_loop(
            dev, ident, counters, ra, seed, directory, RESNET_TRAIN_MASK_CONFIG, "14b", at7_14,
            masks=True, bn_check=True))
        rec["14c"], _, _ = run("14c", lambda: resnet_train_loop(
            dev, ident, counters, ra, seed, directory, RESNET_CASCADE_CONFIG, "14c",
            {"forward": {(bf16, 7): 3}, "backward": {(bf16_b, 7): 3}}, dtype="bfloat16"))
        t0 = time.perf_counter()
        rec["14c"]["bf16_against_f32"] = cascade_bf16_against_f32(
            dev, seed, directory, os.path.join(directory, "14c.pth"))
        seconds["14c_check"] = time.perf_counter() - t0
        rec["14d"], _ = run("14d", lambda: resnet_train_card_vs_cpu(dev, counters, ra, seed,
                                                                     directory))
        rec["14e"] = {}
        for config, label in ((RES2NET_SERVE_CONFIG, "14e_res2net"),
                              (RESNEST_SERVE_CONFIG, "14e_resnest")):
            rec["14e"][label[4:]], _ = run(label, lambda: resnet_family_requests(
                dev, ident, counters, ra, directory, config, label))
        rec["14e"]["resnest_training"], _, _ = run("14e_resnest_training", lambda: (
            resnet_train_loop(dev, ident, counters, ra, seed, directory, RESNEST_TRAIN_CONFIG,
                              "14e", at7_14, masks=True, frames=6)))
    t0 = time.perf_counter()
    kernel = kernel_k3_backward_resnet(dev, ra, sampled)
    seconds["14f"] = time.perf_counter() - t0
    rec["seconds"] = seconds
    print("    phase 14 seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    rec["launches_by_entry"] = {f"{d} {e} o={o}": n for (d, e, o), n in sorted(launches.items())}
    return rec, launches, kernel


# Phase 15: distributed training and evaluation.  Each part runs its
# processes as children of this one, with torchrun's environment (15a through
# `python -m torch.distributed.run` itself), and holds what they write
# against the same work done here in one process without a process group.
DIST_TIMEOUT_S = 420
DIST_FRAMES, DIST_EPOCHS, DIST_BATCH = 4, 2, 2
DIST_EVAL_FRAMES = {"15a": 4, "15b": 5}
DIST_MASK_FRAME = (480, 640)
# 15b and 15c run f32 with TF32 off: the W = 2 step and the one-process step
# on the same two frames sum in other orders (each process's convolutions on
# its own frame, BatchNorm's statistics summed over the processes), so their
# running statistics and the RPN's losses (anchors assigned to fixed ground
# truth, sampled with the handed-over noise) agree to rounding
# (`DIST_STAT_REL`).  The RoI stage's losses, `acc`, the total and the
# gradient norm are means over discrete choices: a rounding difference can
# move a proposal across a top-k, NMS or IoU boundary and so change one of
# the 512 RoIs an image samples, which moves a loss by 1/1024 of a RoI's
# loss, up to a few percent with a random R-50's logits (measured: 2.7e-4
# in 15b's second loss_cls, 1.1e-3 in 15c's; `DIST_ROI_REL`).  A
# normaliser left local would be off by a factor of about W, 2.
DIST_STAT_REL = 1e-4
DIST_ROI_REL = 5e-2


def dist_tolerance(key):
    return DIST_STAT_REL if key.startswith("loss_rpn") else DIST_ROI_REL


def dist_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_children(commands, what):
    """Start each (argv, env) child, wait for all (`DIST_TIMEOUT_S`), kill
    every one if any is late; raise if any exits non-zero.  Returns their
    outputs."""
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for argv, env in commands]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=DIST_TIMEOUT_S)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise AssertionError(f"{what}: a child ran past {DIST_TIMEOUT_S} s and was killed")
    for i, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"{what}: child {i} exited {p.returncode}:\n{out[-6000:]}")
    return outs


def child_env(rank, world, port, local_rank=0):
    """torchrun's environment by hand: card `local_rank` (every process on
    card 0 by default)."""
    return dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def spawn_part(part, world, directory, seconds, torchrun=False, cards=False):
    """Phase 15's part `part` in `world` child processes (through `python -m
    torch.distributed.run` with `torchrun`, else with its environment by
    hand: all on card 0, or one card each with `cards`); returns what each
    rank wrote."""
    script = os.path.abspath(__file__)
    t0 = time.perf_counter()
    port = dist_port()
    if torchrun:
        cmds = [([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                  "--nproc_per_node", str(world), "--master_addr", "127.0.0.1",
                  "--master_port", str(port), script, "--dist-child", part, directory],
                 dict(os.environ))]
    else:
        cmds = [([sys.executable, script, "--dist-child", part, directory],
                 child_env(r, world, port, r if cards else 0)) for r in range(world)]
    run_children(cmds, part)
    seconds[f"{part}_children"] = time.perf_counter() - t0
    return [torch.load(os.path.join(directory, f"{part}_rank{r}.pt"), weights_only=False)
            for r in range(world)]


def k3_entry_launches(ra, fn):
    """`fn()` with K3's launches by (direction, entry, bins) counted across
    it (each wrapper's `launches_by_entry`, read just before and after)."""
    before = {d: dict(w.launches_by_entry) for d, w in (("forward", ra.roi_align),
                                                     ("backward", ra.roi_align_backward))}
    out = fn()
    torch.cuda.synchronize()
    counts = {}
    for d, w in (("forward", ra.roi_align), ("backward", ra.roi_align_backward)):
        for key, n in w.launches_by_entry.items():
            if n - before[d].get(key, 0):
                counts[(d, *key)] = n - before[d].get(key, 0)
    return out, counts


def dist_flagship_data(seed, directory, write):
    """15a's data: the bf16 streetwin config's train split on `DIST_FRAMES`
    seeded frames with pixel boxes, its val split on the first
    `DIST_EVAL_FRAMES["15a"]`, each behind `FramesFromMemory`; the
    annotation files written when `write` (by the parent, before its
    children read them)."""
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(API_CONFIG)
    classes = cfg["classes"]
    rng = np.random.default_rng(seed + 150)
    frames = (rng.random((DIST_FRAMES, H, W, 3)) * 255).astype(np.uint8)
    anns = pixel_annotations(rng, DIST_FRAMES, H, W, len(classes))
    n_eval = DIST_EVAL_FRAMES["15a"]
    val_anns = pixel_annotations(rng, n_eval, H, W, len(classes))
    paths = [os.path.join(directory, f"15a_{s}.json") for s in ("train", "val")]
    if write:
        write_ann(paths[0], frames, classes, anns)
        write_ann(paths[1], frames[:n_eval], classes, val_anns)
    return (cfg, in_memory_dataset(dict(cfg["data"]["train"], classes=classes), paths[0], frames),
            in_memory_dataset(dict(cfg["data"]["val"], classes=classes), paths[1],
                              frames[:n_eval]))


def dist_flagship_run(dev, counters, ra, seed, directory, work_dir):
    """15a's work, in a child under its process group or here without one:
    `train_detector` over the bf16 flagship config, `DIST_EPOCHS` epochs of
    `DIST_FRAMES` frames at the global batch `DIST_BATCH`, no loader
    threads, Python's, numpy's and torch's generators seeded first; then
    `multi_host_test` on the val frames.  Returns the steps' metrics and
    launches, the eval batches' launches, K3's launches by entry, the
    parameters and the detections."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.apis.test import multi_host_test
    from panoswintransformerobjectdetection_torch.apis.train import set_random_seed, train_detector
    cfg, train_ds, val_ds = dist_flagship_data(seed, directory, write=False)
    record = LoopRecord(counters)
    opt, sched = cfg["optimizer"], cfg["lr_config"]
    set_random_seed(seed)
    model = build_detector_from_cfg(cfg)
    t0 = time.perf_counter()
    _, train_k3 = k3_entry_launches(ra, lambda: train_detector(
        model, train_ds, work_dir=work_dir, total_epochs=DIST_EPOCHS, batch_size=DIST_BATCH,
        base_lr=opt["lr"], weight_decay=opt["weight_decay"], warmup_iters=sched["warmup_iters"],
        decay_epochs=sched["step"], log_interval=1, seed=seed, hooks=[record], device=dev,
        stage=record.stage, num_workers=0))
    train_s = time.perf_counter() - t0
    model.eval()
    dets, eval_k3 = k3_entry_launches(ra, lambda: multi_host_test(
        model, val_ds, batch_size=DIST_BATCH, device=dev, stage=record.eval_stage))
    return {"steps": record.steps, "step_launches": record.step_launches,
            "eval_launches": record.eval_launches, "k3": {"train": train_k3, "eval": eval_k3},
            "state": {k: v.detach().cpu() for k, v in model.state_dict().items()},
            "dets": dets, "train_s": train_s}


def dist_eval_data(seed, directory, write):
    """15b's evaluation set: `DIST_EVAL_FRAMES["15b"]` seeded frames through
    the bf16 flagship config's test pipeline."""
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(API_CONFIG)
    rng = np.random.default_rng(seed + 151)
    n = DIST_EVAL_FRAMES["15b"]
    frames = (rng.random((n, H, W, 3)) * 255).astype(np.uint8)
    anns = pixel_annotations(rng, n, H, W, len(cfg["classes"]))
    path = os.path.join(directory, "15b_test.json")
    if write:
        write_ann(path, frames, cfg["classes"], anns)
    return in_memory_dataset(dict(cfg["data"]["test"], classes=cfg["classes"]), path, frames)


def dist_steps(model, inputs, counters, ra, rows):
    """The training steps of 15b and 15c on `rows` of each global batch (and
    of its noise where handed over, else the global batch's draw from a
    generator of the given seed): metrics, launches and K3's by entry."""
    from panoswintransformerobjectdetection_torch.runtime.optim import make_optimizer
    from panoswintransformerobjectdetection_torch.runtime.train import make_train_step
    optimizer, scheduler = make_optimizer(model, **inputs["optim"])
    step = make_train_step(model, optimizer, scheduler)
    dev = model.device
    out = {"metrics": [], "launches": [], "k3": {}, "ms": [],
           "ddp": step.ddp is not None}
    for i, (batch, noise) in enumerate(inputs["steps"]):
        batch = {k: v[rows].to(dev) for k, v in batch.items()}
        # DropPath's masks from one CPU generator a step, as the sampler's:
        # every process draws the global batch's and keeps its rows
        model.backbone.set_drop_path_generator(torch.Generator().manual_seed(inputs["seed"] + i))
        kwargs = ({"noise": {k: tuple(t[rows] for t in v) for k, v in noise.items()}}
                  if isinstance(noise, dict) else {"generator": torch.Generator().manual_seed(noise)})
        (metrics, sec, counts), k3 = k3_entry_launches(
            ra, lambda: train_step_counted(step, batch, counters, **kwargs))
        out["metrics"].append(metrics)
        out["launches"].append(counts)
        out["ms"].append(sec * 1e3)
        for key, n in k3.items():
            out["k3"][key] = out["k3"].get(key, 0) + n
    out["state"] = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    out["lrs"] = [g["lr"] for g in optimizer.param_groups]
    return out


def dist_child(part, directory):
    """One process of phase 15 (`chip_smoke.py --dist-child PART DIR`), under
    torchrun's environment: join the group, run the part's work on this
    process's rows, write `DIR/{part}_rank{r}.pt`."""
    from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                         load_weights)
    from panoswintransformerobjectdetection_torch.apis.test import multi_host_test
    from panoswintransformerobjectdetection_torch.flagship import build_flagship
    from panoswintransformerobjectdetection_torch.ops import roi_align as ra
    from panoswintransformerobjectdetection_torch.ops import stem_conv as stem
    from panoswintransformerobjectdetection_torch.parallel import dist as pdist
    import torch.distributed as dist
    dev = torch.device("cuda")
    counters = {"stem_conv (K1)": stem.stem_conv, "roi_align (K3)": ra.roi_align,
                "roi_align_backward (K3 backward)": ra.roi_align_backward}
    inputs = torch.load(os.path.join(directory, f"{part}_inputs.pt"), weights_only=False)
    seed = inputs["seed"]
    t0 = time.perf_counter()
    rank, world = pdist.init_distributed("pytorch", backend=inputs.get("backend"))
    out = {"rank": rank, "world": world, "backend": dist.get_backend(),
           "join_s": time.perf_counter() - t0}
    if part == "15a":
        out.update(dist_flagship_run(dev, counters, ra, seed, directory,
                                     os.path.join(directory, "15a_work")))
    else:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        per = inputs["global_batch"] // world
        rows = slice(rank * per, (rank + 1) * per)
        if part == "15b":
            model = build_flagship(device=dev, train=True, seed=0)
        else:
            model = build_detector_from_cfg(inputs["cfg"])
            load_weights(model, inputs["pth"])
            model.to(dev).train()
        out.update(dist_steps(model, inputs, counters, ra, rows))
        del model
        if part == "15b":
            model = build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0)
            record = LoopRecord(counters)
            out["dets"], out["eval_k3"] = k3_entry_launches(ra, lambda: multi_host_test(
                model, dist_eval_data(seed, directory, write=False), device=dev,
                stage=record.eval_stage))
            out["eval_launches"] = record.eval_launches
    torch.save(out, os.path.join(directory, f"{part}_rank{rank}.pt"))
    pdist.barrier()
    dist.destroy_process_group()
    print(f"{part} rank {rank} of {world}: done", flush=True)
    return 0


def summed(*counts):
    """Launch counts by key, added."""
    out = {}
    for c in counts:
        for key, n in c.items():
            out[key] = out.get(key, 0) + n
    return out


def keyed(counts):
    return {" ".join(map(str, key)): n for key, n in sorted(counts.items(), key=str)}


def relative(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def compare_steps(got, want, tolerance, what):
    """Every loss, `acc` and `grad_norm` of each step within `tolerance(key)`
    relative (acc absolutely); returns the largest difference of each key."""
    worst = {}
    for i, (g, w) in enumerate(zip(got, want)):
        if g.keys() != w.keys():
            raise AssertionError(f"{what} step {i}: outputs {sorted(g)} against {sorted(w)}")
        for k in w:
            if k == "step" or k == "lr":
                continue
            err = abs(g[k] - w[k]) if k.endswith("acc") else relative(g[k], w[k])
            if not np.isfinite(g[k]) or err > tolerance(k):
                raise AssertionError(f"{what} step {i}: {k} {g[k]} against {w[k]} "
                                     f"(tolerance {tolerance(k)})")
            worst[k] = max(worst.get(k, 0.0), err)
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} steps against {len(want)}")
    return worst


def compare_states(got, want, lr_sum, rel, what, bn_keys=()):
    """Parameters within 2 * (summed learning rates) + `rel` * max|p| a
    tensor (an Adam step moves an entry by at most about its learning
    rate, whatever the gradient's rounding), running statistics within
    `rel` relative to max(1, max|ref|), `num_batches_tracked` equal.
    Returns the largest parameter and statistic differences."""
    worst = {"param": 0.0, "stat": 0.0}
    for k, w in want.items():
        g = got[k]
        if "num_batches" in k:
            if not torch.equal(g, w):
                raise AssertionError(f"{what}: {k} {g} against {w}")
            continue
        err = float((g.float() - w.float()).abs().max()) if w.numel() else 0.0
        scale = float(w.float().abs().max()) if w.numel() else 0.0
        if "running" in k:
            tol = rel * max(1.0, scale)
            worst["stat"] = max(worst["stat"], err / max(1.0, scale))
        else:
            tol = 2 * lr_sum + rel * scale
            worst["param"] = max(worst["param"], err)
        if err > tol:
            raise AssertionError(f"{what}: {k} differs by {err} (tolerance {tol})")
    for k in bn_keys:
        if k not in want:
            raise AssertionError(f"{what}: no {k}")
    return worst


def dist_flagship_steps(dev, ident, counters, ra, seed, directory, seconds, world, cards):
    """15b: the f32 flagship (TF32 off) in `world` processes, one frame each
    (32 boxes, then 12 fewer a frame down to 8), 2 steps with handed-over
    noise, against the one-process steps on all the frames; then
    `multi_host_test` on `DIST_EVAL_FRAMES["15b"]` frames against
    `single_device_test`.  All processes on the one card over gloo, or with
    `cards` one card each over NCCL.  Returns its record and the children's
    launches by (direction, entry, bins), K1's under ("stem", None, None)."""
    from panoswintransformerobjectdetection_torch.apis.test import single_device_test
    from panoswintransformerobjectdetection_torch.core.sampler import sampler_noise
    from panoswintransformerobjectdetection_torch.flagship import (build_flagship,
                                                                   flagship_train_batch)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_flagship(device=dev, train=True, seed=0)
    batch = {k: v.cpu() for k, v in flagship_train_batch(world, "cpu", seed=seed).items()}
    boxes = [max(8, 32 - 12 * i) for i in range(world)]
    for i, n in enumerate(boxes):
        batch["gt_valid"][i, n:] = False
    h, w = batch["images"].shape[1:3]
    anchors = sum(a.shape[0] for a in model.anchor_gen.grid_anchors(
        [(-(-h // s), -(-w // s)) for s in (4, 8, 16, 32, 64)]))
    rcnn = batch["gt_boxes"].shape[1] + model.train_cfg["rpn_proposal"]["max_per_img"]
    gen = torch.Generator().manual_seed(seed + 15)
    steps = [(batch, {"rpn": sampler_noise((world, anchors), gen, "cpu"),
                      "rcnn": sampler_noise((world, rcnn), gen, "cpu")})
             for _ in range(2)]
    inputs = {"seed": seed, "optim": {}, "steps": steps, "global_batch": world,
              "backend": None if cards else "gloo"}
    torch.save(inputs, os.path.join(directory, "15b_inputs.pt"))
    test_ds = dist_eval_data(seed, directory, write=True)
    del model
    torch.cuda.empty_cache()
    kids = spawn_part("15b", world, directory, seconds, cards=cards)
    t0 = time.perf_counter()
    here = dist_steps(build_flagship(device=dev, train=True, seed=0), inputs, counters, ra,
                      slice(0, world))
    eval_model = build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0)
    single = single_device_test(eval_model, test_ds, device=dev)
    seconds["15b_here"] = time.perf_counter() - t0
    del eval_model
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    lr_sum = 2 * max(here["lrs"])
    worst_loss = [compare_steps(k["metrics"], here["metrics"], dist_tolerance, "15b")
                  for k in kids]
    worst_loss = {key: max(w[key] for w in worst_loss) for key in worst_loss[0]}
    worst_state = [compare_states(k["state"], here["state"], lr_sum, DIST_STAT_REL, "15b")
                   for k in kids]
    for k in kids[1:]:
        for name, v in kids[0]["state"].items():
            if not torch.equal(v, k["state"][name]):
                raise AssertionError(f"15b: rank {k['rank']}'s {name} differs from rank 0's")
    if not all(k["ddp"] for k in kids) or any(k["dets"] is not None for k in kids[1:]):
        raise AssertionError("15b: a step ran without DDP, or a rank but 0 got results")
    match_detections(kids[0]["dets"], single, 1e-3, 1e-5, "15b multi_host_test")
    launches = summed(*(summed(k["k3"], k["eval_k3"]) for k in kids))
    k1 = [sum(c["stem_conv (K1)"] for c in k["eval_launches"]) for k in kids]
    launches[("stem", None, None)] = sum(k1)
    backend = kids[0]["backend"]
    rec = {"model": "flagship f32 (TF32 off), train mode", "world": world,
           "backend": backend, "cards": world if cards else 1, "global_batch": world,
           "gt_boxes": boxes, "steps": 2,
           "losses": [{k: m[k] for k in ("loss", "grad_norm")} for m in kids[0]["metrics"]],
           "max_rel_loss_diff": worst_loss,
           "max_param_diff": max(s["param"] for s in worst_state),
           "max_stat_diff": max(s["stat"] for s in worst_state),
           "step_ms": {"ranks": [k["ms"] for k in kids], "here": here["ms"]},
           "eval_frames": DIST_EVAL_FRAMES["15b"], "eval_model": "flagship bf16, BN folded",
           "detections": sum(len(d["boxes"]) for d in single),
           "k1_launches": {"ranks": k1, "here": DIST_EVAL_FRAMES["15b"]},
           "k3_launches": {"ranks": [keyed(summed(k["k3"], k["eval_k3"])) for k in kids],
                           "here": keyed(here["k3"])},
           "card": ident}
    where = f"{world} cards over {backend}" if cards else f"the card over {backend}"
    print(f"    (b) the f32 flagship (TF32 off), {world} processes on {where}, one frame "
          f"each ({', '.join(map(str, boxes))} boxes), 2 steps with handed-over noise, against "
          f"the one-process steps on all the frames: the largest difference of each output "
          f"{ {k: float(f'{v:.3g}') for k, v in worst_loss.items()} } (tolerance "
          f"{DIST_STAT_REL} relative for the RPN's, {DIST_ROI_REL} for the RoI stage's, acc "
          f"absolute), parameters within {rec['max_param_diff']:.3g} (tolerance 2 x the "
          f"summed lr), statistics {rec['max_stat_diff']:.3g}, the ranks' parameters "
          f"bit-identical; multi_host_test on {DIST_EVAL_FRAMES['15b']} frames equals "
          f"single_device_test ({rec['detections']} detections), the other ranks None; step "
          f"ms {rec['step_ms']}; K1 launches {rec['k1_launches']}, K3 {rec['k3_launches']}; "
          f"card {ident}")
    return rec, launches


def distributed_path(dev, ident, counters, ra, seed):
    """Phase 15: distributed training and evaluation on the one card; returns
    its record and the launches of its children's main paths by (direction,
    entry, bins), with K1's under ("stem", None, None)."""
    from panoswintransformerobjectdetection_torch.apis.inference import (build_detector_from_cfg,
                                                                         load_weights)
    from panoswintransformerobjectdetection_torch.data.datasets import CocoDataset
    from panoswintransformerobjectdetection_torch.data.loader import DetDataLoader
    rec, seconds, launches = {}, {}, {}

    def add(counts):
        for key, n in counts.items():
            launches[key] = launches.get(key, 0) + n

    with tempfile.TemporaryDirectory() as directory:
        # 15a: one process under torchrun, NCCL, against no process group
        torch.save({"seed": seed, "backend": None}, os.path.join(directory, "15a_inputs.pt"))
        dist_flagship_data(seed, directory, write=True)
        torch.cuda.empty_cache()
        (child,) = spawn_part("15a", 1, directory, seconds, torchrun=True)
        t0 = time.perf_counter()
        here = dist_flagship_run(dev, counters, ra, seed, directory,
                                 os.path.join(directory, "15a_here"))
        seconds["15a_here"] = time.perf_counter() - t0
        if (child["world"], child["backend"]) != (1, "nccl"):
            raise AssertionError(f"15a: the child joined {child['world']} over "
                                 f"{child['backend']}, not 1 over nccl")
        n_steps = DIST_EPOCHS * DIST_FRAMES // DIST_BATCH
        per_step = {"stem_conv (K1)": 0, "roi_align (K3)": 1,
                    "roi_align_backward (K3 backward)": 1}
        per_batch = {"stem_conv (K1)": 1, "roi_align (K3)": 1,
                     "roi_align_backward (K3 backward)": 0}
        for run, who in ((child, "15a child"), (here, "15a here")):
            if len(run["steps"]) != n_steps:
                raise AssertionError(f"{who}: {len(run['steps'])} steps, expected {n_steps}")
            for counts in run["step_launches"]:
                expect_launches({k: counts[k] for k in per_step}, per_step, f"{who} step")
            for counts in run["eval_launches"]:
                expect_launches({k: counts[k] for k in per_batch}, per_batch, f"{who} eval")
        lr_sum = sum(m["lr"] for m in here["steps"]) if "lr" in here["steps"][0] else 0.0
        cfg = dist_flagship_data(seed, directory, write=False)[0]
        lr_cap = cfg["optimizer"]["lr"] * n_steps
        worst_loss = max(compare_steps(child["steps"], here["steps"], lambda k: BF16_ULPS,
                                       "15a").values())
        worst_state = compare_states(child["state"], here["state"], lr_sum or lr_cap,
                                     BF16_ULPS, "15a")
        match_detections(child["dets"], here["dets"], 1e-3, 1e-5, "15a multi_host_test")
        k1 = sum(c["stem_conv (K1)"] for c in child["eval_launches"])
        add(summed(child["k3"]["train"], child["k3"]["eval"], {("stem", None, None): k1}))
        rec["15a"] = {"config": os.path.basename(API_CONFIG), "frames": DIST_FRAMES,
                      "epochs": DIST_EPOCHS, "global_batch": DIST_BATCH, "world": 1,
                      "backend": "nccl", "launcher": "torch.distributed.run",
                      "losses": [{k: m[k] for k in ("loss", "grad_norm")} for m in child["steps"]],
                      "max_rel_loss_diff": worst_loss, "max_param_diff": worst_state["param"],
                      "max_stat_diff": worst_state["stat"],
                      "eval_frames": DIST_EVAL_FRAMES["15a"],
                      "detections": sum(len(d["boxes"]) for d in child["dets"]),
                      "k1_launches": {"child": k1, "here": sum(c["stem_conv (K1)"]
                                                               for c in here["eval_launches"])},
                      "k3_launches": {"child": keyed(summed(child["k3"]["train"],
                                                            child["k3"]["eval"])),
                                      "here": keyed(summed(here["k3"]["train"],
                                                           here["k3"]["eval"]))},
                      "child_train_s": child["train_s"], "here_train_s": here["train_s"],
                      "card": ident}
        print(f"    (a) {rec['15a']['config']} under `torch.distributed.run --nproc_per_node 1` "
              f"(NCCL, world 1) against the same run without a process group: {n_steps} steps "
              f"of {DIST_BATCH} frames of {H} x {W}, then multi_host_test on "
              f"{DIST_EVAL_FRAMES['15a']} frames: losses and grad_norm within {worst_loss:.3g} "
              f"relative (tolerance {BF16_ULPS:.4g}), parameters within {worst_state['param']:.3g}, "
              f"statistics {worst_state['stat']:.3g}, {rec['15a']['detections']} detections "
              f"matched; K1 launches {rec['15a']['k1_launches']}, K3 {rec['15a']['k3_launches']}; "
              f"training {child['train_s']:.1f} s in the child, {here['train_s']:.1f} s here; "
              f"card {ident}")
        del here, child

        rec["15b"], counts = dist_flagship_steps(dev, ident, counters, ra, seed, directory,
                                                 seconds, 2, cards=False)
        add(counts)

        # 15c: the gcnet R-50 Mask R-CNN with live BatchNorm, two processes
        # on the card over gloo, f32 with TF32 off, against one process
        tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        cfg = train_config(RESNET_TRAIN_MASK_CONFIG, masks=True)
        classes = cfg.get("classes") or CocoDataset.CLASSES
        rng = np.random.default_rng(seed + 152)
        fh, fw = DIST_MASK_FRAME
        arrays = (rng.random((DIST_BATCH, fh, fw, 3)) * 255).astype(np.uint8)
        ann = write_ann(os.path.join(directory, "15c.json"), arrays, classes,
                        polygon_annotations(rng, DIST_BATCH, fh, fw, len(classes)))
        dataset = in_memory_dataset(dict(cfg["data"]["train"], classes=classes), ann, arrays)
        import random as pyrandom
        pyrandom.seed(seed)
        loader = DetDataLoader(dataset, batch_size=DIST_BATCH, shuffle=False, max_gt=100)
        host = next(iter(loader))
        batch = {k: torch.from_numpy(host[k]) for k in ("images", "img_shapes", "gt_boxes",
                                                        "gt_labels", "gt_valid", "gt_masks")}
        path = write_cnn_reference_pth(cfg, directory, seed, "15c")
        opt, sched = cfg["optimizer"], cfg["lr_config"]
        inputs = {"seed": seed, "cfg": cfg, "pth": path, "backend": "gloo",
                  "global_batch": DIST_BATCH,
                  "optim": {"base_lr": opt["lr"], "weight_decay": opt["weight_decay"],
                            "warmup_iters": sched["warmup_iters"]},
                  "steps": [(batch, seed + 16)]}
        torch.save(inputs, os.path.join(directory, "15c_inputs.pt"))
        torch.cuda.empty_cache()
        kids = spawn_part("15c", 2, directory, seconds)
        t0 = time.perf_counter()
        model = build_detector_from_cfg(cfg)
        load_weights(model, path)
        start = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        model.to(dev).train()
        here = dist_steps(model, inputs, counters, ra, slice(0, DIST_BATCH))
        seconds["15c_here"] = time.perf_counter() - t0
        del model
        bn_keys = ("backbone.bn1.running_mean", "backbone.bn1.running_var",
                   "backbone.layer4.0.bn1.running_mean", "backbone.layer4.0.bn1.running_var")
        lr_sum = max(here["lrs"])
        worst_loss = [compare_steps(k["metrics"], here["metrics"], dist_tolerance, "15c")
                      for k in kids]
        worst_loss = {key: max(w[key] for w in worst_loss) for key in worst_loss[0]}
        worst_state = [compare_states(k["state"], here["state"], lr_sum, DIST_STAT_REL, "15c",
                                      bn_keys) for k in kids]
        bn = {}
        for key in bn_keys:
            moved = here["state"][key] - start[key]
            if not moved.abs().max() > 0:
                raise AssertionError(f"15c: {key} did not move")
            bn[key] = max(float((k["state"][key] - here["state"][key]).abs().max())
                          / max(1.0, float(here["state"][key].abs().max())) for k in kids)
        if not all(k["metrics"][0]["loss_mask"] > 0 for k in kids):
            raise AssertionError("15c: no mask loss")
        for k in kids:
            add(k["k3"])
        rec["15c"] = {"config": RESNET_TRAIN_MASK_CONFIG, "dtype": "float32 (TF32 off)",
                      "masks_loaded": True, "frame": list(DIST_MASK_FRAME),
                      "padded": list(batch["images"].shape[1:3]), "world": 2, "backend": "gloo",
                      "losses": kids[0]["metrics"][0], "here_losses": here["metrics"][0],
                      "max_rel_loss_diff": worst_loss,
                      "max_param_diff": max(s["param"] for s in worst_state),
                      "max_stat_diff": max(s["stat"] for s in worst_state),
                      "bn_rel_diff": bn, "step_ms": {"ranks": [k["ms"] for k in kids],
                                                     "here": here["ms"]},
                      "k3_launches": {"ranks": [keyed(k["k3"]) for k in kids],
                                      "here": keyed(here["k3"])},
                      "card": ident}
        print(f"    (c) {os.path.basename(RESNET_TRAIN_MASK_CONFIG)} (f32, TF32 off, norm_eval "
              f"False, masks loaded), 2 processes over gloo, one {fh} x {fw} frame each "
              f"(padded {rec['15c']['padded']}), one step against the one-process step on both: "
              f"losses (loss_mask {kids[0]['metrics'][0]['loss_mask']:.6f} against "
              f"{here['metrics'][0]['loss_mask']:.6f}), the largest difference of each output "
              f"{ {k: float(f'{v:.3g}') for k, v in worst_loss.items()} } (tolerance "
              f"{DIST_STAT_REL} for the RPN's, {DIST_ROI_REL} for the RoI stage's), bn1's and "
              f"layer4.0.bn1's running statistics within "
              f"{max(bn.values()):.3g}, parameters within {rec['15c']['max_param_diff']:.3g}; "
              f"K3 launches {rec['15c']['k3_launches']}; step ms {rec['15c']['step_ms']}; "
              f"card {ident}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    rec["seconds"] = seconds
    rec["launches_by_entry"] = keyed(launches)
    print("    phase 15 seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
          + f"; card {ident}")
    return rec, launches


def dist_cards(n, seed):
    """`--dist-cards N`: build the kernels, run 15b across N cards (one
    process each, NCCL) against one process on card 0, print its record,
    the card's name and power limit and the result line."""
    from panoswintransformerobjectdetection_torch.device import gpu_identity
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    from panoswintransformerobjectdetection_torch.ops import fused_attention as fa
    from panoswintransformerobjectdetection_torch.ops import roi_align as ra
    from panoswintransformerobjectdetection_torch.ops import stem_conv as stem
    if torch.cuda.device_count() < n:
        print(f"chip_smoke: --dist-cards {n} needs {n} cards, not {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    ident = gpu_identity()
    print(f"[1] cards: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}; "
          f"nvidia-smi: {ident}")
    print(f"[2] built {', '.join(cuda_build.SOURCES)} in {cuda_build.build_all():.1f} s")
    counters = {"stem_conv (K1)": stem.stem_conv, "roi_align (K3)": ra.roi_align,
                "window_attention (K2)": fa.window_attention, "dense_crop (K4)": ra.dense_crop,
                "roi_align_backward (K3 backward)": ra.roi_align_backward}
    seconds = {}
    print(f"[15b] across {n} cards")
    with tempfile.TemporaryDirectory() as directory:
        rec, launches = dist_flagship_steps(torch.device("cuda"), ident, counters, ra, seed,
                                            directory, seconds, n, cards=True)
    rec["seconds"], rec["launches_by_entry"] = seconds, keyed(launches)
    print(json.dumps({"distributed_cards": rec}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


V2_CONFIG = "configs/panoswin/faster_rcnn_panoswin_v2_tiny_streetwin.py"
V2_REQUEST_FRAMES = 2               # 16a: a request is one batch of 2 frames
V2_INPUT = (672, 1344)              # 512 x 1024 after the test pipeline's Resize and Pad
V2_TRAIN_FRAMES = 8                 # 16b: 4 steps of 2 frames
V2_PARTIAL = (0.1, 0.9)             # the odd frames' pano_ratio_v in 16b
V2_NANO = {"model": {
    "type": "PanoFasterRCNN",
    "backbone": {"type": "PanoSwinTransformerV2", "embed_dim": 12, "depths": (2, 2, 2, 2),
                 "num_heads": (1, 1, 2, 2), "window_size": 4, "ape": True,
                 "drop_path_rate": 0.0},
    "neck": {"type": "FPN", "in_channels": (12, 24, 48, 96), "out_channels": 16,
             "num_outs": 5},
    "num_classes": 5,
    "test_cfg": {"rpn": {"nms_pre": 256, "max_per_img": 64, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
                 "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 32}}}}


class PartialRatio:
    """A step after a training pipeline's own: the odd frames carry the
    partial ratio `V2_PARTIAL` of a cropped panorama, the even ones keep
    the full one (`PanoCheck`'s)."""

    def __call__(self, results):
        if results["img_info"]["id"] % 2:
            results["pano_ratio_v"] = np.array(V2_PARTIAL, np.float32)
        return results


class RatioLoopRecord(MaskLoopRecord):
    """`MaskLoopRecord`, and each step's batch of ratios as copied to the
    card."""

    def __init__(self, counters, ra):
        super().__init__(counters, ra)
        self.ratios = []

    def stage(self, name, fn):
        if name != "copy":
            return super().stage(name, fn)

        def keep():
            out = fn()
            self.ratios.append(out["pano_ratio_v"].cpu().numpy().tolist())
            return out
        return super().stage(name, keep)


def v2_record(rec, name, share):
    """A phase-16 kernel row: `rec` with the row's name and the source of
    the kernel it runs."""
    k1 = share == "stem_conv (K1)"
    return dict(rec, name=name, shares_kernel_of=share, route="cuda",
                source="panoswintransformerobjectdetection_torch/csrc/"
                       + ("stem_conv.cu" if k1 else "roi_align.cu"),
                replaces="panoswintransformerobjectdetection_tpu/ops/"
                         + ("stem_conv.py:61" if k1 else "roi_align_pallas.py:205"),
                library_ms=rec.get("library_ms"))


def v2_serving(dev, ident, counters, stem, ra, seed, directory):
    """16a: the PanoSwin-v2-T config served on the card.  Returns the
    record and the K1 and K3 rows."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(V2_CONFIG)
    classes = cfg["classes"]
    path = write_reference_pth(V2_CONFIG, directory, 0)
    model = init_detector(V2_CONFIG, path, device=dev)
    if type(model.backbone).__name__ != "PanoSwinTransformerV2":
        raise AssertionError(f"16a: the config built a {type(model.backbone).__name__}")
    rng = np.random.default_rng(seed + 160)
    frames = (rng.random((V2_REQUEST_FRAMES, H, W, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, "v2_test.json"), frames, classes,
                         pixel_annotations(rng, V2_REQUEST_FRAMES, H, W, len(classes)))
    dataset = in_memory_dataset(dict(cfg["data"]["test"], classes=classes), ann_file, frames)
    inputs = first_batch(dataset, dev, V2_REQUEST_FRAMES)
    if tuple(inputs[0].shape[1:3]) != V2_INPUT:
        raise AssertionError(f"16a: the test pipeline made {tuple(inputs[0].shape)}")
    for _ in range(2):
        model.simple_test(*inputs)                                 # warm-up
    torch.cuda.reset_peak_memory_stats()
    expected = {name: 0 for name in counters}
    expected.update({"stem_conv (K1)": 1, "roi_align (K3)": 1})
    latencies, launches = [], {name: 0 for name in counters}
    for _ in range(REQUESTS):
        stem.stem_conv.last_entry = ra.roi_align.last_entry = None
        det, sec, counts = timed_request(model, inputs, counters)
        expect_launches(counts, expected, "16a PanoSwin-v2-T request")
        if (stem.stem_conv.last_entry, ra.roi_align.last_entry) != (
                stem.ENTRIES[torch.float32], ra.ENTRIES[torch.float32]):
            raise AssertionError(f"16a: K1 ran {stem.stem_conv.last_entry}, K3 "
                                 f"{ra.roi_align.last_entry}; the f32 entries expected")
        latencies.append(sec)
        for name, n in counts.items():
            launches[name] += n
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    found = check_detections(det, "16a PanoSwin-v2-T")
    times = {}
    model.simple_test(*inputs, stage=stage_timer(times))           # one request by stage
    stage_ms = {name: t[0] * 1e3 for name, t in times.items()}
    k1 = k1_f32_at_eval_shape(stem, model, inputs[0])
    k1 = v2_record(k1, "stem_conv f32 (K1), PanoSwin-v2-T request", "stem_conv (K1)")
    k1["launches"] = launches["stem_conv (K1)"]
    [(feats, rois, o)] = captured_roi_inputs(model, inputs, masks=False)
    k3 = k3_record(ra, feats, rois, model.featmap_strides, o,
                   "roi_align o=7 float32 (K3), PanoSwin-v2-T request RoIs",
                   f"16a: K3 o=7 f32 on a request's {rois.shape[0]} RoIs")
    k3["launches"] = launches["roi_align (K3)"]
    med = statistics.median(latencies)
    rec = {"config": V2_CONFIG, "dtype": "float32", "frames": V2_REQUEST_FRAMES,
           "input": list(inputs[0].shape), "requests": REQUESTS, "warmup_requests": 2,
           "latency_ms": [t * 1e3 for t in latencies], "median_ms": med * 1e3,
           "images_per_s": V2_REQUEST_FRAMES / med, "peak_memory_gib": peak,
           "stage_ms": stage_ms, "launches": launches, "detections": found, "k1_ms": k1["ms"],
           "k3_ms": k3["ms"], "card": ident}
    print(f"    (a) {os.path.basename(V2_CONFIG)} (PanoSwinTransformerV2 embed 96, depths "
          f"2-2-6-2, window 7, ape, win_trans_type 1, f32, seed-0 weights from a reference "
          f".pth): {REQUESTS} requests of {V2_REQUEST_FRAMES} frames of {H} x {W} "
          f"({V2_INPUT[0]} x {V2_INPUT[1]} after the pipeline) after 2 warm-ups: latency ms "
          f"{[round(t * 1e3, 3) for t in latencies]}, median {med * 1e3:.3f} ms, "
          f"{rec['images_per_s']:.3f} images/s, peak memory {peak:.2f} GiB, {found} detections "
          f"in the last request; launches {launches}; a request by stage (synchronised) ms "
          f"{{{', '.join(f'{k}: {v:.3f}' for k, v in stage_ms.items())}}}; K1 {k1['ms']:.4f} ms, "
          f"K3 {k3['ms']:.4f} ms on this path; card {ident}")
    print(json.dumps({"panoswin_v2_serving": rec}))
    del model
    return rec, [k1, k3]


def v2_training(dev, ident, counters, ra, seed, directory):
    """16b: the PanoSwin-v2-T config through `train_detector`.  Returns the
    record, the K3 rows on the first step's RoIs and the launches by
    (direction, entry, bins)."""
    from panoswintransformerobjectdetection_torch.apis.inference import build_detector_from_cfg
    from panoswintransformerobjectdetection_torch.apis.train import train_detector
    from panoswintransformerobjectdetection_torch.runtime.config import load_config
    cfg = load_config(V2_CONFIG)
    classes = cfg["classes"]
    rng = np.random.default_rng(seed + 161)
    frames = (rng.random((V2_TRAIN_FRAMES, H, W, 3)) * 255).astype(np.uint8)
    ann_file = write_ann(os.path.join(directory, "v2_train.json"), frames, classes,
                         pixel_annotations(rng, V2_TRAIN_FRAMES, H, W, len(classes)))
    dataset = in_memory_dataset(dict(cfg["data"]["train"], classes=classes), ann_file, frames)
    dataset.pipeline.transforms.append(PartialRatio())
    model = build_detector_from_cfg(cfg)
    path = write_trained_like_pth(model, directory, seed + 16)
    start = {k: v.clone() for k, v in torch.load(path, weights_only=True)["state_dict"].items()}
    captured, roi_features = [], model.roi_features

    def pool(feats, rois, out_size=7):
        if not captured:
            captured.append(([f.detach() for f in feats[:4]], rois.detach().clone()))
        return roi_features(feats, rois, out_size)

    model.roi_features = pool
    record = RatioLoopRecord(counters, ra)
    opt, sched = cfg["optimizer"], cfg["lr_config"]
    torch.cuda.reset_peak_memory_stats()
    train_detector(model, dataset, work_dir=os.path.join(directory, "v2_train"), total_epochs=1,
                   batch_size=2, base_lr=opt["lr"], weight_decay=opt["weight_decay"],
                   warmup_iters=sched["warmup_iters"], decay_epochs=sched["step"],
                   log_interval=1, seed=seed, hooks=[record], device=dev, stage=record.stage,
                   num_workers=2, load_from=path)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del model.roi_features
    n_steps = V2_TRAIN_FRAMES // 2
    if len(record.steps) != n_steps or len(record.step_launches) != n_steps:
        raise AssertionError(f"16b: {len(record.steps)} steps, expected {n_steps}")
    by_entry = {"forward": {(ra.ENTRIES[torch.float32], 7): 1},
                "backward": {(ra.BACKWARD_ENTRIES[torch.float32], 7): 1}}
    per_step = {name: 0 for name in counters}
    per_step.update({"roi_align (K3)": 1, "roi_align_backward (K3 backward)": 1})
    for counts, entries in zip(record.step_launches, record.by_entry):
        expect_launches(counts, per_step, "16b PanoSwin-v2-T training step")
        if entries != by_entry:
            raise AssertionError(f"16b: K3's launches by entry {entries}, expected {by_entry}")
    v0 = {r[0] for batch in record.ratios for r in batch}
    if not ({round(x, 6) for x in v0} >= {0.0, V2_PARTIAL[0]}) or any(
            len(batch) != 2 for batch in record.ratios):
        raise AssertionError(f"16b: the steps' ratios {record.ratios} hold no partial and full "
                             "panorama")
    keys = [k for k in record.steps[0] if "loss" in k or k == "grad_norm"]
    if not all(np.isfinite(m[k]) for m in record.steps for k in keys):
        raise AssertionError(f"16b: a loss is not finite: {record.steps}")
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    still = [k for k, _ in model.named_parameters() if torch.equal(state[k], start[k])
             and not k.endswith("relative_position_bias_table")]
    bn = [k for k in state if k.startswith("backbone.patch_embed.proj.") and "running" in k]
    moved_bn = [k for k in bn if not torch.equal(state[k], start[k])]
    nbt = int(state["backbone.patch_embed.proj.1.num_batches_tracked"]) - int(
        start["backbone.patch_embed.proj.1.num_batches_tracked"])
    if still or len(bn) != 4 or moved_bn != bn or nbt != n_steps:
        raise AssertionError(f"16b: parameters that did not move {still[:5]}; stem statistics "
                             f"moved {moved_bn} of {bn}, num_batches_tracked + {nbt}")
    timed = range(1, n_steps)
    step_ms = [record.times["step"][i] * 1e3 for i in timed]
    host = {k: sum(v[i] for i in timed) * 1e3 for k, v in record.times.items()}
    launches = {}
    for entries in record.by_entry:
        for direction, counts in entries.items():
            for (entry, o), n in counts.items():
                launches[(direction, entry, o)] = launches.get((direction, entry, o), 0) + n
    feats, rois = captured[0]
    rois = rois.float().contiguous()
    cot = torch.from_numpy(np.random.default_rng(35).standard_normal(
        (rois.shape[0], 7, 7, feats[0].shape[-1])).astype(np.float32)).to(rois.device)
    rows = [k3_record(ra, feats, rois, (4, 8, 16, 32), 7,
                      "roi_align o=7 float32 (K3), PanoSwin-v2-T sampled RoIs",
                      f"16b: K3 o=7 f32 on the {rois.shape[0]} RoIs the first step sampled"),
            k3_backward_f32_record(ra, cot, rois, [tuple(f.shape) for f in feats],
                                   (4, 8, 16, 32),
                                   "roi_align_backward o=7 f32 (K3 backward), PanoSwin-v2-T "
                                   "sampled RoIs",
                                   f"16b: K3's backward o=7 f32 on the first step's "
                                   f"{rois.shape[0]} RoIs")]
    back = rows[1]
    print(f"  {back['name']}: kernel {back['ms']:.4f} ms ({back['bound_ms'] / back['ms']:.3f} of "
          f"its {back['bound_ms']:.4f} ms bound, {back['bound_by']}), autograd through the twin "
          f"{back['plain_ms']:.4f} ms, no single PyTorch call computes it")
    rows[0]["launches"] = launches[("forward", ra.ENTRIES[torch.float32], 7)]
    rows[1]["launches"] = launches[("backward", ra.BACKWARD_ENTRIES[torch.float32], 7)]
    rec = {"config": V2_CONFIG, "dtype": "float32",
           "pipeline": [p["type"] for p in cfg["data"]["train"]["pipeline"]] + ["PartialRatio"],
           "frames": V2_TRAIN_FRAMES, "batch": 2, "steps": n_steps, "warmup_steps": 1,
           "ratios": record.ratios, "step_ms": step_ms,
           "median_step_ms": statistics.median(step_ms), "stage_ms": host,
           "images_per_s": len(timed) * 2 / (sum(step_ms) / 1e3), "peak_memory_gib": peak,
           "losses": [{k: m[k] for k in keys} for m in record.steps], "launches_step": per_step,
           "stem_statistics": "moved", "card": ident}
    for i, m in enumerate(record.steps):
        print(f"    (b) step {i + 1}{' (warm-up)' if i < 1 else ''}: "
              + ", ".join(f"{k} {m[k]:.6f}" for k in keys)
              + f", {record.times['step'][i] * 1e3:.3f} ms, ratios {record.ratios[i]}")
    print(f"    (b) {os.path.basename(V2_CONFIG)} (f32, trained-like random weights from a "
          f"reference .pth): {n_steps} steps of 2 frames of {H} x {W} through "
          f"{'/'.join(rec['pipeline'][1:])}, {len(timed)} timed: median step "
          f"{rec['median_step_ms']:.3f} ms, {rec['images_per_s']:.3f} images/s over the steps, "
          f"host ms {{{', '.join(f'{k}: {v:.3f}' for k, v in host.items())}}}, peak memory "
          f"{peak:.2f} GiB; every step's K3 launches: forward {by_entry_text(by_entry['forward'])}"
          f"; backward {by_entry_text(by_entry['backward'])}; no other kernel; every parameter "
          f"that a loss reaches moved; the stem's BatchNorm statistics moved; card {ident}")
    print(json.dumps({"panoswin_v2_training": rec}))
    del model
    return rec, rows, launches


def v2_nano_card_vs_cpu(dev, directory):
    """16c: the card against the CPU in f32, TF32 off: the nano v2
    detector's detections with per-image ratios, a nano v1 backbone and a
    nano v2 backbone with the `'tf'` embed and the basketball warp."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    from panoswintransformerobjectdetection_torch.models.panoswin_v1 import (
        PanoSwinTransformerV1)
    from panoswintransformerobjectdetection_torch.models.panoswin_v2 import (
        PanoSwinTransformerV2)
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    path = write_reference_pth(V2_NANO, directory, 3)
    g = torch.Generator().manual_seed(16)
    images = torch.randn((2, 64, 128, 3), generator=g)
    shapes = torch.tensor([[64.0, 128.0]] * 2)
    ratios = torch.tensor([[0.0, 1.0, 64.0], [V2_PARTIAL[0], V2_PARTIAL[1], 80.0]])
    got, want = (init_detector(V2_NANO, path, device=d).simple_test(
        images.to(d), shapes.to(d), pano_ratio_v=ratios.to(d)) for d in (dev, "cpu"))
    as_dicts = [[{"boxes": t.boxes[i][t.mask[i]].cpu().numpy(),
                  "scores": t.scores[i][t.mask[i]].cpu().numpy(),
                  "labels": t.labels[i][t.mask[i]].cpu().numpy()} for i in range(2)]
                for t in (got, want)]
    if not sum(len(d["boxes"]) for d in as_dicts[1]):
        raise AssertionError("16c: the nano v2 detector found nothing on the CPU")
    box_err, score_err = match_detections(*as_dicts, 1e-3, 1e-5, "16c nano v2 detector")
    errs = {"detector": {"box": box_err, "score": score_err,
                         "detections": [len(d["boxes"]) for d in as_dicts[1]]}}
    # the 'tf' embed's 8 heads need an embed width that 8 divides
    kw = {"embed_dim": 16, "depths": (2, 2, 2, 2), "num_heads": (1, 1, 2, 2), "window_size": 4,
          "ape": True, "drop_path_rate": 0.0}
    for name, cls, extra in (("v1", PanoSwinTransformerV1, {}),
                             ("v2 tf basketball", PanoSwinTransformerV2,
                              {"emb_conv_type": "tf", "basketball_trans": True})):
        cpu = cls(**kw, **extra)
        init_weights(cpu, 17)
        card = cls(**kw, **extra)
        card.load_state_dict(cpu.state_dict())
        with torch.no_grad():
            ref = cpu.eval()(images, ratios)
            out = card.to(dev).eval()(images.to(dev), ratios.to(dev))
        errs[name] = max(check(f"16c nano {name} backbone stage {i}, card vs CPU", o.cpu(), r,
                               1e-4 * max(1.0, float(r.abs().max())))
                         for i, (o, r) in enumerate(zip(out, ref)))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    print(f"    (c) card vs CPU, f32, TF32 off: the nano v2 detector (embed 12, per-image ratios "
          f"{ratios.tolist()}) {errs['detector']['detections']} detections, boxes within "
          f"{box_err:.3g} px, scores within {score_err:.3g}; nano backbones' largest stage "
          f"error: v1 {errs['v1']:.3g}, v2 'tf' + basketball {errs['v2 tf basketball']:.3g}")
    return errs


def panoswin_v2_path(dev, ident, counters, stem, ra, seed):
    """Phase 16 (module docstring).  Returns the record, the kernel rows and
    the launches by (direction, entry, bins), K1's as ("stem", None, None)."""
    with tempfile.TemporaryDirectory() as directory:
        serving, rows = v2_serving(dev, ident, counters, stem, ra, seed, directory)
        training, train_rows, launches = v2_training(dev, ident, counters, ra, seed, directory)
        nano = v2_nano_card_vs_cpu(dev, directory)
    launches[("stem", None, None)] = serving["launches"]["stem_conv (K1)"]
    forward = ("forward", ra.ENTRIES[torch.float32], 7)
    launches[forward] = launches.get(forward, 0) + serving["launches"]["roi_align (K3)"]
    return ({"16a": serving, "16b": training, "16c": nano}, rows + train_rows, launches)

# Phase 17: the rest of the CNN-backbone two-stage zoo: HRNet with HRFPN,
# Mask Scoring R-CNN and TridentNet, serving and training.
ZOO_HRNET_MASK = "configs/hrnet/mask_rcnn_hrnetv2p_w32_1x_coco.py"
ZOO_HRNET_CASCADE = "configs/hrnet/cascade_mask_rcnn_hrnetv2p_w32_20e_coco.py"
ZOO_MS = "configs/ms_rcnn/ms_rcnn_r50_fpn_1x_coco.py"
ZOO_TRIDENT = "configs/tridentnet/tridentnet_r50_caffe_1x_coco.py"
ZOO_FRAMES, ZOO_REQUESTS = 8, 3
# 17d: a nano Mask Scoring R-CNN (ResNet-18, FPN 16, 5 classes).
ZOO_NANO_MS = {"model": {
    "type": "MaskScoringRCNN", "backbone": {"type": "ResNet", "depth": 18},
    "neck": {"type": "FPN", "in_channels": (64, 128, 256, 512), "out_channels": 16,
             "num_outs": 5},
    "num_classes": 5,
    "test_cfg": {"rpn": {"nms_pre": 256, "max_per_img": 64, "iou_threshold": 0.7,
                         "min_bbox_size": 0},
                 "rcnn": {"score_thr": 0.05, "iou_threshold": 0.5, "max_per_img": 8}}}}


def ms_rescoring(model, dataset):
    """17c's check of Mask Scoring R-CNN's rescoring on the first batch:
    `simple_test_masks`' valid slots are `simple_test`'s, their scores
    scaled by the predicted IoU clipped to [0, 1] (so at most the plain
    ones, and not all equal), the padded slots' scores untouched."""
    inputs = first_batch(dataset, model.device)
    plain = model.simple_test(*inputs)
    det, _ = model.simple_test_masks(*inputs)
    m = det.mask
    ratio = det.scores[m] / plain.scores[m]
    if (not torch.equal(m, plain.mask) or not m.any() or not (ratio <= 1 + 1e-6).all()
            or torch.equal(det.scores, plain.scores)
            or not torch.equal(det.scores[~m], plain.scores[~m])):
        raise AssertionError("17c: Mask Scoring R-CNN's scores are not the plain detections' "
                             "times the clipped predicted IoU")
    rec = {"rescored_slots": int(m.sum()), "score_ratio_mean": float(ratio.mean()),
           "score_ratio_min": float(ratio.min()), "score_ratio_max": float(ratio.max())}
    print(f"    (17c) Mask Scoring R-CNN rescoring on the first batch: {rec['rescored_slots']} "
          f"detections, score / plain score mean {rec['score_ratio_mean']:.4f} (min "
          f"{rec['score_ratio_min']:.4f}, max {rec['score_ratio_max']:.4f}); the bbox and segm "
          f"results carry the rescored scores")
    return {"rescoring": rec}


def trident_unreached(key):
    """The parameters of a TridentResNet that no loss reaches: the outer
    branches' BatchNorms in res4's trident blocks."""
    from panoswintransformerobjectdetection_torch.models.backbones_extra import OUTER_BRANCHES
    parts = key.split(".")
    return (key.startswith("backbone.layer3.") and len(parts) == 6 and parts[3] in
            ("bn1", "bn2", "bn3") and int(parts[4]) in OUTER_BRANCHES)


def zoo_card_vs_cpu(dev, directory):
    """17d: the card against the CPU in f32, TF32 off: an HRNet-W18 with
    HRFPN on 2 frames of 72 x 104 (non-integer upsampling, pooled levels
    down to 1 x 1), a `MaskIoUHead` on 16 RoIs, a TridentResNet-50 on 2
    frames of 64 x 96 (eval), each output within 1e-4 * max(1, max|ref|);
    the nano Mask Scoring R-CNN's rescored detections (equal counts, 1e-3
    px, 1e-5)."""
    from panoswintransformerobjectdetection_torch.apis.inference import init_detector
    from panoswintransformerobjectdetection_torch.flagship import init_weights
    from panoswintransformerobjectdetection_torch.models.backbones_extra import TridentResNet
    from panoswintransformerobjectdetection_torch.models.hrnet import HRFPN, HRNet
    from panoswintransformerobjectdetection_torch.models.mask_head import MaskIoUHead
    defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(17)
    errs = {}
    try:
        hrnet = torch.nn.Sequential(HRNet(width=18), HRFPN((18, 36, 72, 144), 256))
        trident = TridentResNet(depth=50)
        head = MaskIoUHead(80, 256)
        cases = (("HRNet-W18 + HRFPN", hrnet, (torch.randn((2, 72, 104, 3), generator=g),)),
                 ("TridentResNet-50", trident, (torch.randn((2, 64, 96, 3), generator=g),)),
                 ("MaskIoUHead", head, (torch.randn((16, 14, 14, 256), generator=g),
                                        torch.rand((16, 28, 28), generator=g))))
        for seed, (name, module, args) in enumerate(cases):
            init_weights(module, 170 + seed)
            perturb_batch_norms(module, 180 + seed)
            with torch.no_grad():
                ref = module.eval()(*args)
                out = module.to(dev)(*(a.to(dev) for a in args))
            ref, out = (x if isinstance(x, tuple) else (x,) for x in (ref, out))
            errs[name] = max(check(f"17d {name} output {i}, card vs CPU", o.cpu(), r,
                                   1e-4 * max(1.0, float(r.abs().max())))
                             / max(1.0, float(r.abs().max())) for i, (o, r) in
                             enumerate(zip(out, ref)))
            module.cpu()
        path = write_cnn_reference_pth(ZOO_NANO_MS, directory, 3, "17d_ms")
        images = torch.randn((2, 64, 128, 3), generator=g)
        shapes = torch.tensor([[64.0, 128.0], [60.0, 120.0]])
        sf = torch.tensor([[1.0] * 4, [1.25] * 4])
        dets = [init_detector(ZOO_NANO_MS, path, device=d).simple_test_masks(
            images.to(d), shapes.to(d), sf.to(d))[0] for d in (dev, "cpu")]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = defaults
    as_dicts = [[{"boxes": t.boxes[i][t.mask[i]].cpu().numpy(),
                  "scores": t.scores[i][t.mask[i]].cpu().numpy(),
                  "labels": t.labels[i][t.mask[i]].cpu().numpy()} for i in range(2)]
                for t in dets]
    n = [len(d["boxes"]) for d in as_dicts[1]]
    if not sum(n):
        raise AssertionError("17d: the nano Mask Scoring R-CNN found nothing on the CPU")
    box_err, score_err = match_detections(*as_dicts, 1e-3, 1e-5,
                                          "17d nano Mask Scoring R-CNN")
    errs["nano Mask Scoring R-CNN"] = {"detections": n, "box": box_err, "score": score_err}
    print(f"    (17d) card vs CPU, f32, TF32 off: largest output error / max(1, max|ref|): "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items() if not isinstance(v, dict))
          + f" (tolerance 1e-4); the nano Mask Scoring R-CNN's {n} rescored detections, boxes "
          f"within {box_err:.3g} px (1e-3), scores within {score_err:.3g} (1e-5)")
    return errs


def zoo_path(dev, ident, counters, ra, seed):
    """Phase 17 (module docstring).  Returns the record, the kernel rows and
    the launches of its main paths by (direction, entry, bins)."""
    f32, bf16 = ra.ENTRIES[torch.float32], ra.ENTRIES[torch.bfloat16]
    f32_b = ra.BACKWARD_ENTRIES[torch.float32]
    at7 = {"forward": {(f32, 7): 1}, "backward": {(f32_b, 7): 1}}
    at7_14 = {"forward": {(f32, 7): 1, (f32, 14): 1}, "backward": {(f32_b, 7): 1, (f32_b, 14): 1}}
    launches, rec, seconds, rows = {}, {}, {}, []

    def count(direction, entry, by_size):
        for o, n in by_size.items():
            launches[(direction, entry, o)] = launches.get((direction, entry, o), 0) + n

    def timed(label, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[label] = time.perf_counter() - t0
        return out

    with tempfile.TemporaryDirectory() as directory:
        rec["17a"], k3 = timed("17a", lambda: resnet_eval(
            dev, ident, counters, ra, seed, directory, ZOO_HRNET_MASK, "17a", True, (7, 14),
            frames=ZOO_FRAMES, name="HRNet-W32"))
        count("forward", f32, rec["17a"]["k3_launches_by_size"])
        rows += k3
        rec["17a_cascade"], k3 = timed("17a_cascade", lambda: resnet_cascade_requests(
            dev, ident, counters, ra, directory, ZOO_HRNET_CASCADE, "17a_cascade", ZOO_REQUESTS,
            "HRNet-W32", stage_rows=True))
        count("forward", bf16, rec["17a_cascade"]["k3_launches_by_size"])
        rows += k3
        for config, label, by_entry, kw in (
                (ZOO_HRNET_MASK, "17b_hrnet", at7_14, {"masks": True}),
                (ZOO_MS, "17b_ms", at7_14, {"masks": True, "capture": 14}),
                (ZOO_TRIDENT, "17b_trident", at7, {"unreached": trident_unreached})):
            rec[label], n, sampled = timed(label, lambda: resnet_train_loop(
                dev, ident, counters, ra, seed, directory, config, label, by_entry,
                frames=ZOO_FRAMES, **kw))
            for key, v in n.items():
                launches[key] = launches.get(key, 0) + v
            if label == "17b_ms":
                rois, shapes, feats = sampled
                rois = rois.float().contiguous()
                what = (f"17b: K3 o=14 f32 on the {rois.shape[0]} positive RoIs the first step "
                        "sampled")
                rows.append(k3_record(ra, feats, rois, (4, 8, 16, 32), 14,
                                      "roi_align o=14 float32 (K3), Mask Scoring R-CNN sampled "
                                      "positives", what))
                cot = torch.from_numpy(np.random.default_rng(37).standard_normal(
                    (rois.shape[0], 14, 14, shapes[0][-1])).astype(np.float32)).to(dev)
                rows.append(k3_backward_f32_record(
                    ra, cot, rois, shapes, (4, 8, 16, 32),
                    "roi_align_backward o=14 f32 (K3 backward), Mask Scoring R-CNN sampled "
                    "positives", what.replace("K3", "K3's backward")))
                back = rows[-1]
                print(f"  {back['name']}: kernel {back['ms']:.4f} ms "
                      f"({back['bound_ms'] / back['ms']:.3f} of its {back['bound_ms']:.4f} ms "
                      f"bound, {back['bound_by']}), autograd through the twin "
                      f"{back['plain_ms']:.4f} ms, no single PyTorch call computes it")
                del feats, sampled
        rec["17c_ms"], _ = timed("17c_ms", lambda: resnet_eval(
            dev, ident, counters, ra, seed, directory, ZOO_MS, "17c_ms", True, (),
            frames=ZOO_FRAMES, name="ResNet-50 Mask Scoring R-CNN", extra=ms_rescoring))
        count("forward", f32, rec["17c_ms"]["k3_launches_by_size"])
        rec["17c_trident"], k3 = timed("17c_trident", lambda: resnet_eval(
            dev, ident, counters, ra, seed, directory, ZOO_TRIDENT, "17c_trident", False, (7,),
            frames=ZOO_FRAMES, name="TridentResNet-50"))
        count("forward", f32, rec["17c_trident"]["k3_launches_by_size"])
        rows += k3
        rec["17d"] = timed("17d", lambda: zoo_card_vs_cpu(dev, directory))
    rec["seconds"] = seconds
    print("    phase 17 seconds by part: " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    rec["launches_by_entry"] = {f"{d} {e} o={o}": n for (d, e, o), n in sorted(launches.items())}
    rec["card"] = ident
    return rec, rows, launches


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Drive the PyTorch port on one CUDA card.")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the synthetic frames and boxes of phases 7-17")
    parser.add_argument("--dist-child", nargs=2, metavar=("PART", "DIR"), default=None,
                        help="run one process of phase 15's part PART (15a, 15b or 15c) "
                             "under torchrun's environment, with its files in DIR")
    parser.add_argument("--dist-cards", type=int, default=None, metavar="N",
                        help="run phase 15b alone across N cards, one process each over NCCL, "
                             "against one process, and stop")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if args.dist_child:
        return dist_child(*args.dist_child)
    if args.dist_cards:
        return dist_cards(args.dist_cards, args.seed)
    from panoswintransformerobjectdetection_torch.device import gpu_identity
    from panoswintransformerobjectdetection_torch.flagship import (build_flagship,
                                                                   flagship_inputs,
                                                                   flagship_train_batch)
    from panoswintransformerobjectdetection_torch.ops import cuda_build
    from panoswintransformerobjectdetection_torch.ops import fused_attention as fa
    from panoswintransformerobjectdetection_torch.ops import roi_align as ra
    from panoswintransformerobjectdetection_torch.ops import stem_conv as stem

    ident = gpu_identity()
    dev = torch.device("cuda")
    print(f"[1] card: {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {ident}")
    tf32_defaults = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("    TF32 is off for cuDNN convolutions and matmuls in phases 3 and 4's checks")

    seconds = cuda_build.build_all()
    print(f"[2] built {', '.join(cuda_build.SOURCES)} for sm_90a in {seconds:.1f} s")
    for name in cuda_build.SOURCES:
        for line in cuda_build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    print("[3] kernels against their twins at the flagship's shapes.  K1 tolerance: f32 "
          "1e-4 * max(1, max|ref|) (3xTF32 sums in another order, the lo.lo term dropped); "
          "bf16 4 units of 2**-8 * "
          "max|ref| (another f32 sum order can flip the bf16 rounding of an h0 value, "
          "and h1's own rounding adds one).  K3 tolerance 0: kernel and twin do the "
          "same operations in the same order.  K2 and K5: f32 1e-5 * max(1, max|ref|); "
          "bf16 4 units of 2**-8 * max|ref| (another sum order can flip the bf16 "
          "rounding of p, which moves an output by about one unit)")
    records = [kernel_k1(dev, stem), kernel_k2(dev, fa), kernel_k3(dev, ra),
               kernel_k5(dev, fa), kernel_k4(dev, ra), kernel_k3_backward(dev, ra)]
    mask_records = kernel_k3_mask(dev, ra)
    dense_against_direct(dev, ra)

    print("[4] flagship simple_test, bf16, BN folded, random weights (seed 0); before it "
          "the f32 checks of the card's path against the CPU's, training included")
    reference_check(dev, build_flagship)
    reference_check(dev, build_flagship, fused_attention=True)
    train_reference_check(dev, build_flagship, flagship_train_batch)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    print(f"    timed requests with PyTorch's TF32 defaults: cuDNN {tf32_defaults[0]}, "
          f"matmul {tf32_defaults[1]}")
    counters = {"stem_conv (K1)": stem.stem_conv, "roi_align (K3)": ra.roi_align,
                "window_attention (K2)": fa.window_attention,
                "dense_crop (K4)": ra.dense_crop,
                "roi_align_backward (K3 backward)": ra.roi_align_backward}
    inputs = flagship_inputs(B, dev)
    models = {"plain": build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0),
              "fused": build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0,
                                      fused_attention=True)}
    inference = {"stem_conv (K1)": None, "roi_align (K3)": None, "dense_crop (K4)": 0,
                 "roi_align_backward (K3 backward)": 0}
    expected = {"plain": {**inference, "window_attention (K2)": 0},
                "fused": {**inference, "window_attention (K2)": K2_PER_REQUEST}}
    with torch.no_grad():
        feats = {name: m.backbone(inputs[0]) for name, m in models.items()}
    for i, (a, b) in enumerate(zip(feats["fused"], feats["plain"])):
        scale = float(b.abs().max())
        check(f"fused vs plain backbone, bf16, stage {i} (max|ref| {scale:.3f})", a, b,
              BACKBONE_TOL_UNITS * 2.0 ** -8 * scale)
    for model in models.values():
        model.simple_test(*inputs)                                 # warm-up
    latencies = {name: [] for name in models}
    launches = {name: {c: 0 for c in counters} for name in models}
    dets = {}
    for _ in range(REQUESTS):
        for name, model in models.items():
            fa.window_attention.last_entry = None
            dets[name], sec, counts = timed_request(model, inputs, counters)
            expect_launches(counts, expected[name], f"{name} flagship")
            if name == "fused":
                expect_k2_entry(fa, "fused flagship")
            latencies[name].append(sec)
            for c, v in counts.items():
                launches[name][c] += v
    for name in models:
        found = check_detections(dets[name], f"{name} flagship")
        med = statistics.median(latencies[name])
        print(f"    {name}: {REQUESTS} requests of {B} frames, alternating with the other "
              f"configuration: latency ms {[round(t * 1e3, 3) for t in latencies[name]]}, "
              f"median {med * 1e3:.3f} ms, {B / med:.3f} images/s, {found} detections in the "
              f"last request; launches during the requests {launches[name]}; card {ident}")
    del models, feats
    planar = build_flagship(compute_dtype=torch.bfloat16, device=dev, seed=0,
                            fused_attention=True, pano_mode=False)
    planar.simple_test(*inputs)                                    # warm-up
    fa.window_attention.last_entry = None
    det, sec, counts = timed_request(planar, inputs, counters)
    expect_launches(counts, expected["fused"], "planar fused flagship")
    expect_k2_entry(fa, "planar fused flagship")
    found = check_detections(det, "planar fused flagship")
    print(f"    planar (pano_mode=False), fused attention: one request {sec * 1e3:.3f} ms, "
          f"{found} detections, launches {counts}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card {ident}")

    del planar, det
    print(f"[5] flagship training step, bf16 compute, f32 parameters, AdamW lr 1e-4, {B} x "
          f"{H} x {W}, 32 boxes a frame, PyTorch's TF32 defaults")
    launches["train"], sampled = training_path(dev, ident, build_flagship,
                                               flagship_train_batch, counters)
    k3_backward_sampled(dev, ra, records[-1], sampled)

    print("[6] inference API on the card, bf16, PyTorch's TF32 defaults except in (b)")
    launches["api"] = api_path(dev, ident, counters, stem, ra)

    print("[7] evaluation path on the card: build_dataset, DetDataLoader, single_device_test, "
          "COCOeval with the native matcher; f32 configs, PyTorch's TF32 defaults except in "
          "(b) and K1's f32 timing")
    evaluation = eval_path(dev, ident, counters, stem, ra, args.seed)
    launches["eval"] = evaluation["launches"]

    print("[8] training loop on the card: train_detector over the bf16 streetwin config's own "
          "train_pipeline, checkpoints, resume, eval after each epoch; PyTorch's TF32 defaults "
          "except in (b)")
    loop = training_loop_path(dev, ident, counters, stem, ra, args.seed)
    launches["loop"] = loop["launches"]

    print("[9] Swin-T Mask R-CNN serving on the card: init_detector from a reference .pth, "
          "single_device_test(with_masks=True), paste, RLE, evaluate(bbox, segm); PyTorch's "
          "TF32 defaults except in (c)")
    masks = mask_rcnn_path(dev, ident, counters, ra, args.seed)

    print("[10] Swin-T Mask R-CNN training on the card: train_detector over the mstrain config's "
          "own train_pipeline (masks, flip, multi-scale resize, pad), bf16; the nano model card "
          "vs CPU in f32 with TF32 off; K3's backward at 14 x 14 against its twin; PyTorch's "
          "TF32 defaults elsewhere")
    mask_training, backward_14 = mask_training_path(dev, ident, counters, ra, args.seed)

    print("[11] Cascade Mask R-CNN serving on the card: the Swin-S and Swin-B configs in bf16, "
          "single_device_test(with_masks=True), evaluate(bbox, segm); K3 three times at 7 and "
          "once at 14 a batch; the nano cascade card vs CPU in f32 with TF32 off; PyTorch's "
          "TF32 defaults elsewhere")
    cascade = cascade_path(dev, ident, counters, ra, args.seed)

    print("[12] Cascade Mask R-CNN training on the card: train_detector over the Swin-S 3x "
          "config's own train_pipeline, bf16, K3 three times at 7 forward and backward a step; "
          "the nano cascade with the GIoU loss card vs CPU in f32 with TF32 off; K3's backward "
          "at 7 on the refined RoIs; PyTorch's TF32 defaults elsewhere")
    cascade_training, backward_cascade = cascade_training_path(dev, ident, counters, ra,
                                                                args.seed)

    print("[13] ResNet-family detectors serving on the card: the R-50 Faster and Mask R-CNN "
          "configs in f32 through the eval loop, the R-50 Cascade Mask R-CNN in bf16, a caffe "
          "ResNet-50, a ResNeXt-101 and a RegNetX-3.2GF card vs CPU in f32 with TF32 off; "
          "PyTorch's TF32 defaults elsewhere")
    resnet, resnet_k3 = resnet_path(dev, ident, counters, ra, args.seed)

    print("[14] ResNet-family training and the Res2Net and ResNeSt detectors on the card: the "
          "R-50 Faster R-CNN (f32), the live-BatchNorm R-50 Mask R-CNN (f32) and the R-50 "
          "Cascade Mask R-CNN (bf16) through train_detector; five backbones' forward_train "
          "card vs CPU in f32 with TF32 off, their backbones in f64; pretrained files; Res2Net-101 "
          "and ResNeSt-50 serving, ResNeSt-50 Mask R-CNN training; K3's f32 backward on 14a's "
          "RoIs; PyTorch's TF32 defaults elsewhere")
    resnet_training, training_launches, k3_backward_resnet = resnet_training_path(
        dev, ident, counters, ra, args.seed)

    print("[15] distributed training and evaluation on the card: (a) the bf16 flagship "
          "config through train_detector and multi_host_test under torch.distributed.run, "
          "NCCL, world 1, against no process group; (b) the f32 flagship, 2 processes over "
          "gloo, 2 steps against one process on both frames, multi_host_test against "
          "single_device_test; (c) the gcnet R-50 Mask R-CNN with live BatchNorm, 2 processes, "
          "one step against one process; TF32 off in (b) and (c)")
    distributed, dist_launches = distributed_path(dev, ident, counters, ra, args.seed)

    print("[16] the reference's own PanoSwin, the v-variant, on the card: (a) the PanoSwin-v2-T "
          "Faster R-CNN config served in f32 from a reference .pth, K1 and K3 once a request; "
          "(b) the same config through train_detector, a partial and a full panorama a batch, "
          "K3 forward and backward once a step; (c) nano models card vs CPU in f32 with TF32 "
          "off; PyTorch's TF32 defaults elsewhere")
    panoswin_v2, v2_rows, v2_launches = panoswin_v2_path(dev, ident, counters, stem, ra,
                                                         args.seed)

    for rec in records:
        key = rec.get("shares_kernel_of", rec["name"])
        if key in ("dense_crop (K4)", "roi_align_backward (K3 backward)"):
            path = "train"
        else:
            path = "fused" if "attention" in rec["name"] else "plain"
        rec["launches"] = launches[path][key]
        if key == "roi_align (K3)":
            rec["launches_training"] = launches["train"][key]
        rec["launches_api"] = launches["api"][key]
        rec["launches_eval"] = launches["eval"][key]
        rec["launches_training_loop"] = launches["loop"][key]
        if key == "stem_conv (K1)":
            rec["f32_eval_shape"] = evaluation["k1_f32"]
        rec["launches_mask_rcnn"] = (masks["9a"]["k3_launches_by_size"][7]
                                     + masks["9b"]["k3_launches_by_size"][7]
                                     if key == "roi_align (K3)" else 0)
        # at 7 x 7 bins, over 10a's steps
        rec["launches_mask_training"] = (
            mask_training["forward_launches_by_size"][7] if key == "roi_align (K3)" else
            mask_training["backward_launches_by_size"][7]
            if key == "roi_align_backward (K3 backward)" else 0)
    # K3 at 14: its main path is phase 9's mask branch, 9b (bf16) and 9a (f32)
    for rec, label in zip(mask_records, ("9b", "9a")):
        rec["launches"] = masks[label]["k3_launches_by_size"][14]
    mask_records[0]["launches_mask_training"] = mask_training["forward_launches_by_size"][14]
    records += mask_records + backward_14
    # 11a and 11b run bf16: K3 at 7 is the bf16 record of phase 3, at 14 the bf16 o=14 record
    cascade_k3 = {o: cascade["11a"]["k3_launches_by_size"][o]
                  + cascade["11b"]["k3_launches_by_size"][o] for o in (7, 14)}
    for rec in records:
        rec["launches_cascade"] = (cascade_k3[7] if rec["name"] == "roi_align (K3)" else
                                   cascade_k3[14] if rec["name"] == "roi_align o=14 bfloat16 (K3)"
                                   else 0)
        # 12a runs bf16 at 7: K3's record of phase 3 and its backward's
        rec["launches_cascade_training"] = cascade_training["launches"].get(rec["name"], 0)
    for rec in backward_cascade:
        rec["launches_cascade"] = 0
    records += backward_cascade
    # 13a and 13b run K3's f32 entry (7 and 14), 13c its bf16 entries
    f32_7 = resnet["13a"]["k3_launches_by_size"][7] + resnet["13b"]["k3_launches_by_size"][7]
    resnet_k3_launches = {"roi_align (K3)": resnet["13c"]["k3_launches_by_size"][7],
                          "roi_align o=14 bfloat16 (K3)": resnet["13c"]["k3_launches_by_size"][14],
                          "roi_align o=14 float32 (K3)": resnet["13b"]["k3_launches_by_size"][14],
                          resnet_k3[0]["name"]: f32_7,
                          resnet_k3[1]["name"]: resnet["13b"]["k3_launches_by_size"][14]}
    for rec in resnet_k3:                      # their main path is phase 13
        rec["launches"] = resnet_k3_launches[rec["name"]]
        for key in records[0]:
            if key.startswith("launches_"):
                rec[key] = 0
    records += resnet_k3
    for rec in records:
        rec["launches_resnet"] = resnet_k3_launches.get(rec["name"], 0)
    # 14f's row: its main path is phase 14
    for key in records[0]:
        if key.startswith("launches_"):
            k3_backward_resnet[key] = 0
    records.append(k3_backward_resnet)
    # phase 14's main paths: every K3 row takes the launches of its own
    # direction, entry and bins (rows of one entry and size, timed on other
    # RoIs, take the same count)
    directions = {"roi_align (K3)": "forward", "roi_align_backward (K3 backward)": "backward"}
    for rec in records:
        direction = directions.get(rec.get("shares_kernel_of", rec["name"]))
        rec["launches_resnet_training"] = (training_launches.get(
            (direction, rec.get("entry"), rec.get("out_size", 7)), 0) if direction else 0)
    k3_backward_resnet["launches"] = k3_backward_resnet["launches_resnet_training"]
    # phase 15's main paths, summed over its children: K1 in the evaluations,
    # every K3 row by its direction, entry and bins
    for rec in records:
        key = rec.get("shares_kernel_of", rec["name"])
        direction = directions.get(key)
        rec["launches_distributed"] = (
            dist_launches.get(("stem", None, None), 0) if key == "stem_conv (K1)" else
            dist_launches.get((direction, rec.get("entry"), rec.get("out_size", 7)), 0)
            if direction else 0)
    # phase 16's main paths: K1's f32 entry in 16a's requests, every K3 row
    # by its direction, entry and bins over 16a's requests and 16b's steps
    for rec in v2_rows:
        for key in records[0]:
            if key.startswith("launches_"):
                rec[key] = 0
    records += v2_rows
    f32_stem = stem.ENTRIES[torch.float32]
    for rec in records:
        key = rec.get("shares_kernel_of", rec["name"])
        direction = directions.get(key)
        if key == "stem_conv (K1)":
            n = v2_launches[("stem", None, None)] if rec.get("entry") == f32_stem else 0
        else:
            n = v2_launches.get((direction, rec.get("entry"), rec.get("out_size", 7)), 0)
        rec["launches_panoswin_v2"] = n
    print("[17] the rest of the CNN-backbone two-stage zoo on the card: (a) the HRNet-W32 Mask "
          "R-CNN (f32) through the eval loop and the bf16 HRNet-W32 Cascade Mask R-CNN; (b) the "
          "HRNet-W32 Mask R-CNN, the R-50 Mask Scoring R-CNN and TridentNet through "
          "train_detector; (c) Mask Scoring R-CNN and TridentNet through the eval loop; (d) card "
          "vs CPU in f32 with TF32 off; PyTorch's TF32 defaults elsewhere")
    zoo, zoo_rows, zoo_launches = zoo_path(dev, ident, counters, ra, args.seed)
    for rec in zoo_rows:
        for key in records[0]:
            if key.startswith("launches_"):
                rec[key] = 0
    records += zoo_rows
    # phase 17's main paths: every K3 row by its direction, entry and bins
    for rec in records:
        direction = directions.get(rec.get("shares_kernel_of", rec["name"]))
        rec["launches_cnn_zoo"] = (zoo_launches.get(
            (direction, rec.get("entry"), rec.get("out_size", 7)), 0) if direction else 0)
    for rec in zoo_rows:
        rec["launches"] = rec["launches_cnn_zoo"]
    print("[18] records")
    print(json.dumps({"evaluation": {k: v for k, v in evaluation.items() if k != "k1_f32"}}))
    print(json.dumps({"training_loop": loop}))
    print(json.dumps({"mask_rcnn": masks}))
    print(json.dumps({"mask_rcnn_training": mask_training}))
    print(json.dumps({"cascade_mask_rcnn": cascade}))
    print(json.dumps({"cascade_training": cascade_training}))
    print(json.dumps({"resnet_detectors": resnet}))
    print(json.dumps({"resnet_training": resnet_training}))
    print(json.dumps({"distributed": distributed}))
    print(json.dumps({"panoswin_v2": panoswin_v2}))
    print(json.dumps({"cnn_zoo": zoo}))
    print(json.dumps({"kernels": records}))
    print(ident)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
