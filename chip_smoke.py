#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

Run from the root of a checkout, with one card visible:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device — refuse to run without CUDA; print `nvidia-smi`'s name and power
   limit line.
2. build — compile every `csrc/*.cu` of the port for sm_90a (one `nvcc` per
   source, in parallel) into `build/kernels/`.
3. kernels — call the RoIAlign kernel pair
   (`csrc/roi_align_pyramid.cu`: one forward, one backward, for one level
   or several) through its wrappers at each path's shapes, hold it against
   the plain torch versions (f32 with TF32 off, and bf16; both layouts),
   and time kernel and plain version with CUDA events: at one level the
   forward at the DC5 serving shape and the backward at the training shape;
   on four levels the forward on the pyramid of the 608x1024 serving canvas
   (and once at o=14) and the backward on the pyramid of the 512x1024
   training canvas, with the RoI count per level. The backward logs its
   f32 atomic adds, those of the earlier design beside its own.
4. serving — `init_detector` on the flagship config
   (configs/da/faster_rcnn_r50_daf_c2f.py: DAFasterRCNN, R50-DC5, full
   width) with seeded random weights, then 4 requests of 2 Cityscapes-size
   images through `inference_detector`. The kernel launch counts are set to
   0 just before and read just after; every request must launch the
   forward once and the backward never. Outputs must be well-formed and
   finite, and on the last request's proposals the kernel's RoI features
   must match the plain version's.
5. train — `init_trainer` on the same config (R50-DC5, 'daf', full width,
   f32) with seeded random weights; 1 warm-up and 5 timed steps, past the
   lr warmup, on a seeded batch of 2 images of 512x1024 (one source, one
   target). Every step must give finite losses and launch the RoIAlign forward and backward kernels
   once each (counts set to 0 before the step, read after). Afterwards the
   frozen stem and layer1 are bit-identical, every other parameter, the DA
   heads' BatchNorm statistics and the EMA have moved. Then the RoIs that a
   step of the trained model samples hold the pair to the plain version,
   and the backward is timed on them.
6. FPN serving — `init_detector` on the Cityscapes Faster R-CNN R50-FPN
   config (configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py, full
   width: R50, 256-channel FPN P2–P6, 8 classes), 4 requests as in 4, each
   launching the forward once for all levels; the kernel's RoI features
   on the last request's proposals match the plain version's.
7. FPN train — `init_trainer` on the same config, 1 warm-up and 5 timed
   steps past the lr warmup on the 2 images of 512x1024: each step
   launches the RoIAlign forward and backward kernels once each;
   afterwards the frozen stem and layer1 are bit-identical and every other
   parameter (neck and RPN included) has moved (the config asks for no
   EMA). Then the RoIs that a step of the trained model samples, from gt
   boxes on every level, hold the pair to the plain version on all four
   levels, and the backward is timed on them.
8. reference — the tiny-fixture DC5 detector and a tiny FPN detector (the
   FPN config with an R18 trunk, a 64-channel neck and 2 classes) on the
   card against the same weights on the CPU (plain versions), TF32 off:
   inference, and one train step with dropout off and the same sampler
   priorities.
9. mask kernels — the pair in the mask slice's three regimes, f32 and
   bf16, against the plain version, forwards timed: (a) 14x14 mask
   features on four levels (C = 256), forward and backward, and on
   detections with zero-area padded rows; (b) the mask targets, 28x28 and
   14x14 crops of 2 x 512 single-RoI 112x112 rasters (C = 1, scale 1,
   aligned=False) whose RoIs run from inside to far beyond the raster, some
   under a pixel; (c) C4's 14x14 crops at C = 1024, forward and backward.
10. mask serving — `init_detector` on the Cityscapes Mask R-CNN R50-FPN
   config (configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py, full
   width, 8 classes), 4 requests as in 4, each launching the forward twice
   (box and mask features) and the backward never; on the last request the
   kernel's mask features of the detections match the plain version's,
   `predict`'s masks are finite and in [0, 1], and `paste_masks` on the
   card equals the CPU's.
11. mask train — `init_trainer` on the same config, 1 warm-up and 5 timed
   steps past the lr warmup on the 2 images of 512x1024 with seeded
   box-frame ellipse rasters (112x112): each step launches the forward 3
   times (box, mask features, mask targets) and the backward twice;
   afterwards the stem and layer1 are bit-identical and every other
   parameter, the mask head's included, has moved. Then the RoIs that a
   step of the trained model samples hold (a) and (b) to the plain
   version, and the o=14 backward is timed on them.
12. c4 serving — the same on configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x.py
   (MaskRCNNC4: R50 to C4, res5 as the shared RoI head, 80 classes; served
   at score_thr 0.001, since random weights score each of the 80 classes
   ~1/81), each request launching the forward twice (proposals,
   detections); the
   kernel's C = 1024 crops of the last request's proposals match the plain
   version's; masks and `paste_masks` as in 10.
13. c4 train — as 11, each step launching the forward twice (RoIs, 14x14
   targets) and the backward once; (c) and (b) held on a trained step's
   RoIs, the backward timed there.
14. mask reference — a tiny Mask R-CNN (configs/da/synth_mask_smoke.py:
   R18, 2 classes, 128x192) and a tiny R18 Mask R-CNN C4: card vs CPU,
   inference (detections within 1e-3, masks within 1e-4) and one train
   step (losses 1e-4 relative, parameters 1e-4 of scale).
15. loop — the port's command line `tools.DA_train` (through its
   `main(argv)`) on configs/da/faster_rcnn_r18_synth_shapes.py (R18-DC5,
   DAF with every DA loss, grad clip 35, EMA 0.9995, NaN guard, batch 8 of
   4 source + 4 target, 128x192 canvas, lr 0.005), its data paths
   redirected to the committed synth subset (tests/data/synth_da_small:
   16 + 16 training images, 8 test), 2 epochs of 4 steps, eval and a
   checkpoint each epoch, in build/loop/ (emptied first). Every step must
   launch the pair's forward and backward once and every eval batch the
   forward once; every logged loss is finite, train and val records are
   in train_log.jsonl and AP50 is a finite number in [0, 1]. A second call
   resumes from ckpt_1: the restored params, buffers, momentum, EMA and
   step must equal what the first call saved, bit for bit. Then
   `init_detector(checkpoint=build/loop/ckpt_2)` serves the test split
   from its JPEG paths (equal to serving the decoded arrays), and a loader
   batch built on the card must equal the one built on the CPU, exactly.
   Timed: decode ms an image (the subset's 192x128 JPEGs, and one
   2048x1024 JPEG, tests/data/jpeg_2048x1024, at Cityscapes size), loader
   ms a batch, step ms (8 steps on loader batches made beforehand, and 16
   fed by the loader as the loop runs them, in epochs with the prefetch
   thread and without it, alternating; each launching the pair once),
   eval ms an image, checkpoint save and load ms; the pair held to the
   plain version and timed on a loop step's RoIs (bwd) and an eval batch's
   proposals (fwd). build/loop/ is emptied once the phase's checks pass.
16. DA family — each of configs/da/faster_rcnn_r50_{daf_org,maf,swda,deep,
   tri,cyda}_c2f.py and configs/da/cycada_pretrain_c2f.py at full width
   (R50-DC5, 8 classes, seeded weights): 2 requests of 2 Cityscapes-size
   images through `inference_detector` (forward once a request, backward
   never; CyDA serves untranslated images), then `init_trainer`, 1 warm-up
   and 3 timed steps on the seeded 512x1024 batch, each with finite losses
   under exactly the variant's JAX keys and launching the pair's forward
   and backward once (CyCADA: never). The frozen stem and layer1 stay
   bit-identical, every other parameter moves and the variant's own heads
   (image, SRM, MHSA position terms, generators, discriminators) with
   them; CyCADA's detector moves by weight decay alone. The pair is held
   to the plain version (and timed) on a MAF step's RoIs and on a CyDA
   step's RoIs, sampled on translated images. Then the loop's GAN branch:
   `tools.DA_train` on the synth config with CyDA (2 generator blocks, 16
   images a step), 1 epoch of 2 steps with eval and a checkpoint, and a
   resume whose restored state, both optimizers' momentum included, equals
   the saved one bit for bit (build/loop/ emptied after). Last, a tiny R18
   counterpart of each config: one train step on the card against the CPU,
   TF32 off (losses 1e-4 relative, parameters 1e-4 of scale). Per config:
   request ms, step ms (median, min–max) and peak GiB.
17. bf16 — the bf16 compute path at full width: the flagship with
   `model.dtype=bfloat16` and configs/faster_rcnn/faster_rcnn_r50_fpn_fp16_1x.py
   with `model.dtype=bfloat16` (at score_thr 0.001, as C4) serve 4
   requests each, with detections (launches as in 4;
   the pair's bf16 RoI features on the last request's proposals within
   TOL_BF16 of the plain version's); the flagship (bf16, 1 + 5 steps), the
   FPN and Mask R-CNN FPN fp16 configs through their `fp16` blocks and
   Mask R-CNN C4 (bf16; 1 + 3 and 1 + 2 steps), Tri-attention (bf16,
   1 + 3) and CyDA (bf16, 1 + 2) train on 2 images of 512x1024, each with
   finite losses and its launches as the f32 phases count them; after the
   steps the frozen stem and layer1 unchanged and every other parameter
   moved, parameters, gradients, momentum and EMA f32, the trunk's output
   bf16, the DA heads' and the CycleGAN's f32. On the RoIs a trained step
   samples, the pair at bf16 within TOL_BF16 and timed (DC5 C=2048 o=7,
   FPN o=7 and mask features o=14 on four levels, C4 C=1024 o=14: entries
   `roi_align_pyramid_{fwd,bwd}/{dc5,fpn,mask,c4}_bf16_step`, bytes at 2
   an element and 4 for the backward's f32 buffer). Then bench.py's
   protocol: the flagship step on 8 images of 512x1024, f32 then bf16, 1
   warm-up and 3 timed steps each, img/s and peak GiB. Last, the tiny DC5
   fixture and the tiny FPN at bf16, card against CPU (cuBLAS's
   reduced-precision reduction off): trunk features, RPN logits and box
   logits on seeded RoIs within TOL_BF16 of scale, and one train step with
   the same sampler priorities and proposals, per-term losses within
   TOL_BF16 relative.

18. swin — configs/da/deepalign_swin_t_c2f.py (DeepAlign on Swin-T,
   tapped at stage 2: stride 16, 384 channels; AdamW) in f32 and with
   `model.dtype=bfloat16`, configs/swin/mask_rcnn_swin-t-p4-w7_fpn_1x.py
   (Mask R-CNN Swin-T FPN, 80 classes, f32) and
   configs/swin/mask_rcnn_swin-t-p4-w7_fpn_fp16_ms-crop-3x.py (the same in
   bf16 with paramwise AdamW), full width, seeded weights: 2 requests of 2
   Cityscapes-size images (the Mask configs on their 800x1344 canvas,
   through a MultiScaleFlipAug step at their test scale, at score_thr
   0.001 as C4, the kernel's mask features of the last
   request's detections held to the plain version), then 1 warm-up and 3
   timed AdamW steps (2 images 512x1024; the Mask configs 2 seeded images
   800x1344 with box-frame rasters), each with finite losses under the JAX
   keys and its launches; every parameter moved but those without a
   gradient that are zero or in a paramwise group without decay (AdamW's
   decay reaches the patch embed and stage 0, which the trunk's
   stop-gradient leaves without a gradient and so without Adam moments);
   the bf16 runs with f32 state and bf16 trunks. On each trained step's RoIs the pair at the run's
   dtype against the plain version and timed: one level C=384 o=7
   (`roi_align_pyramid_{fwd,bwd}/swin_dc16_step`, `_bf16_step`), four
   levels o=7 (`swin_fpn_step`) and o=14 (`swin_mask_step`), and the f32
   mask targets. Per config: request ms, step ms and peak GiB.
19. swin loop — configs/da/synth_swin_deepalign.py through `tools.DA_train`
   on the synth subset, as 15: 2 epochs of 4 AdamW steps with eval and a
   checkpoint each, then a resume from ckpt_1 whose restored state (both
   Adam moments included) equals the saved one bit for bit; build/loop/
   emptied after.
20. swin reference — a tiny Swin Mask R-CNN (the tiny Mask R-CNN config
   with a Swin of embed 16, depths 2/2/2/2, AdamW): card vs CPU, inference
   and one AdamW step, launching the pair.

The line before the last is `{"kernels": [...]}`; the last is
`{"ok": true, "device": {...}}`. Imports nothing of JAX.
"""

import contextlib
import gc
import glob
import json
import math
import os
import shutil
import subprocess
import sys
import time
from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.apis import (
    inference_detector, init_detector, init_trainer, prepare_batch)
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.apis import \
    train as train_api
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.apis.test import \
    evaluate_dataset
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.apis.train_state import \
    at_count
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.data import (
    DataLoader, build_dataset)
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.data.pipelines.jpeg import \
    decode_jpeg
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.dense_heads.rpn_head import \
    rpn_proposals
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.detectors import \
    faster_rcnn as frcnn_mod
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.detectors import \
    faster_rcnn_fpn as frcnn_fpn_mod
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.detectors.mask_rcnn import \
    paste_masks
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.layers.norm import \
    BatchNorm
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.roi_heads.mask_head import \
    box_frame_crops
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.models.roi_heads.standard_roi_head import \
    sample_rois
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.ops import (
    cuda_build, roi_align)
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools import \
    DA_train
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.tools.profile_train import (
    demo_batch, ellipse_masks)
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.utils import \
    checkpoint as ckpt_io
from unsupervised_domain_adaptation_object_detection_implementation_tpu_torch.utils.config import \
    Config

PKG = 'unsupervised_domain_adaptation_object_detection_implementation_tpu_torch'
FLAGSHIP = 'configs/da/faster_rcnn_r50_daf_c2f.py'
TINY = 'configs/da/faster_rcnn_r18_tiny_fixture.py'
FPN = 'configs/cityscapes/faster_rcnn_r50_fpn_1x_cityscapes.py'
# the tiny FPN detector of the reference phase; its 128x192 canvas comes
# from a MultiScaleFlipAug test step, as in the tiny fixture. Few proposals:
# the RPN logits of its 6138 anchors lie within ~0.3 of each other, ~1e-8
# apart, so a longer ranking would order near-ties differently on the card
# and on the CPU; the top 64 of weight seed FPN_TINY_SEED lie >= 8.9e-6
# apart, far above the two sides' differences
FPN_TINY = {'model.backbone_depth': 18, 'model.neck_channels': 64,
            'model.num_classes': 2,
            'model.rpn_proposal_cfg': dict(nms_pre=64, max_per_img=32),
            'model.rpn_test_cfg': dict(nms_pre=64, max_per_img=32),
            'model.roi_train_cfg': dict(num_samples=32),
            'data.test.pipeline': [dict(type='MultiScaleFlipAug',
                                        img_scale=(192, 128))]}
FPN_TINY_SEED = 9
FPN_STRIDES = (4, 8, 16, 32)
FPN_SCALES = tuple(1 / s for s in FPN_STRIDES)
# the kernel pair's entries in the kernels line, one per path shape: the
# DC5 serving and training shapes, the RoIs a DC5 step samples, and the
# same on the FPN path
FWD_DC5, BWD_DC5, BWD_DC5_STEP = ('roi_align_pyramid_fwd/dc5',
                                  'roi_align_pyramid_bwd/dc5',
                                  'roi_align_pyramid_bwd/dc5_step')
FWD_FPN, BWD_FPN, BWD_FPN_STEP = ('roi_align_pyramid_fwd/fpn',
                                  'roi_align_pyramid_bwd/fpn',
                                  'roi_align_pyramid_bwd/fpn_step')
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores
# f32: kernel and plain version sum the same few (<= 16) weighted taps per
# bin in another order, from bit-identical sample positions: a few f32 ulps
# of the output's scale, so 1e-5 of it leaves ~100x headroom.
TOL_F32 = 1e-5
# bf16: the plain version rounds the weights, the x-interpolated
# intermediate and the result to bf16 (as the JAX package does); the kernel
# rounds once. Three roundings of 2^-8 each, plus cancellation: 2e-2.
TOL_BF16 = 2e-2
# the backward adds up to 16 weighted taps per gradient element into each
# feature pixel with f32 atomics, in an order that changes from run to run;
# a pixel sums a few hundred such terms: still a few ulps of the gradient's
# scale, so the same 1e-5 and 2e-2 hold
# steps per epoch of the flagship's two-stream loader: Cityscapes' 2975
# training images, one source and one target image per step
CITYSCAPES_STEPS = 2975
FROZEN = ('backbone.trunk.conv1', 'backbone.trunk.bn1',
          'backbone.trunk.layer1.')
# steps per epoch of the FPN config's loader at the 2 images a step that
# this script trains on: Cityscapes' 2975 training images
FPN_STEPS = 1488
FPN_FROZEN = ('backbone.conv1', 'backbone.bn1', 'backbone.layer1.')


def log(*parts):
    print(*parts, flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: torch.cuda.is_available() is False; '
                         'this script needs a CUDA card')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f'device: torch {torch.__version__} cuda {torch.version.cuda} '
        f'{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}')
    return card


def phase_build():
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    if not built:
        raise RuntimeError('no CUDA sources found to build')
    for src, (lib, seconds, compiler_log) in built.items():
        log(f'build: {src} -> {lib.name} in {seconds:.2f} s')
        for line in compiler_log.splitlines():
            if 'registers' in line or 'spill' in line:
                log(f'build:   {line.strip()}')
    log(f'build: all kernels in {time.perf_counter() - t0:.2f} s')


def time_ms(fn, iters, warmup=2):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_rois(gen, b, n, h, w, stride=16):
    """Seeded RoIs over an (h, w) stride-16 map, with edge cases: boxes
    crossing and beyond the border, under one pixel, and zero (padded)."""
    ih, iw = h * stride, w * stride
    u = torch.rand(b, n, 4, generator=gen, device='cuda')
    x1 = u[..., 0] * 1.2 * iw - 0.2 * iw
    y1 = u[..., 1] * 1.2 * ih - 0.2 * ih
    rois = torch.stack([x1, y1, x1 + 0.5 + u[..., 2] * 0.6 * iw,
                        y1 + 0.5 + u[..., 3] * 0.6 * ih], -1)
    special = torch.tensor([
        [0, 0, 0, 0], [0, 0, 0, 0],
        [-48, -32, 32, 48],
        [iw - 16, ih - 16, iw + 64, ih + 48],
        [iw + 16, ih + 16, iw + 80, ih + 96],
        [-144, -144, -32, -48],
        [5.3, 7.1, 5.9, 7.4],
        [iw / 2, ih / 2, iw / 2 + 3, ih / 2 + 2]], device='cuda')
    rois[:, :len(special)] = special
    return rois.contiguous()


def roi_align_taps(rois, h, w, out_size=7, sr=2, scale=1 / 16, aligned=True):
    """What this run's RoIs (per image, (R, 4)) make RoIAlign touch: the
    feature pixels any nonzero tap reads (per image, over all its RoIs), the
    nonzero (sample, tap) products over all bins, per channel, and the
    distinct (RoI, pixel) pairs with a nonzero weight: one float4 atomic
    each per channel vector in the backward kernel, where the nonzero
    products were one each before."""
    wx, wy = zip(*(roi_align._roi_weights(r, scale, out_size, sr, aligned,
                                          h, w) for r in rois))
    touched = sum(int(((y.sum(1) != 0).float().T @ (x.sum(1) != 0).float()
                       > 0).sum()) for x, y in zip(wx, wy))
    pairs = sum(int(((x.sum(1) != 0).sum(1) * (y.sum(1) != 0).sum(1)).sum())
                for x, y in zip(wx, wy))

    def taps_per_bin(lo, size, length):      # nonzero taps per bin, (R, o)
        s = (torch.arange(sr, device=lo.device) + 0.5) / sr
        o = torch.arange(out_size, device=lo.device)
        pos = lo[:, None, None] + (o[None, :, None] + s) * size[:, None, None]
        valid = (pos >= -1) & (pos <= length)
        pc = pos.clamp(0, length - 1)
        frac = pc - pc.floor()
        return (valid * ((frac < 1).int() + (frac > 0).int())).sum(-1)

    sc = torch.cat([r.reshape(-1, 4) for r in rois]) * scale
    off, least = (0.5, 0.0) if aligned else (0.0, 1.0)   # legacy min size 1
    nx = taps_per_bin(sc[:, 0] - off,
                      (sc[:, 2] - sc[:, 0]).clamp(min=least) / out_size, w)
    ny = taps_per_bin(sc[:, 1] - off,
                      (sc[:, 3] - sc[:, 1]).clamp(min=least) / out_size, h)
    return touched, int((nx.sum(1) * ny.sum(1)).sum()), pairs


def roi_align_work(rois, h, w, c, out_size=7, backward=False, scale=1 / 16,
                   aligned=True, elem=4):
    """Bytes and operations this run's RoIAlign needs. Forward: the output
    written once, each touched feature pixel read once, the RoIs; one FMA
    per nonzero product and channel, one scale per output. Backward: the
    output gradient read once, the feature gradient written once (into the
    kernel's f32 buffer, 4 bytes an element whatever the type), the RoIs
    (the zeroing pass that the kernel's atomics need is its own overhead,
    not part of the function); one scale per gradient element, one
    multiply and one add per nonzero product and channel. `elem` is the
    bytes of a feature element (2 for bf16)."""
    touched, products, _ = roi_align_taps(rois, h, w, out_size, scale=scale,
                                          aligned=aligned)
    b, n = rois.shape[:2]
    n_out = b * n * out_size * out_size * c
    feat_bytes = 4 * b * h * w * c if backward else elem * touched * c
    return elem * n_out + feat_bytes + rois.numel() * 4, \
        2 * products * c + n_out


def roi_align_fpn_work(rois, levels, sizes, c, out_size=7, backward=False,
                       elem=4):
    """`roi_align_work` of the multi-level RoIAlign: each RoI's taps on its
    own level; the forward reads the touched pixels of every level, the
    backward writes every level's gradient once; the levels are read too."""
    touched = products = 0
    for lvl, ((h, w), s) in enumerate(zip(sizes, FPN_STRIDES)):
        if not (levels == lvl).any():
            continue
        t, p, _ = roi_align_taps(
            [r[lv == lvl] for r, lv in zip(rois, levels)], h, w, out_size,
            scale=1 / s)
        touched, products = touched + t, products + p
    b, n = rois.shape[:2]
    n_out = b * n * out_size * out_size * c
    feat_bytes = 4 * sum(b * h * w * c for h, w in sizes) if backward else \
        elem * touched * c
    return elem * n_out + feat_bytes + (rois.numel() + levels.numel()) * 4, \
        2 * products * c + n_out


def _entry(name, replaces, nbytes, ops, **numbers):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS * 1e3
    return dict(
        name=name, route='cuda', source=f'{PKG}/csrc/roi_align_pyramid.cu',
        replaces='unsupervised_domain_adaptation_object_detection_'
                 f'implementation_tpu/ops/roi_align_pallas.py:{replaces}',
        launches=None, **numbers, bound_ms=max(bytes_ms, ops_ms),
        bound_by='bytes' if bytes_ms >= ops_ms else 'operations',
        library_ms=None)


def _set_launches(kernels, name, n):
    for entry in kernels:
        if entry['name'] == name:
            entry['launches'] = n


def _check(name, got, ref, tol, what):
    torch.cuda.synchronize()
    if got.shape != ref.shape or not torch.isfinite(got).all():
        raise RuntimeError(f'{name} {what}: shape {tuple(got.shape)} or '
                           'non-finite')
    err = float((got.float() - ref.float()).abs().max())
    scale = max(1.0, float(ref.float().abs().max()))
    log(f'kernels: {name} {what} max_abs_err={err:.3e} scale={scale:.3f} '
        f'tol={tol * scale:.3e}')
    if not err <= tol * scale:
        raise RuntimeError(f'{name} disagrees with its plain version: '
                           f'{err} > {tol * scale}')
    return err


def atomic_adds(rois, sizes, strides, c, levels=None, out_size=7):
    """The backward's f32 atomic adds on this run's RoIs: one per nonzero
    (sample, tap) product and channel in the earlier design (a scatter of
    every tap), one per distinct (RoI, pixel) pair and channel in
    roi_align_pyramid_bwd."""
    old = new = 0
    for lvl, ((h, w), s) in enumerate(zip(sizes, strides)):
        per = rois if levels is None else \
            [r[lv == lvl] for r, lv in zip(rois, levels)]
        if sum(len(r) for r in per):
            _, products, pairs = roi_align_taps(per, h, w, out_size,
                                                scale=1 / s)
            old, new = old + products * c, new + pairs * c
    return old, new


def dc5_fwd(feats, rois, flatten=True, out_size=7):
    """The kernel pair's forward on the single-level path: one level at
    stride 16, no level array (as `batched_roi_align` launches it)."""
    return roi_align.roi_align_pyramid_cuda([feats], rois, None, (1 / 16,),
                                            out_size, flatten=flatten)


def dc5_bwd(grad, rois, shape, flatten=True):
    return roi_align.roi_align_pyramid_bwd_cuda(
        grad, rois, None, [shape], (1 / 16,), flatten=flatten)[0]


def fpn_fwd(feats, rois, levels, flatten=True, out_size=7):
    return roi_align.roi_align_pyramid_cuda(feats, rois, levels, FPN_SCALES,
                                            out_size, flatten=flatten)


def fpn_bwd(grad, rois, levels, shapes, flatten=True, out_size=7):
    return roi_align.roi_align_pyramid_bwd_cuda(grad, rois, levels, shapes,
                                                FPN_SCALES, out_size,
                                                flatten=flatten)


def plain_backward(feats, rois, grad, flatten):
    """d feats of the plain version, by its autograd."""
    f = feats.detach().requires_grad_()
    out = roi_align.batched_roi_align_plain(f, rois, 1 / 16, flatten=flatten)
    return torch.autograd.grad(out, f, grad)[0]


def plain_fpn_backward(feats, rois, grad, out_size, flatten):
    """d feats of every level of the plain multi-level version, by its
    autograd."""
    fs = [f.detach().requires_grad_() for f in feats]
    out = roi_align.batched_roi_align_fpn_plain(
        fs, rois, out_size=out_size, flatten=flatten)
    return torch.autograd.grad(out, fs, grad)


def plain_backward_ms(plain, feats, grad):
    """The plain version's backward alone, by its autograd on a kept graph
    (`plain(feats)` builds the forward)."""
    fs = [f.detach().requires_grad_() for f in feats]
    out = plain(fs)
    return time_ms(lambda: torch.autograd.grad(out, fs, grad,
                                               retain_graph=True),
                   3, warmup=1)


def time_dc5_backward(name, feats, rois, grad, worst):
    """Time the backward at one level on (feats, rois, grad) beside the
    plain version's; log its bound and atomic adds; return its entry."""
    b, h, w, c = feats.shape
    shape = tuple(feats.shape)
    ms = time_ms(lambda: dc5_bwd(grad, rois, shape), 20)
    plain_ms = plain_backward_ms(lambda fs: roi_align.batched_roi_align_plain(
        fs[0], rois, 1 / 16, flatten=True), [feats], grad)
    nbytes, ops = roi_align_work(rois, h, w, c, backward=True)
    entry = _entry(name, 303, nbytes, ops, max_abs_err=worst, ms=ms,
                   plain_ms=plain_ms)
    old, new = atomic_adds(rois, [(h, w)], (16,), c)
    log(f'kernels: {name} f32 {shape} x {b}x{rois.shape[1]} rois flat g: '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{entry["bound_ms"]:.4f} ms ({entry["bound_by"]}: '
        f'{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); f32 atomic adds '
        f'{old / 1e9:.3f} G in the earlier design (one per nonzero tap), '
        f'{new / 1e9:.3f} G now (one per (RoI, pixel))')
    return entry


def phase_kernels():
    """The kernel pair on the single-level (DC5) path: forward at the
    serving shape, backward at the training shape."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)

    # forward, at the serving shape
    b, h, w, c, n = 2, 38, 64, 2048, 1000
    feats = torch.randn(b, h, w, c, generator=gen, device='cuda')
    rois = make_rois(gen, b, n, h, w)
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        f = feats.to(dtype).contiguous()
        for flatten in (True, False):
            err = _check(FWD_DC5, dc5_fwd(f, rois, flatten),
                         roi_align.batched_roi_align_plain(
                             f, rois, 1 / 16, 7, 2, True, flatten),
                         tol, f'{str(dtype)[6:]} flatten={flatten}')
            if dtype == torch.float32:
                worst = max(worst, err)
    ms = time_ms(lambda: dc5_fwd(feats, rois), 20)
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        feats, rois, 1 / 16, flatten=True), 3, warmup=1)
    nbytes, ops = roi_align_work(rois, h, w, c)
    fwd = _entry(FWD_DC5, 63, nbytes, ops, max_abs_err=worst, ms=ms,
                 plain_ms=plain_ms)
    log(f'kernels: {FWD_DC5} f32 (2,38,64,2048) x 2x1000 rois flat: '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {fwd["bound_ms"]:.4f}'
        f' ms ({fwd["bound_by"]}: {nbytes / 1e6:.1f} MB, '
        f'{ops / 1e9:.2f} GFLOP)')
    del feats, rois

    # backward, at the training shape: 512 sampled RoIs per image
    b, h, w, c, n = 2, 32, 64, 2048, 512
    feats = torch.randn(b, h, w, c, generator=gen, device='cuda')
    rois = make_rois(gen, b, n, h, w)
    grad = torch.randn(b, n, 7 * 7 * c, generator=gen, device='cuda')
    shape = (b, h, w, c)
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        f, g = feats.to(dtype), grad.to(dtype)
        for flatten in (True, False):
            gl = g if flatten else \
                g.reshape(b, n, 7, 7, c).transpose(2, 3).contiguous()
            err = _check(BWD_DC5, dc5_bwd(gl, rois, shape, flatten),
                         plain_backward(f, rois, gl, flatten), tol,
                         f'{str(dtype)[6:]} flatten={flatten}')
            if dtype == torch.float32:
                worst = max(worst, err)
            del gl
    del f, g
    return [fwd, time_dc5_backward(BWD_DC5, feats, rois, grad, worst)]


def make_fpn_rois(gen, b, n, ih, iw):
    """Seeded RoIs over an (ih, iw) canvas whose sizes reach every FPN level
    (sqrt area 8..900 px, log-uniform), with edge cases: zero (padded)
    boxes, boxes crossing and beyond the border, under one pixel, and boxes
    at the exact level boundaries sqrt(area) = 112, 224 and 448."""
    u = torch.rand(b, n, 4, generator=gen, device='cuda')
    side = torch.exp(math.log(8) + u[..., 2] * math.log(900 / 8))
    aspect = torch.exp((u[..., 3] - 0.5) * 1.4)
    bw, bh = side * aspect, side / aspect
    x1 = u[..., 0] * (iw + 0.2 * bw) - 0.2 * bw
    y1 = u[..., 1] * (ih + 0.2 * bh) - 0.2 * bh
    rois = torch.stack([x1, y1, x1 + bw, y1 + bh], -1)
    special = torch.tensor([
        [0, 0, 0, 0], [0, 0, 0, 0],
        [10, 20, 122, 132], [100, 50, 324, 274], [30, 40, 478, 488],
        [0, 0, 896, 224],
        [-48, -32, 32, 48],
        [iw - 16, ih - 16, iw + 64, ih + 48],
        [iw + 16, ih + 16, iw + 80, ih + 96],
        [5.3, 7.1, 5.9, 7.4]], device='cuda')
    rois[:, :len(special)] = special
    return rois.contiguous()


def _level_counts(levels):
    counts = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    if not all(counts):
        raise RuntimeError(f'RoIs per level {counts}: a level is missing')
    return counts


def time_fpn_backward(name, feats, rois, grad, worst, out_size=7,
                      flatten=True, replaces=1121):
    """`time_dc5_backward` on the four levels."""
    levels = roi_align.roi_levels(rois, 4)
    shapes = [tuple(f.shape) for f in feats]
    sizes = [s[1:3] for s in shapes]
    c = shapes[0][3]
    ms = time_ms(lambda: fpn_bwd(grad, rois, levels, shapes, flatten,
                                 out_size), 20)
    plain_ms = plain_backward_ms(
        lambda fs: roi_align.batched_roi_align_fpn_plain(
            fs, rois, out_size=out_size, flatten=flatten), feats, grad)
    nbytes, ops = roi_align_fpn_work(rois, levels, sizes, c, out_size,
                                     backward=True)
    entry = _entry(name, replaces, nbytes, ops, max_abs_err=worst, ms=ms,
                   plain_ms=plain_ms)
    old, new = atomic_adds(rois, sizes, FPN_STRIDES, c, levels, out_size)
    log(f'kernels: {name} f32 pyramid {sizes} C={c} x '
        f'{rois.shape[0]}x{rois.shape[1]} rois o={out_size} '
        f'{"flat" if flatten else "NHWC"} g: {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, bound {entry["bound_ms"]:.4f} ms '
        f'({entry["bound_by"]}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} '
        f'GFLOP); f32 atomic adds {old / 1e9:.3f} G in the earlier design, '
        f'{new / 1e9:.3f} G now')
    return entry


def phase_fpn_kernels():
    """The kernel pair on the multi-level (FPN) path: forward on the
    pyramid of the 608x1024 serving canvas (2 x 1000 RoIs), backward on
    that of the 512x1024 training canvas (2 x 512 sampled RoIs), C = 256."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(1)
    plain = roi_align.batched_roi_align_fpn_plain

    b, c, n = 2, 256, 1000
    sizes = [(608 // s, 1024 // s) for s in FPN_STRIDES]
    feats = [torch.randn(b, h, w, c, generator=gen, device='cuda')
             for h, w in sizes]
    rois = make_fpn_rois(gen, b, n, 608, 1024)
    levels = roi_align.roi_levels(rois, 4)
    log(f'kernels: {FWD_FPN} RoIs per level P2..P5 {_level_counts(levels)}')
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        fs = [f.to(dtype) for f in feats]
        for flatten in (True, False):
            err = _check(FWD_FPN, fpn_fwd(fs, rois, levels, flatten),
                         plain(fs, rois, flatten=flatten), tol,
                         f'{str(dtype)[6:]} flatten={flatten}')
            if dtype == torch.float32:
                worst = max(worst, err)
        del fs
    worst = max(worst, _check(
        FWD_FPN, fpn_fwd(feats, rois, levels, out_size=14),
        plain(feats, rois, out_size=14, flatten=True),
        TOL_F32, 'float32 o=14 flatten=True'))
    ms = time_ms(lambda: fpn_fwd(feats, rois, levels), 20)
    plain_ms = time_ms(lambda: plain(feats, rois, flatten=True), 3,
                       warmup=1)
    nbytes, ops = roi_align_fpn_work(rois, levels, sizes, c)
    fwd = _entry(FWD_FPN, 1181, nbytes, ops, max_abs_err=worst, ms=ms,
                 plain_ms=plain_ms)
    log(f'kernels: {FWD_FPN} f32 pyramid of 608x1024 C=256 x 2x1000 rois '
        f'flat: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{fwd["bound_ms"]:.4f} ms ({fwd["bound_by"]}: {nbytes / 1e6:.1f} '
        f'MB, {ops / 1e9:.2f} GFLOP)')
    del feats, rois, levels

    b, n = 2, 512
    sizes = [(512 // s, 1024 // s) for s in FPN_STRIDES]
    feats = [torch.randn(b, h, w, c, generator=gen, device='cuda')
             for h, w in sizes]
    shapes = [tuple(f.shape) for f in feats]
    rois = make_fpn_rois(gen, b, n, 512, 1024)
    levels = roi_align.roi_levels(rois, 4)
    log(f'kernels: {BWD_FPN} RoIs per level P2..P5 {_level_counts(levels)}')
    grad = torch.randn(b, n, 7 * 7 * c, generator=gen, device='cuda')
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        fs, g = [f.to(dtype) for f in feats], grad.to(dtype)
        for flatten in (True, False):
            gl = g if flatten else \
                g.reshape(b, n, 7, 7, c).transpose(2, 3).contiguous()
            got = fpn_bwd(gl, rois, levels, shapes, flatten)
            ref = plain_fpn_backward(fs, rois, gl, 7, flatten)
            for lvl, (gg, rr) in enumerate(zip(got, ref)):
                err = _check(BWD_FPN, gg, rr, tol,
                             f'{str(dtype)[6:]} flatten={flatten} P{lvl + 2}')
                if dtype == torch.float32:
                    worst = max(worst, err)
            del gl, got, ref
        del fs, g
    return [fwd, time_fpn_backward(BWD_FPN, feats, rois, grad, worst)]


def _check_result(res, shape_hw, num_classes, max_det, score_thr=0.05):
    h, w = shape_hw
    if len(res) != num_classes:
        raise RuntimeError(f'{len(res)} class arrays, expected {num_classes}')
    total = 0
    for det in res:
        if det.dtype != np.float32 or det.ndim != 2 or det.shape[1] != 5:
            raise RuntimeError(f'malformed dets {det.dtype} {det.shape}')
        if not np.isfinite(det).all():
            raise RuntimeError('non-finite dets')
        boxes, scores = det[:, :4], det[:, 4]
        if (boxes < -1e-3).any() or (boxes[:, 0::2] > w + 1e-2).any() \
                or (boxes[:, 1::2] > h + 1e-2).any() \
                or (boxes[:, 2:] < boxes[:, :2]).any():
            raise RuntimeError('dets outside the image or inverted')
        if ((scores <= score_thr) | (scores > 1.0)).any():
            raise RuntimeError('scores outside (score_thr, 1]')
        total += len(det)
    if total > max_det:
        raise RuntimeError(f'{total} dets > max_per_img {max_det}')
    return total


def _serve(card, config, label, expect, overrides=None, n_requests=4,
           stats=None, canvas=(608, 1024)):
    """`init_detector` on `config` (full width, seeded random weights; with
    `overrides` merged in; its test pipeline must give `canvas`), one
    warm-up request and `n_requests` timed
    requests of 2 seeded Cityscapes-size images. `expect` maps a kernel's
    name to (its launch counter, launches per request); the counters are
    set to 0 just before the timed requests and checked after each.
    Returns the bundle, the requests and the launch counts; `stats`, a
    dict, gets the latencies (ms) and the peak memory (bytes)."""
    # serving runs with PyTorch's defaults: cuDNN convolutions in TF32,
    # matrix products in full f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(overrides or {})
    bundle = init_detector(cfg, device='cuda', seed=0)
    torch.cuda.synchronize()
    log(f'{label}: init_detector {config} on cuda in '
        f'{time.perf_counter() - t0:.2f} s; canvas {bundle.canvas}, '
        f'{sum(p.numel() for p in bundle.model.parameters()) / 1e6:.1f} M '
        'params')
    if bundle.canvas != tuple(canvas):
        raise RuntimeError(f'canvas {bundle.canvas}, expected {canvas}')
    rs = np.random.RandomState(0)
    requests = [[rs.randint(0, 256, (1024, 2048, 3), dtype=np.uint8)
                 for _ in range(2)] for _ in range(n_requests + 1)]
    t0 = time.perf_counter()
    inference_detector(bundle, requests[0])          # warm-up, set-up cost
    log(f'{label}: warm-up request '
        f'{1e3 * (time.perf_counter() - t0):.1f} ms')

    for fn, _ in expect.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    latencies, n_dets = [], 0
    for i, req in enumerate(requests[1:], 1):
        t0 = time.perf_counter()
        res = inference_detector(bundle, req)
        latencies.append(1e3 * (time.perf_counter() - t0))
        for r in res:
            n_dets += _check_result(r, (1024, 2048),
                                    bundle.model.num_classes, 100,
                                    bundle.model.roi_test_cfg.score_thr)
        for name, (fn, per_request) in expect.items():
            if fn.launches != i * per_request:
                raise RuntimeError(f'{name}: {fn.launches} launches after '
                                   f'{i} requests, expected '
                                   f'{i * per_request}')
    launches = {k: fn.launches for k, (fn, _) in expect.items()}
    peak = torch.cuda.max_memory_allocated()
    total_s = sum(latencies) / 1e3
    log(f'{label}: {n_requests} requests x 2 images 1024x2048 -> {n_dets} '
        f'dets; latency ms {[round(x, 2) for x in latencies]} mean '
        f'{np.mean(latencies):.2f}; {2 * n_requests / total_s:.2f} img/s; '
        f'peak memory {peak / 2**30:.2f} GiB; launches {launches} [{card}]')
    if stats is not None:
        stats.update(latencies=latencies, peak=peak, dets=n_dets)
    return bundle, requests, launches


# a request launches the kernel pair's forward once and its backward never
SERVING_LAUNCHES = {
    'roi_align_pyramid_fwd': (roi_align.roi_align_pyramid_cuda, 1),
    'roi_align_pyramid_bwd': (roi_align.roi_align_pyramid_bwd_cuda, 0)}
# a train step launches each of the pair once
STEP_LAUNCHES = {
    'roi_align_pyramid_fwd': (roi_align.roi_align_pyramid_cuda, 1),
    'roi_align_pyramid_bwd': (roi_align.roi_align_pyramid_bwd_cuda, 1)}


def phase_main_path(card, kernels):
    bundle, requests, launches = _serve(card, FLAGSHIP, 'main',
                                        SERVING_LAUNCHES)
    _set_launches(kernels, FWD_DC5, launches['roi_align_pyramid_fwd'])

    # the kernel's RoI features on the last request's real proposals
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        batch, _ = prepare_batch(bundle, requests[-1])
        model = bundle.model
        feat = model.extract_feat(batch['image'])
        proposals, _, valid = rpn_proposals(
            *model.rpn_outputs(feat), batch['img_shape'], model.rpn_test_cfg)
        feats = model.roi_maps(feat)
        got = dc5_fwd(feats, proposals)
        ref = roi_align.batched_roi_align_plain(feats, proposals, 1 / 16,
                                                flatten=True)
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    log(f'main: RoI features on the last request ({int(valid.sum())} valid '
        f'proposals): max_abs_err {err:.3e} scale {scale:.3f}')
    if not err <= TOL_F32 * scale:
        raise RuntimeError(f'RoI features disagree: {err} > {TOL_F32 * scale}')


def phase_fpn_serving(card, kernels):
    bundle, requests, launches = _serve(card, FPN, 'fpn serving',
                                        SERVING_LAUNCHES)
    _set_launches(kernels, FWD_FPN, launches['roi_align_pyramid_fwd'])

    # the kernel's RoI features on the last request's real proposals
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        batch, _ = prepare_batch(bundle, requests[-1])
        model = bundle.model
        feats = model.extract_feat(batch['image'])
        proposals, _, valid = rpn_proposals(
            *model.rpn_outputs(feats), batch['img_shape'], model.rpn_test_cfg)
        pyramid = model.roi_maps(feats)
        levels = roi_align.roi_levels(proposals, 4)
        got = fpn_fwd(pyramid, proposals, levels)
        ref = roi_align.batched_roi_align_fpn_plain(pyramid, proposals,
                                                    flatten=True)
    err = float((got - ref).abs().max())
    scale = max(1.0, float(ref.abs().max()))
    counts = torch.bincount(levels.flatten().long(), minlength=4).tolist()
    log(f'fpn serving: RoI features on the last request ({int(valid.sum())} '
        f'valid proposals, per level P2..P5 {counts}): max_abs_err '
        f'{err:.3e} scale {scale:.3f}')
    if not err <= TOL_F32 * scale:
        raise RuntimeError(f'FPN RoI features disagree: {err} > '
                           f'{TOL_F32 * scale}')


def _train(card, config, steps_per_epoch, label, counters, batch=None,
           steps=5, keys=None, overrides=None):
    """`init_trainer` on `config` (full width, seeded random weights; with
    `overrides` merged in; f32 unless the config asks for bf16) and 1
    warm-up + `steps` timed steps past the lr warmup on `batch` (by
    default the seeded batch of 2 images of 512x1024). With `keys`, each
    step's loss terms must be exactly those. `counters` maps a kernel's
    name to (its launch counter, launches per step): each step must launch
    each that often (counts set to 0 before the step, read after) and give
    finite losses. Returns (trainer, state, start parameters, step ms,
    launches, peak bytes)."""
    # training runs with PyTorch's defaults, as serving does: cuDNN
    # convolutions in TF32, matrix products in full f32
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = Config.fromfile(config)
    cfg.merge_from_dict(overrides or {})
    trainer = init_trainer(cfg, device='cuda', seed=0,
                           steps_per_epoch=steps_per_epoch)
    params = trainer.state.params
    torch.cuda.synchronize()
    log(f'{label}: init_trainer {config} on cuda in '
        f'{time.perf_counter() - t0:.2f} s; '
        f'{sum(p.numel() for p in params.values()) / 1e6:.1f} M params, '
        f'{sum(p.numel() for p in params.values() if p.requires_grad) / 1e6:.1f}'
        f' M trainable; {trainer.spec}')
    if batch is None:
        batch = demo_batch()            # 2 images of 512x1024, on the card
    gen = torch.Generator(device='cuda').manual_seed(0)
    start = {n: p.detach().clone() for n, p in params.items()}
    totals = dict.fromkeys(counters, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # past the 500-step warmup, at the schedule's full lr: an update at the
    # first steps' lr is below f32 resolution for many parameters
    state, times = trainer.state, []
    state = state._replace(opt_state=at_count(state.opt_state, 500))
    for i in range(1 + steps):          # 1 warm-up + the timed steps
        for fn, _ in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch, gen)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        for name, (fn, per_step) in counters.items():
            if fn.launches != per_step:
                raise RuntimeError(f'{label} step {i}: {name} launched '
                                   f'{fn.launches} times, expected '
                                   f'{per_step}')
            totals[name] += fn.launches
        values = {k: float(v) for k, v in metrics.items()}
        if not all(math.isfinite(v) for v in values.values()) \
                or values.get('skipped_nonfinite') or (
                    keys is not None and set(values) - {
                        'loss', 'skipped_nonfinite'} != keys):
            raise RuntimeError(f'{label} step {i}: {values}')
        if i:
            times.append(ms)
        log(f'{label}: step {i} {ms:.1f} ms ' + ' '.join(
            f'{k}={v:.4f}' for k, v in values.items()))
    return trainer, state, start, times, totals, \
        torch.cuda.max_memory_allocated()


def _moved(params, start, frozen, label):
    """The number of parameters that moved; raises unless exactly those
    outside the `frozen` prefixes did."""
    moved = 0
    for n, p in params.items():
        same = torch.equal(p.detach(), start[n])
        if n.startswith(frozen) != same:
            state = 'unchanged' if same else 'changed'
            raise RuntimeError(f'{label}: {n} {state} after the steps')
        moved += not same
    return moved


def _train_summary(label, what, times, peak, totals, card,
                   images='2 images 512x1024'):
    med = float(np.median(times))
    return (f'{label}: {len(times)} steps x {images} ({what}): step '
            f'ms {[round(t, 2) for t in times]} median {med:.2f} min '
            f'{min(times):.2f} max {max(times):.2f}; {2e3 / med:.2f} img/s; '
            f'peak memory {peak / 2**30:.2f} GiB; launches {totals} over '
            f'{len(times) + 1} steps [{card}]')


def phase_train(card, kernels):
    trainer, state, start, times, totals, peak = _train(
        card, FLAGSHIP, CITYSCAPES_STEPS, 'train', STEP_LAUNCHES)
    params = trainer.state.params
    da_stats = {f'{m_name}.{b}': getattr(m, b)
                for m_name, m in trainer.model.named_modules()
                if isinstance(m, BatchNorm) for b in ('mean', 'var')}
    if not da_stats:
        raise RuntimeError('no DA-head BatchNorm in the model')
    # the DA heads' live BatchNorm starts at mean 0, var 1 (seeded init)
    for n, v in da_stats.items():
        if torch.equal(v, torch.zeros_like(v) if n.endswith('mean')
                       else torch.ones_like(v)):
            raise RuntimeError(f'{n}: DA-head BatchNorm statistic unchanged')
    moved = _moved(params, start, FROZEN, 'train')
    # the EMA follows the parameters (its decay ramps up from ~0, so after 6
    # steps it sits within a few ulps of them on many leaves) but is not them
    ema_apart = 0
    for n, p in params.items():
        if torch.equal(p.detach(), start[n]):
            continue
        if torch.equal(state.ema_params[n], start[n]):
            raise RuntimeError(f'{n}: the EMA did not follow the parameter')
        ema_apart += not torch.equal(state.ema_params[n], p.detach())
    if not ema_apart:
        raise RuntimeError('the EMA equals the parameters on every leaf')
    log(_train_summary('train', 'R50-DC5 daf f32', times, peak, totals, card)
        + f'; {moved} parameters moved, stem and layer1 unchanged, EMA '
        f'apart from {ema_apart} of them, {len(da_stats)} DA BatchNorm '
        'statistics moved')
    kernels.append(dc5_kernels_on_sampled_rois(trainer.model))
    for name in (BWD_DC5, BWD_DC5_STEP):
        _set_launches(kernels, name, totals['roi_align_pyramid_bwd'])


def phase_fpn_train(card, kernels):
    trainer, state, start, times, totals, peak = _train(
        card, FPN, FPN_STEPS, 'fpn train', STEP_LAUNCHES)
    moved = _moved(trainer.state.params, start, FPN_FROZEN, 'fpn train')
    if not any(n.startswith('neck.') for n in start) or \
            state.ema_params is not None:
        raise RuntimeError('FPN trainer: no neck, or an EMA the config does '
                           'not ask for')
    log(_train_summary('fpn train', 'R50-FPN f32', times, peak, totals, card)
        + f'; {moved} parameters moved (neck and RPN included), stem and '
        'layer1 unchanged; the config has no EMA')
    kernels.append(fpn_kernels_on_sampled_rois(trainer.model))
    for name in (BWD_FPN, BWD_FPN_STEP):
        _set_launches(kernels, name, totals['roi_align_pyramid_bwd'])


def fpn_level_batch(hw=(512, 1024)):
    """`demo_batch`'s 2 images (512x1024, or `hw`) with 16 valid gt boxes
    an image, 4 on each FPN level: sqrt(area) 24..90 (P2), 120..210 (P3),
    240..420 (P4), 470..690 px (P5), at seeded places inside the image."""
    batch = demo_batch(h=hw[0], w=hw[1])
    b, g = batch['gt_bboxes'].shape[:2]
    side = np.array([24, 40, 64, 90, 120, 150, 180, 210, 240, 300, 360, 420,
                     470, 520, 600, 690], np.float32)[:g]
    h = np.minimum(side, 480)
    w = side * side / h
    rs = np.random.RandomState(2)
    x1 = rs.uniform(0, 1, (b, g)) * (hw[1] - w)
    y1 = rs.uniform(0, 1, (b, g)) * (hw[0] - h)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], -1).astype(np.float32)
    batch['gt_bboxes'] = torch.from_numpy(boxes).cuda()
    batch['gt_valid'] = torch.ones_like(batch['gt_valid'])
    return batch


def sample_step_rois(model, batch, seed):
    """The RoIs that a train step of `model` samples from `batch`
    (proposals and gt boxes, as the detectors' `loss` samples them, with
    their matched gts), the maps RoIAlign reads them from, and the
    generator that drew them."""
    gen = torch.Generator(device='cuda').manual_seed(seed)
    with torch.no_grad():
        feats = model.extract_feat(batch['image'])
        proposals, _, valid = rpn_proposals(
            *model.rpn_outputs(feats), batch['img_shape'],
            model.rpn_proposal_cfg)
        sampled = sample_rois(
            proposals, valid, batch['gt_bboxes'], batch['gt_labels'],
            batch['gt_valid'], model.num_classes, model.roi_train_cfg,
            generator=gen)
        maps = model.roi_maps(feats)
    return maps, sampled._replace(rois=sampled.rois.contiguous()), gen


def dc5_kernels_on_sampled_rois(model):
    """The kernel pair against the plain version on the RoIs that a train
    step of the trained full-width DC5 model samples from the step's own
    batch (`demo_batch`: 4 gt boxes an image, so the positives crowd around
    them and many RoIs add into the same pixels): forward, and backward on a
    seeded cotangent, which is then timed beside the plain version's.
    Returns the backward's entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, sampled, gen = sample_step_rois(model, demo_batch(), 3)
    rois = sampled.rois
    log(f'train: {tuple(rois.shape[:2])} sampled RoIs on the '
        f'{tuple(feats.shape)} map')
    got = dc5_fwd(feats, rois)
    _check(FWD_DC5, got, roi_align.batched_roi_align_plain(
        feats, rois, 1 / 16, flatten=True), TOL_F32, 'on sampled RoIs')
    grad = torch.randn(got.shape, generator=gen, device='cuda')
    worst = _check(BWD_DC5_STEP, dc5_bwd(grad, rois, tuple(feats.shape)),
                   plain_backward(feats, rois, grad, True), TOL_F32,
                   'on sampled RoIs')
    return time_dc5_backward(BWD_DC5_STEP, feats, rois, grad, worst)


def fpn_kernels_on_sampled_rois(model):
    """The kernel pair against the plain version on the RoIs that a train
    step of the trained full-width FPN model samples from
    `fpn_level_batch`, whose gt boxes reach every level: forward, and
    backward on a seeded cotangent, then timed. Fails if a level gets no
    RoI. Returns the backward's entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    pyramid, sampled, gen = sample_step_rois(model, fpn_level_batch(), 3)
    rois = sampled.rois
    levels = roi_align.roi_levels(rois, 4)
    log(f'fpn train: {tuple(rois.shape[:2])} sampled RoIs, per level P2..P5 '
        f'{_level_counts(levels)}')
    got = fpn_fwd(pyramid, rois, levels)
    _check(FWD_FPN, got, roi_align.batched_roi_align_fpn_plain(
        pyramid, rois, flatten=True), TOL_F32, 'on sampled RoIs')
    grad = torch.randn(got.shape, generator=gen, device='cuda')
    got = fpn_bwd(grad, rois, levels, [tuple(p.shape) for p in pyramid])
    ref = plain_fpn_backward(pyramid, rois, grad, 7, True)
    worst = max(_check(BWD_FPN_STEP, gg, rr, TOL_F32,
                       f'on sampled RoIs P{lvl + 2}')
                for lvl, (gg, rr) in enumerate(zip(got, ref)))
    return time_fpn_backward(BWD_FPN_STEP, pyramid, rois, grad, worst)


def _fpn_tiny_cfg():
    cfg = Config.fromfile(FPN)
    cfg.merge_from_dict(FPN_TINY)
    return cfg


def phase_reference(config=TINY, label='tiny fixture', hw=(64, 96), seed=3):
    """A tiny detector: card (kernels) vs CPU (plain versions), from the
    same weights, TF32 off: detections within 1e-3; for a mask detector
    also `predict`'s labels and validity identical and its masks, every
    row, within 1e-4."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rs = np.random.RandomState(1)
    imgs = [rs.randint(0, 256, (*hw, 3), dtype=np.uint8) for _ in range(2)]
    outs, preds = [], []
    for device in ('cuda', 'cpu'):
        bundle = init_detector(config, device='cpu', seed=seed)
        if device == 'cuda':
            bundle = bundle._replace(model=bundle.model.to('cuda'),
                                     device=torch.device('cuda'))
        outs.append(inference_detector(bundle, imgs))
        if hasattr(bundle.model, 'mask_head'):
            preds.append({k: v.cpu() for k, v in bundle.model.predict(
                prepare_batch(bundle, imgs)[0]).items()})
    if preds:
        (got, ref), masks = preds, preds[1]['masks']
        mask_err = float((got['masks'] - masks).abs().max())
        log(f'reference: {label} masks {tuple(masks.shape)} card vs CPU '
            f'max_abs_err {mask_err:.3e} ({int((~ref["valid"]).sum())} '
            'padded rows)')
        if not (torch.equal(got['labels'], ref['labels'])
                and torch.equal(got['valid'], ref['valid'])
                and mask_err <= 1e-4):
            raise RuntimeError(f'{label}: card and CPU masks disagree '
                               f'({mask_err})')
    worst = 0.0
    for g_img, r_img in zip(*outs):
        for g, r in zip(g_img, r_img):
            if g.shape != r.shape:
                raise RuntimeError(f'card vs CPU: {g.shape} vs {r.shape}')
            if len(g):
                worst = max(worst, float(np.abs(g - r).max()))
    n_dets = sum(len(d) for r in outs[1] for d in r)
    log(f'reference: {label} card vs CPU, {n_dets} dets, max_abs_err '
        f'{worst:.3e}')
    if not n_dets or not worst <= 1e-3:
        raise RuntimeError(f'card and CPU disagree: {worst} ({n_dets} dets)')


def phase_reference_train(config=TINY, label='tiny fixture', hw=(64, 96),
                          anchors=4 * 6 * 6, proposals=64, seed=3,
                          mask_size=None, lr=0.002):
    """One tiny train step on the card (kernels) against the same step on
    the CPU (plain versions), from the same weights, TF32 off, dropout off
    and the same sampler priorities (`anchors` and 6 gt + `proposals`
    candidates per image). Per-term losses within 1e-4 relative and updated
    parameters within 1e-4 of scale: the two sides sum in other orders, the
    RoIAlign backward with atomics. `lr` is the config's lr here (0.002,
    at half of it after the warmup ratio). Adam's first update is ±lr
    whatever the gradient, so under Adam the parameters hold the update
    rule only, and the gradients are held through both moments (the first
    is 0.1x the clipped gradient): each within 1e-4 of the largest entry of
    the whole moment."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    cfg.merge_from_dict({'optimizer.lr': lr,
                         'lr_config.warmup_ratio': 0.5})
    # one step at step count 0: the epoch length only places the decay
    trainers = [init_trainer(cfg, device=d, seed=seed, steps_per_epoch=1)
                for d in ('cpu', 'cuda')]
    trainers[1].model.load_state_dict(trainers[0].model.state_dict())
    batch = demo_batch(2, *hw, g=6, num_classes=2, seed=4, device='cpu',
                       mask_size=mask_size)
    gen = torch.Generator().manual_seed(5)
    pri = dict(rpn=torch.rand(2, anchors, generator=gen),
               rcnn=torch.rand(2, 6 + proposals, generator=gen))
    results = []
    for trainer in trainers:
        for m in trainer.model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
        dev = trainer.device
        state, metrics = trainer.step(
            trainer.state, {k: v.to(dev) for k, v in batch.items()},
            sampler_priorities={k: v.to(dev) for k, v in pri.items()})
        opt = state.opt_state
        moments = [{n: t.cpu() for n, t in m.items()}
                   for m in (opt.momentum, opt.nu)] \
            if hasattr(opt, 'nu') else []
        results.append(({k: float(v) for k, v in metrics.items()},
                        {n: t.detach().cpu() for n, t in
                         trainer.model.state_dict().items()}, moments))
    (ref_l, ref_p, ref_m), (got_l, got_p, got_m) = results
    rel = max(abs(got_l[k] - v) / max(abs(v), 1e-6) for k, v in ref_l.items())
    err = max(float((got_p[n] - v).abs().max()) /
              max(1.0, float(v.abs().max())) for n, v in ref_p.items())
    moment_errs = []
    for got, ref in zip(got_m, ref_m):
        whole = max(float(v.abs().max()) for v in ref.values())
        moment_errs.append(max(float((got[n] - v).abs().max())
                               for n, v in ref.items()) / whole)
    log(f'reference: {label} train step card vs CPU: losses '
        f'{ {k: round(v, 5) for k, v in got_l.items()} }, worst relative '
        f'loss difference {rel:.3e}, worst parameter difference {err:.3e} '
        'of scale' + (', worst Adam moment differences '
                      f'{[f"{e:.3e}" for e in moment_errs]} of the whole '
                      "moment's scale" if moment_errs else ''))
    if set(got_l) != set(ref_l) or not rel <= 1e-4 or not err <= 1e-4 \
            or not all(e <= 1e-4 for e in moment_errs):
        raise RuntimeError(f'train step card vs CPU: losses {rel}, '
                           f'params {err}, moments {moment_errs}')


def phase_fpn_reference():
    """The tiny FPN detector (128x192 canvas, 32 proposals): card vs CPU,
    inference and one train step, launching the kernel pair."""
    fwd, bwd = (roi_align.roi_align_pyramid_cuda.launches,
                roi_align.roi_align_pyramid_bwd_cuda.launches)
    label = 'tiny FPN (R18, 64-channel neck)'
    phase_reference(_fpn_tiny_cfg(), label, (100, 150), FPN_TINY_SEED)
    anchors = 3 * sum(-(-128 // s) * -(-192 // s) for s in (4, 8, 16, 32, 64))
    phase_reference_train(_fpn_tiny_cfg(), label, (128, 192), anchors, 32,
                          FPN_TINY_SEED)
    if roi_align.roi_align_pyramid_cuda.launches - fwd != 2 or \
            roi_align.roi_align_pyramid_bwd_cuda.launches - bwd != 1:
        raise RuntimeError('tiny FPN on the card did not run its kernels')


# ---- the mask slice: Mask R-CNN R50-FPN (Cityscapes) and R50-C4 ------------

MASK = 'configs/cityscapes/mask_rcnn_r50_fpn_1x_cityscapes.py'
C4 = 'configs/mask_rcnn/mask_rcnn_r50_caffe_c4_1x.py'
MASK_TINY = 'configs/da/synth_mask_smoke.py'
# the tiny references' proposal and sample counts and 128x192 canvas, as
# FPN_TINY's and for the same reason; their weight seeds are ones whose top
# 65 RPN logits lie >= 1.9e-5 (mask) and >= 2.2e-5 (C4) apart on the
# reference images and on the train batch (a CPU count)
FEW_PROPOSALS = {'model.rpn_proposal_cfg': dict(nms_pre=64, max_per_img=32),
                 'model.rpn_test_cfg': dict(nms_pre=64, max_per_img=32),
                 'model.roi_train_cfg': dict(num_samples=32),
                 'data.test.pipeline': [dict(type='MultiScaleFlipAug',
                                             img_scale=(192, 128))]}
MASK_TINY_SEED = 37
C4_TINY = {'model.backbone_depth': 18, 'model.num_classes': 2}
C4_TINY_SEED = 13
# box-frame raster size: `LoadAnnotations`' default mask_size
MASK_M = 112
# steps per epoch of the C4 config's loader: COCO train2017's 118287
# images, 2 a step
COCO_STEPS = 59144
FWD_MASK, BWD_MASK_STEP = ('roi_align_pyramid_fwd/mask_fpn',
                           'roi_align_pyramid_bwd/mask_fpn_step')
FWD_TARGETS = 'roi_align_pyramid_fwd/mask_targets'
FWD_C4, BWD_C4_STEP = 'roi_align_pyramid_fwd/c4', 'roi_align_pyramid_bwd/c4_step'
FWD, BWD = roi_align.roi_align_pyramid_cuda, roi_align.roi_align_pyramid_bwd_cuda
# a request launches the forward for the box and the mask features; a step
# for those and the mask targets, and the backward for both features
MASK_SERVING_LAUNCHES = {'roi_align_pyramid_fwd': (FWD, 2),
                         'roi_align_pyramid_bwd': (BWD, 0)}
MASK_STEP_LAUNCHES = {'roi_align_pyramid_fwd': (FWD, 3),
                      'roi_align_pyramid_bwd': (BWD, 2)}
# C4: a request crops the proposals and the detections; a step the sampled
# RoIs (their res5 output feeds box and mask head) and the mask targets
C4_SERVING_LAUNCHES = {'roi_align_pyramid_fwd': (FWD, 2),
                       'roi_align_pyramid_bwd': (BWD, 0)}
# with random weights the 80-class head scores every class ~1/81, under the
# config's score_thr of 0.05, so no detection would reach the mask branch:
# C4 serves at score_thr 0.001
C4_SERVING = {'model.roi_test_cfg': dict(score_thr=0.001)}
C4_STEP_LAUNCHES = {'roi_align_pyramid_fwd': (FWD, 2),
                    'roi_align_pyramid_bwd': (BWD, 1)}


def targets_fwd(rasters, frame_rois, out_size=28):
    """The pair's forward as the mask targets launch it: (B·S, M, M, 1)
    single-RoI rasters, scale 1, the legacy aligned=False geometry."""
    return roi_align.roi_align_pyramid_cuda([rasters], frame_rois, None,
                                            (1.0,), out_size, aligned=False)


def targets_plain(rasters, frame_rois, out_size=28):
    return roi_align.batched_roi_align_plain(rasters, frame_rois, 1.0,
                                             out_size, aligned=False)


def c4_fwd(feats, rois):
    """The pair's forward as C4 launches it: one level at stride 16,
    o = 14, (B, R, 14, 14, C)."""
    return dc5_fwd(feats, rois, flatten=False, out_size=14)


def c4_bwd(grad, rois, shape):
    return roi_align.roi_align_pyramid_bwd_cuda(
        grad, rois, None, [shape], (1 / 16,), 14)[0]


def c4_plain(feats, rois):
    return roi_align.batched_roi_align_plain(feats, rois, 1 / 16, 14)


def mask_plain(feats, rois):
    """The plain multi-level version at the mask features' o = 14."""
    return roi_align.batched_roi_align_fpn_plain(feats, rois, out_size=14)


def make_frame_rois(gen, n, m):
    """n seeded RoIs in an M-sized box frame, one per raster, as positives
    map there (IoU >= 0.5 with their gt: coordinates about [-M, 2M]): from
    inside the raster to far beyond it, a fifth under one pixel wide, and
    edge cases (zero, exact frame, beyond every side, sub-pixel)."""
    u = torch.rand(n, 4, generator=gen, device='cuda')
    lo = (u[:, :2] * 2.2 - 1.0) * m
    size = torch.exp(math.log(0.2) + u[:, 2:] * math.log(1.6 * m / 0.2))
    rois = torch.cat([lo, lo + size], -1)
    special = torch.tensor([
        [0, 0, 0, 0], [0, 0, m, m], [-m, -m, 2 * m, 2 * m],
        [-0.9 * m, 0.2 * m, -0.1 * m, 0.7 * m],
        [1.1 * m, 1.2 * m, 1.9 * m, 1.95 * m],
        [40.3, 50.1, 40.6, 50.5], [m - 0.4, 3.0, m + 0.3, 3.2]],
        device='cuda')
    rois[:len(special)] = special
    return rois[:, None].contiguous()


def _plain_grads(plain, feats, rois, grad):
    """d feats of the plain version `plain(levels, rois)` (one level: a
    list of one map), by its autograd."""
    fs = [f.detach().requires_grad_() for f in feats]
    return torch.autograd.grad(plain(fs if len(fs) > 1 else fs[0], rois),
                               fs, grad)


def phase_mask_kernels():
    """The pair in the mask slice's three regimes, f32 and bf16, against
    the plain version: (a) 14x14 mask features on four levels (C = 256),
    forward and backward on the 512x1024 training pyramid and forward on
    the serving pyramid's detections; (b) the mask targets, 28x28 from
    2 x 512 single-RoI rasters of 112x112 (C = 1, scale 1, aligned=False);
    (c) C4's 14x14 RoI crops at one level, C = 1024, forward at the serving
    shape (2 x 1000 proposals on 38x64) and backward at the training shape
    (2 x 512 on 32x64). Times the forwards; the backwards are timed on the
    RoIs trained steps sample (phases 11 and 13)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(5)
    kernels = []

    # (a) the FPN mask features, o = 14, (B, R, 14, 14, 256)
    b, c, n = 2, 256, 512
    sizes = [(512 // st, 1024 // st) for st in FPN_STRIDES]
    feats = [torch.randn(b, h, w, c, generator=gen, device='cuda')
             for h, w in sizes]
    shapes = [tuple(f.shape) for f in feats]
    rois = make_fpn_rois(gen, b, n, 512, 1024)
    levels = roi_align.roi_levels(rois, 4)
    log(f'kernels: {FWD_MASK} RoIs per level P2..P5 {_level_counts(levels)}')
    grad = torch.randn(b, n, 14, 14, c, generator=gen, device='cuda')
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        fs, g = [f.to(dtype) for f in feats], grad.to(dtype)
        err = _check(FWD_MASK, fpn_fwd(fs, rois, levels, False, 14),
                     mask_plain(fs, rois), tol, f'{str(dtype)[6:]} o=14')
        got = fpn_bwd(g, rois, levels, shapes, False, 14)
        for lvl, (gg, rr) in enumerate(zip(got, _plain_grads(
                mask_plain, fs, rois, g))):
            _check(BWD_MASK_STEP, gg, rr, tol,
                   f'{str(dtype)[6:]} o=14 P{lvl + 2}')
        if dtype == torch.float32:
            worst = max(worst, err)
        del fs, g, got
    ms = time_ms(lambda: fpn_fwd(feats, rois, levels, False, 14), 20)
    plain_ms = time_ms(lambda: mask_plain(feats, rois), 3, warmup=1)
    nbytes, ops = roi_align_fpn_work(rois, levels, sizes, c, 14)
    fwd = _entry(FWD_MASK, 944, nbytes, ops, max_abs_err=worst, ms=ms,
                 plain_ms=plain_ms)
    log(f'kernels: {FWD_MASK} f32 pyramid of 512x1024 C=256 x 2x512 rois '
        f'o=14: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{fwd["bound_ms"]:.4f} ms ({fwd["bound_by"]}: {nbytes / 1e6:.1f} '
        f'MB, {ops / 1e9:.2f} GFLOP)')
    kernels.append(fwd)
    # the serving pyramid's 2 x 100 detections, zero-area padded rows
    # included (they fall on P2 and sample one point per bin)
    sizes = [(608 // st, 1024 // st) for st in FPN_STRIDES]
    feats = [torch.randn(b, h, w, c, generator=gen, device='cuda')
             for h, w in sizes]
    rois = make_fpn_rois(gen, b, 100, 608, 1024)
    rois[:, 60:] = 0
    levels = roi_align.roi_levels(rois, 4)
    _check(FWD_MASK, fpn_fwd(feats, rois, levels, False, 14),
           mask_plain(feats, rois), TOL_F32,
           'f32 o=14 on 2x100 detections, 40 zero-area')
    del feats, grad

    # (b) the mask targets: 2 x 512 single-RoI rasters, M = 112
    rasters = torch.from_numpy(ellipse_masks(
        np.random.RandomState(5), (b * n,), MASK_M)).cuda()[..., None].float()
    frame = make_frame_rois(gen, b * n, MASK_M)
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        r = rasters.to(dtype)
        for out_size in (28, 14):
            err = _check(FWD_TARGETS, targets_fwd(r, frame, out_size),
                         targets_plain(r, frame, out_size), tol,
                         f'{str(dtype)[6:]} o={out_size} C=1 aligned=False')
            if dtype == torch.float32:
                worst = max(worst, err)
    ms = time_ms(lambda: targets_fwd(rasters, frame), 20)
    plain_ms = time_ms(lambda: targets_plain(rasters, frame), 3, warmup=1)
    nbytes, ops = roi_align_work(frame, MASK_M, MASK_M, 1, 28, scale=1.0,
                                 aligned=False)
    entry = _entry(FWD_TARGETS, 237, nbytes, ops, max_abs_err=worst, ms=ms,
                   plain_ms=plain_ms)
    log(f'kernels: {FWD_TARGETS} f32 {b * n} rasters {MASK_M}x{MASK_M}x1 '
        f'o=28: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{entry["bound_ms"]:.4f} ms ({entry["bound_by"]}: '
        f'{nbytes / 1e6:.2f} MB, {ops / 1e9:.4f} GFLOP)')
    kernels.append(entry)
    del rasters

    # (c) C4's crops: one level, C = 1024, o = 14
    c = 1024
    feats = torch.randn(b, 38, 64, c, generator=gen, device='cuda')
    rois = make_rois(gen, b, 1000, 38, 64)
    worst = 0.0
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        f = feats.to(dtype)
        err = _check(FWD_C4, c4_fwd(f, rois), c4_plain(f, rois), tol,
                     f'{str(dtype)[6:]} o=14 C=1024')
        if dtype == torch.float32:
            worst = max(worst, err)
        del f
    ms = time_ms(lambda: c4_fwd(feats, rois), 20)
    plain_ms = time_ms(lambda: c4_plain(feats, rois), 3, warmup=1)
    nbytes, ops = roi_align_work(rois, 38, 64, c, 14)
    entry = _entry(FWD_C4, 434, nbytes, ops, max_abs_err=worst, ms=ms,
                   plain_ms=plain_ms)
    log(f'kernels: {FWD_C4} f32 (2,38,64,1024) x 2x1000 rois o=14: '
        f'{ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{entry["bound_ms"]:.4f} ms ({entry["bound_by"]}: '
        f'{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)')
    kernels.append(entry)
    del feats, rois
    feats = torch.randn(b, 32, 64, c, generator=gen, device='cuda')
    rois = make_rois(gen, b, 512, 32, 64)
    grad = torch.randn(b, 512, 14, 14, c, generator=gen, device='cuda')
    for dtype, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        f, g = feats.to(dtype), grad.to(dtype)
        _check(BWD_C4_STEP, c4_bwd(g, rois, tuple(f.shape)),
               _plain_grads(c4_plain, [f], rois, g)[0], tol,
               f'{str(dtype)[6:]} o=14 C=1024 (2,32,64) x 2x512 rois')
        del f, g
    return kernels


def _check_masks(label, model, maps, out, img_hw):
    """`predict`'s masks finite and in [0, 1]; `paste_masks` on the card
    equal to the same call on the CPU (integer arithmetic both)."""
    masks = model.mask_predict(maps, out)
    if not (torch.isfinite(masks).all() and masks.min() >= 0
            and masks.max() <= 1):
        raise RuntimeError(f'{label}: masks not finite or outside [0, 1]')
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pasted = paste_masks(masks[0], out['dets'][0, :, :4], *img_hw)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    ref = paste_masks(masks[0].cpu(), out['dets'][0, :, :4].cpu(), *img_hw)
    if pasted.device.type != 'cuda' or not torch.equal(pasted.cpu(), ref):
        raise RuntimeError(f'{label}: paste_masks on the card differs from '
                           'the CPU')
    log(f'{label}: masks {tuple(masks.shape)} in [{float(masks.min()):.3f}, '
        f'{float(masks.max()):.3f}]; paste_masks of image 0 on the card '
        f'{tuple(pasted.shape)} in {ms:.1f} ms, {int(pasted.sum())} pixels '
        'set, equal to the CPU')


def phase_mask_serving(card, kernels):
    bundle, requests, launches = _serve(card, MASK, 'mask serving',
                                        MASK_SERVING_LAUNCHES)
    _set_launches(kernels, FWD_MASK, launches['roi_align_pyramid_fwd'])
    _served_mask_features('mask serving', bundle, requests[-1], FWD_MASK,
                          TOL_F32)


def _served_mask_features(label, bundle, request, name, tol):
    """The kernel's mask features (o=14, four levels) against the plain
    version on the detections of `request`, then `_check_masks`."""
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        batch, _ = prepare_batch(bundle, request)
        model = bundle.model
        out, maps = model._detect(batch)
        dets = out['dets'][..., :4].contiguous()
        levels = roi_align.roi_levels(dets, 4)
        _check(name, fpn_fwd(maps, dets, levels, False, 14),
               roi_align.batched_roi_align_fpn_plain(maps, dets, out_size=14),
               tol, f'on the last request\'s {int(out["valid"].sum())} '
               f'detections, per level P2..P5 '
               f'{torch.bincount(levels.flatten().long(), minlength=4).tolist()}')
        _check_masks(label, model, maps, out, batch['img_shape'][0].tolist())


def mask_batch(hw=(512, 1024)):
    """`fpn_level_batch` with seeded box-frame ellipse rasters (112x112)."""
    batch = fpn_level_batch(hw)
    b, g = batch['gt_valid'].shape
    batch['gt_masks'] = torch.from_numpy(ellipse_masks(
        np.random.RandomState(3), (b, g), MASK_M)).cuda()
    return batch


def mask_kernels_on_sampled_rois(model):
    """The pair against the plain version on the RoIs that a train step of
    the trained full-width mask model samples from `mask_batch` (gt boxes
    on every level): (a) the 14x14 features forward and backward, the
    backward then timed; (b) the targets on the step's box-frame RoIs.
    Returns the backward's entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    batch = mask_batch()
    pyramid, sampled, gen = sample_step_rois(model, batch, 3)
    rois = sampled.rois
    levels = roi_align.roi_levels(rois, 4)
    log(f'mask train: {tuple(rois.shape[:2])} sampled RoIs, per level P2..P5 '
        f'{_level_counts(levels)}')
    got = fpn_fwd(pyramid, rois, levels, False, 14)
    _check(FWD_MASK, got, mask_plain(pyramid, rois), TOL_F32,
           'on sampled RoIs')
    grad = torch.randn(got.shape, generator=gen, device='cuda')
    got = fpn_bwd(grad, rois, levels, [tuple(p.shape) for p in pyramid],
                  False, 14)
    worst = max(_check(BWD_MASK_STEP, gg, rr, TOL_F32,
                       f'on sampled RoIs P{lvl + 2}')
                for lvl, (gg, rr) in enumerate(zip(
                    got, _plain_grads(mask_plain, pyramid, rois, grad))))
    _targets_on_sampled_rois('mask train', batch, sampled, 28)
    return time_fpn_backward(BWD_MASK_STEP, pyramid, rois, grad, worst, 14,
                             False, 889)


def _targets_on_sampled_rois(label, batch, sampled, out_size):
    """The mask targets' forward against the plain version on a step's
    sampled RoIs, in the frames of their matched gts."""
    rasters, frame = box_frame_crops(batch['gt_masks'], batch['gt_bboxes'],
                                     sampled.rois, sampled.matched_gt)
    wide = frame[..., 2:] - frame[..., :2]
    pos = (sampled.is_pos & sampled.label_valid).flatten()
    log(f'{label}: mask targets on {frame.shape[0]} box-frame RoIs, '
        f'{int(pos.sum())} positive; frame coordinates of the positives in '
        f'[{float(frame[pos].min()):.1f}, {float(frame[pos].max()):.1f}], '
        f'{int((wide < 1).any(-1).sum())} RoIs under a pixel on an axis')
    _check(FWD_TARGETS, targets_fwd(rasters, frame, out_size),
           targets_plain(rasters, frame, out_size), TOL_F32,
           f'on sampled RoIs o={out_size}')


def phase_mask_train(card, kernels):
    trainer, state, start, times, totals, peak = _train(
        card, MASK, FPN_STEPS, 'mask train', MASK_STEP_LAUNCHES,
        demo_batch(mask_size=MASK_M))
    moved = _moved(trainer.state.params, start, FPN_FROZEN, 'mask train')
    if not any(n.startswith('mask_head.') for n in start):
        raise RuntimeError('mask trainer: no mask head')
    log(_train_summary('mask train', 'Mask R-CNN R50-FPN f32', times, peak,
                       totals, card)
        + f'; {moved} parameters moved (mask head included), stem and '
        'layer1 unchanged')
    kernels.append(mask_kernels_on_sampled_rois(trainer.model))
    _set_launches(kernels, BWD_MASK_STEP, totals['roi_align_pyramid_bwd'])
    _set_launches(kernels, FWD_TARGETS, totals['roi_align_pyramid_fwd'])


def phase_c4_serving(card, kernels):
    bundle, requests, launches = _serve(card, C4, 'c4 serving',
                                        C4_SERVING_LAUNCHES, C4_SERVING)
    _set_launches(kernels, FWD_C4, launches['roi_align_pyramid_fwd'])
    # the kernel's crops of the last request's proposals
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        batch, _ = prepare_batch(bundle, requests[-1])
        model = bundle.model
        feat = model.extract_feat(batch['image'])
        proposals, _, valid = rpn_proposals(
            *model.rpn_outputs(feat), batch['img_shape'], model.rpn_test_cfg)
        maps = model.roi_maps(feat)
        _check(FWD_C4, c4_fwd(maps, proposals), c4_plain(maps, proposals),
               TOL_F32, f'on the last request\'s {int(valid.sum())} '
               'proposals')
        out = model.predict(batch)
        if not out['valid'].any():
            raise RuntimeError('c4 serving: no detection reached the masks')
        _check_masks('c4 serving', model, maps, out,
                     batch['img_shape'][0].tolist())


def c4_kernels_on_sampled_rois(model, batch):
    """The pair against the plain version on the RoIs that a train step of
    the trained full-width C4 model samples from its batch: (c) forward and
    backward at C = 1024, o = 14, the backward then timed; (b) the 14x14
    targets on the step's box-frame RoIs. Returns the backward's entry."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, sampled, gen = sample_step_rois(model, batch, 3)
    rois = sampled.rois
    b, h, w, c = feats.shape
    log(f'c4 train: {tuple(rois.shape[:2])} sampled RoIs on the '
        f'{tuple(feats.shape)} map')
    got = c4_fwd(feats, rois)
    _check(FWD_C4, got, c4_plain(feats, rois), TOL_F32, 'on sampled RoIs')
    grad = torch.randn(got.shape, generator=gen, device='cuda')
    shape = tuple(feats.shape)
    worst = _check(BWD_C4_STEP, c4_bwd(grad, rois, shape),
                   _plain_grads(c4_plain, [feats], rois, grad)[0], TOL_F32,
                   'on sampled RoIs')
    _targets_on_sampled_rois('c4 train', batch, sampled, 14)
    ms = time_ms(lambda: c4_bwd(grad, rois, shape), 20)
    plain_ms = plain_backward_ms(lambda fs: c4_plain(fs[0], rois), [feats],
                                 grad)
    nbytes, ops = roi_align_work(rois, h, w, c, 14, backward=True)
    entry = _entry(BWD_C4_STEP, 487, nbytes, ops, max_abs_err=worst, ms=ms,
                   plain_ms=plain_ms)
    old, new = atomic_adds(rois, [(h, w)], (16,), c, out_size=14)
    log(f'kernels: {BWD_C4_STEP} f32 {shape} x {b}x{rois.shape[1]} rois '
        f'o=14: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{entry["bound_ms"]:.4f} ms ({entry["bound_by"]}: '
        f'{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP); f32 atomic adds '
        f'{new / 1e9:.3f} G (one per (RoI, pixel)), {old / 1e9:.3f} G '
        'nonzero taps')
    return entry


def phase_c4_train(card, kernels):
    batch = demo_batch(mask_size=MASK_M)
    trainer, state, start, times, totals, peak = _train(
        card, C4, COCO_STEPS, 'c4 train', C4_STEP_LAUNCHES, batch)
    moved = _moved(trainer.state.params, start, FPN_FROZEN, 'c4 train')
    for head in ('shared_head.', 'mask_head.'):
        if not any(n.startswith(head) for n in start):
            raise RuntimeError(f'C4 trainer: no {head[:-1]}')
    log(_train_summary('c4 train', 'Mask R-CNN R50-C4 f32', times, peak,
                       totals, card)
        + f'; {moved} parameters moved (res5 shared head and mask head '
        'included), stem and layer1 unchanged')
    kernels.append(c4_kernels_on_sampled_rois(trainer.model, batch))
    _set_launches(kernels, BWD_C4_STEP, totals['roi_align_pyramid_bwd'])


def _tiny_cfg(path, overrides):
    cfg = Config.fromfile(path)
    cfg.merge_from_dict(overrides)
    return cfg


def phase_mask_reference():
    """The tiny Mask R-CNN (configs/da/synth_mask_smoke.py: R18, 256-channel
    neck, 2 classes) and a tiny R18 Mask R-CNN C4: card vs CPU, inference
    (detections and masks) and one train step, launching the pair."""
    for label, path, overrides, seed, hw, anchors, fwd, bwd in (
            ('tiny Mask R-CNN (R18)', MASK_TINY, FEW_PROPOSALS,
             MASK_TINY_SEED, (100, 150),
             3 * sum(-(-128 // st) * -(-192 // st)
                     for st in (4, 8, 16, 32, 64)), 7, 2),
            ('tiny Mask R-CNN C4 (R18)', C4, dict(C4_TINY, **FEW_PROPOSALS),
             C4_TINY_SEED, (100, 150), 15 * 8 * 12, 6, 1)):
        before = FWD.launches, BWD.launches
        phase_reference(_tiny_cfg(path, overrides), label, hw, seed)
        phase_reference_train(_tiny_cfg(path, overrides), label, (128, 192),
                              anchors, 32, seed, mask_size=MASK_M)
        got = (FWD.launches - before[0], BWD.launches - before[1])
        if got != (fwd, bwd):
            raise RuntimeError(f'{label} on the card launched the pair '
                               f'{got} times, expected {(fwd, bwd)}')


# ---- the loop: train, evaluate, checkpoint, resume and serve ---------------

SYNTH = 'configs/da/faster_rcnn_r18_synth_shapes.py'
SYNTH_DATA = 'tests/data/synth_da_small'
CITYSCAPES_SIZE_JPEG = 'tests/data/jpeg_2048x1024/synth_clear.jpg'
LOOP_DIR = 'build/loop'
FWD_LOOP, BWD_LOOP = ('roi_align_pyramid_fwd/synth_loop',
                      'roi_align_pyramid_bwd/synth_loop')
# the published gate-3 config with only its data redirected: each split's
# ann_file and img_prefix (the config builds them from data_root when it
# loads, so data_root alone would change nothing); 2 short epochs, eval and
# a checkpoint after each
LOOP_OPTIONS = [
    f'{key}.{field}={SYNTH_DATA}/{sub}/' + (
        f'ImageSets/Main/{split}.txt' if field == 'ann_file' else '')
    for key, sub, split in (('data.train.datasets.0', 'shapes_clear', 'train'),
                            ('data.train.datasets.1', 'shapes_foggy', 'train'),
                            ('data.val', 'shapes_foggy', 'test'),
                            ('data.test', 'shapes_foggy', 'test'))
    for field in ('ann_file', 'img_prefix')] + [
    'runner.max_epochs=2', 'evaluation.interval=1',
    'checkpoint_config.interval=1']


def _loop_cfg():
    args = DA_train.parse_args([SYNTH, '--cfg-options', *LOOP_OPTIONS])
    return DA_train.load_config(args)


def _run_cli(argv, steps, eval_batches):
    """`DA_train.main(argv)` with the launch counters set to 0 just before;
    raises unless the run launched the forward once a step and once an
    eval batch, and the backward once a step. Returns (metrics, forward
    launches, backward launches, seconds)."""
    FWD.launches = BWD.launches = 0
    t0 = time.perf_counter()
    metrics = DA_train.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    fwd, bwd = FWD.launches, BWD.launches
    if (fwd, bwd) != (steps + eval_batches, steps):
        raise RuntimeError(f'loop: {fwd} forward / {bwd} backward launches '
                           f'for {steps} steps and {eval_batches} eval '
                           'batches')
    return metrics, fwd, bwd, seconds


def _check_log(path, epochs):
    """The train log's records: finite losses at every epoch's end, a val
    record per epoch with AP50 in [0, 1]. Returns the records."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if r['mode'] == 'train']
    val = [r for r in recs if r['mode'] == 'val']
    if [r['epoch'] for r in train] != epochs or \
            [r['epoch'] for r in val] != epochs:
        raise RuntimeError(f'loop: train/val records for epochs '
                           f'{[r["epoch"] for r in train]} / '
                           f'{[r["epoch"] for r in val]}, expected {epochs}')
    for r in train:
        losses = {k: v for k, v in r.items() if k.startswith('loss')
                  or k.endswith('_loss')}
        if len(losses) < 5 or not all(math.isfinite(v)
                                      for v in losses.values()):
            raise RuntimeError(f'loop: losses {losses}')
    for r in val:
        if not (math.isfinite(r['AP50']) and 0.0 <= r['AP50'] <= 1.0):
            raise RuntimeError(f'loop: AP50 {r["AP50"]}')
    return recs


def _same_payload(got, ref, what):
    """Raise unless two checkpoint payloads are equal, bit for bit."""
    for key in ('step', 'opt_count'):
        if got[key] != ref[key]:
            raise RuntimeError(f'{what}: {key} {got[key]} != {ref[key]}')
    for key in ('params', 'buffers', 'momentum', 'nu', 'ema_params'):
        # no EMA (the GAN step), no second moment (SGD)
        if ref[key] is None or got[key] is None:
            if (ref[key] is None) != (got[key] is None):
                raise RuntimeError(f'{what}: {key} kept on one side only')
            continue
        if set(got[key]) != set(ref[key]):
            raise RuntimeError(f'{what}: {key} names differ')
        for n, v in ref[key].items():
            if not torch.equal(got[key][n].to(v.device), v):
                raise RuntimeError(f'{what}: {key}.{n} differs')


def _time_loader(cfg, card):
    """Decode ms an image (host) of the subset and of one 2048x1024 JPEG,
    then a loader epoch built on the card (no prefetch: each batch timed
    from its request to a synchronize) and the same epoch built on the CPU,
    which must equal it exactly. Returns (decode ms, loader ms per batch,
    the card's batches)."""
    paths = sorted(glob.glob(f'{SYNTH_DATA}/*/JPEGImages/*.jpg'))
    t0 = time.perf_counter()
    for p in paths:
        decode_jpeg(p)
    decode_ms = 1e3 * (time.perf_counter() - t0) / len(paths)
    big_ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        big = decode_jpeg(CITYSCAPES_SIZE_JPEG)
        big_ms.append(1e3 * (time.perf_counter() - t0))
    if big.shape != (1024, 2048, 3) or big.dtype != np.uint8:
        raise RuntimeError(f'loop: decoded {CITYSCAPES_SIZE_JPEG} as '
                           f'{big.shape} {big.dtype}')
    log(f'loop: decode one 2048x1024 JPEG '
        f'({os.path.getsize(CITYSCAPES_SIZE_JPEG)} bytes): '
        f'{[round(t, 3) for t in big_ms]} ms (host) [{card}]')
    batches, times = [], []
    loaders = [DataLoader(build_dataset(cfg.data['train'], d), 8, seed=0,
                          prefetch=0) for d in ('cuda', 'cpu')]
    made = iter(loaders[0])
    for _ in range(len(loaders[0])):
        t0 = time.perf_counter()
        batches.append(next(made))
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    for got, ref in zip(batches, loaders[1]):
        for k, v in ref.items():
            if got[k].device.type != 'cuda' or not torch.equal(got[k].cpu(),
                                                               v):
                raise RuntimeError(f'loop: loader {k} on the card differs '
                                   'from the CPU')
    log(f'loop: decode {len(paths)} JPEGs 192x128: {decode_ms:.3f} ms an '
        f'image (host) [{card}]')
    log(f'loop: loader batches of 8 on the card {[round(t, 2) for t in times]}'
        f' ms, mean {np.mean(times):.3f} ms a batch; {len(batches)} batches '
        'equal to the CPU-built ones (image, boxes, labels, flips, domain) '
        f'[{card}]')
    return decode_ms, float(np.mean(times)), batches


def _time_steps(cfg, batches):
    """8 train steps (2 epochs of the card-built batches) of a fresh
    trainer of the loop's config, each launching the pair's forward and
    backward once. Returns (step ms, trainer, state)."""
    trainer = init_trainer(cfg, device='cuda', seed=0,
                           steps_per_epoch=len(batches))
    gen = torch.Generator(device='cuda').manual_seed(1)
    state, times = trainer.state, []
    for i, batch in enumerate(batches * 2):
        FWD.launches = BWD.launches = 0
        t0 = time.perf_counter()
        state, metrics = trainer.step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
        if (FWD.launches, BWD.launches) != (1, 1):
            raise RuntimeError(f'loop step {i}: launches {FWD.launches} / '
                               f'{BWD.launches}')
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise RuntimeError(f'loop step {i}: {metrics}')
    return times, trainer, state


def eval_proposals(model, dataset):
    """The RPN's proposals on the first eval batch of `dataset` and the
    map RoIAlign reads them from, as `predict` makes them."""
    with torch.no_grad():
        batch = next(iter(DataLoader(dataset, 8, shuffle=False,
                                     two_stream=False, drop_last=False,
                                     prefetch=0)))
        feat = model.extract_feat(batch['image'])
        proposals, _, _ = rpn_proposals(*model.rpn_outputs(feat),
                                        batch['img_shape'],
                                        model.rpn_test_cfg)
        return model.roi_maps(feat), proposals.contiguous()


def _time_fed_steps(cfg, trainer, state):
    """Epochs as the loop runs them: each step waits for its batch from
    the loader, then runs; each launching the pair once. Epochs alternate
    between a loader with the prefetch thread (depth 2: one thread decoding
    on the host and preparing on the card) and one without it (each batch
    made when it is asked for), in the order 2, 0, 0, 2. Returns {prefetch:
    [(epoch ms, [ms from one step's end to the next's])]}."""
    loaders = {p: DataLoader(build_dataset(cfg.data['train'], 'cuda'), 8,
                             seed=0, prefetch=p) for p in (2, 0)}
    gen = torch.Generator(device='cuda').manual_seed(1)
    out = {2: [], 0: []}
    FWD.launches = BWD.launches = 0
    for p in (2, 0, 0, 2):
        times = []
        start = t0 = time.perf_counter()
        for batch in loaders[p]:
            state, _ = trainer.step(state, batch, gen)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            times.append(1e3 * (t1 - t0))
            t0 = t1
        out[p].append((1e3 * (t0 - start), times))
    steps = sum(len(t) for runs in out.values() for _, t in runs)
    if (FWD.launches, BWD.launches) != (steps, steps):
        raise RuntimeError(f'loop fed steps: launches {FWD.launches} / '
                           f'{BWD.launches} for {steps} steps')
    return out


def loop_kernels(maps, proposals, model, batch):
    """The pair against the plain version in the loop's regime (R18-DC5,
    C=512, 8x12 map, 8 images): forward on an eval batch's proposals
    (timed), forward and backward on the RoIs a loop step of `model`
    samples from `batch` (backward timed). Returns the two entries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    b, h, w, c = maps.shape
    worst = _check(FWD_LOOP, dc5_fwd(maps, proposals),
                   roi_align.batched_roi_align_plain(
                       maps, proposals, 1 / 16, flatten=True), TOL_F32,
                   f'on an eval batch\'s {tuple(proposals.shape[:2])} '
                   'proposals')
    ms = time_ms(lambda: dc5_fwd(maps, proposals), 20)
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        maps, proposals, 1 / 16, flatten=True), 3, warmup=1)
    nbytes, ops = roi_align_work(proposals, h, w, c)
    fwd = _entry(FWD_LOOP, 63, nbytes, ops, max_abs_err=worst, ms=ms,
                 plain_ms=plain_ms)
    log(f'kernels: {FWD_LOOP} f32 {tuple(maps.shape)} x '
        f'{b}x{proposals.shape[1]} proposals: {ms:.4f} ms, plain '
        f'{plain_ms:.4f} ms, bound {fwd["bound_ms"]:.4f} ms '
        f'({fwd["bound_by"]}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP)')
    feats, sampled, gen = sample_step_rois(model, batch, 3)
    rois = sampled.rois
    got = dc5_fwd(feats, rois)
    worst = max(worst, _check(FWD_LOOP, got, roi_align.batched_roi_align_plain(
        feats, rois, 1 / 16, flatten=True), TOL_F32,
        f'on a step\'s {tuple(rois.shape[:2])} sampled RoIs'))
    fwd['max_abs_err'] = worst
    grad = torch.randn(got.shape, generator=gen, device='cuda')
    worst = _check(BWD_LOOP, dc5_bwd(grad, rois, tuple(feats.shape)),
                   plain_backward(feats, rois, grad, True), TOL_F32,
                   'on sampled RoIs')
    return [fwd, time_dc5_backward(BWD_LOOP, feats, rois, grad, worst)]


def phase_loop(card, kernels):
    """Train → evaluate → checkpoint → resume → serve through the command
    line, on the gate-3 config at its published width."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    cfg = _loop_cfg()
    val_images = len(build_dataset(cfg.data['val']))
    eval_batches = -(-val_images // 8)
    argv = [SYNTH, '--work-dir', LOOP_DIR, '--cfg-options', *LOOP_OPTIONS]
    metrics, fwd, bwd, seconds = _run_cli(argv, 8, 2 * eval_batches)
    recs = _check_log(f'{LOOP_DIR}/train_log.jsonl', [1, 2])
    meta = [ckpt_io.load_meta(f'{LOOP_DIR}/ckpt_{e}')['epoch'] for e in (1, 2)]
    if meta != [1, 2]:
        raise RuntimeError(f'loop: checkpoints {meta}')
    log(f'loop: DA_train 2 epochs x 4 steps of 8 images 128x192 (R18-DC5 '
        f'daf, clip 35, EMA 0.9995) in {seconds:.2f} s with 2 evals on '
        f'{val_images} images and 2 checkpoints; launches fwd {fwd} bwd '
        f'{bwd}; records {recs}; final {metrics} [{card}]')

    # resume: the restored state must be what the first call saved
    saved = ckpt_io.load_checkpoint(f'{LOOP_DIR}/ckpt_1', 'cuda')
    restored = []
    original = train_api.restore_train_state

    def spy(model, state, ckpt):
        state = original(model, state, ckpt)
        restored.append({k: v.clone() if torch.is_tensor(v) else
                         ({n: t.clone() for n, t in v.items()}
                          if isinstance(v, dict) else v)
                         for k, v in ckpt_io.train_state_dict(
                             model, state).items()})
        return state
    train_api.restore_train_state = spy
    try:
        _run_cli(argv + ['--resume-from', f'{LOOP_DIR}/ckpt_1'], 4,
                 eval_batches)
    finally:
        train_api.restore_train_state = original
    _same_payload(restored[0], saved, 'resume')
    log(f'loop: resumed from ckpt_1 at step {saved["step"]}: params, '
        'buffers, momentum, EMA and step equal to the saved ones, bit for '
        'bit; epoch 2 trained again')

    # serve the test split from its JPEG paths with the last checkpoint
    bundle = init_detector(cfg, device='cuda',
                           checkpoint=f'{LOOP_DIR}/ckpt_2')
    test_ds = build_dataset(dict(cfg.data['test'], test_mode=True))
    paths = [os.path.join(test_ds.img_prefix, info['filename'])
             for info in test_ds.data_infos]
    from_paths = inference_detector(bundle, paths)
    from_arrays = inference_detector(bundle, [decode_jpeg(p) for p in paths])
    n_dets = 0
    for a, b in zip(from_paths, from_arrays):
        n_dets += _check_result(a, (128, 192), bundle.model.num_classes, 50,
                                bundle.model.roi_test_cfg.score_thr)
        for x, y in zip(a, b):
            if not np.array_equal(x, y):
                raise RuntimeError('loop: serving a path differs from '
                                   'serving its decoded array')
    log(f'loop: init_detector(checkpoint=ckpt_2) served {len(paths)} test '
        f'JPEGs by path: {n_dets} dets, equal to serving the arrays; '
        f'classes {bundle.classes}')

    # timings of the layers
    decode_ms, loader_ms, batches = _time_loader(cfg, card)
    times, trainer, state = _time_steps(cfg, batches)
    med = float(np.median(times))
    log(f'loop: step ms {[round(t, 2) for t in times]} median {med:.3f} '
        f'min {min(times):.3f} max {max(times):.3f} (8 images 128x192 a '
        f'step, batches made beforehand) [{card}]')
    fed_runs = _time_fed_steps(cfg, trainer, state)
    for p, runs in fed_runs.items():
        log(f'loop: epochs of 4 steps fed by the loader with prefetch={p}: '
            f'epoch ms {[round(e, 2) for e, _ in runs]}, step ms '
            f'{[[round(t, 2) for t in ts] for _, ts in runs]} (the loader '
            f'alone {loader_ms:.3f} ms a batch, the step alone {med:.3f})'
            f' [{card}]')
    fed = [t for _, ts in fed_runs[2] for t in ts]
    epoch_ms = {p: float(np.mean([e for e, _ in runs]))
                for p, runs in fed_runs.items()}
    val_ds = build_dataset(cfg.data['val'], 'cuda')
    FWD.launches = BWD.launches = 0
    t0 = time.perf_counter()
    ap = evaluate_dataset(bundle.model, val_ds, 8)
    torch.cuda.synchronize()
    eval_ms = 1e3 * (time.perf_counter() - t0) / len(val_ds)
    if (FWD.launches, BWD.launches) != (eval_batches, 0):
        raise RuntimeError(f'loop eval: launches {FWD.launches} / '
                           f'{BWD.launches}')
    log(f'loop: eval {len(val_ds)} images with ckpt_2\'s EMA weights: '
        f'{eval_ms:.3f} ms an image (decode included), {ap} [{card}]')
    payload = ckpt_io.train_state_dict(trainer.model, state)
    save_ms, load_ms = [], []
    for i in range(3):
        t0 = time.perf_counter()
        ckpt_io.save_checkpoint(f'{LOOP_DIR}/timed', payload)
        save_ms.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        back = ckpt_io.load_checkpoint(f'{LOOP_DIR}/timed', 'cuda')
        torch.cuda.synchronize()
        load_ms.append(1e3 * (time.perf_counter() - t0))
    _same_payload(back, payload, 'checkpoint round trip')
    size = os.path.getsize(f'{LOOP_DIR}/timed/{ckpt_io.STATE_FILE}')
    shutil.rmtree(f'{LOOP_DIR}/timed')
    log(f'loop: checkpoint {size / 1e6:.1f} MB: save ms '
        f'{[round(t, 2) for t in save_ms]}, load ms '
        f'{[round(t, 2) for t in load_ms]} [{card}]')
    log(f'loop summary: decode {decode_ms:.3f} ms/img, loader '
        f'{loader_ms:.3f} ms/batch, step median {med:.3f} ms (min '
        f'{min(times):.3f} max {max(times):.3f}), fed step median '
        f'{np.median(fed):.3f} ms, fed epoch mean {epoch_ms[2]:.3f} ms '
        f'(prefetch 2) / {epoch_ms[0]:.3f} ms (prefetch 0), eval '
        f'{eval_ms:.3f} ms/img, '
        f'checkpoint save {np.median(save_ms):.3f} ms load '
        f'{np.median(load_ms):.3f} ms, AP50 {ap["AP50"]} [{card}]')

    # the pair in the loop's regime: an eval batch's proposals, a step's
    # RoIs
    entries = loop_kernels(*eval_proposals(bundle.model, val_ds),
                           trainer.model, batches[0])
    for e in entries:
        e['launches'] = fwd if e['name'] == FWD_LOOP else bwd
    kernels += entries
    shutil.rmtree(LOOP_DIR)

# ---- the rest of the DA family: DAF-original, MAF, SWDA, DeepAlign,
# Tri-attention, CyDA and CyCADA ---------------------------------------------

DET_KEYS = {'loss_rpn_cls', 'loss_rpn_bbox', 'loss_cls', 'loss_bbox'}
GAN_KEYS = {'cycle_loss', 'gan_g_loss', 'disc_loss'}
TAP_KEYS = {'globle_da_loss', 'patch_bottom_loss', 'local_da_loss'}
# (label, config, prefixes of the variant's own parameters, which must
# move, and its loss terms, the JAX detector's keys)
DA_FAMILY = (
    ('daf_org', 'configs/da/faster_rcnn_r50_daf_org_c2f.py',
     ('backbone.image_s3_0.', 'local_da.'),
     DET_KEYS | {'img_da_loss', 'local_da_loss', 'consist_loss'}),
    ('maf', 'configs/da/faster_rcnn_r50_maf_c2f.py',
     ('backbone.srm_s1_0.', 'backbone.srm_s2_1.', 'backbone.srm_s3_2.'),
     DET_KEYS | {'globle_da_loss', 'local_da_loss'}),
    ('swda', 'configs/da/faster_rcnn_r50_swda_c2f.py',
     ('backbone.pixel_s1_0.', 'backbone.global_s2_1.'), DET_KEYS | TAP_KEYS),
    ('deep', 'configs/da/faster_rcnn_r50_deep_c2f.py',
     ('backbone.pixel_s2_1.', 'backbone.global_s3_3.'), DET_KEYS | TAP_KEYS),
    ('tri', 'configs/da/faster_rcnn_r50_tri_c2f.py',
     ('backbone.global_s2_2.mhsa.rel_h', 'backbone.global_s2_2.mhsa.rel_w',
      'backbone.global_s3_3.mhsa.rel_h', 'backbone.global_s3_3.mhsa.rel_w'),
     DET_KEYS | TAP_KEYS),
    ('cyda', 'configs/da/faster_rcnn_r50_cyda_c2f.py',
     ('gen_s2t.', 'gen_t2s.', 'disc_s.', 'disc_t.'),
     DET_KEYS | GAN_KEYS | {'globle_da_loss'}),
    ('cycada', 'configs/da/cycada_pretrain_c2f.py',
     ('gen_s2t.', 'gen_t2s.', 'disc_s.', 'disc_t.'), GAN_KEYS),
)
FWD_FAMILY, BWD_FAMILY = ('roi_align_pyramid_fwd/da_family',
                          'roi_align_pyramid_bwd/da_family')
FWD_CYDA, BWD_CYDA = ('roi_align_pyramid_fwd/cyda_step',
                      'roi_align_pyramid_bwd/cyda_step')
# CyCADA's translation phase never reaches the detector
NO_LAUNCHES = {
    'roi_align_pyramid_fwd': (roi_align.roi_align_pyramid_cuda, 0),
    'roi_align_pyramid_bwd': (roi_align.roi_align_pyramid_bwd_cuda, 0)}
# the GAN branch of the loop: the gate-3 config with the CyDA detector (two
# generator blocks), 16 images a step so that an epoch is 2 steps, 1 epoch
# with eval and a checkpoint, then a resume that trains a second epoch
GAN_LOOP_OPTIONS = [o for o in LOOP_OPTIONS if not o.startswith(
    'runner.max_epochs')] + ['model.type=CyDAFasterRCNN',
                             'model.gen_blocks=2', 'data.samples_per_gpu=16']


def _free():
    gc.collect()
    torch.cuda.empty_cache()


def _cycada_detector_check(trainer, start, label):
    """CyCADA's detector gets no gradient: each trainable detector
    parameter must equal what SGD makes of it from a zero gradient (weight
    decay and momentum alone, replayed here over the same step counts), the
    frozen ones their start. Returns the number of detector parameters."""
    tx_main = trainer.optimizer[0]
    mu, wd = tx_main.spec.momentum, tx_main.spec.weight_decay
    n = 0
    for name, p in trainer.state.params.items():
        if name.startswith(('gen_', 'disc_')):
            continue
        n += 1
        p0 = start[name]
        if not tx_main.trainable[name]:
            if not torch.equal(p.detach(), p0):
                raise RuntimeError(f'{label}: frozen {name} changed')
            continue
        ref, m = p0.double(), torch.zeros_like(p0, dtype=torch.float64)
        for count in range(500, 504):            # 1 warm-up + 3 timed
            m = mu * m + wd * ref
            ref = ref - tx_main.schedule(count) * m
        err = float((p.detach().double() - ref).abs().max())
        if not err <= 1e-6 * max(1.0, float(ref.abs().max())):
            raise RuntimeError(f'{label}: {name} is not weight decay alone '
                               f'({err})')
    return n


def _own_heads_moved(params, start, prefixes, label):
    """The variant's own parameters exist and every one of them moved."""
    own = [n for n in params if any(n.startswith(pre) or pre in n
                                    for pre in prefixes)]
    missing = [pre for pre in prefixes
               if not any(n.startswith(pre) or pre in n for n in own)]
    if missing:
        raise RuntimeError(f'{label}: no parameters {missing}')
    for n in own:
        if torch.equal(params[n].detach(), start[n]):
            raise RuntimeError(f'{label}: {n} did not move')
    return len(own)


def cyda_step_rois_batch(model, batch):
    """`batch` with the images the detector of a CyDA step sees
    (`detector_images`: the source rows translated, the target rows
    raw)."""
    return dict(batch, image=model.detector_images(batch).contiguous())


def step_kernels(model, batch, fwd_name, bwd_name, what):
    """The pair against the plain version on the RoIs that a train step of
    the trained full-width `model` samples from `batch`: forward (timed),
    and backward on a seeded cotangent (timed). Returns both entries."""
    torch.backends.cuda.matmul.allow_tf32 = False
    feats, sampled, gen = sample_step_rois(model, batch, 3)
    rois = sampled.rois
    b, h, w, c = feats.shape
    log(f'da family: {what}: {tuple(rois.shape[:2])} sampled RoIs on the '
        f'{tuple(feats.shape)} map')
    got = dc5_fwd(feats, rois)
    worst = _check(fwd_name, got, roi_align.batched_roi_align_plain(
        feats, rois, 1 / 16, flatten=True), TOL_F32, f'on {what}')
    ms = time_ms(lambda: dc5_fwd(feats, rois), 20)
    plain_ms = time_ms(lambda: roi_align.batched_roi_align_plain(
        feats, rois, 1 / 16, flatten=True), 3, warmup=1)
    nbytes, ops = roi_align_work(rois, h, w, c)
    fwd = _entry(fwd_name, 63, nbytes, ops, max_abs_err=worst, ms=ms,
                 plain_ms=plain_ms)
    log(f'kernels: {fwd_name} f32 {tuple(feats.shape)} x {b}x'
        f'{rois.shape[1]} rois: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound '
        f'{fwd["bound_ms"]:.4f} ms ({fwd["bound_by"]}: {nbytes / 1e6:.1f} '
        f'MB, {ops / 1e9:.2f} GFLOP)')
    grad = torch.randn(got.shape, generator=gen, device='cuda')
    worst = _check(bwd_name, dc5_bwd(grad, rois, tuple(feats.shape)),
                   plain_backward(feats, rois, grad, True), TOL_F32,
                   f'on {what}')
    return [fwd, time_dc5_backward(bwd_name, feats, rois, grad, worst)]


def phase_da_family(card, kernels):
    """Each of the seven configs at full width: 2 requests served, 1
    warm-up and 3 timed train steps, the launches counted, the frozen stem
    and layer1 unchanged, the variant's own heads moved; the pair held on
    a MAF step's RoIs and on a CyDA step's RoIs of translated images."""
    launches = dict(fwd=0, bwd=0, cyda_fwd=0, cyda_bwd=0)
    rows = []
    for label, config, own, keys in DA_FAMILY:
        gan = label in ('cyda', 'cycada')
        stats = {}
        bundle, _, served = _serve(card, config, f'da {label} serving',
                                   SERVING_LAUNCHES, n_requests=2,
                                   stats=stats)
        launches['fwd'] += served['roi_align_pyramid_fwd']
        del bundle
        _free()
        trainer, state, start, times, totals, peak = _train(
            card, config, CITYSCAPES_STEPS, f'da {label} train',
            NO_LAUNCHES if label == 'cycada' else STEP_LAUNCHES, steps=3,
            keys=keys)
        launches['fwd'] += totals['roi_align_pyramid_fwd']
        launches['bwd'] += totals['roi_align_pyramid_bwd']
        params = trainer.state.params
        if (state.ema_params is None) != gan:
            raise RuntimeError(f'{label}: EMA {state.ema_params is not None}'
                               f', expected {not gan}')
        n_own = _own_heads_moved(params, start, own, label)
        if label == 'cycada':
            n_det = _cycada_detector_check(trainer, start, label)
            moved = f'detector ({n_det} parameters) moved by weight decay ' \
                'alone, frozen stem and layer1 unchanged'
        else:
            moved = f'{_moved(params, start, FROZEN, label)} parameters ' \
                'moved, stem and layer1 unchanged'
        log(_train_summary(f'da {label} train', f'R50-DC5 {label} f32',
                           times, peak, totals, card)
            + f'; {moved}; its own {n_own} parameters moved')
        if label == 'maf':
            kernels += step_kernels(trainer.model, demo_batch(), FWD_FAMILY,
                                    BWD_FAMILY, 'a MAF step\'s RoIs')
        elif label == 'cyda':
            launches['cyda_fwd'] = totals['roi_align_pyramid_fwd']
            launches['cyda_bwd'] = totals['roi_align_pyramid_bwd']
            kernels += step_kernels(
                trainer.model, cyda_step_rois_batch(trainer.model,
                                                    demo_batch()),
                FWD_CYDA, BWD_CYDA, 'a CyDA step\'s RoIs of translated '
                'images')
        med = float(np.median(times))
        rows.append(f'{label}: request ms {np.mean(stats["latencies"]):.2f} '
                    f'({[round(t, 2) for t in stats["latencies"]]}), step ms '
                    f'median {med:.2f} (min {min(times):.2f} max '
                    f'{max(times):.2f}), peak {peak / 2**30:.2f} GiB train, '
                    f'{stats["peak"] / 2**30:.2f} GiB serving')
        del trainer, state, start, params
        _free()
    _set_launches(kernels, FWD_FAMILY, launches['fwd'])
    _set_launches(kernels, BWD_FAMILY, launches['bwd'])
    _set_launches(kernels, FWD_CYDA, launches['cyda_fwd'])
    _set_launches(kernels, BWD_CYDA, launches['cyda_bwd'])
    for row in rows:
        log(f'da family summary: {row} [{card}]')


def phase_gan_loop(card):
    """The loop's GAN branch through the command line: 1 epoch of 2 steps
    of CyDA (16 images a step, two generator blocks) with eval and a
    checkpoint, then a resume from it for a second epoch; the restored
    state (parameters, buffers, both optimizers' momentum and count) must
    equal the saved one bit for bit. Empties build/loop/ afterwards."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    argv = [SYNTH, '--work-dir', LOOP_DIR, '--cfg-options',
            *GAN_LOOP_OPTIONS]
    cfg = DA_train.load_config(DA_train.parse_args(argv))
    eval_batches = -(-len(build_dataset(cfg.data['val'])) // 16)
    _, fwd, bwd, seconds = _run_cli(argv + ['runner.max_epochs=1'], 2,
                                    eval_batches)
    recs = _check_log(f'{LOOP_DIR}/train_log.jsonl', [1])
    if not all(GAN_KEYS <= set(r) for r in recs if r['mode'] == 'train'):
        raise RuntimeError(f'gan loop: records {recs}')
    saved = ckpt_io.load_checkpoint(f'{LOOP_DIR}/ckpt_1', 'cuda')
    if saved['ema_params'] is not None or not any(
            n.startswith('disc_t.') for n in saved['momentum']):
        raise RuntimeError('gan loop: the checkpoint holds an EMA or no '
                           'discriminator momentum')
    restored = []
    original = train_api.restore_train_state

    def spy(model, state, ckpt):
        state = original(model, state, ckpt)
        if not isinstance(state.opt_state, tuple) or \
                len(state.opt_state) != 2:
            raise RuntimeError('gan loop: resumed without two optimizers')
        restored.append({k: v.clone() if torch.is_tensor(v) else
                         ({n: t.clone() for n, t in v.items()}
                          if isinstance(v, dict) else v)
                         for k, v in ckpt_io.train_state_dict(
                             model, state).items()})
        return state
    train_api.restore_train_state = spy
    try:
        _run_cli(argv + ['runner.max_epochs=2', '--resume-from',
                         f'{LOOP_DIR}/ckpt_1'], 2, eval_batches)
    finally:
        train_api.restore_train_state = original
    _same_payload(restored[0], saved, 'gan resume')
    log(f'gan loop: DA_train CyDA (2 generator blocks) 1 epoch x 2 steps of '
        f'16 images 128x192 in {seconds:.2f} s with eval and a checkpoint; '
        f'launches fwd {fwd} bwd {bwd}; resumed from ckpt_1 at step '
        f'{saved["step"]}: params, buffers, both optimizers\' momentum '
        f'({len(saved["momentum"])} tensors) and count equal to the saved '
        f'ones, bit for bit; records {recs} [{card}]')
    shutil.rmtree(LOOP_DIR)


def phase_da_family_reference():
    """A tiny R18 counterpart of each of the seven configs (the tiny
    fixture's 64x96 canvas, CyDA and CyCADA with two generator blocks):
    one train step on the card against the CPU, TF32 off."""
    for label, config, _, _ in DA_FAMILY:
        cfg = Config.fromfile(TINY)
        det_type = Config.fromfile(config).model['type']
        cfg.merge_from_dict({'model.type': det_type})
        if label in ('cyda', 'cycada'):
            cfg.merge_from_dict({'model.gen_blocks': 2})
        phase_reference_train(cfg, f'tiny {label} (R18)')


# ---- the bf16 compute path -------------------------------------------------

BF16 = {'model.dtype': 'bfloat16'}
FPN_FP16 = 'configs/faster_rcnn/faster_rcnn_r50_fpn_fp16_1x.py'
MASK_FP16 = 'configs/mask_rcnn/mask_rcnn_r50_fpn_fp16_1x.py'
TRI = 'configs/da/faster_rcnn_r50_tri_c2f.py'
CYDA = 'configs/da/faster_rcnn_r50_cyda_c2f.py'
# the pair's in-model bf16 regimes: (forward entry, backward entry, lines
# of the JAX kernels they replace), each held and timed on the RoIs a
# trained bf16 step samples
BF16_REGIMES = {
    'dc5': ('roi_align_pyramid_fwd/dc5_bf16_step',
            'roi_align_pyramid_bwd/dc5_bf16_step', 237, 303),
    'fpn': ('roi_align_pyramid_fwd/fpn_bf16_step',
            'roi_align_pyramid_bwd/fpn_bf16_step', 1181, 1121),
    'mask': ('roi_align_pyramid_fwd/mask_bf16_step',
             'roi_align_pyramid_bwd/mask_bf16_step', 944, 889),
    'c4': ('roi_align_pyramid_fwd/c4_bf16_step',
           'roi_align_pyramid_bwd/c4_bf16_step', 434, 487),
}
# bench.py's protocol: the flagship train step on 8 images of 512x1024
BENCH_BATCH = 8


def _all_f32(label, state):
    """Parameters, gradients, momentum (both groups of a GAN step) and EMA
    are f32; raises otherwise. Returns how many tensors were checked."""
    opt = state.opt_state if not hasattr(state.opt_state, 'momentum') \
        else (state.opt_state,)
    groups = dict(
        parameter=list(state.params.values()),
        gradient=[p.grad for p in state.params.values()
                  if p.grad is not None],
        momentum=[m for o in opt for m in o.momentum.values()],
        EMA=list((state.ema_params or {}).values()))
    for what, tensors in groups.items():
        for t in tensors:
            if t.dtype != torch.float32:
                raise RuntimeError(f'{label}: a {what} in {t.dtype}')
    return sum(len(t) for t in groups.values())


def _compute_types(label, model, batch):
    """The trunk (and neck) answer in bf16, the DA heads (on the bf16
    taps) and the CycleGAN in f32; raises otherwise. Runs the model in eval
    mode, so no statistic moves."""
    model.eval()
    try:
        with torch.no_grad():
            feats = model.extract_feat(batch['image'])
            feats = feats if isinstance(feats, tuple) else (feats,)
            heads = {}
            if hasattr(model.backbone, 'taps'):
                _, heads = model.backbone(
                    batch['image'].to(model.dtype).permute(0, 3, 1, 2))
            gan = model.translate(batch) if hasattr(model, 'translate') \
                else None
    finally:
        model.train()
    types = {f.dtype for f in feats}
    if model.dtype != torch.bfloat16 or types != {torch.bfloat16}:
        raise RuntimeError(f'{label}: model {model.dtype}, features {types}')
    if any(v.dtype != torch.float32 for v in heads.values()) or (
            gan is not None and gan.dtype != torch.float32):
        raise RuntimeError(f'{label}: a DA head or the CycleGAN not in f32')
    return (f'features {len(feats)} x bf16, {len(heads)} DA heads f32'
            + (', CycleGAN f32' if gan is not None else ''))


def pair_step_kernels(regime, model, batch, names=None,
                      dtype=torch.bfloat16):
    """The pair at `dtype` (bf16 by default) against its plain version on
    the RoIs that a step of the trained `model` samples from `batch`, on
    its own maps: forward and backward (a seeded cotangent in `dtype`)
    within TOL_BF16 (TOL_F32 at f32), then both timed beside the plain
    version. `regime` gives the geometry: 'dc5' one level at stride 16,
    o=7; 'c4' one level, o=14; 'fpn' four levels, o=7; 'mask' four levels,
    o=14. `names` are (forward entry, backward entry, lines of the JAX
    kernels they replace), by default the bf16 regime's. Bytes at the
    element size, 4 for the backward's f32 buffer. Returns the two
    entries."""
    fwd_name, bwd_name, fwd_line, bwd_line = names or BF16_REGIMES[regime]
    maps, sampled, gen = sample_step_rois(model, batch, 3)
    rois = sampled.rois
    one = regime in ('dc5', 'c4')
    maps = [maps] if one else list(maps)
    if any(m.dtype != dtype for m in maps):
        raise RuntimeError(f'{regime}: RoIAlign maps not in {dtype}')
    tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
    elem = torch.finfo(dtype).bits // 8
    levels = None if one else roi_align.roi_levels(rois, 4).contiguous()
    scales = (1 / 16,) if one else FPN_SCALES
    out_size = 14 if regime in ('mask', 'c4') else 7
    flatten = regime in ('dc5', 'fpn')
    shapes = [tuple(m.shape) for m in maps]

    def fwd():
        return roi_align.roi_align_pyramid_cuda(maps, rois, levels, scales,
                                                out_size, flatten=flatten)

    def plain(fs):
        if one:
            return roi_align.batched_roi_align_plain(
                fs[0], rois, 1 / 16, out_size, flatten=flatten)
        return roi_align.batched_roi_align_fpn_plain(
            fs, rois, out_size=out_size, flatten=flatten)

    got = fwd()
    what = f"{str(dtype)[6:]} on a step's {tuple(rois.shape[:2])} sampled " \
        'RoIs'
    err_f = _check(fwd_name, got, plain(maps), tol, what)
    grad = torch.randn(got.shape, generator=gen, device='cuda').to(dtype)

    def bwd():
        return roi_align.roi_align_pyramid_bwd_cuda(
            grad, rois, levels, shapes, scales, out_size, flatten=flatten)

    fs = [m.detach().requires_grad_() for m in maps]
    ref = torch.autograd.grad(plain(fs), fs, grad)
    err_b = max(_check(bwd_name, g, r, tol, f'{what}, level {i}')
                for i, (g, r) in enumerate(zip(bwd(), ref)))
    ms_f, ms_b = time_ms(fwd, 20), time_ms(bwd, 20)
    plain_f = time_ms(lambda: plain(maps), 3, warmup=1)
    plain_b = plain_backward_ms(plain, maps, grad)
    sizes, c = [s[1:3] for s in shapes], shapes[0][3]
    if one:
        work_f = roi_align_work(rois, *sizes[0], c, out_size, elem=elem)
        work_b = roi_align_work(rois, *sizes[0], c, out_size, backward=True,
                                elem=elem)
    else:
        work_f = roi_align_fpn_work(rois, levels, sizes, c, out_size,
                                    elem=elem)
        work_b = roi_align_fpn_work(rois, levels, sizes, c, out_size,
                                    backward=True, elem=elem)
    entries = [_entry(fwd_name, fwd_line, *work_f, max_abs_err=err_f,
                      ms=ms_f, plain_ms=plain_f),
               _entry(bwd_name, bwd_line, *work_b, max_abs_err=err_b,
                      ms=ms_b, plain_ms=plain_b)]
    for e, (nbytes, ops) in zip(entries, (work_f, work_b)):
        log(f'kernels: {e["name"]} {str(dtype)[6:]} {shapes} C={c} '
            f'o={out_size} x '
            f'{rois.shape[0]}x{rois.shape[1]} rois: {e["ms"]:.4f} ms, '
            f'plain {e["plain_ms"]:.4f} ms, bound {e["bound_ms"]:.4f} ms '
            f'({e["bound_by"]}: {nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} '
            'GFLOP)')
    return entries


def _bf16_served_features(label, bundle, request, regime):
    """The pair's bf16 RoI features against the plain version on the real
    proposals of `request`."""
    name = BF16_REGIMES[regime][0]
    with torch.inference_mode():
        batch, _ = prepare_batch(bundle, request)
        model = bundle.model
        feats = model.extract_feat(batch['image'])
        proposals, _, valid = rpn_proposals(
            *model.rpn_outputs(feats), batch['img_shape'], model.rpn_test_cfg)
        maps = model.roi_maps(feats)
        if regime == 'dc5':
            got = dc5_fwd(maps, proposals)
            ref = roi_align.batched_roi_align_plain(maps, proposals, 1 / 16,
                                                    flatten=True)
        else:
            got = fpn_fwd(maps, proposals, roi_align.roi_levels(proposals, 4))
            ref = roi_align.batched_roi_align_fpn_plain(maps, proposals,
                                                        flatten=True)
    if got.dtype != torch.bfloat16:
        raise RuntimeError(f'{label}: RoI features in {got.dtype}')
    _check(name, got, ref, TOL_BF16, f"bf16 on the last request's "
           f'{int(valid.sum())} proposals')


def phase_bf16(card, kernels):
    """The bf16 compute path at full width: the flagship (model.dtype=
    bfloat16) and the R50-FPN fp16 config (model.dtype=bfloat16) serve 4
    requests each; the flagship, the FPN and Mask R-CNN FPN fp16 configs
    (through their `fp16` blocks), Mask R-CNN C4, Tri-attention and CyDA
    train (model.dtype=bfloat16 where no fp16 block). Launch counts, finite
    losses, parameters moved and f32 state as the f32 phases check them;
    the trunk in bf16, the DA heads and the CycleGAN in f32. The pair at
    bf16 on each regime's trained step's RoIs (and on the served
    proposals); then bench.py's protocol, batch 8, f32 against bf16."""
    launches = {r: [0, 0] for r in BF16_REGIMES}
    rows = []
    # the FPN fp16 config's 80-class head scores every class ~1/81 with
    # random weights, under its score_thr of 0.05: served at 0.001, as C4
    for label, config, over, regime in (
            ('bf16 serving', FLAGSHIP, BF16, 'dc5'),
            ('bf16 fpn serving', FPN_FP16, dict(BF16, **C4_SERVING), 'fpn')):
        stats = {}
        bundle, requests, served = _serve(card, config, label,
                                          SERVING_LAUNCHES, overrides=over,
                                          stats=stats)
        if not stats['dets']:
            raise RuntimeError(f'{label}: no detection in any request')
        launches[regime][0] += served['roi_align_pyramid_fwd']
        _bf16_served_features(label, bundle, requests[-1], regime)
        rows.append(f'{label} {config}: request ms mean '
                    f'{np.mean(stats["latencies"]):.2f} '
                    f'{[round(t, 2) for t in stats["latencies"]]}, peak '
                    f'{stats["peak"] / 2**30:.2f} GiB')
        del bundle
        _free()
    runs = (
        ('bf16 train', FLAGSHIP, BF16, CITYSCAPES_STEPS, 'dc5', demo_batch,
         5, STEP_LAUNCHES, FROZEN),
        ('bf16 fpn train (fp16 block)', FPN_FP16, {}, COCO_STEPS, 'fpn',
         demo_batch, 3, STEP_LAUNCHES, FPN_FROZEN),
        ('bf16 mask train (fp16 block)', MASK_FP16, {}, COCO_STEPS, 'mask',
         mask_batch, 3, MASK_STEP_LAUNCHES, FPN_FROZEN),
        ('bf16 c4 train', C4, BF16, COCO_STEPS, 'c4',
         lambda: demo_batch(mask_size=MASK_M), 2, C4_STEP_LAUNCHES,
         FPN_FROZEN),
        # 3 steps: Tri's background instance head gets its first gradient
        # once the box classifier calls some RoIs background (step 3 here)
        ('bf16 tri train', TRI, BF16, CITYSCAPES_STEPS, 'dc5', demo_batch,
         3, STEP_LAUNCHES, FROZEN),
        ('bf16 cyda train', CYDA, BF16, CITYSCAPES_STEPS, 'dc5', demo_batch,
         2, STEP_LAUNCHES, FROZEN))
    held = set()
    for label, config, over, spe, regime, make_batch, steps, counters, \
            frozen in runs:
        batch = make_batch()
        trainer, state, start, times, totals, peak = _train(
            card, config, spe, label, counters, batch, steps=steps,
            overrides=over)
        launches[regime][0] += totals['roi_align_pyramid_fwd']
        launches[regime][1] += totals['roi_align_pyramid_bwd']
        moved = _moved(trainer.state.params, start, frozen, label)
        n_f32 = _all_f32(label, state)
        types = _compute_types(label, trainer.model, batch)
        log(_train_summary(label, f'{config} bf16', times, peak, totals,
                           card)
            + f'; {moved} parameters moved, frozen ones unchanged; {n_f32} '
            f'parameter, gradient, momentum and EMA tensors f32; {types}')
        rows.append(f'{label} {config}: step ms median '
                    f'{float(np.median(times)):.2f} (min {min(times):.2f} '
                    f'max {max(times):.2f}), peak {peak / 2**30:.2f} GiB')
        if regime not in held:
            kb = fpn_level_batch() if regime == 'fpn' else batch
            kernels += pair_step_kernels(regime, trainer.model, kb)
            held.add(regime)
        del trainer, state, start
        _free()
    for label, over in (('bench f32', {}), ('bench bf16', BF16)):
        trainer, state, start, times, totals, peak = _train(
            card, FLAGSHIP, CITYSCAPES_STEPS, label, STEP_LAUNCHES,
            demo_batch(b=BENCH_BATCH), steps=3, overrides=over)
        if over:
            launches['dc5'][0] += totals['roi_align_pyramid_fwd']
            launches['dc5'][1] += totals['roi_align_pyramid_bwd']
        med = float(np.median(times))
        rows.append(f'{label}: {BENCH_BATCH} images 512x1024 a step, step '
                    f'ms {[round(t, 2) for t in times]} median {med:.2f}, '
                    f'{BENCH_BATCH * 1e3 / med:.2f} img/s, peak '
                    f'{peak / 2**30:.2f} GiB')
        del trainer, state, start
        _free()
    for regime, (fwd_name, bwd_name, _, _) in BF16_REGIMES.items():
        _set_launches(kernels, fwd_name, launches[regime][0])
        _set_launches(kernels, bwd_name, launches[regime][1])
    for row in rows:
        log(f'bf16 summary: {row} [{card}]')


@contextlib.contextmanager
def _pinned_proposals(fixed):
    """The detectors' steps take `fixed` (proposals, scores, valid) in
    place of their own, moved to the step's device: at bf16 the tiny RPN's
    logits tie or sit an ulp apart by the hundred, and card and CPU round
    their convolutions differently, so their own rankings would differ."""
    saved = [(m, m.rpn_proposals) for m in (frcnn_mod, frcnn_fpn_mod)]
    for m, _ in saved:
        m.rpn_proposals = lambda cls, *a, **k: tuple(
            t.to(cls.device) for t in fixed)
    try:
        yield
    finally:
        for m, fn in saved:
            m.rpn_proposals = fn


def phase_bf16_reference():
    """The tiny DC5 fixture and the tiny FPN at bf16, card (cuDNN, cuBLAS
    with f32 accumulation, the pair) against the CPU (plain versions) from
    the same weights: trunk features, RPN logits and box logits on seeded
    RoIs within TOL_BF16 of their scale; one train step (dropout off, the
    same sampler priorities and proposals) with per-term losses within
    TOL_BF16 relative."""
    gen = torch.Generator(device='cuda').manual_seed(11)
    for label, cfg, hw, anchors, seed in (
            ('tiny fixture bf16', _tiny_cfg(TINY, BF16), (64, 96),
             6 * 4 * 6, 3),
            ('tiny FPN bf16', _tiny_cfg(FPN, dict(FPN_TINY, **BF16)),
             (128, 192), 3 * sum(-(-128 // st) * -(-192 // st)
                                 for st in (4, 8, 16, 32, 64)),
             FPN_TINY_SEED)):
        cfg.merge_from_dict({'optimizer.lr': 0.002,
                             'lr_config.warmup_ratio': 0.5})
        fpn = cfg.model['type'] == 'FasterRCNNFPN'
        models, outs = [], []
        batch = demo_batch(2, *hw, g=6, num_classes=2, seed=4, device='cpu')
        rois = (make_fpn_rois(gen, 2, 48, *hw) if fpn else
                make_rois(gen, 2, 48, hw[0] // 16, hw[1] // 16)).cpu()
        for device in ('cpu', 'cuda'):
            model = init_detector(cfg, device='cpu', seed=seed).model
            model = model.to(device)
            models.append(model)
            with torch.no_grad():
                img = batch['image'].to(device)
                feats = model.extract_feat(img)
                cls, _, _ = model.rpn_outputs(feats)
                box = model.bbox_head(model.roi_extract(
                    model.roi_maps(feats), rois.to(device)))[0]
            feats = feats if isinstance(feats, tuple) else (feats,)
            if torch.backends.cuda.matmul.\
                    allow_bf16_reduced_precision_reduction:
                raise RuntimeError('a bf16 detector left cuBLAS '
                                   'reduced-precision reductions on')
            outs.append(dict(features=torch.cat(
                [f.float().flatten() for f in feats]).cpu(),
                rpn_logits=cls.float().cpu(), box_logits=box.float().cpu()))
        for key in outs[0]:
            _check(label, outs[1][key], outs[0][key], TOL_BF16,
                   f'{key} card vs CPU')
        trainers = [init_trainer(cfg, device=d, seed=seed, steps_per_epoch=1)
                    for d in ('cpu', 'cuda')]
        trainers[1].model.load_state_dict(trainers[0].model.state_dict())
        cpu_model = trainers[0].model
        with torch.no_grad():
            fixed = rpn_proposals(
                *cpu_model.rpn_outputs(cpu_model.extract_feat(
                    batch['image'])), batch['img_shape'],
                cpu_model.rpn_proposal_cfg)
        g = torch.Generator().manual_seed(5)
        pri = dict(rpn=torch.rand(2, anchors, generator=g),
                   rcnn=torch.rand(2, 6 + fixed[0].shape[1], generator=g))
        losses = []
        with _pinned_proposals(fixed):
            for trainer in trainers:
                for m in trainer.model.modules():
                    if isinstance(m, torch.nn.Dropout):
                        m.p = 0.0
                dev = trainer.device
                _, metrics = trainer.step(
                    trainer.state, {k: v.to(dev) for k, v in batch.items()},
                    sampler_priorities={k: v.to(dev) for k, v in pri.items()})
                losses.append({k: float(v) for k, v in metrics.items()})
        ref, got = losses
        rel = max(abs(got[k] - v) / max(abs(v), 1e-6) for k, v in ref.items())
        log(f'reference: {label} train step card vs CPU: losses '
            f'{ {k: round(v, 5) for k, v in got.items()} }, worst relative '
            f'loss difference {rel:.3e}')
        if set(got) != set(ref) or not rel <= TOL_BF16:
            raise RuntimeError(f'{label}: train step card vs CPU, losses '
                               f'{rel}')


# ---- the Swin slice: DeepAlign-Swin and Mask R-CNN Swin-T, AdamW ----------

DA_SWIN = 'configs/da/deepalign_swin_t_c2f.py'
MASK_SWIN = 'configs/swin/mask_rcnn_swin-t-p4-w7_fpn_1x.py'
MASK_SWIN_BF16 = 'configs/swin/mask_rcnn_swin-t-p4-w7_fpn_fp16_ms-crop-3x.py'
SYNTH_SWIN = 'configs/da/synth_swin_deepalign.py'
# the COCO configs' serving and training canvas
COCO_CANVAS = (800, 1344)
# their serving: `init_detector` takes the canvas only from a
# MultiScaleFlipAug test step, which the COCO test pipeline lacks (it would
# serve on 608x1024), so one is given at the pipeline's own Resize scale;
# random weights score each of the 80 classes ~1/81, so they serve at
# score_thr 0.001, as C4, to reach the mask branch
COCO_SERVING = {'data.test.pipeline': [dict(type='MultiScaleFlipAug',
                                            img_scale=(1333, 800))],
                'model.roi_test_cfg': dict(score_thr=0.001)}
# the pair's Swin regimes: (geometry, dtype) → (forward entry, backward
# entry, lines of the JAX kernels they replace)
SWIN_REGIMES = {
    ('dc5', torch.float32): ('roi_align_pyramid_fwd/swin_dc16_step',
                             'roi_align_pyramid_bwd/swin_dc16_step', 63, 303),
    ('dc5', torch.bfloat16): ('roi_align_pyramid_fwd/swin_dc16_bf16_step',
                              'roi_align_pyramid_bwd/swin_dc16_bf16_step',
                              237, 303),
    ('fpn', torch.float32): ('roi_align_pyramid_fwd/swin_fpn_step',
                             'roi_align_pyramid_bwd/swin_fpn_step', 944, 889),
    ('fpn', torch.bfloat16): ('roi_align_pyramid_fwd/swin_fpn_bf16_step',
                              'roi_align_pyramid_bwd/swin_fpn_bf16_step',
                              1181, 1121),
    ('mask', torch.float32): ('roi_align_pyramid_fwd/swin_mask_step',
                              'roi_align_pyramid_bwd/swin_mask_step', 944,
                              889),
    ('mask', torch.bfloat16): ('roi_align_pyramid_fwd/swin_mask_bf16_step',
                               'roi_align_pyramid_bwd/swin_mask_bf16_step',
                               944, 889),
}
# the tiny Swin of the card-vs-CPU reference (embed 16, depths 2/2/2/2) in
# the tiny Mask R-CNN, trained with AdamW; the weight seed is one whose top
# 65 RPN logits lie >= 2.2e-5 apart on the reference images and on the
# train batch (a CPU count)
SWIN_TINY = {'model.backbone_cfg': dict(type='SwinTransformer', embed_dims=16,
                                        depths=(2, 2, 2, 2),
                                        num_heads=(1, 2, 2, 4)),
             'optimizer': dict(type='AdamW', lr=1e-4, weight_decay=0.05)}
SWIN_TINY_SEED = 41
# its one reference step: Adam's first update is ±lr on every element whose
# gradient lies within rounding of zero, with a sign card and CPU set
# independently; at this lr (2e-5, 1e-5 after the warmup ratio) those
# elements stay within the 1e-4 parameter tolerance, which therefore holds
# the update rule only; the moments hold the gradients
SWIN_TINY_LR = 2e-5


def _swin_trunk_checks(label, trainer, state, trunk):
    """AdamW's state: both moments, none for the patch embed (the trunk
    detaches its map after stage 0, `frozen_stages=1`), both for stage 1;
    no parameter frozen (the frozen mask matches no Swin name). Returns
    the paramwise groups' sizes."""
    opt = state.opt_state
    if trainer.spec.opt_type != 'adamw' or not hasattr(opt, 'nu'):
        raise RuntimeError(f'{label}: optimizer {trainer.spec.opt_type}')
    if not all(trainer.optimizer.trainable.values()):
        raise RuntimeError(f'{label}: a Swin parameter frozen')
    if opt.nu[f'{trunk}.patch_embed.weight'].any() or \
            not opt.nu[f'{trunk}.stage1.block0.mlp_fc1.weight'].any():
        raise RuntimeError(f'{label}: the stop-gradient after stage 0 '
                           'does not show in the second moment')
    return {k: len(v) for k, v in trainer.optimizer.groups.items()}


def _adamw_moved(params, start, state, tx, label):
    """The number of parameters that moved; raises unless every one did
    but those that AdamW leaves as they are: without a gradient (both
    moments 0, behind the trunk's stop-gradient) and either all zero at
    the start (a decoupled decay of 0 is 0) or in a paramwise group with
    no decay (the norms under the Swin configs' `paramwise_cfg`)."""
    decay = {n: wd for (_, wd), names in tx.groups.items() for n in names}
    moved = 0
    for n, p in params.items():
        if not torch.equal(p.detach(), start[n]):
            moved += 1
        elif (start[n].any() and decay[n]) \
                or state.opt_state.momentum[n].any() \
                or state.opt_state.nu[n].any():
            raise RuntimeError(f'{label}: {n} unchanged after the steps')
    return moved


class SwinRun(NamedTuple):
    """One config of `phase_swin`: how it serves and trains, what its
    steps log and which of the pair's regimes it runs."""
    label: str
    config: str
    overrides: dict
    canvas: Tuple[int, int]
    serving: dict              # launches a request, as SERVING_LAUNCHES
    steps_per_epoch: int
    counters: dict             # launches a step, as STEP_LAUNCHES
    make_batch: Callable       # the train batch
    kernel_batch: Callable     # the batch the pair is held on
    keys: set                  # the loss terms of a step
    regimes: Tuple[str, ...]   # keys of SWIN_REGIMES
    trunk: str                 # the trunk's module path


def _coco_batch():
    return demo_batch(h=COCO_CANVAS[0], w=COCO_CANVAS[1], mask_size=MASK_M)


def phase_swin(card, kernels):
    """DeepAlign-Swin (f32 and bf16) and the two Mask R-CNN Swin-T configs
    (1x in f32, the fp16 ms-crop config in bf16 with paramwise AdamW) at
    full width: 2 requests served, 1 warm-up and 3 timed AdamW steps, the
    launches counted, the parameters moved (`_adamw_moved`), the pair held
    and timed on each run's step RoIs. A Mask Swin run's two regimes (o=7
    box and o=14 mask features) share one count: the pair's launches on
    that path, box, mask and mask targets together."""
    da = dict(canvas=(608, 1024), serving=SERVING_LAUNCHES,
              steps_per_epoch=CITYSCAPES_STEPS, counters=STEP_LAUNCHES,
              make_batch=demo_batch, kernel_batch=demo_batch,
              keys=DET_KEYS | TAP_KEYS, regimes=('dc5',),
              trunk='backbone.trunk')
    coco = dict(canvas=COCO_CANVAS, serving=MASK_SERVING_LAUNCHES,
                steps_per_epoch=COCO_STEPS, counters=MASK_STEP_LAUNCHES,
                make_batch=_coco_batch,
                kernel_batch=lambda: mask_batch(COCO_CANVAS),
                keys=DET_KEYS | {'loss_mask'}, regimes=('fpn', 'mask'),
                trunk='backbone')
    runs = (SwinRun('swin da', DA_SWIN, {}, **da),
            SwinRun('swin da bf16', DA_SWIN, BF16, **da),
            SwinRun('swin mask', MASK_SWIN, {}, **coco),
            SwinRun('swin mask bf16 paramwise', MASK_SWIN_BF16, {}, **coco))
    launches = {}
    rows = []
    for run in runs:
        label, config, over, regimes = run.label, run.config, \
            run.overrides, run.regimes
        mask = 'mask' in regimes
        stats = {}
        bundle, requests, served = _serve(
            card, config, f'{label} serving', run.serving,
            overrides=dict(over, **(COCO_SERVING if mask else {})),
            n_requests=2, stats=stats, canvas=run.canvas)
        dtype = bundle.model.dtype
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        names = [SWIN_REGIMES[(r, dtype)] for r in regimes]
        for fwd_name, _, _, _ in names:
            launches[fwd_name] = served['roi_align_pyramid_fwd']
        if mask:
            if not stats['dets']:
                raise RuntimeError(f'{label}: no detection in any request')
            _served_mask_features(f'{label} serving', bundle, requests[-1],
                                  names[-1][0], tol)
        del bundle
        _free()
        trainer, state, start, times, totals, peak = _train(
            card, config, run.steps_per_epoch, f'{label} train', run.counters,
            run.make_batch(), steps=3, keys=run.keys, overrides=over)
        if trainer.model.dtype != dtype:
            raise RuntimeError(f'{label}: trained in {trainer.model.dtype}, '
                               f'served in {dtype}')
        for fwd_name, bwd_name, _, _ in names:
            launches[fwd_name] += totals['roi_align_pyramid_fwd']
            launches[bwd_name] = totals['roi_align_pyramid_bwd']
        moved = _adamw_moved(trainer.state.params, start, state,
                             trainer.optimizer, label)
        groups = _swin_trunk_checks(label, trainer, state, run.trunk)
        extra = ''
        if dtype == torch.bfloat16:
            extra = f'; {_all_f32(label, state)} parameter, gradient, ' \
                f'moment and EMA tensors f32; ' \
                f'{_compute_types(label, trainer.model, run.make_batch())}'
        log(_train_summary(f'{label} train', f'{config} '
                           f'{str(dtype)[6:]}', times, peak, totals, card,
                           '2 images 800x1344' if mask else
                           '2 images 512x1024')
            + f'; {moved} of {len(start)} parameters moved (the rest without '
            'a gradient and zero or undecayed); AdamW groups (lr_mult, '
            f'decay_mult): sizes {groups}{extra}')
        if mask and len(groups) != (2 if 'paramwise' in label else 1):
            raise RuntimeError(f'{label}: paramwise groups {groups}')
        batch = run.kernel_batch()
        for regime, regime_names in zip(regimes, names):
            kernels += pair_step_kernels(regime, trainer.model, batch,
                                         regime_names, dtype)
        if mask and dtype == torch.float32:
            _, sampled, _ = sample_step_rois(trainer.model, batch, 3)
            _targets_on_sampled_rois(label, batch, sampled, 28)
        rows.append(f'{label} {config}: request ms mean '
                    f'{np.mean(stats["latencies"]):.2f} '
                    f'{[round(t, 2) for t in stats["latencies"]]}, serving '
                    f'peak {stats["peak"] / 2**30:.2f} GiB; step ms median '
                    f'{float(np.median(times)):.2f} (min {min(times):.2f} '
                    f'max {max(times):.2f}), train peak '
                    f'{peak / 2**30:.2f} GiB')
        del trainer, state, start
        _free()
    for name, n in launches.items():
        _set_launches(kernels, name, n)
    for row in rows:
        log(f'swin summary: {row} [{card}]')


def phase_swin_loop(card):
    """configs/da/synth_swin_deepalign.py through `tools.DA_train` on the
    committed synth subset: 2 epochs of 4 AdamW steps with eval and a
    checkpoint each, then a resume from ckpt_1 whose restored state
    (parameters, buffers, both Adam moments and the count, EMA, step)
    equals the saved one bit for bit. Empties build/loop/ afterwards."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    argv = [SYNTH_SWIN, '--work-dir', LOOP_DIR, '--cfg-options',
            *LOOP_OPTIONS]
    cfg = DA_train.load_config(DA_train.parse_args(argv))
    eval_batches = -(-len(build_dataset(cfg.data['val'])) // 8)
    metrics, fwd, bwd, seconds = _run_cli(argv, 8, 2 * eval_batches)
    recs = _check_log(f'{LOOP_DIR}/train_log.jsonl', [1, 2])
    saved = ckpt_io.load_checkpoint(f'{LOOP_DIR}/ckpt_1', 'cuda')
    if saved['nu'] is None or saved['ema_params'] is None or \
            not any(n.startswith('backbone.trunk.stage') for n in saved['nu']):
        raise RuntimeError('swin loop: the checkpoint lacks the Adam '
                           'moments or the EMA')
    restored = []
    original = train_api.restore_train_state

    def spy(model, state, ckpt):
        state = original(model, state, ckpt)
        restored.append({k: v.clone() if torch.is_tensor(v) else
                         ({n: t.clone() for n, t in v.items()}
                          if isinstance(v, dict) else v)
                         for k, v in ckpt_io.train_state_dict(
                             model, state).items()})
        return state
    train_api.restore_train_state = spy
    try:
        _run_cli(argv + ['--resume-from', f'{LOOP_DIR}/ckpt_1'], 4,
                 eval_batches)
    finally:
        train_api.restore_train_state = original
    _same_payload(restored[0], saved, 'swin resume')
    log(f'swin loop: DA_train DeepAlign-Swin (Swin-T, AdamW, clip 35, EMA '
        f'0.999) 2 epochs x 4 steps of 8 images 128x192 in {seconds:.2f} s '
        f'with 2 evals and 2 checkpoints; launches fwd {fwd} bwd {bwd}; '
        f'resumed from ckpt_1 at step {saved["step"]}: params, buffers, both '
        f'Adam moments ({len(saved["nu"])} tensors each), count, EMA and '
        f'step equal to the saved ones, bit for bit; records {recs}; final '
        f'{metrics} [{card}]')
    shutil.rmtree(LOOP_DIR)


def phase_swin_reference():
    """A tiny Swin Mask R-CNN (configs/da/synth_mask_smoke.py with
    `backbone_cfg` a Swin of embed 16, depths 2/2/2/2; AdamW): card vs CPU,
    inference (detections within 1e-3, masks within 1e-4) and one AdamW
    step (losses 1e-4 relative, parameters 1e-4 of scale, both moments,
    hence the gradients, 1e-4 of the whole moment's scale), launching the
    pair."""
    label = 'tiny Swin Mask R-CNN'
    over = dict(FEW_PROPOSALS, **SWIN_TINY)
    before = FWD.launches, BWD.launches
    phase_reference(_tiny_cfg(MASK_TINY, over), label, (100, 150),
                    SWIN_TINY_SEED)
    phase_reference_train(_tiny_cfg(MASK_TINY, over), label, (128, 192),
                          3 * sum(-(-128 // st) * -(-192 // st)
                                  for st in (4, 8, 16, 32, 64)), 32,
                          SWIN_TINY_SEED, mask_size=MASK_M, lr=SWIN_TINY_LR)
    got = (FWD.launches - before[0], BWD.launches - before[1])
    if got != (7, 2):
        raise RuntimeError(f'{label} on the card launched the pair {got} '
                           'times, expected (7, 2)')


def main():
    card = phase_device()
    phase_build()
    kernels = phase_kernels() + phase_fpn_kernels()
    phase_main_path(card, kernels)
    phase_train(card, kernels)
    phase_fpn_serving(card, kernels)
    phase_fpn_train(card, kernels)
    phase_reference()
    phase_reference_train()
    phase_fpn_reference()
    kernels += phase_mask_kernels()
    phase_mask_serving(card, kernels)
    phase_mask_train(card, kernels)
    phase_c4_serving(card, kernels)
    phase_c4_train(card, kernels)
    phase_mask_reference()
    phase_loop(card, kernels)
    phase_da_family(card, kernels)
    phase_gan_loop(card)
    phase_da_family_reference()
    phase_bf16(card, kernels)
    phase_bf16_reference()
    phase_swin(card, kernels)
    phase_swin_loop(card)
    phase_swin_reference()
    for k in kernels:
        if not k['launches']:
            raise RuntimeError(f'{k["name"]} was not launched on its path')
        for key, v in k.items():
            if isinstance(v, float) and not math.isfinite(v):
                raise RuntimeError(f'{k["name"]}.{key} = {v}')
    log(card)
    log(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    sys.exit(main())
