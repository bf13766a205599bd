"""Inference API (counterpart of the JAX package's `apis/inference.py`).

`init_detector(config, variables=None, device='cuda')` → bundle;
`inference_detector(bundle, imgs)` → per image, a `list[num_classes]` of
(n, 5) [x1, y1, x2, y2, score] float32 arrays in original image
coordinates — the JAX package's return format.

Weights: `checkpoint` names a port checkpoint directory (`ckpt_<tag>`,
`utils/checkpoint.py`; its EMA parameters when it holds them, as the
training loop evaluates), `variables` takes a JAX-package variable tree
with numpy leaves (converted by `utils.convert.from_jax_variables`);
without either the detector gets seeded random weights. The JAX package's
orbax checkpoints cannot be read without JAX.
"""

from __future__ import annotations

from typing import List, Mapping, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..core.bbox.transforms import bbox2result
from ..data import collate
from ..data.pipelines.transforms import (Compose, LoadImageFromFile,
                                         Normalize, PackDetInputs, Pad,
                                         Resize)
from ..models.builder import build_detector, train_canvas
from ..models.weight_init import head_scale_of, init_random_weights_
from ..utils.checkpoint import load_checkpoint, load_meta, load_weights
from ..utils.config import Config
from ..utils.convert import load_jax_variables
from ..utils.device import resolve_device


class DetectorBundle(NamedTuple):
    model: torch.nn.Module
    cfg: Config
    classes: Sequence[str]
    canvas: tuple
    img_scale: tuple
    device: torch.device


def _default_canvas(img_scale, divisor=32):
    long_e, short_e = max(img_scale), min(img_scale)
    h = int(np.ceil(short_e / divisor)) * divisor
    w = int(np.ceil(long_e / divisor)) * divisor
    return (h, w)


def init_detector(config: Union[str, Config],
                  variables: Optional[Mapping] = None,
                  device: Union[str, torch.device] = 'cuda',
                  classes: Optional[Sequence[str]] = None,
                  seed: int = 0,
                  checkpoint: Optional[str] = None) -> DetectorBundle:
    """Build the config's detector on `device` (CUDA unless the caller asks
    for the CPU; raises without a card) with the weights of a port
    `checkpoint` (EMA parameters when it has them; its classes when
    `classes` is not given), `variables` converted from the JAX package, or
    random weights from a `torch.Generator` seeded by `seed`. The trunk's
    weights are channels_last. MHSA heads, which serving never runs, are
    sized for the train pipeline's canvas, as the trainer sizes them, so a
    checkpoint of the trainer loads."""
    if checkpoint is not None and variables is not None:
        raise ValueError('give one of checkpoint and variables')
    device = resolve_device(device)
    cfg = Config.fromfile(config) if isinstance(config, str) else config
    model = build_detector(cfg.model, device='meta', canvas=train_canvas(cfg))
    model = model.to_empty(device=device).to(memory_format=torch.channels_last)
    if checkpoint is not None:
        load_weights(model, load_checkpoint(checkpoint, device))
        saved = load_meta(checkpoint).get('classes')
        classes = classes or (tuple(saved) if saved else None)
    elif variables is not None:
        load_jax_variables(model, variables)
    else:
        init_random_weights_(
            model, torch.Generator(device=device).manual_seed(seed),
            head_scale_of(cfg))
    model.eval()

    img_scale = (1000, 600)
    test_cfg = (cfg.get('data') or {}).get('test') or {}
    for t in test_cfg.get('pipeline', []):
        if t.get('type') == 'MultiScaleFlipAug':
            img_scale = tuple(t.get('img_scale', img_scale))
    canvas = _default_canvas(img_scale)

    if classes is None:
        classes = cfg.get('classes')
        if classes is None:
            for split in ('test', 'val', 'train'):
                classes = (cfg.get('data') or {}).get(split, {}).get('classes')
                if classes:
                    break
        if classes is not None:
            classes = tuple(classes)
        else:
            classes = tuple(f'class_{i}' for i in range(model.num_classes))
    return DetectorBundle(model, cfg, classes, canvas, img_scale, device)


def prepare_batch(bundle: DetectorBundle, imgs: Sequence):
    """Run the test pipeline (keep-ratio resize, normalize, pad to the
    canvas) on the bundle's device. Returns (batch dict, per-image samples).
    """
    pipeline = Compose([
        Resize(img_scale=bundle.img_scale),
        Normalize(),
        Pad(size=bundle.canvas),
        PackDetInputs(max_gt=1),
    ])
    samples = []
    for img in imgs:
        if isinstance(img, str):
            results = LoadImageFromFile()(dict(
                img_info=dict(filename=img), img_prefix=None,
                device=bundle.device))
        else:
            arr = np.asarray(img)
            results = dict(img=torch.tensor(arr, device=bundle.device),
                           img_shape=arr.shape[:2], ori_shape=arr.shape[:2])
        results.setdefault('gt_bboxes', np.zeros((0, 4), np.float32))
        results.setdefault('gt_labels', np.zeros((0,), np.int64))
        samples.append(pipeline(results))
    return collate(samples), samples


def inference_detector(bundle: DetectorBundle,
                       imgs: Union[str, np.ndarray, List]):
    """Detect on one image (a JPEG path or an HWC RGB uint8 array) or a
    list of them, as one batch. A path is decoded on the host
    (`data.pipelines.jpeg`); the rest of the preprocessing runs on the
    bundle's device.

    Returns per image `list[num_classes]` of (n, 5) arrays, original coords.
    """
    single = not isinstance(imgs, (list, tuple))
    if single:
        imgs = [imgs]
    batch, samples = prepare_batch(bundle, imgs)
    out = {k: v.cpu().numpy() for k, v in bundle.model.predict(batch).items()}
    results_out = []
    for i in range(len(imgs)):
        boxes = out['dets'][i, :, :4] / np.asarray(
            samples[i]['scale_factor'])
        results_out.append(bbox2result(
            boxes, out['labels'][i], out['dets'][i, :, 4], out['valid'][i],
            bundle.model.num_classes))
    return results_out[0] if single else results_out
