"""CycleGAN domain adaptation detectors (counterpart of the JAX package's
`models/detectors/cyda_faster_rcnn.py:CyDAFasterRCNN`).

`CyDAFasterRCNN` translates the source rows of a two-stream batch
([s, t, s, t, ...]: even rows source, odd rows target) into the target
domain with a CycleGAN and trains Faster R-CNN R50-DC5 on the translated
source rows and the raw target rows, with one global CBAM alignment head
on C5. Its loss dict has the generator-side terms (`cycle_loss`,
`gan_g_loss`, the detection losses, `globle_da_loss`) and the
discriminators' `disc_loss`, computed on detached fakes;
`apis.train_state.make_gan_train_step` updates the two parameter groups
(`DISC_KEYS`) from their own terms. The frozen stem that every config
has detaches the trunk's input, as the JAX trunk's stop_gradient at its
frozen stages does, so the detection losses' gradient stops at the
translated image and the translation trains on the GAN and cycle terms
alone. With `pretraining=True` (CyCADA) the loss stops after the GAN
terms and the detector gets no gradient.

The CycleGAN has no compute type and runs in f32; on a bf16 detector
(`dtype`) only the detector's input is cast, as in the JAX module.

Images enter the generators divided by 2.7 (about the largest |value| of
an ImageNet-normalised pixel) and leave multiplied by it. `predict` is
plain Faster R-CNN on untranslated images; `translate` maps a batch from
source to target; `detector_images` is the detector's input of a train
step.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.profiler import record_function

from ...utils.registry import DETECTORS
from ..backbones.da_resnet import DAResNet, Tap
from ..backbones.resnet import ResNet
from ..da.cyclegan import PatchDiscriminator, ResnetGenerator
from ..da.losses import global_alignment_loss
from ..losses.gan_loss import cycle_consistency_loss, gan_lsgan_loss
from .faster_rcnn import FasterRCNN

# the discriminators' top-level names: the second parameter group
DISC_KEYS = ('disc_s', 'disc_t')
# ~ the largest |value| of an ImageNet-normalised pixel: maps images into
# the generators' tanh range and back
TANH_SCALE = 2.7


@DETECTORS.register_module()
class CyDAFasterRCNN(FasterRCNN):

    def __init__(self, pretraining: bool = False, cycle_weight: float = 10.0,
                 gan_weight: float = 1.0, global_weight: float = 0.1,
                 gen_blocks: int = 6, **kwargs):
        super().__init__(**kwargs)
        self.pretraining = pretraining
        self.cycle_weight = cycle_weight
        self.gan_weight = gan_weight
        self.global_weight = global_weight
        self.gen_s2t = ResnetGenerator(n_blocks=gen_blocks)
        self.gen_t2s = ResnetGenerator(n_blocks=gen_blocks)
        self.disc_s = PatchDiscriminator()
        self.disc_t = PatchDiscriminator()

    def _build_backbone(self, depth: int, frozen_stages: int) -> nn.Module:
        return DAResNet(depth=depth, frozen_stages=frozen_stages,
                        taps=(Tap(3, 'global', 'cbam'),), dtype=self.dtype)

    def _trunk(self) -> ResNet:
        return self.backbone.trunk

    @staticmethod
    def _through(gen: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """(N, 3, H, W) images translated by `gen`, in its tanh range."""
        return gen(x / TANH_SCALE) * TANH_SCALE

    @staticmethod
    def _det_rows(fake_t: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        """[translated source | raw target] rows of `img`, interleaved
        again, out of place (the caller's batch stays as it was)."""
        return torch.stack([fake_t, img[1::2]], dim=1).reshape(img.shape)

    def extract_feat(self, image: torch.Tensor) -> torch.Tensor:
        (feat,), _ = self.backbone(image.to(self.dtype).permute(0, 3, 1, 2),
                                   with_da=False)
        return feat

    def loss(self, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             sampler_priorities: Optional[Dict[str, torch.Tensor]] = None
             ) -> Dict[str, torch.Tensor]:
        img = batch['image'].permute(0, 3, 1, 2)
        b = img.shape[0]
        if b % 2:
            raise ValueError('CyDA needs interleaved [s, t, ...] batches of '
                             f'an even size, got {b} images')
        src, tgt = img[0::2], img[1::2]
        with record_function('step/cyclegan'):
            fake_t = self._through(self.gen_s2t, src)
            fake_s = self._through(self.gen_t2s, tgt)
            rec_s = self._through(self.gen_t2s, fake_t)
            rec_t = self._through(self.gen_s2t, fake_s)
            losses = dict(cycle_loss=(
                cycle_consistency_loss(src, rec_s, self.cycle_weight) +
                cycle_consistency_loss(tgt, rec_t, self.cycle_weight)))
            losses['gan_g_loss'] = self.gan_weight * (
                gan_lsgan_loss(self.disc_t(fake_t), True) +
                gan_lsgan_loss(self.disc_s(fake_s), True))
            # the discriminators' objective, on detached fakes
            losses['disc_loss'] = 0.5 * (
                gan_lsgan_loss(self.disc_t(tgt), True) +
                gan_lsgan_loss(self.disc_t(fake_t.detach()), False) +
                gan_lsgan_loss(self.disc_s(src), True) +
                gan_lsgan_loss(self.disc_s(fake_s.detach()), False))
        if self.pretraining:                 # CyCADA: translation only
            return losses

        det_img = self._det_rows(fake_t, img)
        with record_function('step/trunk_and_grl_heads'):
            (feat,), da_out = self.backbone(det_img.to(self.dtype),
                                            with_da=True)
        det, _, _, _ = self._det_losses(
            feat, batch, (batch['domain'] == 0).float(), generator,
            sampler_priorities)
        losses.update(det)
        with record_function('step/da_losses'):
            for name, out in da_out.items():
                losses['globle_da_loss'] = self.global_weight * \
                    global_alignment_loss(out, batch['domain'])
        return losses

    @torch.no_grad()
    def translate(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Source → target translation of every image of the batch:
        (B, H, W, 3) → (B, H, W, 3)."""
        x = batch['image'].permute(0, 3, 1, 2)
        return self._through(self.gen_s2t, x).permute(0, 2, 3, 1)

    @torch.no_grad()
    def detector_images(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The images the detector sees in a train step on `batch`,
        (B, H, W, 3): the source rows translated, the target rows raw."""
        img = batch['image'].permute(0, 3, 1, 2)
        fake_t = self._through(self.gen_s2t, img[0::2])
        return self._det_rows(fake_t, img).permute(0, 2, 3, 1)
