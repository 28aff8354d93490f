"""FlexPipeline — txt2img / img2img / inpainting denoising (port of
``flexdiffuse_tpu/pipeline/flex.py``).

The JAX package compiles the whole loop into one ``lax.scan``; here the
loop is a Python loop over device tensors: the UNet (with CFG at 2B, or the
composite stack) and the scheduler update run eagerly, step after step, on
the models' device. Latents stay fp32 and NHWC ``[B, H/8, W/8, 4]`` at this
layer, as in JAX.

Noise: every draw the JAX pipeline takes from its key can be passed in, so
that tests replay JAX's key chain (``key, k_enc, k_noise, k_scan =
split(key, 4)``; per scan row ``k, sub, k_inp = split(k, 3)``):

* ``noise=``: txt2img's initial latents (unit normal; scaled by σ₀ for
  LMS), or img2img's ``add_noise`` noise (``k_noise``);
* ``posterior_noise=``: the init image's VAE posterior sample (``k_enc``;
  for a 9-channel inpainting UNet at strength < 1, ``fold_in(k_enc, 1)``);
* ``mask_posterior_noise=``: the masked image's posterior sample of the
  9-channel inpainting path (``k_enc``);
* ``variance_noise=``, ``inpaint_noise=``: sequences indexed by the scan
  position ``i``, the DDIM η > 0 variance noise (``sub``) and the latent
  inpainting anchor noise (``k_inp``).

Whatever is omitted is drawn from the ``generator`` (a ``torch.Generator``
on the pipeline's device).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.config import LATENT_SCALE
from flexdiffuse_tpu_torch.models.vae import sample_latents
from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                   SimpleGuidance)
from flexdiffuse_tpu_torch.schedulers.pndm import PRKSchedule
from flexdiffuse_tpu_torch.utils.image import preprocess, to_pil

Guidance = Union[SimpleGuidance, CompositeGuidance]


@dataclasses.dataclass
class FlexPipelineOutput:
    images: Union[List[Image.Image], torch.Tensor]


def prepare_latent_mask(mask, latent_hw: Tuple[int, int]) -> torch.Tensor:
    """Pixel- or latent-space inpainting mask → ``[B, h, w, 1]`` fp32 (CPU).

    1 = regenerate, 0 = keep. Takes PIL, (H, W), (H, W, C), (B, H, W) or
    (B, H, W, C); RGB(A) collapses to the mean of RGB; a map of another size
    is resized linearly (antialiased when shrinking, as
    ``jax.image.resize``) to the latent grid."""
    if isinstance(mask, Image.Image):
        mask = np.asarray(mask.convert('L'), np.float32) / 255.0
    m = torch.as_tensor(np.asarray(mask, np.float32))
    if m.ndim == 2:
        m = m[None, :, :, None]
    elif m.ndim == 3:
        # A trailing dim of 1/3/4 is a channel axis, anything else a
        # batch-leading grayscale mask.
        m = m[None] if m.shape[-1] in (1, 3, 4) else m[..., None]
    if m.shape[-1] > 1:
        m = m[..., :3].mean(dim=-1, keepdim=True)
    h, w = latent_hw
    if tuple(m.shape[1:3]) != (h, w):
        m = F.interpolate(m.permute(0, 3, 1, 2), size=(h, w),
                          mode='bilinear', align_corners=False,
                          antialias=True).permute(0, 2, 3, 1)
    return torch.clamp(m, 0.0, 1.0)


class FlexPipeline:
    """Holds the UNet and VAE modules and runs the denoise loop.

    Args:
        unet: a :class:`~flexdiffuse_tpu_torch.models.UNet2DCondition`.
        vae: an :class:`~flexdiffuse_tpu_torch.models.AutoencoderKL`.
        scheduler: 'ddim' | 'pndm' | 'lms'.
        scheduler_config: a :class:`~flexdiffuse_tpu_torch.schedulers.
            SchedulerConfig` (None: the defaults; PNDM's PRK warm-up is
            ``skip_prk_steps=False``).
    """

    def __init__(self, unet, vae, scheduler: str = 'pndm',
                 scheduler_config: Optional[
                     schedulers.SchedulerConfig] = None) -> None:
        self.unet = unet
        self.vae = vae
        self.scheduler_kind = scheduler
        self.scheduler_config = scheduler_config
        self._schedules: dict = {}
        self.latent_channels = vae.config.latent_channels
        self.vae_scale = 2**(len(vae.config.block_channels) - 1)
        self.latent_scale = LATENT_SCALE

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    def schedule(self, steps: int) -> schedulers.Schedule:
        key = (self.scheduler_kind, steps)
        if key not in self._schedules:
            self._schedules[key] = schedulers.make(self.scheduler_kind, steps,
                                                   self.scheduler_config)
        return self._schedules[key]

    def _randn(self, shape, generator: Optional[torch.Generator]):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=self.device)

    def _draw(self, given, shape, generator) -> torch.Tensor:
        if given is None:
            return self._randn(shape, generator)
        given = torch.as_tensor(given).to(self.device, torch.float32)
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f'noise shape {tuple(given.shape)} != '
                             f'{tuple(shape)}')
        return given

    @torch.no_grad()
    def encode_pixels(self, pixels: torch.Tensor,
                      posterior_noise: torch.Tensor) -> torch.Tensor:
        """VAE-encode NHWC pixels in [-1, 1] → scaled latents, sampling the
        posterior with the given unit noise."""
        mean, logvar = self.vae.encode(pixels)
        return sample_latents(mean, logvar, posterior_noise) * \
            self.latent_scale

    def _encode(self, pixels: torch.Tensor, posterior_noise,
                generator) -> torch.Tensor:
        f = self.vae_scale
        shape = (pixels.shape[0], pixels.shape[1] // f, pixels.shape[2] // f,
                 self.latent_channels)
        return self.encode_pixels(pixels,
                                  self._draw(posterior_noise, shape,
                                             generator))

    @torch.no_grad()
    def decode_u8_device(self, latents: torch.Tensor) -> torch.Tensor:
        """VAE decode + uint8 quantize (round half up, as ``to_pil``), left
        on the device: ``[B, H, W, 3]`` uint8."""
        img = self.vae.decode(latents / self.latent_scale)
        img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
        return (img * 255.0 + 0.5).to(torch.uint8)

    def latents_to_images(self, latents: torch.Tensor) -> List[Image.Image]:
        return to_pil(self.decode_u8_device(latents).cpu().numpy())

    def _pixels(self, init_image) -> torch.Tensor:
        if isinstance(init_image, Image.Image):
            init_image = preprocess(init_image)
        return torch.as_tensor(np.asarray(init_image, np.float32),
                               device=self.device)

    @torch.no_grad()
    def __call__(self,
                 guide: Guidance,
                 steps: int = 30,
                 init_image: Optional[Union[Image.Image, np.ndarray]] = None,
                 init_size: Tuple[int, int] = (512, 512),
                 strength: float = 0.6,
                 eta: float = 0.0,
                 generator: Optional[torch.Generator] = None,
                 output_type: str = 'pil',
                 debug: bool = False,
                 mask=None,
                 noise: Optional[torch.Tensor] = None,
                 posterior_noise: Optional[torch.Tensor] = None,
                 mask_posterior_noise: Optional[torch.Tensor] = None,
                 variance_noise: Optional[Sequence[torch.Tensor]] = None,
                 inpaint_noise: Optional[Sequence[torch.Tensor]] = None):
        """Generate images. ``output_type``: 'pil' or 'latent' (the final
        scaled latents). ``eta``: DDIM's η. ``mask`` (needs ``init_image``):
        1 = regenerate, 0 = keep; a 9-channel UNet takes it as input
        channels, any other UNet re-anchors the kept region every step.
        ``debug``: decode the latents after every step from the first active
        one and return all those images ('pil' only)."""
        if strength < 0 or strength > 1:
            raise ValueError('The value of strength should in [0.0, 1.0] '
                             f'but is {strength}')
        if mask is not None and init_image is None:
            raise ValueError('inpainting (mask=...) requires init_image')
        if debug and output_type != 'pil':
            raise ValueError("debug decodes every step: output_type 'pil'")
        if output_type not in ('pil', 'latent'):
            raise ValueError(f'unknown output_type {output_type!r}')
        dev = self.device
        batch_size = guide.batch_size
        schedule = self.schedule(steps)
        f = self.vae_scale
        sigma_space = schedule.kind in schedulers.SIGMA_SPACE_KINDS
        init_latents = latent_mask = None

        if mask is not None and \
                self.unet.config.in_channels > self.latent_channels:
            # 9-channel inpainting UNet: the mask and the masked image's
            # latents ride as extra input channels every step; no latent
            # re-anchoring.
            if not isinstance(guide, SimpleGuidance):
                raise ValueError('inpainting-checkpoint conditioning is '
                                 'supported for SimpleGuidance only')
            pixels = self._pixels(init_image)
            hpix, wpix = pixels.shape[1:3]
            pix_mask = prepare_latent_mask(mask, (hpix, wpix)).to(dev)
            masked_latents = self._encode(pixels * (1.0 - pix_mask),
                                          mask_posterior_noise, generator)
            lat_mask = prepare_latent_mask(mask,
                                           (hpix // f, wpix // f)).to(dev)
            extra = torch.cat([lat_mask, masked_latents.expand(
                tuple(lat_mask.shape[:3]) + (masked_latents.shape[-1],))],
                dim=-1)
            guide = guide.replace(extra_channels=extra)
            want = (batch_size, hpix // f, wpix // f, self.latent_channels)
            if strength < 1.0:
                orig = self._encode(pixels, posterior_noise, generator)
                orig = torch.cat([orig] * batch_size)
                init_timestep, t_start = schedulers.init_timestep_info(
                    schedule, strength, steps)
                latents = schedulers.add_noise(
                    schedule, orig, self._draw(noise, want, generator),
                    init_timestep)
            else:
                t_start = 0
                latents = self._draw(noise, want, generator)
                if sigma_space:
                    latents = latents * schedule.sigmas[0]
        elif init_image is not None:
            if isinstance(schedule, PRKSchedule):
                # The PRK feed's first 12 positions span only the top 3
                # timesteps: a strength-derived t_start would enter the
                # table mid warm-up with empty RK state.
                raise NotImplementedError(
                    'img2img/inpaint is not defined for PNDM PRK warm-up '
                    '(skip_prk_steps=False); use the PLMS mode')
            init_latents = self._encode(self._pixels(init_image),
                                        posterior_noise, generator)
            init_latents = torch.cat([init_latents] * batch_size)
            init_timestep, t_start = schedulers.init_timestep_info(
                schedule, strength, steps)
            latents = schedulers.add_noise(
                schedule, init_latents,
                self._draw(noise, init_latents.shape, generator),
                init_timestep)
            if mask is not None:
                latent_mask = prepare_latent_mask(
                    mask, tuple(latents.shape[1:3])).to(dev)
        else:
            height, width = init_size
            latents = self._draw(noise, (batch_size, height // f, width // f,
                                         self.latent_channels), generator)
            if sigma_space:
                latents = latents * schedule.sigmas[0]
            t_start = 0

        state = schedulers.init_state(schedule, latents.shape, latents.dtype)
        span = max(schedule.length - 1 - t_start, 1)
        eta_noise = schedule.kind == 'ddim' and eta > 0
        recorded = []
        for i in range(t_start, schedule.length):
            xin = schedulers.scale_model_input(schedule, latents, i)
            t = schedule.timesteps[i].to(dev)
            progress = torch.tensor(float(i - t_start)) / span
            eps = guide.noise_pred(self.unet, xin, t, progress)
            vnoise = None
            if eta_noise:
                vnoise = self._draw(None if variance_noise is None else
                                    variance_noise[i], latents.shape,
                                    generator)
            state, latents = schedulers.step(schedule, state, eps, i,
                                             i - t_start, latents, eta,
                                             vnoise)
            if latent_mask is not None:
                # Re-anchor the kept region to the init latents noised to
                # this step's output level.
                anchor = schedulers.anchor_noise(
                    schedule, init_latents,
                    self._draw(None if inpaint_noise is None else
                               inpaint_noise[i], latents.shape, generator),
                    i, i - t_start)
                latents = latent_mask * latents + (1.0 - latent_mask) * anchor
            if debug:
                recorded.append(latents)

        if debug:
            return FlexPipelineOutput(images=[
                im for lat in recorded for im in self.latents_to_images(lat)])
        if output_type == 'latent':
            return FlexPipelineOutput(images=latents)
        return FlexPipelineOutput(images=self.latents_to_images(latents))
