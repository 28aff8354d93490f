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
  position ``i``, the step noise (``sub``: DDIM's η > 0 variance noise and
  the per-step draws of Euler-a, DDPM and LCM) and the latent inpainting
  anchor noise (``k_inp``).

Whatever is omitted is drawn from the ``generator`` (a ``torch.Generator``
on the pipeline's device).

The sampling features of the JAX pipeline: Heun's two evaluations per step
(its schedule has ``2·steps − 1`` rows), the CFG interval (outside it the
UNet runs at batch B), PAG (the guide's 3B batch and the UNet's
``pag_mask``), DeepCache (``deepcache=N``: every N-th active row runs the
full UNet and saves the deep feature, the rows between run the shallow
levels around it), the LCM guidance embedding for guidance-embedded UNets,
latents-direct img2img (``init_latents=``, the hires fix's second pass
and the SDXL refiner's, with :func:`upscale_latents`) and the tiled VAE
(``vae_tile``). ``latent_scale`` is the VAE's latent scaling (SD-1.x's
0.18215 by default; SDXL's 0.13025), applied in every encode and decode.

The conditioning models: a ControlNet (``FlexPipeline(controlnet=)``,
``__call__(control_image=, controlnet_scale=)``) runs beside every UNet
evaluation on the same rows and ``t``, on the latent channels only, never
PAG-perturbed, and in full under DeepCache's shallow evaluations too; an
IP-Adapter's image tokens ride ``SimpleGuidance``; an 8-channel
InstructPix2Pix UNet runs through ``InstructPix2PixGuidance``.

Sequence parallelism (``sp_mesh=``, ``flexdiffuse_tpu/pipeline/flex.py:
119-213``; :func:`~flexdiffuse_tpu_torch.parallel.sp.sp_pipeline`): every
rank of the mesh axis runs the call with the same arguments, draws or
takes the same full noise and holds the same whole latents, so the result
equals the single-device result given the same noise, at any height. The
VAE, UNet and ControlNet run under
:func:`~flexdiffuse_tpu_torch.ops.attention.sp_context`: each takes and
returns whole tensors and shards the rows of every level that splits
evenly over the ranks (``ops/row_shard.py`` ``Plan``: the ring for long
self-attention, halo rows for the 3×3 convs, GroupNorm statistics over the
ranks), running the levels that do not split whole. The tiled VAE is off
under SP, and ToMe is refused, as in JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.config import LATENT_SCALE
from flexdiffuse_tpu_torch.models.unet import guidance_scale_embedding
from flexdiffuse_tpu_torch.models.vae import sample_latents
from flexdiffuse_tpu_torch.ops import attention as _attn
from flexdiffuse_tpu_torch.ops.tiled_vae import tiled_apply
from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                   InstructPix2PixGuidance,
                                                   SimpleGuidance)
from flexdiffuse_tpu_torch.schedulers.pndm import PRKSchedule
from flexdiffuse_tpu_torch.utils.image import preprocess, to_pil

Guidance = Union[SimpleGuidance, CompositeGuidance, InstructPix2PixGuidance]


@dataclasses.dataclass
class FlexPipelineOutput:
    """The JAX pipeline's output (``flexdiffuse_tpu/pipeline/flex.py:44-
    58``): ``images`` and ``nsfw_content_detected``, ``[False]`` per image
    (no safety checker runs). Subscripting answers ``'images'`` and
    ``'sample'`` (the reference Runner's key) with ``images``, and
    ``'nsfw_content_detected'``."""
    images: Union[List[Image.Image], np.ndarray, torch.Tensor]
    nsfw_content_detected: List[bool]

    def __getitem__(self, key):
        if key in ('images', 'sample'):
            return self.images
        if key == 'nsfw_content_detected':
            return self.nsfw_content_detected
        raise KeyError(key)


def resize_nhwc(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """``[B, H, W, C]`` fp32 resized to ``hw``: half-pixel linear
    interpolation, antialiased when it shrinks, as ``jax.image.resize``'s
    'bilinear'."""
    if tuple(x.shape[1:3]) == tuple(hw):
        return x
    return F.interpolate(x.permute(0, 3, 1, 2), size=tuple(hw),
                         mode='bilinear', align_corners=False,
                         antialias=True).permute(0, 2, 3, 1)


def prepare_control_image(image) -> torch.Tensor:
    """A ControlNet conditioning image → ``[B, H, W, 3]`` fp32 in [0, 1]
    (CPU): PIL images become RGB / 255; arrays are taken as given, a bare
    ``[H, W, 3]`` gaining the batch dim."""
    if isinstance(image, Image.Image):
        image = np.asarray(image.convert('RGB'), np.float32) / 255.0
    cond = torch.as_tensor(np.asarray(image, np.float32))
    return cond[None] if cond.ndim == 3 else cond


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
    return torch.clamp(resize_nhwc(m, latent_hw), 0.0, 1.0)


def upscale_latents(latents: torch.Tensor, scale: float,
                    method: str = 'bilinear') -> torch.Tensor:
    """Latent-space upscale for the hires fix's second pass (A1111's
    'Latent' mode): NHWC latents resized by ``scale``, the new dims snapped
    down to multiples of 8 (at least 8), half-pixel linear interpolation as
    ``jax.image.resize``; fp32."""
    if scale <= 1.0:
        raise ValueError(f'hires scale must be > 1, got {scale}')
    _, h, w, _ = latents.shape
    nh = max(8, (int(h * scale) // 8) * 8)
    nw = max(8, (int(w * scale) // 8) * 8)
    out = F.interpolate(latents.float().permute(0, 3, 1, 2), size=(nh, nw),
                        mode=method, align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous()


class FlexPipeline:
    """Holds the UNet and VAE modules and runs the denoise loop.

    Args:
        unet: a :class:`~flexdiffuse_tpu_torch.models.UNet2DCondition`.
        vae: an :class:`~flexdiffuse_tpu_torch.models.AutoencoderKL`.
        scheduler: a kind of :mod:`~flexdiffuse_tpu_torch.schedulers`.
        scheduler_config: a :class:`~flexdiffuse_tpu_torch.schedulers.
            SchedulerConfig` (None: the defaults; PNDM's PRK warm-up is
            ``skip_prk_steps=False``).
        vae_tile, vae_tile_overlap: decode and encode in tiles of
            ``vae_tile`` latent units with cross-faded overlaps once the
            canvas exceeds one tile (0: off).
        deepcache: the DeepCache interval (0 or 1: off).
        controlnet: a :class:`~flexdiffuse_tpu_torch.models.controlnet.
            ControlNetModel` for ``control_image=`` (None: none).
        latent_scale: the VAE latents' scaling factor.
        sp_mesh, sp_axis, sp_min_seq: sequence parallelism over ``sp_mesh``
            (a torch ``DeviceMesh``) axis ``sp_axis``; self-attention over
            at least ``sp_min_seq`` tokens rides the ring (None: off).
    """

    def __init__(self, unet, vae, scheduler: str = 'pndm',
                 scheduler_config: Optional[
                     schedulers.SchedulerConfig] = None,
                 vae_tile: int = 0, vae_tile_overlap: int = 8,
                 deepcache: int = 0, controlnet=None,
                 latent_scale: float = LATENT_SCALE, sp_mesh=None,
                 sp_axis: str = 'seq', sp_min_seq: int = 4096) -> None:
        if sp_mesh is not None and getattr(unet, 'tome', None) is not None:
            # The ToMe merge plan gathers tokens across the full sequence;
            # under SP the sequence is row-sharded.
            raise ValueError('ToMe (unet.tome) is incompatible with '
                             'sequence parallelism — disable one')
        self.sp_mesh = sp_mesh
        self.sp_axis = sp_axis
        self.sp_min_seq = int(sp_min_seq)
        self.unet = unet
        self.vae = vae
        self.controlnet = controlnet
        self.scheduler_kind = scheduler
        self.scheduler_config = scheduler_config
        self._schedules: dict = {}
        self.latent_channels = vae.config.latent_channels
        self.vae_scale = 2**(len(vae.config.block_channels) - 1)
        self.latent_scale = float(latent_scale)
        self.vae_tile = int(vae_tile)
        self.vae_tile_overlap = int(vae_tile_overlap)
        if self.vae_tile and self.vae_tile_overlap >= self.vae_tile:
            raise ValueError('vae_tile_overlap must be < vae_tile')
        self.deepcache = int(deepcache)
        if self.deepcache < 0:
            raise ValueError('deepcache interval must be >= 0')

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

    def _sp(self):
        """The SP context of this pipeline (a no-op without ``sp_mesh``)."""
        if self.sp_mesh is None:
            return contextlib.nullcontext()
        return _attn.sp_context(self.sp_mesh, self.sp_axis, self.sp_min_seq)

    def _draw(self, given, shape, generator) -> torch.Tensor:
        """Unit noise of ``shape``: ``given``, or drawn."""
        if given is None:
            return self._randn(shape, generator)
        given = torch.as_tensor(given).to(self.device, torch.float32)
        if tuple(given.shape) != tuple(shape):
            raise ValueError(f'noise shape {tuple(given.shape)} != '
                             f'{tuple(shape)}')
        return given

    def _tiling_active(self, h: int, w: int) -> bool:
        """Latent dims ``h×w`` exceed one VAE tile (never under SP)."""
        return self.vae_tile > 0 and self.sp_mesh is None and (
            h > self.vae_tile or w > self.vae_tile)

    @torch.no_grad()
    def encode_pixels(self, pixels: torch.Tensor,
                      posterior_noise: torch.Tensor) -> torch.Tensor:
        """VAE-encode NHWC pixels in [-1, 1] → scaled latents, sampling the
        posterior with the given unit noise. Tiled, the posterior moments
        cross-fade across the seams and the posterior is sampled once over
        the blended canvas."""
        f = self.vae_scale
        if self._tiling_active(pixels.shape[1] // f, pixels.shape[2] // f):
            mean, logvar = tiled_apply(
                self.vae.encode, pixels, self.vae_tile * f,
                self.vae_tile_overlap * f, out_num=1, out_den=f)
        else:
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

    def _decode01(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → images in [0, 1], tiled when the canvas exceeds one
        tile."""
        def decode(z):
            img = self.vae.decode(z / self.latent_scale)
            return torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
        if self._tiling_active(latents.shape[1], latents.shape[2]):
            return tiled_apply(decode, latents, self.vae_tile,
                               self.vae_tile_overlap, out_num=self.vae_scale,
                               out_den=1)
        return decode(latents)

    def _decode_full(self, latents: torch.Tensor) -> torch.Tensor:
        """:meth:`_decode01` (under SP, the decoder shards its levels)."""
        with self._sp():
            return self._decode01(latents)

    @torch.no_grad()
    def decode_u8_device(self, latents: torch.Tensor) -> torch.Tensor:
        """VAE decode + uint8 quantize (round half up, as ``to_pil``), left
        on the device: ``[B, H, W, 3]`` uint8."""
        return (self._decode_full(latents) * 255.0 + 0.5).to(torch.uint8)

    def latents_to_images(self, latents: torch.Tensor) -> List[Image.Image]:
        return to_pil(self.decode_u8_device(latents).cpu().numpy())

    @torch.no_grad()
    def latents_to_np(self, latents: torch.Tensor) -> np.ndarray:
        """VAE decode → float32 images ``[B, H, W, 3]`` in [0, 1] on the
        host (the JAX pipeline's ``output_type='np'``)."""
        return self._decode_full(latents).float().cpu().numpy()

    def _pixels(self, init_image) -> torch.Tensor:
        """The init image on the device."""
        if isinstance(init_image, Image.Image):
            init_image = preprocess(init_image)
        return torch.as_tensor(np.asarray(init_image, np.float32),
                               device=self.device)

    def _check_features(self, guide) -> None:
        """The JAX pipeline's composition rules for DeepCache, the CFG
        interval and PAG."""
        if (self.deepcache >= 2 and getattr(guide, 'cfg_interval', False)
                and isinstance(guide, CompositeGuidance)):
            raise ValueError('cfg_interval composes with deepcache only for '
                             'SimpleGuidance (composite stacks have no '
                             'half-batch cache layout)')
        if getattr(guide, 'pag', False):
            if self.unet.pag_layers is None:
                raise ValueError(
                    'PAG guidance requires a UNet with pag_layers set '
                    '(Runner.enable_pag / unet.with_settings(pag_layers=...))'
                    ' — without it the perturbed row is a wasted cond copy')
            if self.deepcache >= 2 and guide.cfg_interval:
                raise ValueError('PAG composes with deepcache or '
                                 'cfg_interval, but not both at once (the '
                                 'half-batch cache layout assumes two rows '
                                 'per sample)')

    def _lcm_guide(self, guide):
        """A guidance-embedded (LCM) UNet takes the guidance scale as an
        input and runs without CFG (diffusers' semantics)."""
        tcp = self.unet.config.time_cond_proj_dim
        if not tcp:
            return guide
        if not hasattr(guide, 'timestep_cond'):
            raise NotImplementedError(
                'guidance-embedded (LCM) UNets are driven through '
                'SimpleGuidance; composite guidance does not carry a '
                'timestep_cond')
        if guide.timestep_cond is not None:
            return guide
        w = torch.as_tensor(guide.guidance_scale, dtype=torch.float32) - 1.0
        return guide.replace(timestep_cond=guidance_scale_embedding(
            w.cpu(), tcp).to(self.device), cfg=False)

    def _model(self, control):
        """The noise function the guides call: the UNet, with the
        ControlNet's residuals when ``control`` is ``(cond [1 or N, H, W,
        3], scale)``. The control branch sees the rows' latent channels
        only (a 9- or 8-channel UNet's extras stripped), the same ``t``,
        context and ``added_cond``, and neither PAG's mask nor DeepCache's
        mode."""
        unet = self.unet
        if control is None:
            return unet
        cond, scale = control
        c = self.latent_channels

        def model(lat, t, ctx, **kw):
            rows = cond.expand((lat.shape[0],) + tuple(cond.shape[1:]))
            kw['control'] = self.controlnet(
                lat[..., :c], t, ctx, rows, scale,
                added_cond=kw.get('added_cond'))
            return unet(lat, t, ctx, **kw)
        return model

    def _control(self, control_image, scale: float, latents: torch.Tensor):
        """``(cond, scale)`` for :meth:`_model`: the control image on the
        device, resized to the generation's pixel size; None without
        one."""
        if control_image is None:
            return None
        f = self.vae_scale
        hw = (latents.shape[1] * f, latents.shape[2] * f)
        return (resize_nhwc(prepare_control_image(control_image),
                            hw).to(self.device), float(scale))

    def _predictor(self, guide, span: int, t_start: int, control=None):
        """``eps_at(i, xin, t)``: the guided ε at row ``i``, through the CFG
        interval and DeepCache schedules of the JAX pipeline's scan."""
        unet = self._model(control)
        use_interval = (getattr(guide, 'cfg_interval', False)
                        and getattr(guide, 'cfg', False))
        g_cond = guide.replace(cfg=False) if use_interval else None
        lo, hi = (np.float32(guide.cfg_from), np.float32(guide.cfg_to)) \
            if use_interval else (None, None)

        def prog(i: int) -> np.float32:
            # fp32, as the JAX scan compares it with fp32 bounds.
            return np.float32(i - t_start) / np.float32(span)

        def inside(i: int) -> bool:
            return bool(lo <= prog(i) <= hi)

        def pick(i: int):
            return guide if not use_interval or inside(i) else g_cond

        def progress(i: int) -> torch.Tensor:
            return torch.tensor(float(i - t_start)) / span

        if self.deepcache < 2:
            def eps_at(i, xin, t):
                return pick(i).noise_pred(unet, xin, t, progress(i))
            return eps_at

        box = {}

        def save_fn(*args, **kw):
            eps, box['cache'] = unet(*args, cache_mode='save', **kw)
            return eps

        def use_fn(*args, **kw):
            return unet(*args, cache_mode='use', deep_cache=box['use'],
                        **kw)[0]

        def eps_at(i, xin, t):
            full = (i - t_start) % self.deepcache == 0
            if use_interval:
                # A full 'save' on every interval transition: a CFG row
                # never uses the cond-only save's tiled stand-in.
                full = full or inside(i) != inside(i - 1)
            g = pick(i)
            if full:
                eps = g.noise_pred(save_fn, xin, t, progress(i))
                if g is g_cond:
                    # Tile the half-batch cache into the uncond slots.
                    box['cache'] = torch.cat([box['cache']] * 2)
                return eps
            cache = box['cache']
            box['use'] = cache[cache.shape[0] // 2:] if g is g_cond \
                else cache
            return g.noise_pred(use_fn, xin, t, progress(i))
        return eps_at

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
                 return_dict: bool = True,
                 debug: bool = False,
                 mask=None,
                 control_image=None,
                 controlnet_scale: float = 1.0,
                 init_latents: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None,
                 posterior_noise: Optional[torch.Tensor] = None,
                 mask_posterior_noise: Optional[torch.Tensor] = None,
                 variance_noise: Optional[Sequence[torch.Tensor]] = None,
                 inpaint_noise: Optional[Sequence[torch.Tensor]] = None):
        """Generate images. ``output_type``: 'pil', 'np' (float32 ``[B, H,
        W, 3]`` in [0, 1] on the host) or 'latent' (the final scaled
        latents). ``eta``: DDIM's η. ``mask`` (needs ``init_image``):
        1 = regenerate, 0 = keep; a 9-channel UNet takes it as input
        channels, any other UNet re-anchors the kept region every step.
        ``init_latents`` (instead of ``init_image``): img2img from scaled
        latents, no VAE round trip. ``debug``: decode the latents after
        every step from the first active one and return all those images
        (for any ``output_type`` but 'pil', float32 ``[steps·B, H, W, 3]``
        in [0, 1], the steps concatenated on axis 0, as JAX).
        ``control_image`` (needs the pipeline's ``controlnet``): PIL, or
        ``[H, W, 3]``/``[1, H, W, 3]`` in [0, 1], resized to the
        generation's pixel size; ``controlnet_scale`` weighs its residuals.
        ``return_dict=False`` returns ``(images, False)`` (the JAX
        pipeline's tuple: images and the NSFW flag).

        Under SP (``sp_mesh``) every rank of the axis makes the same call
        and gets the same full result (see the module doc)."""
        with self._sp():
            return self._call(
                guide, steps, init_image, init_size, strength, eta,
                generator, output_type, return_dict, debug, mask,
                control_image, controlnet_scale, init_latents, noise,
                posterior_noise, mask_posterior_noise, variance_noise,
                inpaint_noise)

    def _call(self, guide, steps, init_image, init_size, strength, eta,
              generator, output_type, return_dict, debug, mask,
              control_image, controlnet_scale, init_latents, noise,
              posterior_noise, mask_posterior_noise, variance_noise,
              inpaint_noise):
        if strength < 0 or strength > 1:
            raise ValueError('The value of strength should in [0.0, 1.0] '
                             f'but is {strength}')
        if mask is not None and init_image is None:
            raise ValueError('inpainting (mask=...) requires init_image')
        if init_latents is not None and init_image is not None:
            raise ValueError('pass init_image OR init_latents, not both')
        if output_type not in ('pil', 'np', 'latent'):
            raise ValueError(f'unknown output_type {output_type!r}')
        if control_image is not None and self.controlnet is None:
            raise ValueError('control_image given but this pipeline was '
                             'built without a controlnet')
        self._check_features(guide)
        guide = self._lcm_guide(guide)
        dev = self.device
        batch_size = guide.batch_size
        schedule = self.schedule(steps)
        f = self.vae_scale
        sigma_space = schedule.kind in schedulers.SIGMA_SPACE_KINDS
        latent_mask = None

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
            lat_mask = prepare_latent_mask(
                mask, (hpix // f, wpix // f)).to(dev)
            extra = torch.cat([lat_mask, masked_latents.expand(
                tuple(lat_mask.shape[:3]) + (masked_latents.shape[-1],))],
                dim=-1)
            guide = guide.replace(extra_channels=extra)
            want = (batch_size,) + tuple(lat_mask.shape[1:3]) + (
                self.latent_channels,)
            init_latents = None
            if strength < 1.0:
                orig = self._encode(pixels, posterior_noise, generator)
                orig = torch.cat([orig] * batch_size)
                init_timestep, t_start = schedulers.init_timestep_info(
                    schedule, strength, steps)
                t_start *= schedule.rows_per_step
                latents = schedulers.add_noise(
                    schedule, orig, self._draw(noise, want, generator),
                    init_timestep)
            else:
                t_start = 0
                latents = self._draw(noise, want, generator)
                if sigma_space:
                    latents = latents * schedule.sigmas[0]
        elif init_image is not None or init_latents is not None:
            if isinstance(schedule, PRKSchedule):
                # The PRK feed's first 12 positions span only the top 3
                # timesteps: a strength-derived t_start would enter the
                # table mid warm-up with empty RK state.
                raise NotImplementedError(
                    'img2img/inpaint is not defined for PNDM PRK warm-up '
                    '(skip_prk_steps=False); use the PLMS mode')
            if init_latents is not None:
                init_latents = torch.as_tensor(init_latents).to(
                    dev, torch.float32)
                if init_latents.shape[0] != batch_size:
                    init_latents = torch.cat([init_latents] * batch_size)
            else:
                pixels = self._pixels(init_image)
                init_latents = self._encode(pixels, posterior_noise,
                                            generator)
                init_latents = torch.cat([init_latents] * batch_size)
            init_timestep, t_start = schedulers.init_timestep_info(
                schedule, strength, steps)
            t_start *= schedule.rows_per_step
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
        eps_at = self._predictor(
            guide, span, t_start,
            self._control(control_image, controlnet_scale, latents))
        step_noise = schedulers.takes_noise(schedule, eta)
        recorded = []
        for i in range(t_start, schedule.length):
            xin = schedulers.scale_model_input(schedule, latents, i)
            eps = eps_at(i, xin, schedule.timesteps[i].to(dev))
            vnoise = None
            if step_noise:
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

        if debug and output_type == 'pil':
            images = [im for lat in recorded
                      for im in self.latents_to_images(lat)]
        elif debug:
            images = np.concatenate([self.latents_to_np(lat)
                                     for lat in recorded])
        elif output_type == 'latent':
            images = latents
        elif output_type == 'np':
            images = self.latents_to_np(latents)
        else:
            images = self.latents_to_images(latents)
        if not return_dict:
            return images, False
        return FlexPipelineOutput(images=images,
                                  nsfw_content_detected=[False] * len(images))
