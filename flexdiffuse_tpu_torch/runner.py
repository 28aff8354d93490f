"""Runner — guided generation and regional composition end to end (port of
``flexdiffuse_tpu/runner.py``: ``Runner(model_root=...)``,
``Runner.from_models``, ``Runner.gen``, ``Runner.compose``,
``Runner.apply_lora`` and ``Runner.load_textual_inversion``).

``Runner(model_root=...)`` loads SD-1.x and CLIP ViT-L/14 HF snapshots from
disk (``weights/load.py``) onto the card by default (``device='cpu'`` for
the CPU); ``from_models`` takes modules that already hold their weights.

``gen`` takes the reference's Sandbox parameters: the prompt, an optional
guide image or text with the ``guide_*`` tween parameters and mapping
concepts, an optional init image (img2img) with its strength and an
inpainting ``mask``, steps, CFG scale, samples, seed, ``debug`` (every
step's image), negative prompt and saving, and the JAX Runner's
``long_prompt`` (75-token windows), ``weighted`` (A1111 emphasis), the
two-pass hires fix (``hires_scale``, ``hires_strength``, ``hires_steps``),
``cfg_interval``, ``guidance_rescale`` and ``pag_scale``. Its ControlNet and
IP-Adapter keywords raise ``NotImplementedError`` naming ROADMAP step 10.
``compose`` is the reference's second UI tab: a background prompt and
rectangular entities, each with its prompt and blend.

The sampling toggles of the JAX Runner: ``enable_freeu``, ``enable_tome``,
``enable_pag``, ``enable_deepcache`` and ``enable_vae_tiling``, each with
its ``disable_*``. The first three give the pipeline a shallow copy of the
UNet with the setting (the weights are shared); DeepCache rebuilds the
pipeline; the tiling applies at once.

``Runner.timer`` (``utils/profiling.PhaseTimer``) accumulates the host
seconds of ``gen``'s two phases, ``'embeds'`` (the prompt and guide
embeddings) and ``'generate'`` (denoise, decode and saving), as the JAX
Runner's.

Seeds are clamped as in the JAX Runner and seed a ``torch.Generator`` on the
UNet's device; it draws every batch's noise in turn. A torch generator and a
JAX key give different numbers, so seeded outputs of the two packages
differ (the tests hand both the same noise instead).
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from PIL import Image

from flexdiffuse_tpu_torch.composition import (EntitySchema, Schema,
                                               encode_schema)
from flexdiffuse_tpu_torch.config import (MAX_SEED, GuidanceParams,
                                          RunConfig, clamp_seed)
from flexdiffuse_tpu_torch.encode import CLIPEncoder
from flexdiffuse_tpu_torch.guidance import Guide
from flexdiffuse_tpu_torch.models import (CLIP_VIT_L14_TEXT,
                                          CLIP_VIT_L14_VISION, SD14_UNET,
                                          SD14_VAE, AutoencoderKL,
                                          CLIPTextConfig, CLIPTextModel,
                                          CLIPVisionConfig, CLIPVisionModel,
                                          UNet2DCondition, UNetConfig,
                                          VAEConfig)
from flexdiffuse_tpu_torch.pipeline import (FlexPipeline, SimpleGuidance,
                                            upscale_latents)
from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
from flexdiffuse_tpu_torch.text.tokenizer import CLIPTokenizer
from flexdiffuse_tpu_torch.utils.image import image_grid
from flexdiffuse_tpu_torch.utils.profiling import PhaseTimer
from flexdiffuse_tpu_torch.weights import convert, load
from flexdiffuse_tpu_torch.weights import lora as _lora
from flexdiffuse_tpu_torch.weights import textual_inversion as _ti

log = logging.getLogger(__name__)

# JAX Runner.gen keywords the port does not take yet → the ROADMAP Queue 1
# step that ports them.
_NOT_PORTED = {
    'control_image': 10, 'controlnet_scale': 10,
    'ip_embed': 10, 'ip_image': 10, 'ip_scale': 10,
}


def _i100(f: float) -> int:
    return int(f * 100)


class Runner:
    """End-to-end generation runner: from HF snapshots on disk
    (``Runner(model_root=...)``) or from built modules
    (:meth:`from_models`)."""

    def __init__(self,
                 model_root: Optional[str] = None,
                 config: RunConfig = RunConfig(),
                 scheduler: str = 'pndm',
                 dtype: torch.dtype = torch.bfloat16,
                 text_config: Optional[CLIPTextConfig] = None,
                 vision_config: Optional[CLIPVisionConfig] = None,
                 unet_config: Optional[UNetConfig] = None,
                 vae_config: Optional[VAEConfig] = None,
                 clip_skip: int = 0,
                 scheduler_config: Optional[SchedulerConfig] = None,
                 device: Union[str, torch.device, None] = None) -> None:
        """Load the snapshots of ``config.sd_model`` and
        ``config.clip_model`` (directories named after the last part of each
        id) under ``model_root`` into modules of ``dtype`` on ``device``
        (None: the CUDA card, which must be present). The configs default
        to SD-1.4 and CLIP ViT-L/14; without ``unet_config`` the snapshot's
        ``unet/config.json`` sets ``in_channels`` (9: inpainting)."""
        if model_root is None:
            raise ValueError(
                'model_root is required (a directory with HF snapshots of '
                f'{config.sd_model} and {config.clip_model}); for weightless '
                'construction use Runner.from_models(...)')
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'Runner(model_root=...) runs on the CUDA card by default '
                    "and none is available; pass device='cpu' to run on the "
                    'CPU')
            device = 'cuda'
        sd_dir, clip_dir = load.snapshot_dirs(model_root, config.sd_model,
                                              config.clip_model)
        if unet_config is None:
            unet_config = SD14_UNET
            found = load.unet_overrides(sd_dir)
            if found.get('time_cond_proj_dim'):
                # A guidance-embedded (LCM) checkpoint.
                unet_config = dataclasses.replace(
                    unet_config,
                    time_cond_proj_dim=found['time_cond_proj_dim'])
            if found.get('in_channels', 4) == 8:
                raise NotImplementedError(
                    'InstructPix2Pix UNets (8 input channels) are not ported '
                    'yet (ROADMAP Queue 1 step 10)')
            if found.get('in_channels', 4) != unet_config.in_channels:
                unet_config = dataclasses.replace(
                    unet_config, in_channels=found['in_channels'])
        log.info('Loading CLIP from %s and SD from %s onto %s (%s)',
                 clip_dir, sd_dir, device, dtype)
        text_sd, vision_sd = load.load_clip(clip_dir)
        unet_sd, vae_sd = load.load_sd(sd_dir)
        build = lambda cls, cfg, sd: load.instantiate(cls, cfg, sd, device,
                                                      dtype)
        models = (build(CLIPTextModel, text_config or CLIP_VIT_L14_TEXT,
                        text_sd),
                  build(CLIPVisionModel, vision_config or CLIP_VIT_L14_VISION,
                        vision_sd),
                  build(UNet2DCondition, unet_config, unet_sd),
                  build(AutoencoderKL, vae_config or SD14_VAE, vae_sd))
        del text_sd, vision_sd, unet_sd, vae_sd
        self._init(*models, CLIPTokenizer.from_dir(clip_dir), scheduler,
                   config, scheduler_config, clip_skip)
        # The stored weights apply_lora merges from: mapped safetensors
        # files only (a torch file would be read whole on every merge).
        files = {'unet': load.weights_file(os.path.join(sd_dir, 'unet')),
                 'te': load.weights_file(clip_dir)}
        self._snapshots = {t: f for t, f in files.items()
                           if f.endswith('.safetensors')}

    @classmethod
    def from_models(cls, text_model, vision_model, unet, vae, tokenizer,
                    scheduler: str = 'pndm',
                    config: RunConfig = RunConfig(),
                    scheduler_config: Optional[SchedulerConfig] = None
                    ) -> 'Runner':
        """Build from modules that already hold their weights (on the
        device, in the dtype they should run in). ``scheduler``: a kind of
        :mod:`~flexdiffuse_tpu_torch.schedulers`; ``scheduler_config`` sets
        its switches (v-prediction, Karras σ, spacing, zero SNR, DDIM's and
        PNDM's)."""
        self = cls.__new__(cls)
        self._init(text_model, vision_model, unet, vae, tokenizer, scheduler,
                   config, scheduler_config)
        self._snapshots = {}
        return self

    def _init(self, text_model, vision_model, unet, vae, tokenizer,
              scheduler: str, config: RunConfig,
              scheduler_config: Optional[SchedulerConfig],
              clip_skip: int = 0) -> None:
        self.config = config
        self.encoder = CLIPEncoder(text_model, vision_model, tokenizer,
                                   clip_skip=clip_skip)
        self.guide = Guide(self.encoder)
        self.pipe = FlexPipeline(unet, vae, scheduler=scheduler,
                                 scheduler_config=scheduler_config)
        self.eta = 0.0  # DDIM η, read by every generation
        self.output_dir = config.output_dir
        self.grid_dir = os.path.join(self.output_dir, 'grids')
        self._generator = torch.Generator(self.pipe.device)
        self._merged: set = set()   # parameters a LoRA has changed
        self.timer = PhaseTimer()

    def _rebuild(self, unet=None, **overrides) -> None:
        """A new pipeline around ``unet`` (default: the current one) with
        the current scheduler, tiling and DeepCache unless overridden."""
        kw = dict(scheduler=self.pipe.scheduler_kind,
                  scheduler_config=self.pipe.scheduler_config,
                  vae_tile=self.pipe.vae_tile,
                  vae_tile_overlap=self.pipe.vae_tile_overlap,
                  deepcache=self.pipe.deepcache)
        kw.update(overrides)
        self.pipe = FlexPipeline(unet or self.pipe.unet, self.pipe.vae,
                                 **kw)

    def enable_freeu(self, b1: float = 1.5, b2: float = 1.6,
                     s1: float = 0.9, s2: float = 0.2) -> None:
        """FreeU (the published recipe; the defaults are SD-1.x's): amplify
        the backbone's first half-channels and Fourier-attenuate the skips
        at the two deepest decoder levels. No new weights."""
        self._rebuild(self.pipe.unet.with_settings(freeu=(b1, b2, s1, s2)))

    def disable_freeu(self) -> None:
        if self.pipe.unet.freeu is not None:
            self._rebuild(self.pipe.unet.with_settings(freeu=None))

    def enable_tome(self, ratio: float = 0.5, min_seq: int = 4096) -> None:
        """ToMe token merging (``ops/tome.py``): before every self-attention
        on a grid of at least ``min_seq`` tokens, merge ``ratio`` of the
        tokens into their most similar neighbours and copy the outputs
        back. The default engages SD-1.x's 4096-token level (and larger
        canvases). An approximation."""
        if not 0.0 < ratio < 1.0:
            raise ValueError('tome ratio must be in (0, 1)')
        self._rebuild(self.pipe.unet.with_settings(
            tome=(float(ratio), int(min_seq))))

    def disable_tome(self) -> None:
        if self.pipe.unet.tome is not None:
            self._rebuild(self.pipe.unet.with_settings(tome=None))

    def enable_pag(self, layers: Sequence[str] = ('mid',)) -> None:
        """PAG, perturbed-attention guidance: an extra cond row runs with
        identity self-attention in the transformers whose names start with
        one of ``layers`` ('mid', 'down_1', 'up_2_attn_1'; ('mid',) is the
        published default); ``gen(pag_scale=...)`` sets the strength."""
        if not layers:
            raise ValueError('pag layers must name at least one '
                             "transformer (e.g. ('mid',))")
        self._rebuild(self.pipe.unet.with_settings(pag_layers=tuple(layers)))

    def disable_pag(self) -> None:
        if self.pipe.unet.pag_layers is not None:
            self._rebuild(self.pipe.unet.with_settings(pag_layers=None))

    def enable_deepcache(self, interval: int = 2) -> None:
        """DeepCache: the full UNet every ``interval``-th denoise step, the
        deep feature reused in between with only the shallow levels
        recomputed (2-3 is the published sweet spot)."""
        if int(interval) != self.pipe.deepcache:
            self._rebuild(deepcache=int(interval))

    def disable_deepcache(self) -> None:
        if self.pipe.deepcache:
            self._rebuild(deepcache=0)

    def enable_vae_tiling(self, tile: int = 64, overlap: int = 8) -> None:
        """Decode and encode in ``tile``-latent-unit tiles with cross-faded
        ``overlap`` seams once the canvas exceeds one tile (``ops/
        tiled_vae.py``); ``tile=64`` is 512² pixels per tile."""
        if overlap >= tile:
            raise ValueError('overlap must be < tile')
        self.pipe.vae_tile = int(tile)
        self.pipe.vae_tile_overlap = int(overlap)

    def disable_vae_tiling(self) -> None:
        self.pipe.vae_tile = 0

    def apply_lora(self, path: str, scale: float = 1.0) -> None:
        """Merge a LoRA adapter (kohya or diffusers/PEFT naming,
        ``weights/lora.py``) into the UNet and text encoder in place.
        Each weight is merged in fp32 and cast once: a weight no LoRA has
        changed yet is merged from the snapshot's stored values (safetensors
        snapshots), so a bf16 model keeps updates below bf16's resolution of
        the weight. Repeated calls stack adapters."""
        kinds = {'unet': 'unet', 'te': 'text'}
        base = {t: convert.normalize(load.load_state_dict(f), kinds[t])
                for t, f in self._snapshots.items()}
        self._merged |= _lora.apply_lora(
            self.pipe.unet, self.encoder.text_model,
            load.load_state_dict(path), scale=scale, base=base,
            merged=self._merged)

    def load_textual_inversion(self, path: str,
                               token: Optional[str] = None) -> None:
        """Load a textual-inversion embedding: its placeholder token joins
        the tokenizer and its vectors the text encoder's embedding table
        (``weights/textual_inversion.py``). ``token`` overrides the name
        stored in (or implied by) the file."""
        file_token, table = _ti.extract_embedding(load.load_state_dict(path),
                                                  token)
        name = token or file_token or os.path.splitext(
            os.path.basename(path))[0]
        enc = self.encoder
        enc.replace_text(_ti.add_textual_inversion(
            enc.tokenizer, enc.text_model, name, table))
        log.info('textual inversion %r: %d vector(s) added', name,
                 table.shape[0])

    def _set_seed(self, seed: Optional[int]) -> int:
        seed = clamp_seed(seed)
        if seed is None:
            seed = int(np.random.default_rng().integers(0, MAX_SEED))
        self._generator.manual_seed(seed)
        return seed

    def _run(self, batches: int, guidance, init_image, init_size,
             strength: float, steps: int, debug: bool, fp: str, save: bool,
             mask=None, hires_scale: float = 0.0,
             hires_strength: float = 0.55,
             hires_steps: Optional[int] = None
             ) -> Tuple[List[Image.Image], Image.Image]:
        """Multi-batch sweep (reference ``_run`` utils.py:85-112); in debug
        mode each batch gives one image per recorded step.

        ``hires_scale > 1``: the two-pass hires fix (A1111's 'Latent'
        mode): pass 1 at ``init_size``, its latents upscaled by
        ``hires_scale`` (:func:`upscale_latents`) and refined by an img2img
        pass at ``hires_strength`` (a mask applies to pass 1 only)."""
        hires = bool(hires_scale) and hires_scale > 1.0
        all_images: List[Image.Image] = []
        if save:
            os.makedirs(self.grid_dir, exist_ok=True)
        for b in range(batches):
            stime = time.time()
            ms_time = int(stime * 1000)
            if hires:
                lat = self.pipe(guidance, steps=steps, init_image=init_image,
                                init_size=init_size, strength=strength,
                                eta=self.eta, generator=self._generator,
                                mask=mask, output_type='latent').images
                images = self.pipe(guidance, steps=hires_steps or steps,
                                   init_latents=upscale_latents(
                                       lat, hires_scale),
                                   strength=hires_strength, eta=self.eta,
                                   generator=self._generator,
                                   debug=debug).images
            else:
                images = self.pipe(guidance, steps=steps,
                                   init_image=init_image,
                                   init_size=init_size, strength=strength,
                                   eta=self.eta, generator=self._generator,
                                   debug=debug, mask=mask).images
            log.info('batch %d/%d: %d image(s) in %.2fs', b + 1, batches,
                     len(images), time.time() - stime)
            if save:
                for i, img in enumerate(images):
                    img.save(f'{self.output_dir}/{ms_time:>013d}_{i:>02d}_'
                             f'{fp}.png', format='png')
            all_images.extend(images)
        grid = image_grid(all_images)
        if save:
            ms_time = int(time.time() * 1000)
            grid.save(f'{self.grid_dir}/{ms_time:>013d}_{fp}.png',
                      format='png')
        return all_images, grid

    def gen(self,
            prompt: Union[str, List[str]] = '',
            init_image: Optional[Image.Image] = None,
            guide: Union[Image.Image, str, None] = None,
            init_size: Tuple[int, int] = (512, 512),
            mapping_concepts: str = '',
            guide_threshold_mult: float = 0.5,
            guide_threshold_floor: float = 0.5,
            guide_clustered: float = 0.5,
            guide_linear: Tuple[float, float] = (0.0, 0.5),
            guide_max_guidance: float = 0.5,
            guide_header_max: float = 0.15,
            guide_mode: int = 0,
            guide_reuse: bool = True,
            strength: float = 0.6,
            steps: int = 10,
            guidance_scale: float = 8,
            samples: int = 1,
            seed: Optional[int] = None,
            debug: bool = False,
            save: bool = True,
            negative_prompt: str = '',
            mask: Optional[Image.Image] = None,
            long_prompt: bool = False,
            weighted: bool = False,
            hires_scale: float = 0.0,
            hires_strength: float = 0.55,
            hires_steps: Optional[int] = None,
            cfg_interval: Optional[Tuple[float, float]] = None,
            guidance_rescale: float = 0.0,
            pag_scale: float = 0.0,
            **not_ported) -> Tuple[List[Image.Image], Image.Image]:
        """Guided generation (reference ``Runner.gen`` utils.py:114-166);
        returns ``(images, grid)``. ``mask`` (with ``init_image``): 1 =
        regenerate, 0 = keep. ``long_prompt`` encodes a prompt beyond 75
        tokens in 75-token windows; ``weighted`` parses A1111 emphasis
        (``(word:1.3)``, ``[word]``, ``BREAK``) in the prompt and the
        negative prompt and chunks the same way. Either takes a single
        prompt; a guide then tweens the first window only.

        ``hires_scale > 1``: the two-pass hires fix (see :meth:`_run`).
        ``cfg_interval=(lo, hi)``: CFG only for denoise progress in
        [lo, hi], cond-only at half the UNet batch outside.
        ``guidance_rescale``: CFG rescale's phi (0: off).
        ``pag_scale``: perturbed-attention guidance on the layers of
        :meth:`enable_pag` (('mid',) on first use; 0: off)."""
        for name in not_ported:
            if name not in _NOT_PORTED:
                raise TypeError(f'gen() got an unexpected keyword argument '
                                f'{name!r}')
            raise NotImplementedError(
                f'gen({name}=...) is not ported yet (ROADMAP Queue 1 step '
                f'{_NOT_PORTED[name]})')
        if pag_scale and self.pipe.unet.pag_layers is None:
            self.enable_pag()
        if mask is not None and init_image is not None:
            fp = f'inp_ds{int(strength * 100)}'
        elif init_image is not None:
            fp = f'i2i_ds{int(strength * 100)}'
        else:
            fp = 't2i'
        if guide is not None and not (isinstance(guide, str) and not guide):
            fp += (f'_itm{_i100(guide_threshold_mult)}'
                   f'_itf{_i100(guide_threshold_floor)}'
                   f'_ic{_i100(guide_clustered)}'
                   f'_il{_i100(guide_linear[0])}'
                   f'-{_i100(guide_linear[1])}'
                   f'_mg{_i100(guide_max_guidance)}'
                   f'_hm{_i100(guide_header_max)}'
                   f'_im{guide_mode:d}')
        fp += f'_st{steps}_gs{int(guidance_scale)}'
        if cfg_interval is not None:
            fp += f'_ci{_i100(cfg_interval[0])}-{_i100(cfg_interval[1])}'
        if guidance_rescale:
            fp += f'_gr{_i100(guidance_rescale)}'
        if pag_scale:
            fp += f'_pg{_i100(pag_scale)}'
        if hires_scale and hires_scale > 1.0:
            fp += f'_hr{_i100(hires_scale)}_hs{_i100(hires_strength)}'
        if seed:
            fp += f'_se{seed}'

        self._set_seed(seed)
        params = GuidanceParams(threshold_mult=guide_threshold_mult,
                                threshold_floor=guide_threshold_floor,
                                clustered=guide_clustered,
                                linear=tuple(guide_linear),
                                max_guidance=guide_max_guidance,
                                header_max=guide_header_max, mode=guide_mode,
                                reuse=guide_reuse)
        enc_fn = (self.encoder.prompt_weighted if weighted
                  else self.encoder.prompt_chunked)
        with self.timer.phase('embeds'):
            if long_prompt or weighted:
                embeds = self._windowed(prompt, guide, mapping_concepts,
                                        params, enc_fn)
            else:
                embeds = self.guide.embeds(prompt=prompt, guide=guide,
                                           mapping_concepts=mapping_concepts,
                                           params=params)
            if embeds.device.type == 'cuda':
                torch.cuda.synchronize(embeds.device)
        if long_prompt or weighted:
            uncond = self._windowed_uncond(negative_prompt, embeds, enc_fn)
        else:
            uncond = self.encoder.prompt(negative_prompt or '')
        features = {}
        if cfg_interval is not None:
            features.update(cfg_interval=True,
                            cfg_from=float(cfg_interval[0]),
                            cfg_to=float(cfg_interval[1]))
        if pag_scale:
            features.update(pag=True, pag_scale=float(pag_scale))
        if guidance_rescale:
            features.update(rescale=True,
                            guidance_rescale=float(guidance_rescale))
        guidance = SimpleGuidance(embeddings=embeds, uncond=uncond,
                                  guidance_scale=float(guidance_scale),
                                  cfg=guidance_scale > 1.0, **features)
        with self.timer.phase('generate'):
            return self._run(samples, guidance, init_image, init_size,
                             strength, steps, debug, fp, save, mask=mask,
                             hires_scale=hires_scale,
                             hires_strength=hires_strength,
                             hires_steps=hires_steps)

    def _windowed(self, prompt, guide, mapping_concepts: str,
                  params: GuidanceParams, enc_fn) -> torch.Tensor:
        """The cond context of a chunked (A1111) encoding, as the JAX
        ``Runner.gen`` builds it: the guide tween, defined on one 77-token
        window, applies to the first window."""
        if not isinstance(prompt, str):
            raise ValueError('long_prompt/weighted take a single prompt')
        embeds = enc_fn(prompt)
        win = self.encoder.tokenizer.model_max_length
        if guide is not None and (not isinstance(guide, str)
                                  or bool(guide.strip())):
            first = self.guide.embeds(prompt=prompt, guide=guide,
                                      mapping_concepts=mapping_concepts,
                                      params=params,
                                      text_embeddings=embeds[:, :win])
            embeds = torch.cat([first, embeds[:, win:]], dim=1)
        return embeds

    def _windowed_uncond(self, negative_prompt: str, embeds: torch.Tensor,
                         enc_fn) -> torch.Tensor:
        """The uncond context beside :meth:`_windowed`'s: the negative
        prompt chunked on its own, then cut or padded with empty-prompt
        windows to the prompt's window count."""
        win = self.encoder.tokenizer.model_max_length
        uncond = enc_fn(negative_prompt or '')
        k, k_u = embeds.shape[1] // win, uncond.shape[1] // win
        if k_u > k:
            uncond = uncond[:, :k * win]
        elif k_u < k:
            pad = self.encoder.prompt('').repeat(1, k - k_u, 1)
            uncond = torch.cat([uncond, pad], dim=1)
        return uncond

    def compose(self,
                bg_prompt: str = '',
                entities_df: Sequence[Sequence[Any]] = (),
                start_style: str = '',
                end_style: str = '',
                style_blend: Tuple[float, float] = (0.0, 1.0),
                init_image: Optional[Image.Image] = None,
                batches: int = 4,
                strength: float = 0.7,
                steps: int = 30,
                guidance_scale: float = 8.0,
                init_size: Tuple[int, int] = (512, 512),
                seed: Optional[int] = None,
                debug: bool = False,
                style_strength: float = 0.0,
                save: bool = True) -> Tuple[List[Image.Image], Image.Image]:
        """Regional composition (reference ``Runner.compose`` utils.py:
        168-207). ``entities_df`` rows are ``(prompt, left, top, width,
        height, blend)`` in pixels (a pandas DataFrame works too); rows that
        do not parse, or have an empty prompt, are skipped. Returns
        ``(images, grid)``."""
        fp = f'ci2i_ds{int(strength * 100)}' if init_image is not None \
            else 'ct2i'
        fp += f'_st{steps}_gs{int(guidance_scale)}'
        if seed:
            fp += f'_se{seed}'
        self._set_seed(seed)

        def _row_to_ent(row: Sequence[Any]) -> Optional[EntitySchema]:
            try:
                return EntitySchema(
                    str(row[0]).strip(), (int(row[1]), int(row[2])),
                    (int(row[3]), int(row[4])), float(row[5]))
            except (IndexError, TypeError, ValueError) as ex:
                log.warning('Failed to build EntitySchema: %s', ex)
                return None

        if hasattr(entities_df, '_values'):
            entities_df = entities_df._values  # pandas DataFrame support
        rows = [_row_to_ent(r) for r in entities_df]
        schema = Schema(bg_prompt, start_style, end_style, tuple(style_blend),
                        [r for r in rows if r and r.prompt])
        f = self.pipe.vae_scale
        guidance = encode_schema(schema, self.encoder,
                                 (init_size[0] // f, init_size[1] // f),
                                 guidance_scale, cfg=guidance_scale > 1.0,
                                 style_strength=style_strength, scale=f)
        return self._run(batches, guidance, init_image, init_size, strength,
                         steps, debug, fp, save)
