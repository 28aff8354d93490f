"""Runner — guided generation, editing and regional composition end to end
(port of ``flexdiffuse_tpu/runner.py``: ``Runner(model_root=...)``,
``Runner.from_models``, ``Runner.gen``, ``Runner.edit``,
``Runner.compose``, ``Runner.apply_lora``, ``Runner.load_textual_inversion``,
``Runner.load_controlnet`` and ``Runner.load_ip_adapter``).

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
``cfg_interval``, ``guidance_rescale`` and ``pag_scale``, and the
conditioning models: ``control_image``/``controlnet_scale`` after
:meth:`Runner.load_controlnet`, ``ip_image``/``ip_embed``/``ip_scale``
after :meth:`Runner.load_ip_adapter`. ``edit`` is InstructPix2Pix on an
8-channel UNet (detected from the snapshot's ``unet/config.json``).
``compose`` is the reference's second UI tab: a background prompt and
rectangular entities, each with its prompt and blend.

The sampling toggles of the JAX Runner: ``enable_freeu``, ``enable_tome``,
``enable_pag``, ``enable_deepcache`` and ``enable_vae_tiling``, each with
its ``disable_*``. The first three give the pipeline a shallow copy of the
UNet with the setting (the weights are shared); DeepCache rebuilds the
pipeline; the tiling applies at once.

``Runner.timer`` (``utils/profiling.PhaseTimer``) accumulates the host
seconds of ``gen``'s two phases, ``'embeds'`` (the prompt and guide
embeddings, as the host enqueues them) and ``'generate'`` (denoise, decode
and saving, up to the images on the host), as the JAX Runner's. In a
``torch.profiler`` trace ``gen`` is the span ``fd.gen`` and its phases
``fd.embeds`` and ``fd.generate`` (``utils/profiling.span``).

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
from flexdiffuse_tpu_torch.models.configs import OPENCLIP_H_VISION
from flexdiffuse_tpu_torch.models.controlnet import ControlNetModel
from flexdiffuse_tpu_torch.models import ip_adapter as _ipa
from flexdiffuse_tpu_torch.pipeline import (FlexPipeline,
                                            InstructPix2PixGuidance,
                                            SimpleGuidance, upscale_latents)
from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
from flexdiffuse_tpu_torch.text.tokenizer import CLIPTokenizer
from flexdiffuse_tpu_torch.utils.image import (clip_preprocess, image_grid,
                                               preprocess)
from flexdiffuse_tpu_torch.utils.profiling import PhaseTimer, span, spanned
from flexdiffuse_tpu_torch.weights import convert, load
from flexdiffuse_tpu_torch.weights import lora as _lora
from flexdiffuse_tpu_torch.weights import textual_inversion as _ti

log = logging.getLogger(__name__)


def _param(module: torch.nn.Module) -> torch.Tensor:
    return next(module.parameters())


class IPAdapterState:
    """A loaded IP-Adapter: its image-projection head (``ImageProjection``
    or ``Resampler``, on the UNet's device and dtype), what the head takes
    (``input_kind``: 'pooled' or 'penultimate'), the image encoder (a
    :class:`CLIPVisionModel`, or None for precomputed embeddings) and the
    adapter's unconditional tokens."""

    def __init__(self, proj, input_kind: str, encoder,
                 vision_config: CLIPVisionConfig) -> None:
        self.proj = proj
        self.input_kind = input_kind
        self.encoder = encoder
        self.vision_config = vision_config
        with torch.no_grad():
            self.uncond_tokens = self.proj(self._uncond_embed())

    def _uncond_embed(self) -> torch.Tensor:
        """Zeros for base checkpoints; for Plus, the encoder's
        penultimate states of a zeros pixel grid (zeros in the normalized
        pixel space, the official uncond), or zero hidden states without an
        encoder."""
        w = _param(self.proj)
        if self.input_kind == 'pooled':
            return torch.zeros((1, self.proj.proj.in_features),
                               device=w.device)
        if self.encoder is not None:
            size = self.vision_config.image_size
            return self.encoder(torch.zeros((1, size, size, 3),
                                            device=w.device),
                                output='penultimate')
        return torch.zeros((1, 257, self.proj.proj_in.in_features),
                           device=w.device)

    @torch.no_grad()
    def fields(self, ip_embed, ip_image, ip_scale: float) -> dict:
        """The ``SimpleGuidance`` ip_* fields of one generation."""
        w = _param(self.proj)
        if ip_embed is None:
            if self.encoder is None:
                raise ValueError(
                    'ip_image requires load_ip_adapter(image_encoder_dir=…) '
                    '— or pass a precomputed ip_embed')
            pixels = torch.as_tensor(clip_preprocess(
                ip_image, self.vision_config.image_size), device=w.device)
            ip_embed = self.encoder(pixels, output=self.input_kind)
        emb = torch.as_tensor(ip_embed, dtype=torch.float32).to(w.device)
        want_ndim = 3 if self.input_kind == 'penultimate' else 2
        if emb.ndim == want_ndim - 1:
            emb = emb[None]
        return dict(ip_tokens=self.proj(emb), ip_uncond=self.uncond_tokens,
                    ip_scale=float(ip_scale))


def attach_ip_adapter(pipe: FlexPipeline, path: str,
                      image_encoder_dir: Optional[str] = None,
                      vision_config: Optional[CLIPVisionConfig] = None):
    """An IP-Adapter checkpoint merged into ``pipe``'s UNet: returns
    ``(unet, IPAdapterState)``, the UNet an ``ip_adapter=True`` copy whose
    weights are the old ones (shared) plus the per-layer
    ``to_k_ip``/``to_v_ip``, with the old one's sampling settings.
    ``vision_config`` (default OpenCLIP ViT-H, the SD-1.5 adapters'
    encoder) describes the image-encoder snapshot at ``image_encoder_dir``.
    Official ``.bin`` files nest ``image_proj`` and ``ip_adapter`` dicts;
    ``load_state_dict`` flattens them to dotted keys."""
    vision_config = vision_config or OPENCLIP_H_VISION
    sd = load.load_state_dict(path)
    old = pipe.unet
    w = _param(old)
    layers = _ipa.convert_ip_layers(sd, old.config)
    proj, tokens, kind = _ipa.build_image_proj(sd, old.config)
    cfg = dataclasses.replace(old.config, ip_adapter=True, ip_tokens=tokens)
    unet = load.instantiate(UNet2DCondition, cfg, _ipa.merge_ip_weights(
        old.state_dict(), layers), w.device, w.dtype).with_settings(
            **old.settings())
    encoder = None
    if image_encoder_dir:
        enc_sd = convert.normalize(load.load_state_dict(image_encoder_dir),
                                   'vision')
        encoder = load.instantiate(CLIPVisionModel, vision_config, enc_sd,
                                   w.device, w.dtype)
    state = IPAdapterState(proj.to(w.device, w.dtype), kind, encoder,
                           vision_config)
    log.info('ip-adapter loaded from %s (%d tokens, %s input)', path,
             tokens, kind)
    return unet, state


def rebuild(pipe: FlexPipeline, unet=None, **changes) -> FlexPipeline:
    """A new pipeline around ``unet`` (default: ``pipe``'s) and ``pipe``'s
    VAE, with ``pipe``'s scheduler, tiling, DeepCache, ControlNet, latent
    scale and sequence parallelism unless ``changes`` say otherwise."""
    kw = dict(scheduler=pipe.scheduler_kind,
              scheduler_config=pipe.scheduler_config,
              vae_tile=pipe.vae_tile, vae_tile_overlap=pipe.vae_tile_overlap,
              deepcache=pipe.deepcache, controlnet=pipe.controlnet,
              latent_scale=pipe.latent_scale, sp_mesh=pipe.sp_mesh,
              sp_axis=pipe.sp_axis, sp_min_seq=pipe.sp_min_seq)
    kw.update(changes)
    return FlexPipeline(unet or pipe.unet, pipe.vae, **kw)


def seed_generator(generator: torch.Generator, seed: Optional[int]) -> int:
    """Seed ``generator`` with ``seed`` (clamped; a random one when None)
    and return the seed used."""
    seed = clamp_seed(seed)
    if seed is None:
        seed = int(np.random.default_rng().integers(0, MAX_SEED))
    generator.manual_seed(seed)
    return seed


def ip_fields(state: Optional[IPAdapterState], ip_embed, ip_image,
              ip_scale: float, runner: str = 'Runner') -> dict:
    """The guide's ip_* fields of one generation from ``state`` (the
    loaded IP-Adapter of a ``runner``); none without an image prompt."""
    if ip_embed is None and ip_image is None:
        return {}
    if state is None:
        raise ValueError('image prompt given but no IP-Adapter is '
                         f'loaded ({runner}.load_ip_adapter)')
    return state.fields(ip_embed, ip_image, ip_scale)


def run_batches(batches: int, sample, output_dir: str, fp: str,
                save: bool) -> Tuple[List[Image.Image], Image.Image]:
    """``batches`` calls of ``sample()`` (a list of images each) and the
    grid of all their images; with ``save`` each image goes to
    ``output_dir`` and the grid to its ``grids/``, under file names of the
    time and the provenance tag ``fp``."""
    grid_dir = os.path.join(output_dir, 'grids')
    all_images: List[Image.Image] = []
    if save:
        os.makedirs(grid_dir, exist_ok=True)
    for b in range(batches):
        stime = time.time()
        ms_time = int(stime * 1000)
        images = sample()
        log.info('batch %d/%d: %d image(s) in %.2fs', b + 1, batches,
                 len(images), time.time() - stime)
        if save:
            with span('fd.save'):
                for i, img in enumerate(images):
                    img.save(f'{output_dir}/{ms_time:>013d}_{i:>02d}_{fp}'
                             '.png', format='png')
        all_images.extend(images)
    with span('fd.grid'):
        grid = image_grid(all_images)
    if save:
        ms_time = int(time.time() * 1000)
        with span('fd.save'):
            grid.save(f'{grid_dir}/{ms_time:>013d}_{fp}.png', format='png')
    return all_images, grid


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
        to SD-1.4 and CLIP ViT-L/14; the snapshot's ``unet/config.json`` sets
        the UNet's ``in_channels`` (9: inpainting, 8: InstructPix2Pix) and
        ``time_cond_proj_dim`` (LCM)."""
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
        # The snapshot's unet/config.json sets the conditioned UNets' input
        # width (9: inpainting; 8: InstructPix2Pix) and a guidance-embedded
        # (LCM) checkpoint's cond_proj width, also over a given config (the
        # CLI gives its family's geometry); the weights would not load
        # into another.
        unet_config = unet_config or SD14_UNET
        found = load.unet_overrides(sd_dir)
        if found.get('time_cond_proj_dim'):
            unet_config = dataclasses.replace(
                unet_config, time_cond_proj_dim=found['time_cond_proj_dim'])
        if found.get('in_channels', unet_config.in_channels) != \
                unet_config.in_channels:
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
        self._generator = torch.Generator(self.pipe.device)
        self._merged: set = set()   # parameters a LoRA has changed
        self._ip: Optional[IPAdapterState] = None
        self.timer = PhaseTimer()

    def _rebuild(self, unet=None, **overrides) -> None:
        self.pipe = rebuild(self.pipe, unet, **overrides)

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

    def load_controlnet(self, path: str) -> None:
        """Load a diffusers ControlNet snapshot (a directory or weights
        file; ``models/controlnet.py``) onto the UNet's device and dtype and
        rebuild the pipeline with it; then pass ``control_image=`` (and
        ``controlnet_scale=``) to :meth:`gen`. The conditioning ramp comes
        from the checkpoint's shapes."""
        sd = convert.normalize(load.load_state_dict(path), 'controlnet')
        ramp, i = [sd['controlnet_cond_embedding.conv_in.weight'].shape[0]], 1
        while f'controlnet_cond_embedding.blocks.{i}.weight' in sd:
            ramp.append(sd[f'controlnet_cond_embedding.blocks.{i}.weight'
                           ].shape[0])
            i += 2
        w = _param(self.pipe.unet)
        build = lambda cfg: ControlNetModel(cfg, tuple(ramp))
        self._rebuild(controlnet=load.instantiate(
            build, self.pipe.unet.config, sd, w.device, w.dtype))
        log.info('controlnet loaded from %s', path)

    def load_ip_adapter(self, path: str,
                        image_encoder_dir: Optional[str] = None,
                        vision_config: Optional[CLIPVisionConfig] = None
                        ) -> None:
        """Load an official IP-Adapter checkpoint (base or Plus, detected
        from its keys; ``models/ip_adapter.py``) and rebuild the pipeline
        around a UNet with its per-layer projections. Generate with
        ``gen(ip_image=<PIL image>, ip_scale=...)`` when
        ``image_encoder_dir`` holds the adapter's image-encoder snapshot
        (OpenCLIP ViT-H for the SD-1.5 adapters, or ``vision_config``), or
        with a precomputed ``gen(ip_embed=...)`` of the adapter's input kind
        (the CLS-pooled projected embedding for base adapters, the
        penultimate hidden states for Plus ones)."""
        unet, self._ip = attach_ip_adapter(self.pipe, path,
                                           image_encoder_dir, vision_config)
        self._rebuild(unet)

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

    def _run(self, batches: int, guidance, init_image, init_size,
             strength: float, steps: int, debug: bool, fp: str, save: bool,
             mask=None, control_image=None, controlnet_scale: float = 1.0,
             hires_scale: float = 0.0, hires_strength: float = 0.55,
             hires_steps: Optional[int] = None
             ) -> Tuple[List[Image.Image], Image.Image]:
        """Multi-batch sweep (reference ``_run`` utils.py:85-112); in debug
        mode each batch gives one image per recorded step.

        ``hires_scale > 1``: the two-pass hires fix (A1111's 'Latent'
        mode): pass 1 at ``init_size``, its latents upscaled by
        ``hires_scale`` (:func:`upscale_latents`) and refined by an img2img
        pass at ``hires_strength`` (a mask applies to pass 1 only)."""
        hires = bool(hires_scale) and hires_scale > 1.0
        control = dict(control_image=control_image,
                       controlnet_scale=controlnet_scale)

        def sample() -> List[Image.Image]:
            if not hires:
                return self.pipe(guidance, steps=steps, init_image=init_image,
                                 init_size=init_size, strength=strength,
                                 eta=self.eta, generator=self._generator,
                                 debug=debug, mask=mask, **control).images
            lat = self.pipe(guidance, steps=steps, init_image=init_image,
                            init_size=init_size, strength=strength,
                            eta=self.eta, generator=self._generator,
                            mask=mask, output_type='latent', **control).images
            return self.pipe(guidance, steps=hires_steps or steps,
                             init_latents=upscale_latents(lat, hires_scale),
                             strength=hires_strength, eta=self.eta,
                             generator=self._generator, debug=debug,
                             **control).images
        return run_batches(batches, sample, self.output_dir, fp, save)

    @spanned('fd.gen')
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
            control_image: Optional[Image.Image] = None,
            controlnet_scale: float = 1.0,
            ip_embed=None,
            ip_image: Optional[Image.Image] = None,
            ip_scale: float = 1.0,
            long_prompt: bool = False,
            weighted: bool = False,
            hires_scale: float = 0.0,
            hires_strength: float = 0.55,
            hires_steps: Optional[int] = None,
            cfg_interval: Optional[Tuple[float, float]] = None,
            guidance_rescale: float = 0.0,
            pag_scale: float = 0.0) -> Tuple[List[Image.Image], Image.Image]:
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
        :meth:`enable_pag` (('mid',) on first use; 0: off).
        ``control_image`` (after :meth:`load_controlnet`): the ControlNet's
        conditioning image, weighed by ``controlnet_scale``. ``ip_image``
        or a precomputed ``ip_embed`` (after :meth:`load_ip_adapter`): the
        image prompt, weighed by ``ip_scale``."""
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

        seed_generator(self._generator, seed)
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
        features.update(ip_fields(self._ip, ip_embed, ip_image, ip_scale))
        guidance = SimpleGuidance(embeddings=embeds, uncond=uncond,
                                  guidance_scale=float(guidance_scale),
                                  cfg=guidance_scale > 1.0, **features)
        with self.timer.phase('generate'):
            return self._run(samples, guidance, init_image, init_size,
                             strength, steps, debug, fp, save, mask=mask,
                             control_image=control_image,
                             controlnet_scale=controlnet_scale,
                             hires_scale=hires_scale,
                             hires_strength=hires_strength,
                             hires_steps=hires_steps)

    def edit(self,
             prompt: str,
             image: Union[Image.Image, np.ndarray],
             steps: int = 20,
             guidance_scale: float = 7.5,
             image_guidance_scale: float = 1.5,
             negative_prompt: str = '',
             samples: int = 1,
             seed: Optional[int] = None,
             save: bool = True,
             debug: bool = False,
             guidance_rescale: float = 0.0
             ) -> Tuple[List[Image.Image], Image.Image]:
        """Instruction-based editing (InstructPix2Pix, Brooks et al. 2023):
        ``prompt`` is the instruction ("make it winter"), ``image`` the
        picture, PIL or a preprocessed ``[-1, 1]`` NHWC array ``[1, H, W,
        3]`` (a bare ``[H, W, 3]`` gains the batch dim). Needs an 8-channel
        UNet. The image's VAE posterior mean, unscaled, conditions every
        step through the extra input channels; sampling starts from noise
        with dual text/image CFG (:class:`InstructPix2PixGuidance`;
        ``image_guidance_scale`` 1.5 is the published default, higher stays
        closer to the input). Returns ``(images, grid)``."""
        in_ch = self.pipe.unet.config.in_channels
        if in_ch != 8:
            raise ValueError(
                'edit() needs an 8-channel InstructPix2Pix UNet; this '
                f'pipeline has {in_ch} input channels (point --models at an '
                'instruct-pix2pix snapshot)')
        fp = (f'edit_st{steps}_gs{int(guidance_scale)}'
              f'_igs{_i100(image_guidance_scale)}')
        if guidance_rescale:
            fp += f'_gr{_i100(guidance_rescale)}'
        if seed:
            fp += f'_se{seed}'
        seed_generator(self._generator, seed)
        with self.timer.phase('embeds'):
            embeds = self.encoder.prompt(prompt)
            uncond = self.encoder.prompt(negative_prompt or '')
        if isinstance(image, Image.Image):
            image = preprocess(image)
        pixels = torch.as_tensor(np.asarray(image, np.float32))
        if pixels.ndim == 3:          # unbatched HWC → add the batch dim
            pixels = pixels[None]
        if pixels.ndim != 4 or pixels.shape[-1] != 3:
            raise ValueError(
                'edit() image array must be [1, H, W, 3] (or [H, W, 3]) '
                f'in [-1, 1]; got shape {tuple(pixels.shape)}')
        h, w = pixels.shape[1:3]
        with torch.no_grad():
            # The posterior mean, unscaled: IP2P's conditioning.
            mean, _ = self.pipe.vae.encode(pixels.to(self.pipe.device))
        rescale = dict(rescale=True, guidance_rescale=float(
            guidance_rescale)) if guidance_rescale else {}
        guidance = InstructPix2PixGuidance(
            embeddings=embeds, uncond=uncond, image_latents=mean,
            guidance_scale=float(guidance_scale),
            image_guidance_scale=float(image_guidance_scale), **rescale)
        with self.timer.phase('generate'):
            return self._run(samples, guidance, None, (h, w), 1.0, steps,
                             debug, fp, save)

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
        seed_generator(self._generator, seed)

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
