"""SDXLRunner — generation with the SDXL family (port of
``flexdiffuse_tpu/sdxl_runner.py``).

:class:`~flexdiffuse_tpu_torch.runner.Runner`'s surface for SDXL: prompt and
negative prompt, FlexDiffuse guidance (a guide image's CLIP-L patches, or a
guide text's CLIP-L states, tween into the CLIP-L half of the dual-encoder
context), seeds, provenance file names and grids, the optional refiner
stage (base → refiner on the latents, no VAE round trip), the sampling
toggles (DeepCache, ToMe, PAG on the base stage), SGM-named LoRAs and
SDXL IP-Adapters. Regional composition is SD-1.x only, as in the JAX
package.

Image guidance needs the CLIP ViT-L/14 vision tower, which the SDXL
snapshot does not ship: pass ``clip_root`` (an ``openai/clip-vit-large-
patch14`` snapshot).

The models load onto the CUDA card in bf16 unless ``device='cpu'`` is
given (raising when there is no card), and one seeded ``torch.Generator``
on the UNet's device draws every batch's noise in turn (a JAX key gives
other numbers; the tests hand both packages the same noise through the
pipelines' ``noise=``).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import torch
from PIL import Image

from flexdiffuse_tpu_torch.config import GuidanceParams
from flexdiffuse_tpu_torch.guidance.tween import Tweener
from flexdiffuse_tpu_torch.models.clip import CLIPVisionModel
from flexdiffuse_tpu_torch.models.configs import (CLIP_VIT_L14_VISION,
                                                  OPENCLIP_BIGG_VISION,
                                                  OPENCLIP_H_VISION)
from flexdiffuse_tpu_torch.models.sdxl import (SDXL_LATENT_SCALE,
                                               SDXLTextEncoder, load_sdxl,
                                               load_sdxl_refiner,
                                               sdxl_guidance,
                                               sdxl_refiner_guidance,
                                               tween_sdxl_context)
from flexdiffuse_tpu_torch.pipeline import FlexPipeline
from flexdiffuse_tpu_torch.runner import (attach_ip_adapter, ip_fields,
                                          rebuild, run_batches,
                                          seed_generator)
from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
from flexdiffuse_tpu_torch.utils.image import clip_preprocess
from flexdiffuse_tpu_torch.utils.profiling import PhaseTimer, spanned
from flexdiffuse_tpu_torch.weights import convert, load
from flexdiffuse_tpu_torch.weights import lora as _lora

IP_ENCODERS = {'vit-h': OPENCLIP_H_VISION, 'bigg': OPENCLIP_BIGG_VISION}


class SDXLRunner:
    """SDXL base (and optional refiner): from HF snapshots on disk
    (``SDXLRunner(model_root=...)``) or from built modules
    (:meth:`from_models`)."""

    def __init__(self, model_root: str, clip_root: Optional[str] = None,
                 scheduler: str = 'dpmpp',
                 dtype: torch.dtype = torch.bfloat16,
                 output_dir: str = './outputs',
                 refiner_root: Optional[str] = None, refiner_config=None,
                 device: Union[str, torch.device, None] = None,
                 **load_kwargs) -> None:
        """``load_kwargs`` (``unet_config``, ``vae_config``, ``te1_config``,
        ``te2_config``) and ``refiner_config`` override the published
        geometry for snapshots of another size."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    'SDXLRunner runs on the CUDA card by default and none is '
                    "available; pass device='cpu' to run on the CPU")
            device = 'cuda'
        unet, vae, text = load_sdxl(model_root, device=device, dtype=dtype,
                                    **load_kwargs)
        # The refiner (ensemble-of-experts second stage): its own UNet in a
        # pipeline sharing the base VAE; bigG-only conditioning.
        r_unet = None
        if refiner_root:
            rkw = {} if refiner_config is None else {
                'unet_config': refiner_config}
            r_unet = load_sdxl_refiner(refiner_root, device=device,
                                       dtype=dtype, **rkw)
        vision = None
        if clip_root:
            _, vision_sd = load.load_clip(clip_root)
            vision = load.instantiate(CLIPVisionModel, CLIP_VIT_L14_VISION,
                                      vision_sd, device, dtype)
        self._init(unet, vae, text, vision, scheduler, None, output_dir,
                   r_unet)
        # The stored weights apply_lora merges from (mapped safetensors
        # files only).
        files = {t: load.weights_file(os.path.join(model_root, sub))
                 for t, sub in (('unet', 'unet'), ('te', 'text_encoder'),
                                ('te2', 'text_encoder_2'))}
        self._snapshots = {t: f for t, f in files.items()
                           if f.endswith('.safetensors')}

    @classmethod
    def from_models(cls, unet, vae, text_encoder: SDXLTextEncoder,
                    vision_model=None, scheduler: str = 'dpmpp',
                    scheduler_config: Optional[SchedulerConfig] = None,
                    output_dir: str = './outputs',
                    refiner_unet=None) -> 'SDXLRunner':
        """Build from modules that already hold their weights (on the
        device, in the dtype they should run in): the base UNet, the VAE,
        an :class:`SDXLTextEncoder` over the two text towers, optionally
        the CLIP ViT-L/14 vision tower (image guides) and the refiner's
        UNet. ``scheduler``: a kind of :mod:`~flexdiffuse_tpu_torch.
        schedulers`; ``scheduler_config`` its training schedule and
        switches. ``apply_lora`` then merges from the loaded weights (there
        is no snapshot to read the stored ones from)."""
        self = cls.__new__(cls)
        self._init(unet, vae, text_encoder, vision_model, scheduler,
                   scheduler_config, output_dir, refiner_unet)
        self._snapshots = {}
        return self

    def _init(self, unet, vae, text: SDXLTextEncoder, vision_model,
              scheduler: str, scheduler_config: Optional[SchedulerConfig],
              output_dir: str, refiner_unet=None) -> None:
        self.text = text
        # The width of the encoder-1 (CLIP-L) slice of the context: the
        # half that guides tween.
        self._l_dim = text.enc1.config.hidden_size
        self._unet_config = unet.config
        self.pipe = FlexPipeline(unet, vae, scheduler=scheduler,
                                 scheduler_config=scheduler_config,
                                 latent_scale=SDXL_LATENT_SCALE)
        self.refiner_pipe = None
        if refiner_unet is not None:
            self.refiner_pipe = FlexPipeline(
                refiner_unet, vae, scheduler=scheduler,
                scheduler_config=scheduler_config,
                latent_scale=SDXL_LATENT_SCALE)
        self.vision = vision_model
        self.output_dir = output_dir
        self._generator = torch.Generator(self.pipe.device)
        self._ip = None
        self.timer = PhaseTimer()
        self._merged: set = set()   # parameters a LoRA has changed

    # ------------------------------------------------------------------
    def enable_deepcache(self, interval: int = 2) -> None:
        """DeepCache for the base (and the refiner, if loaded): the full UNet
        every ``interval``-th step, the shallow level in between (SDXL's
        level 0 has no attention, so its shallow step is cheap)."""
        iv = int(interval)
        self.pipe, self.refiner_pipe = (
            p if p is None or p.deepcache == iv else rebuild(p, deepcache=iv)
            for p in (self.pipe, self.refiner_pipe))

    def disable_deepcache(self) -> None:
        self.enable_deepcache(0)

    def _set_unet(self, refiner: bool = True, **settings) -> None:
        """Rebuild the base (and the refiner's, with ``refiner``) pipeline
        around a copy of its UNet with ``settings``, where they differ."""
        def changed(p):
            if p is None or all(getattr(p.unet, k) == v
                                for k, v in settings.items()):
                return p
            return rebuild(p, p.unet.with_settings(**settings))
        self.pipe = changed(self.pipe)
        if refiner:
            self.refiner_pipe = changed(self.refiner_pipe)

    def enable_tome(self, ratio: float = 0.5, min_seq: int = 4096) -> None:
        """ToMe token merging (``ops/tome.py``) for the base (and the
        refiner): merge ``ratio`` of the tokens before every self-attention
        on a grid of at least ``min_seq`` tokens; at 1024² the default
        reaches only the 4096-token level."""
        if not 0.0 < ratio < 1.0:
            raise ValueError('tome ratio must be in (0, 1)')
        self._set_unet(tome=(float(ratio), int(min_seq)))

    def disable_tome(self) -> None:
        self._set_unet(tome=None)

    def enable_pag(self, layers=('mid',)) -> None:
        """PAG's perturbed layers on the base stage only (the refiner keeps
        plain CFG, as the published SDXL-PAG workflows)."""
        if not layers:
            raise ValueError("pag layers must name at least one "
                             "transformer (e.g. ('mid',))")
        self._set_unet(refiner=False, pag_layers=tuple(layers))

    def disable_pag(self) -> None:
        self._set_unet(refiner=False, pag_layers=None)

    # ------------------------------------------------------------------
    def apply_lora(self, path: str, scale: float = 1.0) -> None:
        """Merge a kohya SDXL LoRA (SGM-named ``lora_unet_*`` and
        ``lora_te1_``/``lora_te2_``) into the loaded weights in place, each
        weight in fp32 and cast once: a weight no LoRA has changed yet is
        merged from the snapshot's stored values (safetensors snapshots), as
        ``Runner.apply_lora`` merges. Repeated calls stack
        (``weights/lora.py``)."""
        def stored(target: str, f: str) -> dict:
            kind = 'unet' if target == 'unet' else 'text'
            return convert.normalize(load.load_state_dict(f), kind,
                                     projection=target == 'te2')
        base = {t: stored(t, f) for t, f in self._snapshots.items()}
        self._merged |= _lora.apply_lora(
            self.pipe.unet, self.text.enc1, load.load_state_dict(path),
            scale=scale, unet_config=self._unet_config, base=base,
            merged=self._merged, text2_model=self.text.enc2)

    def load_ip_adapter(self, path: str, image_encoder_dir: str = None,
                        encoder: str = 'vit-h') -> None:
        """An SDXL IP-Adapter checkpoint (base projection or Plus
        Resampler, told apart by its keys) on the base pipeline. ``encoder``
        is the image tower at ``image_encoder_dir``: 'vit-h' (the ``_vit-h``
        checkpoints) or 'bigg' (the original ``ip-adapter_sdxl.bin``)."""
        unet, self._ip = attach_ip_adapter(self.pipe, path,
                                           image_encoder_dir,
                                           vision_config=IP_ENCODERS[encoder])
        self.pipe = rebuild(self.pipe, unet)

    def compose(self, *args, **kwargs):
        """Regional composition is SD-1.x only (the reference's composition
        predates SDXL); the web UI's Compose tab shows this error."""
        raise ValueError('composition is not supported for the SDXL family '
                         '(use --model-family sd1)')

    # ------------------------------------------------------------------
    def _patches(self, guide: Image.Image) -> torch.Tensor:
        if self.vision is None:
            raise ValueError('image guidance requires clip_root (a CLIP '
                             'ViT-L/14 snapshot)')
        w = next(self.vision.parameters())
        pixels = torch.as_tensor(clip_preprocess(
            guide, self.vision.config.image_size), device=w.device)
        with torch.no_grad():
            return self.vision(pixels)

    # The Runner.gen keywords of the CLI and the web UI → GuidanceParams
    # fields, so the SDXL family sits behind the same entry points.
    _GP_FIELDS = {
        'guide_threshold_mult': 'threshold_mult',
        'guide_threshold_floor': 'threshold_floor',
        'guide_clustered': 'clustered',
        'guide_linear': 'linear',
        'guide_max_guidance': 'max_guidance',
        'guide_header_max': 'header_max',
        'guide_mode': 'mode',
        'guide_reuse': 'reuse',
    }
    _UNSUPPORTED = ('mask', 'control_image', 'mapping_concepts',
                    'long_prompt', 'weighted')

    @spanned('fd.gen')
    def gen(self,
            prompt: Union[str, List[str]] = '',
            negative_prompt: str = '',
            guide: Union[Image.Image, str, None] = None,
            guidance_params: Optional[GuidanceParams] = None,
            init_image: Optional[Image.Image] = None,
            init_size: Tuple[int, int] = (1024, 1024),
            strength: float = 0.6,
            steps: int = 25,
            guidance_scale: float = 5.0,
            samples: int = 1,
            seed: Optional[int] = None,
            save: bool = True,
            debug: bool = False,
            refine_strength: float = 0.3,
            aesthetic_score: float = 6.0,
            negative_aesthetic_score: float = 2.5,
            ip_image: Optional[Image.Image] = None,
            ip_embed=None,
            ip_scale: float = 1.0,
            cfg_interval: Optional[Tuple[float, float]] = None,
            guidance_rescale: float = 0.0,
            pag_scale: float = 0.0,
            **ui_kwargs) -> Tuple[List[Image.Image], Image.Image]:
        """SDXL generation with optional FlexDiffuse guidance; returns
        ``(images, grid)``. Takes ``Runner.gen``'s keywords: the ``guide_*``
        ones build the :class:`GuidanceParams`; the features SDXL does not
        have (inpainting mask, ControlNet, concept mapping, long or
        weighted prompts) raise. A text ``guide`` tweens with its CLIP-L
        states as an image guide does with its patches. With a refiner and
        ``refine_strength > 0`` the base's latents are renoised to that
        level and denoised by the refiner. ``cfg_interval``,
        ``guidance_rescale`` and ``pag_scale`` apply to the base stage, as
        the IP-Adapter's image prompt does."""
        if guidance_params is None:
            gp_kw = {
                self._GP_FIELDS[k]: (tuple(v) if k == 'guide_linear' else v)
                for k, v in ui_kwargs.items() if k in self._GP_FIELDS
            }
            guidance_params = (GuidanceParams(**gp_kw)
                               if gp_kw else GuidanceParams.ui_defaults())
        for k in self._UNSUPPORTED:
            if ui_kwargs.get(k):
                raise ValueError(f'{k} is not supported for the SDXL '
                                 'family yet (SD1.x only)')
        ui_kwargs.pop('controlnet_scale', None)
        unknown = set(ui_kwargs) - set(self._GP_FIELDS) - set(
            self._UNSUPPORTED)
        if unknown:
            raise TypeError(f'unknown gen() arguments: {sorted(unknown)}')
        seed_generator(self._generator, seed)
        with self.timer.phase('embeds'):
            g = sdxl_guidance(self.text, prompt, negative_prompt,
                              guidance_scale, size=init_size)
            if isinstance(guide, str) and not guide.strip():
                guide = None
            if guide is not None:
                alt = (self.text.encode_l(guide)[0] if isinstance(guide, str)
                       else self._patches(guide))
                g = g.replace(embeddings=tween_sdxl_context(
                    Tweener(guidance_params), g.embeddings, alt,
                    l_dim=self._l_dim))
        features = {}
        if cfg_interval is not None:
            # Outside [lo, hi] the base runs cond-only at half the batch; the
            # refiner keeps full CFG (its low-noise tail is where guidance
            # works).
            features.update(cfg_interval=True,
                            cfg_from=float(cfg_interval[0]),
                            cfg_to=float(cfg_interval[1]))
        if guidance_rescale:
            features.update(rescale=True,
                            guidance_rescale=float(guidance_rescale))
        if pag_scale:
            if self.pipe.unet.pag_layers is None:
                self.enable_pag()
            features.update(pag=True, pag_scale=float(pag_scale))
        # The image prompt conditions the base stage; the refiner UNet has
        # no adapter weights (the official SDXL IP-Adapter workflows).
        features.update(ip_fields(self._ip, ip_embed, ip_image, ip_scale,
                                  'SDXLRunner'))
        if features:
            g = g.replace(**features)

        refine = self.refiner_pipe is not None and refine_strength > 0
        g_ref = None
        if refine:
            if debug:
                raise ValueError('debug (per-step decode) is not supported '
                                 'with the refiner stage')
            g_ref = sdxl_refiner_guidance(
                self.text, prompt, negative_prompt, guidance_scale,
                size=init_size, aesthetic_score=aesthetic_score,
                negative_aesthetic_score=negative_aesthetic_score)

        fp = (f'{"xli2i" if init_image is not None else "xlt2i"}'
              f'_st{steps}_gs{int(guidance_scale)}')
        if cfg_interval is not None:
            fp += (f'_ci{int(cfg_interval[0] * 100)}'
                   f'-{int(cfg_interval[1] * 100)}')
        if pag_scale:
            fp += f'_pg{int(pag_scale * 100)}'
        if refine:
            fp += f'_ref{int(refine_strength * 100)}'
        if seed:
            fp += f'_se{seed}'

        def sample() -> List[Image.Image]:
            out = self.pipe(g, steps=steps, init_image=init_image,
                            init_size=init_size, strength=strength,
                            generator=self._generator,
                            output_type='latent' if refine else 'pil')
            if refine:
                # SDEdit-style refinement on the shared latent space.
                out = self.refiner_pipe(g_ref, steps=steps,
                                        init_latents=out.images,
                                        strength=refine_strength,
                                        generator=self._generator)
            return out.images
        with self.timer.phase('generate'):
            return run_batches(samples, sample, self.output_dir, fp, save)
