"""SDXL backbone assembly: dual text encoders, text-time conditioning,
loading (port of ``flexdiffuse_tpu/models/sdxl.py``).

The building blocks are the port's general ones: :class:`UNet2DCondition`
with ``SDXL_UNET`` geometry (2,567,463,684 parameters) or the refiner's, the
same :class:`AutoencoderKL` (SDXL's latent scaling 0.13025), and
:class:`CLIPTextModel` in its 'penultimate' and 'penultimate_and_pooled'
outputs.

Conditioning (stabilityai/stable-diffusion-xl-base-1.0's layout):

* context = concat(encoder-1 penultimate ``[77, 768]``, encoder-2
  penultimate ``[77, 1280]``) → ``[77, 2048]``;
* added cond = encoder-2's pooled projection ``[1280]`` and the time ids
  ``[orig_h, orig_w, crop_top, crop_left, target_h, target_w]`` (the
  refiner: bigG only, and an aesthetic score in place of the target size).

FlexDiffuse image guidance tweens CLIP-L image patches into the encoder-1
(768-wide) half of the context and leaves the bigG half as it is.
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple, Union

import torch

from flexdiffuse_tpu_torch.models.clip import CLIPTextModel
from flexdiffuse_tpu_torch.models.configs import (CLIP_VIT_L14_TEXT,
                                                  OPENCLIP_BIGG_TEXT,
                                                  SDXL_REFINER_UNET,
                                                  SDXL_UNET, SDXL_VAE)
from flexdiffuse_tpu_torch.utils.profiling import spanned

SDXL_LATENT_SCALE = 0.13025
# SDXL's second tokenizer pads with '!' (id 0), not EOS.
PAD_ID_2 = 0

Prompt = Union[str, List[str]]


class SDXLTextEncoder:
    """Dual-encoder prompt encoding on the encoders' device: ``encode() ->
    (ctx [B, 77, 2048], pooled [B, 1280])``. Each encode is an
    ``fd.encode`` span, as :class:`~flexdiffuse_tpu_torch.encode.
    CLIPEncoder`'s are."""

    def __init__(self, enc1: CLIPTextModel, enc2: CLIPTextModel,
                 tokenizer) -> None:
        self.enc1 = enc1
        self.enc2 = enc2
        self.tokenizer = tokenizer

    def _ids(self, prompt: Prompt, pad_id=None) -> torch.Tensor:
        device = next(self.enc1.parameters()).device
        return torch.as_tensor(self.tokenizer(prompt, pad_id=pad_id),
                               dtype=torch.long, device=device)

    @spanned('fd.encode')
    @torch.no_grad()
    def encode(self, prompt: Prompt) -> Tuple[torch.Tensor, torch.Tensor]:
        h1 = self.enc1(self._ids(prompt), output='penultimate')
        h2, pooled = self.enc2(self._ids(prompt, PAD_ID_2),
                               output='penultimate_and_pooled')
        return torch.cat([h1, h2.to(h1.dtype)], dim=-1), pooled

    def prompt(self, prompt: Prompt) -> torch.Tensor:
        """The context only (the CLIPEncoder contract)."""
        return self.encode(prompt)[0]

    @spanned('fd.encode')
    @torch.no_grad()
    def encode_l(self, prompt: Prompt) -> torch.Tensor:
        """Encoder-1 (CLIP-L) penultimate states only ``[B, 77, 768]``: the
        space text guides tween in (the bigG half has no comparable guide
        embedding)."""
        return self.enc1(self._ids(prompt), output='penultimate')

    @spanned('fd.encode')
    @torch.no_grad()
    def encode_refiner(self, prompt: Prompt
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The refiner's conditioning, encoder-2 (bigG) only: ``(ctx [B, 77,
        1280], pooled [B, 1280])`` (its UNet has no CLIP-L half)."""
        return self.enc2(self._ids(prompt, PAD_ID_2),
                         output='penultimate_and_pooled')


def time_ids(original_size: Tuple[int, int] = (1024, 1024),
             crop: Tuple[int, int] = (0, 0),
             target_size: Tuple[int, int] = (1024, 1024)) -> torch.Tensor:
    """SDXL's micro-conditioning ids ``[1, 6]`` fp32 (host)."""
    return torch.tensor([[*original_size, *crop, *target_size]],
                        dtype=torch.float32)


def refiner_time_ids(original_size: Tuple[int, int] = (1024, 1024),
                     crop: Tuple[int, int] = (0, 0),
                     aesthetic_score: float = 6.0) -> torch.Tensor:
    """The refiner's ids ``[1, 5]``: the aesthetic score in place of the
    target size (``add_embedding`` input 1280 + 5·256)."""
    return torch.tensor([[*original_size, *crop, aesthetic_score]],
                        dtype=torch.float32)


def sdxl_refiner_guidance(encoder: SDXLTextEncoder, prompt: Prompt,
                          negative_prompt: str = '',
                          guidance_scale: float = 5.0,
                          size: Tuple[int, int] = (1024, 1024),
                          aesthetic_score: float = 6.0,
                          negative_aesthetic_score: float = 2.5):
    """:class:`SimpleGuidance` for the refiner UNet: bigG-only context and
    pooled embedding, aesthetic-score time ids (stabilityai's defaults 6.0
    and 2.5 for the two CFG halves)."""
    from flexdiffuse_tpu_torch.pipeline.guides import SimpleGuidance
    ctx, pooled = encoder.encode_refiner(prompt)
    unc_ctx, unc_pooled = encoder.encode_refiner(negative_prompt or '')
    return SimpleGuidance(
        embeddings=ctx, uncond=unc_ctx[:1],
        guidance_scale=float(guidance_scale),
        pooled=pooled, uncond_pooled=unc_pooled[:1],
        time_ids=refiner_time_ids(size, (0, 0), aesthetic_score),
        uncond_time_ids=refiner_time_ids(size, (0, 0),
                                         negative_aesthetic_score),
        cfg=guidance_scale > 1.0)


def sdxl_guidance(encoder: SDXLTextEncoder, prompt: Prompt,
                  negative_prompt: str = '', guidance_scale: float = 5.0,
                  size: Tuple[int, int] = (1024, 1024),
                  embeddings: Optional[torch.Tensor] = None):
    """:class:`SimpleGuidance` for the SDXL UNet. ``embeddings`` may replace
    the context (a tweened ``[B, 77, 2048]`` stack); the pooled embeddings
    still come from the prompts."""
    from flexdiffuse_tpu_torch.pipeline.guides import SimpleGuidance
    ctx, pooled = encoder.encode(prompt)
    if embeddings is not None:
        ctx = embeddings
    unc_ctx, unc_pooled = encoder.encode(negative_prompt or '')
    return SimpleGuidance(
        embeddings=ctx, uncond=unc_ctx[:1],
        guidance_scale=float(guidance_scale),
        pooled=pooled, uncond_pooled=unc_pooled[:1],
        time_ids=time_ids(size, (0, 0), size),
        cfg=guidance_scale > 1.0)


def encode_schema_sdxl(schema, encoder: SDXLTextEncoder,
                       latent_hw: Tuple[int, int], guidance_scale: float,
                       size: Tuple[int, int] = (1024, 1024),
                       cfg: bool = True, style_strength: float = 0.0,
                       scale: int = 8):
    """A composition :class:`~flexdiffuse_tpu_torch.composition.Schema`
    encoded for the SDXL backbone: dual-encoder contexts per row and the
    per-row pooled embeddings (:func:`~flexdiffuse_tpu_torch.composition.
    encode_schema` without pooled rows is the SD-1.x twin; keep the two in
    step)."""
    from flexdiffuse_tpu_torch.composition.embeds import px_to_block
    from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                       entity_masks)
    bg_ctx, bg_pooled = encoder.encode(schema.background_prompt)
    unc_ctx, unc_pooled = encoder.encode('')
    t, d = bg_ctx.shape[1], bg_ctx.shape[2]
    if schema.entities:
        pairs = [encoder.encode(e.prompt) for e in schema.entities]
        ents = torch.cat([p[0] for p in pairs])
        ent_pooled = torch.cat([p[1] for p in pairs])
        rects = [(px_to_block(e.offset, scale), px_to_block(e.size, scale))
                 for e in schema.entities]
        blends = torch.tensor([e.blend for e in schema.entities],
                              dtype=torch.float32)
    else:
        ents = bg_ctx.new_zeros((0, t, d))
        ent_pooled = bg_pooled.new_zeros((0, bg_pooled.shape[-1]))
        rects = []
        blends = torch.zeros((0,), dtype=torch.float32)
    style_kwargs = {}
    if style_strength and (schema.style_start_prompt
                           or schema.style_end_prompt):
        style_kwargs = dict(
            style_start=encoder.encode(schema.style_start_prompt)[0],
            style_end=encoder.encode(schema.style_end_prompt)[0],
            style_range=torch.tensor(schema.style_blend, dtype=torch.float32),
            style_strength=float(style_strength))
    return CompositeGuidance(
        background=bg_ctx, entities=ents,
        masks=entity_masks(rects, latent_hw).to(bg_ctx.device),
        blends=blends, uncond=unc_ctx,
        guidance_scale=float(guidance_scale),
        pooled_stack=torch.cat([bg_pooled, ent_pooled]),
        uncond_pooled=unc_pooled, time_ids=time_ids(size, (0, 0), size),
        cfg=cfg, **style_kwargs)


def tween_sdxl_context(tweener, ctx: torch.Tensor,
                       patch_embeddings: torch.Tensor,
                       l_dim: int = 768) -> torch.Tensor:
    """FlexDiffuse image-guidance tweening of the CLIP-L half of an SDXL
    context (the ``l_dim``-wide slice the patch embeddings compare with);
    the bigG half is left as it is. A batched context tweens each row on
    its own."""
    l_half = ctx[..., :l_dim]
    if ctx.dim() == 3:
        blended = torch.stack([tweener.tween(l_half[i], patch_embeddings)
                               for i in range(ctx.shape[0])])
    else:
        blended = tweener.tween(l_half, patch_embeddings)
    out = ctx.clone()
    out[..., :l_dim] = blended.to(ctx.dtype)
    return out


def load_sdxl(model_dir: str, device='cuda', dtype=torch.bfloat16,
              unet_config=SDXL_UNET, vae_config=SDXL_VAE,
              te1_config=CLIP_VIT_L14_TEXT, te2_config=OPENCLIP_BIGG_TEXT):
    """An ``stable-diffusion-xl-base-1.0`` snapshot directory → ``(unet, vae,
    text_encoder)`` in ``dtype`` on ``device``, for ``FlexPipeline(...,
    latent_scale=SDXL_LATENT_SCALE)``. The config overrides serve tiny
    snapshots of the same layout."""
    from flexdiffuse_tpu_torch.models.unet import UNet2DCondition
    from flexdiffuse_tpu_torch.models.vae import AutoencoderKL
    from flexdiffuse_tpu_torch.text.tokenizer import CLIPTokenizer
    from flexdiffuse_tpu_torch.weights import load

    unet_sd, vae_sd, te1_sd, te2_sd = load.load_sdxl(
        model_dir, projection=bool(te2_config.projection_dim))
    build = lambda cls, cfg, sd: load.instantiate(cls, cfg, sd, device,
                                                  dtype)
    unet = build(UNet2DCondition, unet_config, unet_sd)
    vae = build(AutoencoderKL, vae_config, vae_sd)
    text = SDXLTextEncoder(build(CLIPTextModel, te1_config, te1_sd),
                           build(CLIPTextModel, te2_config, te2_sd),
                           CLIPTokenizer.from_dir(model_dir))
    return unet, vae, text


def load_sdxl_refiner(model_dir: str, device='cuda', dtype=torch.bfloat16,
                      unet_config=SDXL_REFINER_UNET):
    """The UNet of a ``stable-diffusion-xl-refiner-1.0`` snapshot (the
    refiner shares the base's VAE and bigG encoder, the same weights in both
    repositories)."""
    from flexdiffuse_tpu_torch.models.unet import UNet2DCondition
    from flexdiffuse_tpu_torch.weights import convert, load
    sd = convert.normalize(load.load_state_dict(os.path.join(model_dir,
                                                             'unet')),
                           'unet')
    return load.instantiate(UNet2DCondition, unet_config, sd, device, dtype)
