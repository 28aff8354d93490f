"""Schema encoding: prompts → embedding stacks + latent-space masks (port of
``flexdiffuse_tpu/composition/embeds.py``; reference composition/embeds.py:
28-44).

The schema encodes straight into a :class:`CompositeGuidance` (stacked
entity embeddings, precomputed masks, blend vector). The style
interpolation is the documented intent (start→end over normalized progress,
blended into the background embedding each step) behind
``style_strength``; 0 keeps the reference's effective behaviour, which
computed the style embedding but never fed it to the UNet.
"""
from __future__ import annotations

from typing import Tuple

import torch

from flexdiffuse_tpu_torch.composition.schema import Schema
from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                   entity_masks)


def px_to_block(px: Tuple[int, int], scale: int = 8) -> Tuple[int, int]:
    """Pixel → latent-block coordinates (reference composition/embeds.py:
    28-29)."""
    return tuple(p // scale for p in px)


def encode_schema(schema: Schema, encoder, latent_hw: Tuple[int, int],
                  guidance_scale: float, cfg: bool = True,
                  style_strength: float = 0.0,
                  scale: int = 8) -> CompositeGuidance:
    """Encode a composition schema into a :class:`CompositeGuidance` on the
    encoder's device.

    Args:
        schema: the composition description.
        encoder: CLIP encoder (``prompt(str) -> [1, T, D]``).
        latent_hw: latent grid size ``(h, w)`` (pixels // ``scale``).
        guidance_scale: CFG scale.
        cfg: enable classifier-free guidance (reference gates on scale > 1).
    """
    bg = encoder.prompt(schema.background_prompt)
    uncond = encoder.prompt('')
    t, d = bg.shape[1], bg.shape[2]
    if schema.entities:
        ents = torch.cat([encoder.prompt(e.prompt) for e in schema.entities])
        rects = [(px_to_block(e.offset, scale), px_to_block(e.size, scale))
                 for e in schema.entities]
        blends = torch.tensor([e.blend for e in schema.entities],
                              dtype=torch.float32)
    else:
        ents = torch.zeros((0, t, d), dtype=bg.dtype, device=bg.device)
        rects = []
        blends = torch.zeros((0,), dtype=torch.float32)
    masks = entity_masks(rects, latent_hw).to(bg.device)
    style_kwargs = {}
    if style_strength and (schema.style_start_prompt
                           or schema.style_end_prompt):
        style_kwargs = dict(
            style_start=encoder.prompt(schema.style_start_prompt),
            style_end=encoder.prompt(schema.style_end_prompt),
            style_range=torch.tensor(schema.style_blend, dtype=torch.float32),
            style_strength=torch.tensor(style_strength, dtype=torch.float32))
    return CompositeGuidance(background=bg, entities=ents, masks=masks,
                             blends=blends, uncond=uncond,
                             guidance_scale=float(guidance_scale), cfg=cfg,
                             **style_kwargs)
