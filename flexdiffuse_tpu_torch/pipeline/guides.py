"""Guidance strategies (port of ``flexdiffuse_tpu/pipeline/guides.py``).

* :class:`SimpleGuidance`: classifier-free guidance with the batch stacked
  ``[uncond; cond]`` at 2B; ``extra_channels`` carries a 9-channel
  inpainting UNet's mask and masked-image latents.
* :class:`CompositeGuidance`: regional composition. One UNet call denoises
  the latents against the ``[uncond,] background, entities...`` stack; each
  entity's ε is blended into its rectangle of the background's ε in
  declaration order, and CFG runs after the blend.

``noise_pred(noise_fn, latents, t, progress)``: ``progress`` in [0, 1] is the
denoise progress (CompositeGuidance's style interpolation reads it).

Fields of the JAX guides that the port does not take yet raise
``NotImplementedError`` naming the ROADMAP Queue 1 step that ports them:
CFG interval and CFG rescale (step 9), SDXL's pooled embeddings and time ids
(step 11).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import torch

# noise_fn(latents [N,h,w,C], t [N], context [N,T,D]) -> eps [N,h,w,4]
NoiseFn = Callable[..., torch.Tensor]

_UNPORTED_FIELDS = {'cfg_interval': 9, 'rescale': 9, 'pooled': 11,
                    'time_ids': 11}


def _reject_unported(guide) -> None:
    for name, step in _UNPORTED_FIELDS.items():
        value = getattr(guide, name)
        if value is not None and value is not False:
            raise NotImplementedError(
                f'{type(guide).__name__}({name}=...) is not ported yet '
                f'(ROADMAP Queue 1 step {step})')


@dataclasses.dataclass(frozen=True)
class SimpleGuidance:
    """CFG conditioning: ``embeddings [B, T, D]`` tweened prompt embeddings,
    ``uncond [1, T, D]`` empty/negative-prompt embeddings. ``cfg`` follows
    the reference's ``guidance > 1`` gate. ``extra_channels [1 or B, h, w,
    5]`` (mask, masked-image latents) is concatenated onto the UNet input
    every step for a 9-channel inpainting UNet."""

    embeddings: torch.Tensor
    uncond: torch.Tensor
    guidance_scale: float
    cfg: bool = True
    extra_channels: Optional[torch.Tensor] = None
    cfg_interval: bool = False
    rescale: bool = False
    pooled: Optional[torch.Tensor] = None
    time_ids: Optional[torch.Tensor] = None

    def __post_init__(self):
        _reject_unported(self)

    @property
    def batch_size(self) -> int:
        return self.embeddings.shape[0]

    def replace(self, **changes) -> 'SimpleGuidance':
        return dataclasses.replace(self, **changes)

    def _with_extra(self, latents: torch.Tensor) -> torch.Tensor:
        if self.extra_channels is None:
            return latents
        extra = self.extra_channels.expand(
            tuple(latents.shape[:3]) + (self.extra_channels.shape[-1],))
        return torch.cat([latents, extra.to(latents.dtype)], dim=-1)

    def noise_pred(self, noise_fn: NoiseFn, latents: torch.Tensor,
                   t: torch.Tensor, progress=0.0) -> torch.Tensor:
        del progress
        b = self.batch_size
        lat_in = self._with_extra(latents)
        if not self.cfg:
            return noise_fn(lat_in, t.expand(b), self.embeddings)
        dtype = torch.promote_types(self.uncond.dtype, self.embeddings.dtype)
        ctx = torch.cat([self.uncond.expand(self.embeddings.shape).to(dtype),
                         self.embeddings.to(dtype)])
        eps = noise_fn(torch.cat([lat_in, lat_in]), t.expand(2 * b), ctx)
        eps_u, eps_c = eps.chunk(2)
        return eps_u + self.guidance_scale * (eps_c - eps_u)


def entity_masks(entities: Sequence[Tuple[Tuple[int, int], Tuple[int, int]]],
                 latent_hw: Tuple[int, int]) -> torch.Tensor:
    """Rect masks ``[E, h, w, 1]`` fp32 from ``((ox, oy), (sx, sy))`` pairs
    in latent blocks (:func:`~flexdiffuse_tpu_torch.composition.px_to_block`
    converts pixels)."""
    h, w = latent_hw
    masks = torch.zeros((len(entities), h, w, 1), dtype=torch.float32)
    for m, ((ox, oy), (sx, sy)) in zip(masks, entities):
        m[oy:oy + sy, ox:ox + sx] = 1.0
    return masks


@dataclasses.dataclass(frozen=True)
class CompositeGuidance:
    """Regional composition conditioning (reference composition/guide.py
    semantics). ``background [1, T, D]``, ``entities [E, T, D]``, ``masks
    [E, h, w, 1]`` (on the latents' device), ``blends [E]`` per-entity
    strengths, ``uncond [1, T, D]``. ``style_start``/``style_end`` ``[1, T,
    D]`` with ``style_range`` ``[2]`` (the blend at progress 0 and 1) move
    the background toward the interpolated style by ``style_strength`` (the
    documented intent the reference never fed to its UNet; 0 keeps the
    reference's behaviour)."""

    background: torch.Tensor
    entities: torch.Tensor
    masks: torch.Tensor
    blends: torch.Tensor
    uncond: torch.Tensor
    guidance_scale: float
    style_start: Optional[torch.Tensor] = None
    style_end: Optional[torch.Tensor] = None
    style_range: Optional[torch.Tensor] = None
    style_strength: float = 0.0
    cfg: bool = True
    cfg_interval: bool = False
    rescale: bool = False
    pooled: Optional[torch.Tensor] = None
    time_ids: Optional[torch.Tensor] = None

    def __post_init__(self):
        _reject_unported(self)

    @property
    def batch_size(self) -> int:
        return 1

    @property
    def num_entities(self) -> int:
        return self.entities.shape[0]

    def replace(self, **changes) -> 'CompositeGuidance':
        return dataclasses.replace(self, **changes)

    def noise_pred(self, noise_fn: NoiseFn, latents: torch.Tensor,
                   t: torch.Tensor, progress=0.0) -> torch.Tensor:
        background = self.background
        if self.style_start is not None:
            lo, hi = self.style_range[0], self.style_range[1]
            mix = lo + progress * (hi - lo)
            style = self.style_start + (self.style_end -
                                        self.style_start) * mix
            background = background + self.style_strength * (style -
                                                             background)
        stack = [background, self.entities]
        if self.cfg:
            stack = [self.uncond] + stack
        dtype = stack[0].dtype
        for s in stack[1:]:
            dtype = torch.promote_types(dtype, s.dtype)
        ctx = torch.cat([s.to(dtype) for s in stack])    # [(cfg)+1+E, T, D]
        n = ctx.shape[0]
        # Each latent row denoises against the whole stack, row-major
        # [b0·ctx0..b0·ctxN, b1·ctx0, ...], in one UNet call.
        b = latents.shape[0]
        lat = latents.repeat_interleave(n, dim=0)
        eps = noise_fn(lat, t.expand(b * n), ctx.repeat(b, 1, 1))
        eps = eps.reshape((b, n) + tuple(eps.shape[1:]))

        off = 1 if self.cfg else 0
        bg = eps[:, off]
        # Sequential blends: declaration order decides overlapping rects.
        for i in range(self.num_entities):
            ent = eps[:, off + 1 + i]
            m = self.masks[i][None]
            bg = bg + m * self.blends[i] * (ent - bg)
        if self.cfg:
            uncond = eps[:, 0]
            bg = uncond + self.guidance_scale * (bg - uncond)
        return bg
