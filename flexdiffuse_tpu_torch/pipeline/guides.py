"""Guidance strategies (port of ``flexdiffuse_tpu/pipeline/guides.py``).

* :class:`SimpleGuidance`: classifier-free guidance with the batch stacked
  ``[uncond; cond]`` at 2B; ``extra_channels`` carries a 9-channel
  inpainting UNet's mask and masked-image latents; ``ip_tokens`` an
  IP-Adapter's image tokens, whose rows follow the CFG rows (the uncond
  rows take ``ip_uncond``).
* :class:`InstructPix2PixGuidance`: an 8-channel edit UNet's dual text and
  image CFG, 3 rows per sample in one UNet call.
* :func:`prompt_guidance`: CFG guidance straight from a prompt.
* :class:`CompositeGuidance`: regional composition. One UNet call denoises
  the latents against the ``[uncond,] background, entities...`` stack; each
  entity's ε is blended into its rectangle of the background's ε in
  declaration order, and CFG runs after the blend.

``noise_pred(noise_fn, latents, t, progress)``: ``progress`` in [0, 1] is the
denoise progress (CompositeGuidance's style interpolation reads it).

Both take the JAX guides' sampling fields:

- CFG interval (Kynkäänniemi et al. 2024): with ``cfg_interval`` the
  pipeline runs CFG only for progress in ``[cfg_from, cfg_to]`` and, outside,
  the guide with ``cfg=False`` (the UNet at batch B, not 2B);
- CFG rescale (Lin et al. 2023): with ``rescale``, :func:`rescale_cfg` pulls
  the guided ε toward the cond ε's per-sample std by ``guidance_rescale``;
- PAG (Ahn et al. 2024, SimpleGuidance): with ``pag`` one more cond row per
  sample runs with identity self-attention in the UNet's ``pag_layers``
  (the ``pag_mask`` row selector), and ε gains ``pag_scale·(ε_cond −
  ε_perturbed)``;
- ``timestep_cond``: the LCM guidance embedding, passed to the UNet;
- SDXL's text-time conditioning: ``pooled`` (``pooled_stack`` on the
  composite) and ``time_ids`` become the UNet's ``added_cond`` rows, laid
  out beside the context rows as the JAX guides lay them (``_added``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

# noise_fn(latents [N,h,w,C], t [N], context [N,T,D]) -> eps [N,h,w,4]
NoiseFn = Callable[..., torch.Tensor]


def rescale_cfg(eps_cfg: torch.Tensor, eps_cond: torch.Tensor,
                phi) -> torch.Tensor:
    """CFG rescale (Lin et al. 2023, §3.4): scale the guided ε toward the
    cond ε's per-sample std (population std over every axis but the
    batch) and lerp by ``phi``. Under sequence parallelism ε is whole on
    every rank (the UNet gathers it)."""
    dims = tuple(range(1, eps_cfg.ndim))
    std = lambda x: torch.std(x, dim=dims, keepdim=True, correction=0)
    rescaled = eps_cfg * (std(eps_cond) / (std(eps_cfg) + 1e-8))
    return phi * rescaled + (1.0 - phi) * eps_cfg


def _check_rescale_gate(guide) -> None:
    """A nonzero ``guidance_rescale`` with the ``rescale`` flag off would
    never apply: refuse it, as the JAX guides do."""
    if not guide.rescale and float(guide.guidance_rescale) != 0.0:
        raise ValueError(
            'guidance_rescale is set but the static rescale flag is off — '
            'it would silently never apply. Pass rescale=True alongside '
            'guidance_rescale (runner-level APIs do this automatically).')


def _scale(value, device):
    return value.to(device) if isinstance(value, torch.Tensor) else value


def _call(noise_fn: NoiseFn, lat, t, ctx, timestep_cond=None,
          pag_mask=None, ip=None, added=None) -> torch.Tensor:
    """``noise_fn`` with the optional UNet inputs only when they are set
    (``ip``: ``(ip_ctx, ip_scale)``; ``added``: SDXL's ``added_cond``)."""
    kw = {}
    if added is not None:
        kw['added_cond'] = added
    if timestep_cond is not None:
        kw['timestep_cond'] = timestep_cond
    if pag_mask is not None:
        kw['pag_mask'] = pag_mask
    if ip is not None:
        kw['ip_ctx'], kw['ip_scale'] = ip
    return noise_fn(lat, t, ctx, **kw)


@dataclasses.dataclass(frozen=True)
class SimpleGuidance:
    """CFG conditioning: ``embeddings [B, T, D]`` tweened prompt embeddings,
    ``uncond [1 or B, T, D]`` empty/negative-prompt embeddings (one row for
    all, or one per row). ``guidance_scale``: a float, or a per-row fp32
    tensor ``[B, 1, 1, 1]`` (the serving path fuses requests with their own
    scales). ``cfg`` follows the reference's ``guidance > 1`` gate.
    ``extra_channels [1 or B, h, w, 5]`` (mask, masked-image latents) is
    concatenated onto the UNet input every step for a 9-channel inpainting
    UNet. ``timestep_cond [1, time_cond_proj_dim]`` is the LCM guidance
    embedding (then ``cfg`` is False). ``ip_tokens [1 or B, N, D]``: an
    IP-Adapter's projected image tokens at ``ip_scale``; the uncond rows
    take ``ip_uncond`` (zeros when None). SDXL: ``pooled [1 or B, P]``
    and ``uncond_pooled [1, P]`` (the second encoder's pooled projections),
    ``time_ids [1, n]`` and, for the refiner's CFG, ``uncond_time_ids [1,
    n]`` (its own aesthetic score; None: ``time_ids``). The CFG interval,
    CFG rescale and PAG fields are the module docstring's."""

    embeddings: torch.Tensor
    uncond: torch.Tensor
    guidance_scale: Union[float, torch.Tensor]
    cfg: bool = True
    extra_channels: Optional[torch.Tensor] = None
    timestep_cond: Optional[torch.Tensor] = None
    cfg_from: float = 0.0
    cfg_to: float = 1.0
    cfg_interval: bool = False
    guidance_rescale: float = 0.0
    rescale: bool = False
    pag_scale: float = 0.0
    pag: bool = False
    ip_tokens: Optional[torch.Tensor] = None
    ip_uncond: Optional[torch.Tensor] = None
    ip_scale: Union[float, torch.Tensor] = 1.0
    pooled: Optional[torch.Tensor] = None
    uncond_pooled: Optional[torch.Tensor] = None
    time_ids: Optional[torch.Tensor] = None
    uncond_time_ids: Optional[torch.Tensor] = None

    def __post_init__(self):
        _check_rescale_gate(self)

    @property
    def batch_size(self) -> int:
        return self.embeddings.shape[0]

    def _added(self, n: int, with_uncond: bool, cond_copies: int = 1):
        """SDXL's ``added_cond`` for a UNet call of ``n`` rows laid out as
        the context rows: ``[uncond;] cond × cond_copies``; None without
        ``pooled``."""
        if self.pooled is None:
            return None
        b = self.batch_size
        width = self.pooled.shape[1:]
        pooled = torch.cat([self.pooled.expand((b,) + width)] * cond_copies)
        if with_uncond:
            unc = self.uncond_pooled.expand((b,) + width).to(pooled)
            pooled = torch.cat([unc, pooled])
        k = self.time_ids.shape[-1]
        if with_uncond and self.uncond_time_ids is not None:
            tids = torch.cat([self.uncond_time_ids.expand(b, k),
                              self.time_ids.expand(b * cond_copies, k)])
        else:
            tids = self.time_ids.expand(n, k)
        return {'text_embeds': pooled, 'time_ids': tids}

    def _ip(self, with_uncond: bool, cond_copies: int = 1):
        """The IP-Adapter rows beside the CFG rows: ``(ip_ctx,
        ip_scale)``, or None without image tokens."""
        if self.ip_tokens is None:
            return None
        shape = (self.batch_size,) + tuple(self.ip_tokens.shape[1:])
        cond = torch.cat([self.ip_tokens.expand(shape)] * cond_copies)
        if with_uncond:
            unc = (self.ip_uncond.expand(shape).to(cond.dtype)
                   if self.ip_uncond is not None else
                   torch.zeros(shape, dtype=cond.dtype, device=cond.device))
            cond = torch.cat([unc, cond])
        return cond, self.ip_scale

    def replace(self, **changes) -> 'SimpleGuidance':
        return dataclasses.replace(self, **changes)

    def _with_extra(self, latents: torch.Tensor) -> torch.Tensor:
        if self.extra_channels is None:
            return latents
        extra = self.extra_channels.expand(
            tuple(latents.shape[:3]) + (self.extra_channels.shape[-1],))
        return torch.cat([latents, extra.to(latents.dtype)], dim=-1)

    def _tcond(self, n: int):
        if self.timestep_cond is None:
            return None
        return self.timestep_cond.expand((n,) +
                                         tuple(self.timestep_cond.shape[1:]))

    def _uncond_ctx(self) -> torch.Tensor:
        dtype = torch.promote_types(self.uncond.dtype, self.embeddings.dtype)
        return self.uncond.expand(self.embeddings.shape).to(dtype), dtype

    def _finish(self, out, eps_c):
        if self.rescale:
            out = rescale_cfg(out, eps_c, self.guidance_rescale)
        return out

    def noise_pred(self, noise_fn: NoiseFn, latents: torch.Tensor,
                   t: torch.Tensor, progress=0.0) -> torch.Tensor:
        del progress
        b = self.batch_size
        lat_in = self._with_extra(latents)
        if self.pag:
            return self._noise_pred_pag(noise_fn, lat_in, t)
        if not self.cfg:
            return _call(noise_fn, lat_in, t.expand(b), self.embeddings,
                         self._tcond(b), ip=self._ip(False),
                         added=self._added(b, False))
        unc, dtype = self._uncond_ctx()
        ctx = torch.cat([unc, self.embeddings.to(dtype)])
        eps = _call(noise_fn, torch.cat([lat_in, lat_in]), t.expand(2 * b),
                    ctx, self._tcond(2 * b), ip=self._ip(True),
                    added=self._added(2 * b, True))
        eps_u, eps_c = eps.chunk(2)
        scale = _scale(self.guidance_scale, eps.device)
        return self._finish(eps_u + scale * (eps_c - eps_u), eps_c)

    def _noise_pred_pag(self, noise_fn: NoiseFn, lat_in: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
        """PAG: ``[uncond; cond; perturbed]`` at 3B under CFG (the published
        PAG+CFG combination), ``[cond; perturbed]`` at 2B without; the
        perturbed rows are the ``pag_mask`` ones."""
        b = self.batch_size
        unc, dtype = self._uncond_ctx()
        cond = self.embeddings.to(dtype)
        rows = 3 if self.cfg else 2
        ctx = torch.cat(([unc] if self.cfg else []) + [cond, cond])
        mask = torch.cat([torch.zeros(((rows - 1) * b,)), torch.ones((b,))])
        eps = _call(noise_fn, torch.cat([lat_in] * rows),
                    t.expand(rows * b), ctx, self._tcond(rows * b),
                    pag_mask=mask.to(lat_in.device),
                    ip=self._ip(self.cfg, cond_copies=2),
                    added=self._added(rows * b, self.cfg, cond_copies=2))
        pag = _scale(self.pag_scale, eps.device)
        if self.cfg:
            eps_u, eps_c, eps_p = eps.chunk(3)
            scale = _scale(self.guidance_scale, eps.device)
            out = (eps_u + scale * (eps_c - eps_u) + pag * (eps_c - eps_p))
        else:
            eps_c, eps_p = eps.chunk(2)
            out = eps_c + pag * (eps_c - eps_p)
        return self._finish(out, eps_c)


@dataclasses.dataclass(frozen=True)
class InstructPix2PixGuidance:
    """Dual text and image CFG for InstructPix2Pix (Brooks et al. 2023):
    an 8-channel UNet conditioned on the input image's latents as extra
    input channels. Three rows per sample ride one UNet call, ``[uncond
    text, zero image; uncond text, image; text, image]``, combined as
    ``eps_u + s_img·(eps_i − eps_u) + s_txt·(eps_f − eps_i)``.

    ``embeddings [B, T, D]`` (the edit instruction), ``uncond [1 or B, T,
    D]``, ``image_latents [1 or B, h, w, 4]``: the VAE posterior mean,
    unscaled (as the published checkpoints were trained), and not scaled by
    the scheduler's input scaling either. ``guidance_scale`` is s_txt,
    ``image_guidance_scale`` s_img; ``rescale``/``guidance_rescale`` as
    :class:`SimpleGuidance`'s (toward the full row's std)."""

    embeddings: torch.Tensor
    uncond: torch.Tensor
    image_latents: torch.Tensor
    guidance_scale: float
    image_guidance_scale: float
    guidance_rescale: float = 0.0
    rescale: bool = False

    def __post_init__(self):
        _check_rescale_gate(self)

    @property
    def batch_size(self) -> int:
        return self.embeddings.shape[0]

    def replace(self, **changes) -> 'InstructPix2PixGuidance':
        return dataclasses.replace(self, **changes)

    def noise_pred(self, noise_fn: NoiseFn, latents: torch.Tensor,
                   t: torch.Tensor, progress=0.0) -> torch.Tensor:
        del progress
        b = self.batch_size
        img = self.image_latents.to(latents.device, latents.dtype).expand(
            tuple(latents.shape[:3]) + (self.image_latents.shape[-1],))
        with_img = torch.cat([latents, img], dim=-1)
        lat3 = torch.cat([torch.cat([latents, torch.zeros_like(img)],
                                    dim=-1), with_img, with_img])
        dtype = torch.promote_types(self.uncond.dtype, self.embeddings.dtype)
        unc = self.uncond.expand(self.embeddings.shape).to(dtype)
        ctx = torch.cat([unc, unc, self.embeddings.to(dtype)])
        eps = noise_fn(lat3, t.expand(3 * b), ctx)
        eps_u, eps_i, eps_f = eps.chunk(3)
        out = (eps_u + _scale(self.image_guidance_scale, eps.device) *
               (eps_i - eps_u) +
               _scale(self.guidance_scale, eps.device) * (eps_f - eps_i))
        if self.rescale:
            out = rescale_cfg(out, eps_f, self.guidance_rescale)
        return out


def prompt_guidance(encoder, prompt, guidance_scale: float
                    ) -> SimpleGuidance:
    """CFG guidance straight from a prompt (the reference's
    ``PromptGuide``, pipeline/guide.py:67-72): ``encoder`` is a
    :class:`~flexdiffuse_tpu_torch.encode.CLIPEncoder`."""
    return SimpleGuidance(embeddings=encoder.prompt(prompt),
                          uncond=encoder.prompt(''),
                          guidance_scale=float(guidance_scale),
                          cfg=guidance_scale > 1.0)


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
    cfg_from: float = 0.0
    cfg_to: float = 1.0
    cfg_interval: bool = False
    guidance_rescale: float = 0.0
    rescale: bool = False
    pooled_stack: Optional[torch.Tensor] = None
    uncond_pooled: Optional[torch.Tensor] = None
    time_ids: Optional[torch.Tensor] = None

    def __post_init__(self):
        _check_rescale_gate(self)

    @property
    def batch_size(self) -> int:
        return 1

    @property
    def num_entities(self) -> int:
        return self.entities.shape[0]

    def _added(self, b: int, n: int):
        """SDXL's ``added_cond`` for ``b`` latent rows against the ``n``-row
        stack, row-major as the contexts; None without ``pooled_stack``."""
        if self.pooled_stack is None:
            return None
        rows = [self.pooled_stack]
        if self.cfg:
            rows = [self.uncond_pooled.to(self.pooled_stack)] + rows
        pooled = torch.cat(rows).repeat(b, 1)
        tids = self.time_ids.expand(b * n, self.time_ids.shape[-1])
        return {'text_embeds': pooled, 'time_ids': tids}

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
        eps = _call(noise_fn, lat, t.expand(b * n), ctx.repeat(b, 1, 1),
                    added=self._added(b, n))
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
            cond = bg
            bg = uncond + self.guidance_scale * (bg - uncond)
            if self.rescale:
                bg = rescale_cfg(bg, cond, self.guidance_rescale)
        return bg
