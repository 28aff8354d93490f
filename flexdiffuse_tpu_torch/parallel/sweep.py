"""Data-parallel multi-seed sweeps (port of
``flexdiffuse_tpu/parallel/sweep.py``).

:func:`sweep` generates one image per seed with the seeds split over the
mesh's data axis: every rank denoises its seeds through the port's
:class:`~flexdiffuse_tpu_torch.pipeline.FlexPipeline` at batch N/dp (K1
and K6 on the card, as any generation), and the decoded images are
all-gathered, so every rank returns all N. Each seed's noise is drawn on
its rank from that seed's own ``torch.Generator``, so an image does not
depend on the world size; a parity test passes the noise in instead
(JAX's ``PRNGKey`` streams cannot be reproduced).

Generators per seed ``s``: the initial latents (or img2img's noise) from
``s``; the in-loop draws (DDIM η > 0 and the ancestral schedulers' step
noise, the inpainting anchor noise) from ``s + 0x5eed``; img2img's one
posterior sample from ``seeds[0] + 0x33``, the same on every rank.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch.guidance.tween import Tweener
from flexdiffuse_tpu_torch.parallel.axis import MeshAxis, gather
from flexdiffuse_tpu_torch.parallel.mesh import (MODEL_AXIS, batch_sharding,
                                                 make_mesh, shard_batch,
                                                 shard_params)
from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                   SimpleGuidance)

LOOP_OFFSET = 0x5eed
ENCODE_OFFSET = 0x33


def guidance_param_sweep(base_emb: torch.Tensor, alt_emb: torch.Tensor,
                         params_list) -> torch.Tensor:
    """Tween one prompt against one guide under N parameter settings:
    ``[N, T, D]`` conditioning rows for :func:`sweep`, row i the tween of
    setting i (JAX groups the settings into vmapped calls; the rows are
    the same). ``base_emb`` ``[T, D]`` or ``[1, T, D]``, ``alt_emb``
    ``[A, D]`` or ``[1, A, D]``."""
    base = base_emb[0] if base_emb.dim() == 3 else base_emb
    alt = alt_emb[0] if alt_emb.dim() == 3 else alt_emb
    rows = [Tweener(p).tween(base, alt) for p in params_list]
    return torch.stack([r[0] if r.dim() == 3 else r for r in rows])


class _SeedNoise:
    """Unit noise ``[n, *shape]`` for the scan position asked, one row
    per seed from that seed's generator (drawn in the order asked), or the
    rows of a given sequence of full ``[N, ...]`` arrays."""

    def __init__(self, gens, shape, device, given=None, mesh=None):
        self.gens, self.shape, self.device = gens, tuple(shape), device
        self.given, self.mesh = given, mesh

    def __getitem__(self, i: int) -> torch.Tensor:
        if self.given is not None:
            return shard_batch(torch.as_tensor(np.asarray(
                self.given[i], np.float32)), self.mesh)
        return torch.stack([torch.randn(self.shape, generator=g,
                                        device=self.device)
                            for g in self.gens])


def _generators(seeds, offset: int, device) -> list:
    return [torch.Generator(device).manual_seed(
        (int(s) + offset) % 2**63) for s in seeds]


def _noise(given, seeds, shape, device, mesh) -> torch.Tensor:
    """This rank's rows of the initial noise: the given ``[N, ...]``
    array's, or one draw per local seed."""
    if given is not None:
        return shard_batch(torch.as_tensor(np.asarray(given, np.float32)),
                           mesh).to(device)
    return torch.stack([torch.randn(shape, generator=g, device=device)
                        for g in _generators(seeds, 0, device)])


def _gather_images(images: np.ndarray, mesh) -> np.ndarray:
    """Every data rank's images, in rank order (host numpy)."""
    data = batch_sharding(mesh)
    if data.size == 1:
        return images
    return gather(torch.as_tensor(images, device=mesh.device_type), data,
                  0).cpu().numpy()


def _mesh_pipe(pipe, mesh):
    """``pipe`` itself, or, with a model axis > 1, a pipeline around a
    tensor-parallel copy of its UNet (the caller's stays as it is)."""
    if MeshAxis.of(mesh, MODEL_AXIS).size == 1:
        return pipe
    from flexdiffuse_tpu_torch.runner import rebuild
    return rebuild(pipe, shard_params(copy.deepcopy(pipe.unet), mesh))


def sweep(pipe, embeddings: torch.Tensor, uncond: torch.Tensor, seeds,
          steps: int = 30, guidance_scale: float = 8.0,
          init_size: Tuple[int, int] = (512, 512), mesh=None,
          model_parallel: int = 1, eta: float = 0.0, init_image=None,
          strength: float = 0.6, mask=None, noise=None,
          posterior_noise=None, variance_noise: Optional[Sequence] = None,
          inpaint_noise: Optional[Sequence] = None) -> np.ndarray:
    """One image per seed, the seeds split over the data axis.

    Args:
        pipe: a FlexPipeline (every rank holds the same).
        embeddings: ``[T, D]`` / ``[1, T, D]`` conditioning shared by all
            seeds, or ``[N, T, D]`` per-seed rows (guidance-param sweeps).
        uncond: ``[1, T, D]`` unconditional embeddings.
        seeds: ``[N]`` seeds (:func:`~flexdiffuse_tpu_torch.parallel.
            seed_sweep_keys`); N must divide by the data-axis size.
        mesh: a mesh (default: every rank, ``model_parallel`` per model
            group).
        init_image: ``[1, H, W, 3]`` in [-1, 1] (or PIL): img2img, encoded
            once, noised per seed at ``strength``.
        mask: inpainting mask (1 = regenerate; needs ``init_image``).
        noise, posterior_noise, variance_noise, inpaint_noise: the draws
            passed in instead (full ``[N, ...]`` arrays; the last two
            sequences of them by scan position), as ``FlexPipeline`` takes
            them.

    Returns:
        ``[N, H, W, 3]`` images in [0, 1] (host numpy), on every rank.
    """
    if mask is not None and init_image is None:
        raise ValueError('inpainting sweep (mask=...) requires init_image')
    if mesh is None:
        mesh = make_mesh(model_parallel=model_parallel)
    seeds = [int(s) for s in seeds]
    n = len(seeds)
    if embeddings.dim() == 2:
        embeddings = embeddings[None]
    if embeddings.shape[0] != n:
        embeddings = embeddings.expand((n,) + tuple(embeddings.shape[1:]))
    local = shard_batch(torch.tensor(seeds), mesh).tolist()
    emb = shard_batch(embeddings, mesh)
    dev = pipe.device
    f = pipe.vae_scale
    shape = (init_size[0] // f, init_size[1] // f, pipe.latent_channels)
    kw = {}
    if init_image is not None:
        post_shape = (1,) + shape
        kw = dict(init_image=init_image, strength=strength, mask=mask,
                  posterior_noise=posterior_noise if posterior_noise
                  is not None else torch.randn(
                      post_shape, device=dev,
                      generator=_generators(seeds[:1], ENCODE_OFFSET,
                                            dev)[0]))
    loop_gens = _generators(local, LOOP_OFFSET, dev)
    guide = SimpleGuidance(embeddings=emb, uncond=uncond,
                           guidance_scale=float(guidance_scale),
                           cfg=guidance_scale > 1.0)
    out = _mesh_pipe(pipe, mesh)(
        guide, steps=steps, init_size=init_size, eta=eta, output_type='np',
        noise=_noise(noise, local, shape, dev, mesh),
        variance_noise=_SeedNoise(loop_gens, shape, dev, variance_noise,
                                  mesh),
        inpaint_noise=_SeedNoise(loop_gens, shape, dev, inpaint_noise,
                                 mesh), **kw).images
    return _gather_images(out, mesh)


@dataclasses.dataclass(frozen=True)
class _CompositeRows(CompositeGuidance):
    """A :class:`CompositeGuidance` over ``rows`` latent rows (its
    ``noise_pred`` is batch-general; the pipeline reads ``batch_size``)."""
    rows: int = 1

    @property
    def batch_size(self) -> int:
        return self.rows


def compose_sweep(pipe, guidance: CompositeGuidance, seeds,
                  steps: int = 30, init_size: Tuple[int, int] = (512, 512),
                  mesh=None, eta: float = 0.0, noise=None) -> np.ndarray:
    """Multi-seed regional composition: each seed's latents denoise
    against the whole ``(uncond+bg+E)`` stack of ``guidance``, the seeds
    split over the data axis (one UNet call covers the rank's ``n·(2+E)``
    rows). ``noise``: the initial latents passed in (full ``[N, h, w,
    C]``). Returns ``[N, H, W, 3]`` images in [0, 1] (host numpy)."""
    if mesh is None:
        mesh = make_mesh()
    seeds = [int(s) for s in seeds]
    local = shard_batch(torch.tensor(seeds), mesh).tolist()
    dev = pipe.device
    f = pipe.vae_scale
    shape = (init_size[0] // f, init_size[1] // f, pipe.latent_channels)
    guide = _CompositeRows(**{fl.name: getattr(guidance, fl.name)
                              for fl in dataclasses.fields(guidance)},
                           rows=len(local))
    loop_gens = _generators(local, LOOP_OFFSET, dev)
    out = _mesh_pipe(pipe, mesh)(
        guide, steps=steps, init_size=init_size, eta=eta, output_type='np',
        noise=_noise(noise, local, shape, dev, mesh),
        variance_noise=_SeedNoise(loop_gens, shape, dev)).images
    return _gather_images(out, mesh)
