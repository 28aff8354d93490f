"""Schedulers (port of ``flexdiffuse_tpu/schedulers``): DDIM, PNDM (PLMS and
PRK) and K-LMS. The JAX package's other kinds come with ROADMAP Queue 1
step 9.

Usage::

    sch = schedulers.make('pndm', steps=30)
    state = schedulers.init_state(sch, latents.shape, latents.dtype)
    for i in range(t_start, sch.length):
        x = schedulers.scale_model_input(sch, latents, i)
        state, latents = schedulers.step(sch, state, eps, i, i - t_start,
                                         latents, eta, noise)
"""
from __future__ import annotations

from typing import Optional

import torch

from flexdiffuse_tpu_torch.schedulers import ddim as _ddim
from flexdiffuse_tpu_torch.schedulers import lms as _lms
from flexdiffuse_tpu_torch.schedulers import pndm as _pndm
from flexdiffuse_tpu_torch.schedulers.pndm import PRKSchedule
from flexdiffuse_tpu_torch.schedulers.base import (SIGMA_SPACE_KINDS,
                                                   Schedule,
                                                   SchedulerConfig,
                                                   alphas_cumprod,
                                                   ddim_like_add_noise,
                                                   init_timestep_info,
                                                   make_betas,
                                                   spaced_timesteps)

_KINDS = {'ddim': _ddim, 'pndm': _pndm, 'lms': _lms}
# The JAX package's kinds that are not ported yet.
_LATER = ('euler', 'euler_a', 'dpmpp', 'lcm', 'ddpm', 'unipc', 'heun')


def make(kind: str, steps: int,
         config: Optional[SchedulerConfig] = None) -> Schedule:
    if kind in _LATER:
        raise NotImplementedError(
            f'scheduler {kind!r} is not ported yet (ROADMAP Queue 1 step 9); '
            f'ported: {list(_KINDS)}')
    if kind not in _KINDS:
        raise ValueError(f'unknown scheduler {kind!r}; one of {list(_KINDS)}')
    return _KINDS[kind].make_schedule(config or SchedulerConfig(), steps)


def init_state(schedule: Schedule, latent_shape, dtype):
    return _KINDS[schedule.kind].init_state(schedule, latent_shape, dtype)


def scale_model_input(schedule: Schedule, sample: torch.Tensor,
                      i: int) -> torch.Tensor:
    """``x/√(σ²+1)`` for LMS; the identity for the VP-space kinds."""
    if schedule.kind == 'lms':
        return _lms.scale_model_input(schedule, sample, i)
    return sample


def step(schedule: Schedule, state, eps: torch.Tensor, i: int, counter: int,
         sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None):
    """One update at table position ``i``. ``eta`` and the unit ``noise``
    are DDIM's (the η > 0 variance term); the other kinds ignore them."""
    return _KINDS[schedule.kind].step(schedule, state, eps, i, counter,
                                      sample, eta, noise)


def add_noise(schedule: Schedule, sample: torch.Tensor, noise: torch.Tensor,
              init_timestep: int) -> torch.Tensor:
    """Noise init latents for img2img. LMS indexes its σ table with
    ``steps - init_timestep`` (reference flex.py:200-204); DDIM/PNDM use the
    timestep value ``timesteps[-init_timestep]`` (flex.py:206-209)."""
    if schedule.kind == 'lms':
        return _lms.add_noise(schedule, sample, noise,
                              schedule.num_steps - init_timestep)
    t = schedule.timesteps[-max(int(init_timestep), 1)]
    return ddim_like_add_noise(schedule, sample, noise, t)


def anchor_noise(schedule: Schedule, sample: torch.Tensor,
                 noise: torch.Tensor, i: int, counter: int) -> torch.Tensor:
    """Noise a clean latent to the level of step ``i``'s OUTPUT: inpainting
    re-anchors the kept region with it, so both regions share one
    trajectory. LMS: ``σ[i+1]`` (the terminal 0 is clean); DDIM:
    ``timesteps[i] - ratio``; PLMS: the same, except that the warm-up's
    counter-1 call re-steps to ``timesteps[i]`` itself; PRK: the position's
    target timestep. A negative level is the scheduler's own final ᾱ."""
    f32 = sample.float()
    n32 = noise.float()
    length = schedule.length
    if schedule.kind == 'lms':
        sigma = schedule.sigmas[min(max(i + 1, 0), length)]
        return (f32 + n32 * sigma).to(sample.dtype)
    pos = min(max(i, 0), length - 1)
    if isinstance(schedule, PRKSchedule):
        t_out = int(schedule.prev_tr[pos])
    else:
        t = int(schedule.timesteps[pos])
        t_out = t if (schedule.kind == 'pndm' and counter == 1) else \
            t - schedule.ratio
    if t_out < 0:
        ap = schedule.final_alpha_cumprod
    else:
        ap = schedule.alphas_cumprod[min(t_out,
                                         schedule.num_train_timesteps - 1)]
    return (torch.sqrt(ap) * f32 + torch.sqrt(1.0 - ap) * n32).to(
        sample.dtype)


__all__ = [
    'Schedule', 'SchedulerConfig', 'PRKSchedule', 'make', 'init_state',
    'scale_model_input', 'step', 'add_noise', 'anchor_noise',
    'init_timestep_info', 'make_betas', 'alphas_cumprod', 'spaced_timesteps',
    'SIGMA_SPACE_KINDS'
]
