"""Schedulers (port of ``flexdiffuse_tpu/schedulers``): DDIM, PNDM (PLMS and
PRK), K-LMS, Euler, Euler-a, Heun, DPM++ 2M, UniPC, DDPM and LCM, with
v-prediction, Karras σ, trailing spacing and zero terminal SNR.

Usage::

    sch = schedulers.make('pndm', steps=30)
    state = schedulers.init_state(sch, latents.shape, latents.dtype)
    for i in range(t_start, sch.length):
        x = schedulers.scale_model_input(sch, latents, i)
        state, latents = schedulers.step(sch, state, eps, i, i - t_start,
                                         latents, eta, noise)

``noise`` is the step's unit normal draw of the kinds that take one
(:data:`NOISE_KINDS`, and DDIM at η > 0); the pipeline draws it or takes
the caller's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from flexdiffuse_tpu_torch.schedulers import ddim as _ddim
from flexdiffuse_tpu_torch.schedulers import ddpm as _ddpm
from flexdiffuse_tpu_torch.schedulers import dpmpp as _dpmpp
from flexdiffuse_tpu_torch.schedulers import euler as _euler
from flexdiffuse_tpu_torch.schedulers import euler_ancestral as _euler_a
from flexdiffuse_tpu_torch.schedulers import heun as _heun
from flexdiffuse_tpu_torch.schedulers import lcm as _lcm
from flexdiffuse_tpu_torch.schedulers import lms as _lms
from flexdiffuse_tpu_torch.schedulers import pndm as _pndm
from flexdiffuse_tpu_torch.schedulers import unipc as _unipc
from flexdiffuse_tpu_torch.schedulers.pndm import PRKSchedule
from flexdiffuse_tpu_torch.schedulers.base import (SIGMA_SPACE_KINDS,
                                                   Schedule,
                                                   SchedulerConfig,
                                                   alphas_cumprod,
                                                   ddim_like_add_noise,
                                                   init_timestep_info,
                                                   make_betas,
                                                   spaced_timesteps,
                                                   timestep_at)

_KINDS = {'ddim': _ddim, 'pndm': _pndm, 'lms': _lms,
          'euler': _euler, 'euler_a': _euler_a, 'dpmpp': _dpmpp,
          'lcm': _lcm, 'ddpm': _ddpm, 'unipc': _unipc, 'heun': _heun}
# VP-space kinds with per-position (α, σ) tables (exact for the fractional
# timesteps of Karras spacing).
_VP_TABLE_KINDS = ('dpmpp', 'unipc')
KARRAS_KINDS = ('euler', 'euler_a', 'dpmpp', 'unipc', 'heun')
# Kinds whose every step takes a fresh unit-normal draw.
NOISE_KINDS = ('euler_a', 'ddpm', 'lcm')


def make(kind: str, steps: int,
         config: Optional[SchedulerConfig] = None) -> Schedule:
    if kind not in _KINDS:
        raise ValueError(f'unknown scheduler {kind!r}; one of {list(_KINDS)}')
    config = config or SchedulerConfig(kind=kind)
    if config.use_karras_sigmas and kind not in KARRAS_KINDS:
        raise ValueError('use_karras_sigmas is only supported for '
                         f'{"/".join(KARRAS_KINDS)}, not {kind!r}')
    if config.prediction_type not in ('epsilon', 'v_prediction'):
        raise ValueError(
            f'unknown prediction_type {config.prediction_type!r}')
    schedule = _KINDS[kind].make_schedule(config, steps)
    if config.prediction_type == 'v_prediction':
        schedule = dataclasses.replace(schedule, v_prediction=True)
    return schedule


def init_state(schedule: Schedule, latent_shape, dtype):
    return _KINDS[schedule.kind].init_state(schedule, latent_shape, dtype)


def scale_model_input(schedule: Schedule, sample: torch.Tensor,
                      i: int) -> torch.Tensor:
    """``x/√(σ²+1)`` for the σ-space kinds; the identity for the others."""
    if schedule.kind in SIGMA_SPACE_KINDS:
        return _KINDS[schedule.kind].scale_model_input(schedule, sample, i)
    return sample


def convert_v_prediction(schedule: Schedule, v: torch.Tensor, i: int,
                         sample: torch.Tensor) -> torch.Tensor:
    """A v-parameterised model output → ε at position ``i`` (SD-2.x).

    VP space: ``ε = √(1−ᾱ_t)·x_t + √ᾱ_t·v``. The σ-space kinds carry
    ``x = x₀ + σ·ε`` (the UNet sees the VP-scaled input), where the same
    identity reads ``ε = x·σ/(σ²+1) + v/√(σ²+1)``.
    """
    x = sample.float()
    v = v.float()
    if schedule.kind in SIGMA_SPACE_KINDS:
        sigma = schedule.sigmas[i]
        return x * (sigma / (sigma * sigma + 1.0)) + v * torch.rsqrt(
            sigma * sigma + 1.0)
    if schedule.kind in _VP_TABLE_KINDS:
        return schedule.vp_sigma[i] * x + schedule.vp_alpha[i] * v
    t = min(max(int(schedule.timesteps[i]), 0),
            schedule.num_train_timesteps - 1)
    ap = schedule.alphas_cumprod[t]
    return torch.sqrt(1.0 - ap) * x + torch.sqrt(ap) * v


def step(schedule: Schedule, state, eps: torch.Tensor, i: int, counter: int,
         sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None):
    """One update at table position ``i``. ``eta`` is DDIM's; ``noise`` the
    step's unit draw (DDIM at η > 0, euler_a, ddpm, lcm); the other kinds
    ignore both."""
    if schedule.v_prediction:
        eps = convert_v_prediction(schedule, eps, i, sample)
    return _KINDS[schedule.kind].step(schedule, state, eps, i, counter,
                                      sample, eta, noise)


def takes_noise(schedule: Schedule, eta: float) -> bool:
    """Whether :func:`step` at this ``eta`` uses a per-step draw."""
    return schedule.kind in NOISE_KINDS or (schedule.kind == 'ddim' and
                                            eta > 0)


def add_noise(schedule: Schedule, sample: torch.Tensor, noise: torch.Tensor,
              init_timestep: int) -> torch.Tensor:
    """Noise init latents for img2img. The σ-space kinds index their σ
    table with ``steps - init_timestep`` (reference flex.py:200-204); the
    VP-table kinds their (α, σ) tables likewise; DDIM/PNDM and the rest
    use the timestep value ``timesteps[-init_timestep]`` (flex.py:206-209).
    """
    if schedule.kind in SIGMA_SPACE_KINDS:
        return _KINDS[schedule.kind].add_noise(
            schedule, sample, noise, schedule.num_steps - init_timestep)
    if schedule.kind in _VP_TABLE_KINDS:
        idx = schedule.num_steps - int(init_timestep)
        if idx >= schedule.length:      # strength ~0: clean
            return sample
        return (schedule.vp_alpha[idx] * sample.float() +
                schedule.vp_sigma[idx] * noise.float()).to(sample.dtype)
    # init_timestep 0 (an offset-0 kind at a tiny strength) would wrap to
    # the highest timestep; the lowest is right (every step is skipped).
    t = schedule.timesteps[-max(int(init_timestep), 1)]
    return ddim_like_add_noise(schedule, sample, noise, t)


def anchor_noise(schedule: Schedule, sample: torch.Tensor,
                 noise: torch.Tensor, i: int, counter: int) -> torch.Tensor:
    """Noise a clean latent to the level of step ``i``'s OUTPUT: inpainting
    re-anchors the kept region with it, so both regions share one
    trajectory. σ-space kinds: ``σ[i+1]`` (the terminal 0 is clean);
    VP-table kinds: position i+1's (α, σ) (past the end: clean); DDIM:
    ``timesteps[i] - ratio``; PLMS: the same, except that the warm-up's
    counter-1 call re-steps to ``timesteps[i]`` itself; PRK and LCM: the
    position's target timestep. A negative level is the scheduler's own
    final ᾱ."""
    f32 = sample.float()
    n32 = noise.float()
    length = schedule.length
    if schedule.kind in SIGMA_SPACE_KINDS:
        sigma = schedule.sigmas[min(max(i + 1, 0), length)]
        return (f32 + n32 * sigma).to(sample.dtype)
    if schedule.kind in _VP_TABLE_KINDS:
        if i + 1 >= length:
            return (1.0 * f32 + 0.0 * n32).to(sample.dtype)
        pos = min(max(i + 1, 0), length - 1)
        return (schedule.vp_alpha[pos] * f32 +
                schedule.vp_sigma[pos] * n32).to(sample.dtype)
    pos = min(max(i, 0), length - 1)
    if isinstance(schedule, (PRKSchedule, _lcm.LCMSchedule)):
        t_out = int(schedule.prev_tr[pos])
    else:
        t = int(timestep_at(schedule, pos))
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
    'convert_v_prediction', 'takes_noise', 'init_timestep_info',
    'make_betas', 'alphas_cumprod', 'spaced_timesteps', 'SIGMA_SPACE_KINDS',
    'KARRAS_KINDS', 'NOISE_KINDS'
]
