"""DDPM, the ancestral sampler of Ho et al. (2020); port of
``flexdiffuse_tpu/schedulers/ddpm.py`` (diffusers' ``DDPMScheduler`` with
``variance_type='fixed_small'``)::

    x₀ = (x_t − √(1−ᾱ_t)·ε)/√ᾱ_t                      (clipped if configured)
    μ  = √ᾱ_prev·β_t/(1−ᾱ_t)·x₀ + √α_t·(1−ᾱ_prev)/(1−ᾱ_t)·x_t
    x_prev = μ + √(β̃_t)·z,   β̃_t = β_t·(1−ᾱ_prev)/(1−ᾱ_t)

with no noise on the final (t = 0) step. The unit ``z`` is an argument of
:func:`step`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod, f32,
                                                   spaced_timesteps)


def make_schedule(config: SchedulerConfig, steps: int) -> Schedule:
    n = config.num_train_timesteps
    acp = alphas_cumprod(config)
    return Schedule(
        kind='ddpm', num_steps=steps, num_train_timesteps=n,
        ratio=n // steps, steps_offset=0, length=steps,
        timesteps=f32(spaced_timesteps(config, steps)),
        alphas_cumprod=f32(acp),
        final_alpha_cumprod=f32(1.0),   # diffusers' `self.one`
        clip_sample=config.clip_sample)


def init_state(schedule: Schedule, latent_shape, dtype) -> tuple:
    del schedule, latent_shape, dtype
    return ()


def step(schedule: Schedule, state: tuple, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None
         ) -> Tuple[tuple, torch.Tensor]:
    del state, counter, eta
    t = int(schedule.timesteps[i])
    prev_t = t - schedule.ratio
    acp = schedule.alphas_cumprod
    ap_t = acp[min(max(t, 0), schedule.num_train_timesteps - 1)]
    ap_prev = acp[prev_t] if prev_t >= 0 else schedule.final_alpha_cumprod
    alpha_t = ap_t / ap_prev
    beta_t = 1.0 - alpha_t

    x = sample.float()
    x0 = (x - torch.sqrt(1.0 - ap_t) * eps.float()) / torch.sqrt(ap_t)
    if schedule.clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)
    c0 = torch.sqrt(ap_prev) * beta_t / (1.0 - ap_t)
    c1 = torch.sqrt(alpha_t) * (1.0 - ap_prev) / (1.0 - ap_t)
    mean = c0 * x0 + c1 * x
    if noise is not None and t > 0:
        var = torch.clamp(beta_t * (1.0 - ap_prev) / (1.0 - ap_t),
                          min=1e-20)
        mean = mean + torch.sqrt(var) * noise.float()
    return (), mean.to(sample.dtype)
