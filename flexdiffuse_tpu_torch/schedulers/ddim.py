"""DDIM, deterministic (η = 0) or stochastic (η > 0); port of
``flexdiffuse_tpu/schedulers/ddim.py``.

Stateless. The η > 0 variance noise is an argument of :func:`step`: the
pipeline draws it from its ``torch.Generator`` (or takes it from the caller),
where the JAX step draws it from its key.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod,
                                                   spaced_timesteps)


def make_schedule(config: SchedulerConfig, steps: int) -> Schedule:
    acp = alphas_cumprod(config)
    final = 1.0 if config.set_alpha_to_one else float(acp[0])
    return Schedule(
        kind='ddim', num_steps=steps,
        num_train_timesteps=config.num_train_timesteps,
        ratio=config.num_train_timesteps // steps,
        steps_offset=config.steps_offset, length=steps,
        timesteps=torch.tensor(
            spaced_timesteps(config, steps, config.steps_offset),
            dtype=torch.float32),
        alphas_cumprod=torch.tensor(acp, dtype=torch.float32),
        final_alpha_cumprod=torch.tensor(final, dtype=torch.float32),
        clip_sample=config.clip_sample)


def init_state(schedule: Schedule, latent_shape, dtype) -> tuple:
    del schedule, latent_shape, dtype
    return ()


def step(schedule: Schedule, state: tuple, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None
         ) -> Tuple[tuple, torch.Tensor]:
    """One x_t → x_{t-ratio} DDIM update at table position ``i``. ``noise``
    (unit normal, like ``sample``) is added with the η-scaled std; without
    it the step adds nothing, which equals η = 0."""
    del state, counter
    t = int(schedule.timesteps[i])
    prev_t = t - schedule.ratio
    acp = schedule.alphas_cumprod
    ap_t = acp[min(max(t, 0), schedule.num_train_timesteps - 1)]
    ap_prev = acp[prev_t] if prev_t >= 0 else schedule.final_alpha_cumprod

    f32 = sample.float()
    eps32 = eps.float()
    x0 = (f32 - torch.sqrt(1.0 - ap_t) * eps32) / torch.sqrt(ap_t)
    if schedule.clip_sample:
        x0 = torch.clamp(x0, -1.0, 1.0)

    variance = (1.0 - ap_prev) / (1.0 - ap_t) * (1.0 - ap_t / ap_prev)
    std = torch.tensor(eta, dtype=torch.float32) * torch.sqrt(variance)
    direction = torch.sqrt(torch.clamp(1.0 - ap_prev - std**2, min=0.0)) * \
        eps32
    prev = torch.sqrt(ap_prev) * x0 + direction
    if noise is not None:
        prev = prev + std * noise.float()
    return (), prev.to(sample.dtype)
