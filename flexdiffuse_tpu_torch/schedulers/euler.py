"""Euler discrete (σ-space first-order ODE steps); port of
``flexdiffuse_tpu/schedulers/euler.py``.

LMS's σ machinery (float timesteps, ``x/√(σ²+1)`` input scaling, position
indexing) with the first-order update ``x ← x + ε·(σ_{i+1} − σ_i)``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod, f32,
                                                   sigma_table)


def make_schedule(config: SchedulerConfig, steps: int,
                  kind: str = 'euler') -> Schedule:
    n = config.num_train_timesteps
    acp = alphas_cumprod(config)
    ts, sigmas = sigma_table(config, steps)
    return Schedule(
        kind=kind, num_steps=steps, num_train_timesteps=n, ratio=n // steps,
        steps_offset=0, length=steps, timesteps=f32(ts),
        alphas_cumprod=f32(acp), final_alpha_cumprod=f32(acp[0]),
        sigmas=f32(np.concatenate([sigmas, [0.0]])))


def init_state(schedule: Schedule, latent_shape, dtype) -> tuple:
    del schedule, latent_shape, dtype
    return ()


def scale_model_input(schedule: Schedule, sample: torch.Tensor,
                      i: int) -> torch.Tensor:
    sigma = schedule.sigmas[i]
    return (sample.float() / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)


def step(schedule: Schedule, state: tuple, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None
         ) -> Tuple[tuple, torch.Tensor]:
    del state, counter, eta, noise
    dt = schedule.sigmas[i + 1] - schedule.sigmas[i]
    prev = sample.float() + eps.float() * dt
    return (), prev.to(sample.dtype)


def add_noise(schedule: Schedule, sample: torch.Tensor, noise: torch.Tensor,
              index: int) -> torch.Tensor:
    """img2img noising ``x + σ[index]·ε`` (index-driven, as LMS)."""
    sigma = schedule.sigmas[int(index)]
    return (sample.float() + noise.float() * sigma).to(sample.dtype)
