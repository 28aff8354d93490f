"""Heun (second-order) discrete scheduler; port of
``flexdiffuse_tpu/schedulers/heun.py``.

The two evaluations of a σ transition are two table rows
(``rows_per_step = 2``), interleaved as in the JAX package::

    sigmas    [σ0, σ1,σ1, σ2,σ2, …, σ_{N-1},σ_{N-1}, 0]
    timesteps [t0, t1,t1, t2,t2, …, t_{N-1}]            (length 2N−1)

Even rows predict ``s[i] → s[i+1]`` (stash the start sample and the
derivative, return the Euler estimate); odd rows correct ``s[i−1] → s[i]``
with the mean of the stashed and the fresh derivative. The final
transition to σ = 0 is a lone even row (Euler only): the UNet runs
``2N − 1`` times for N steps.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod, f32,
                                                   sigma_table)


def make_schedule(config: SchedulerConfig, steps: int) -> Schedule:
    n = config.num_train_timesteps
    acp = alphas_cumprod(config)
    ts, sigmas = sigma_table(config, steps)
    ts_rows = np.concatenate([ts[:1], np.repeat(ts[1:], 2)])
    sig_rows = np.concatenate([sigmas[:1], np.repeat(sigmas[1:], 2), [0.0]])
    return Schedule(
        kind='heun', num_steps=steps, num_train_timesteps=n,
        ratio=n // steps, steps_offset=0, length=2 * steps - 1,
        rows_per_step=2, timesteps=f32(ts_rows), alphas_cumprod=f32(acp),
        final_alpha_cumprod=f32(acp[0]), sigmas=f32(sig_rows))


def init_state(schedule: Schedule, latent_shape, dtype):
    """(step-start sample, stashed predictor derivative); None until the
    first predictor row."""
    del schedule, latent_shape, dtype
    return (None, None)


def scale_model_input(schedule: Schedule, sample: torch.Tensor,
                      i: int) -> torch.Tensor:
    sigma = schedule.sigmas[i]
    return (sample.float() / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)


def step(schedule: Schedule, state, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None):
    del counter, eta, noise
    x0_stash, d_stash = state
    x = sample.float()
    d = eps.float()
    if i % 2 == 0:
        # Predictor: the Euler estimate of s[i] → s[i+1]; stash.
        dt = schedule.sigmas[i + 1] - schedule.sigmas[i]
        return (x, d), (x + d * dt).to(sample.dtype)
    # Corrector: finish s[i-1] → s[i] with the mean derivative.
    dt = schedule.sigmas[i] - schedule.sigmas[max(i - 1, 0)]
    prev = x0_stash + 0.5 * (d_stash + d) * dt
    return (x0_stash, d_stash), prev.to(sample.dtype)


def add_noise(schedule: Schedule, sample: torch.Tensor, noise: torch.Tensor,
              index: int) -> torch.Tensor:
    """img2img noising at step ``index``: the interleaved row
    ``2·index``."""
    row = min(max(2 * int(index), 0), schedule.length)
    sigma = schedule.sigmas[row]
    return (sample.float() + noise.float() * sigma).to(sample.dtype)
