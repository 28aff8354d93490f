"""LCM (latent consistency model) few-step sampling; port of
``flexdiffuse_tpu/schedulers/lcm.py`` (diffusers' ``LCMScheduler``).

- Timesteps come from the distillation's base DDIM grid
  (``original_inference_steps`` of the train steps), strided down to
  ``steps``; ``prev_tr`` holds each position's next timestep (−1: clean).
- A step maps the sample to the consistency output ``c_out·x₀(x_t) +
  c_skip·x_t`` with the boundary scalings (σ_d = 0.5, s =
  ``timestep_scaling``), then, on every step but the last, re-noises it to
  the next level with fresh unit ``noise`` (an argument of :func:`step`).
- CFG is off for full LCM checkpoints: the UNet takes the guidance scale as
  an input (``UNetConfig.time_cond_proj_dim``, :func:`~flexdiffuse_tpu_
  torch.models.unet.guidance_scale_embedding`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod, f32)

SIGMA_DATA = 0.5


@dataclasses.dataclass(frozen=True)
class LCMSchedule(Schedule):
    prev_tr: Optional[torch.Tensor] = None   # [L] next timestep; -1: clean
    timestep_scaling: float = 10.0


def make_schedule(config: SchedulerConfig, steps: int) -> LCMSchedule:
    n = config.num_train_timesteps
    orig = config.original_inference_steps
    if steps > orig:
        raise ValueError(
            f'LCM steps ({steps}) cannot exceed original_inference_steps '
            f'({orig}): the model was only distilled on that sub-schedule')
    k = n // orig
    origin = np.arange(1, orig + 1, dtype=np.int64) * k - 1
    skip = len(origin) // steps
    ts = origin[::-skip][:steps].astype(np.float64)
    prev = np.concatenate([ts[1:], [-1.0]])
    acp = alphas_cumprod(config)
    return LCMSchedule(
        kind='lcm', num_steps=steps, num_train_timesteps=n,
        ratio=k * skip, steps_offset=config.steps_offset, length=steps,
        timesteps=f32(ts), alphas_cumprod=f32(acp),
        final_alpha_cumprod=f32(1.0),
        # diffusers' LCMScheduler does not clip; the config's DDIM-oriented
        # default is ignored, as in the JAX package.
        clip_sample=False, prev_tr=f32(prev),
        timestep_scaling=config.timestep_scaling)


def init_state(schedule: LCMSchedule, latent_shape, dtype) -> tuple:
    del schedule, latent_shape, dtype
    return ()


def boundary_scalings(schedule: LCMSchedule, t: torch.Tensor):
    """Consistency boundary conditions ``(c_skip, c_out)`` at timestep t."""
    scaled = t.float() * schedule.timestep_scaling
    c_skip = SIGMA_DATA**2 / (scaled**2 + SIGMA_DATA**2)
    c_out = scaled * torch.rsqrt(scaled**2 + SIGMA_DATA**2)
    return c_skip, c_out


def step(schedule: LCMSchedule, state: tuple, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None
         ) -> Tuple[tuple, torch.Tensor]:
    del state, counter, eta
    t = int(schedule.timesteps[i])
    prev_t = int(schedule.prev_tr[i])
    nmax = schedule.num_train_timesteps - 1
    acp = schedule.alphas_cumprod
    ap_t = acp[min(max(t, 0), nmax)]
    x = sample.float()
    x0 = (x - torch.sqrt(1.0 - ap_t) * eps.float()) * torch.rsqrt(ap_t)
    c_skip, c_out = boundary_scalings(schedule, torch.tensor(
        float(t), dtype=torch.float32))
    denoised = c_out * x0 + c_skip * x
    if prev_t < 0:
        return (), denoised.to(sample.dtype)
    if noise is None:
        raise ValueError('lcm needs the step noise')
    ap_prev = acp[min(prev_t, nmax)]
    prev = torch.sqrt(ap_prev) * denoised + torch.sqrt(1.0 - ap_prev) * \
        noise.float()
    return (), prev.to(sample.dtype)
