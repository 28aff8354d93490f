"""Scheduler foundations (port of ``flexdiffuse_tpu/schedulers/base.py``):
beta schedules, the config, the leading timestep spacing, the schedule
tables and the img2img noise-level helpers.

A scheduler is a :class:`Schedule` of precomputed fp32 tables plus a
``step`` function. The tables stay on the CPU as fp32 tensors: their
entries enter the device math as 0-d tensors, so the coefficients are
computed in fp32 exactly as the JAX package computes them, and the denoise
loop is a Python loop over device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

# Scheduler kinds whose carry lives in k-diffusion sigma space
# (x = x0 + sigma*eps; input scaling x/sqrt(sigma^2+1)). Of these the port
# has 'lms'; the others come with ROADMAP Queue 1 step 9.
SIGMA_SPACE_KINDS = ('lms', 'euler', 'euler_a', 'heun')


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """SD v1.x's training schedule (scaled-linear betas), its
    ``steps_offset = 1`` shim, and the per-kind switches of the JAX
    package's config: DDIM's ``clip_sample`` and ``set_alpha_to_one``
    (diffusers' defaults) and PNDM's ``skip_prk_steps`` (True: PLMS, what
    SD ships; False: the PRK warm-up)."""
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    steps_offset: int = 1
    clip_sample: bool = True
    set_alpha_to_one: bool = True
    skip_prk_steps: bool = True


def spaced_timesteps(config: SchedulerConfig, steps: int,
                     offset: int = 0) -> np.ndarray:
    """Descending 'leading' inference timesteps ``(arange(steps)·ratio)
    [::-1] + offset`` (SD's spacing; the JAX package's 'trailing' spacing
    serves zero-SNR checkpoints, ROADMAP Queue 1 step 9)."""
    ratio = config.num_train_timesteps // steps
    return (np.arange(steps) * ratio)[::-1].copy() + offset


def make_betas(config: SchedulerConfig) -> np.ndarray:
    """Scaled-linear betas (the only schedule SD v1.x checkpoints use)."""
    return np.linspace(config.beta_start**0.5, config.beta_end**0.5,
                       config.num_train_timesteps, dtype=np.float64)**2


def alphas_cumprod(config: SchedulerConfig) -> np.ndarray:
    return np.cumprod(1.0 - make_betas(config), axis=0)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Precomputed schedule tables (fp32 CPU tensors)."""

    kind: str
    num_steps: int
    num_train_timesteps: int
    ratio: int
    steps_offset: int
    length: int                     # UNet calls per full run
    timesteps: torch.Tensor         # [length] fp32, fed to the UNet
    alphas_cumprod: torch.Tensor    # [num_train_timesteps] fp32
    final_alpha_cumprod: torch.Tensor
    clip_sample: bool = False       # DDIM: clip x0 to [-1, 1]
    sigmas: Optional[torch.Tensor] = None      # [length + 1] (LMS)
    lms_coeffs: Optional[torch.Tensor] = None  # [length, 4] (LMS)


def ddim_like_add_noise(schedule: Schedule, sample: torch.Tensor,
                        noise: torch.Tensor,
                        timestep: torch.Tensor) -> torch.Tensor:
    """``x_t = sqrt(ᾱ_t)·x₀ + sqrt(1-ᾱ_t)·ε`` (DDIM/PNDM add_noise)."""
    t = int(min(max(int(timestep), 0), schedule.num_train_timesteps - 1))
    ap = schedule.alphas_cumprod[t]
    return (torch.sqrt(ap) * sample +
            torch.sqrt(1.0 - ap) * noise).to(sample.dtype)


def init_timestep_info(schedule: Schedule, strength: float,
                       steps: int) -> Tuple[int, int]:
    """img2img noise level ``(init_timestep, t_start)`` (pipeline/flex.py:
    196-221 of the reference)."""
    offset = schedule.steps_offset
    init_timestep = min(int(steps * strength) + offset, steps)
    t_start = max(steps - init_timestep + offset, 0)
    return init_timestep, t_start
