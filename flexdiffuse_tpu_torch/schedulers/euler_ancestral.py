"""Euler-Ancestral (k-diffusion ``sample_euler_ancestral``); port of
``flexdiffuse_tpu/schedulers/euler_ancestral.py``.

Each transition σ_i → σ_{i+1} steps deterministically down to
``σ_down = √(σ_to² − σ_up²)``, ``σ_up² = σ_to²·(σ_from² − σ_to²)/σ_from²``,
then adds fresh N(0, σ_up²) noise. The unit ``noise`` is an argument of
:func:`step` (the pipeline draws it, or takes the caller's).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from flexdiffuse_tpu_torch.schedulers import euler as _euler
from flexdiffuse_tpu_torch.schedulers.base import Schedule, SchedulerConfig

init_state = _euler.init_state
scale_model_input = _euler.scale_model_input
add_noise = _euler.add_noise


def make_schedule(config: SchedulerConfig, steps: int) -> Schedule:
    return _euler.make_schedule(config, steps, kind='euler_a')


def step(schedule: Schedule, state: tuple, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None
         ) -> Tuple[tuple, torch.Tensor]:
    del state, counter, eta
    if noise is None:
        raise ValueError('euler_a needs the step noise')
    s_from = schedule.sigmas[i]
    s_to = schedule.sigmas[i + 1]
    # σ_to = 0 on the final step gives σ_up = 0: a deterministic landing.
    up2 = s_to**2 * (s_from**2 - s_to**2) / torch.clamp(s_from**2,
                                                        min=1e-20)
    s_up = torch.sqrt(up2)
    s_down = torch.sqrt(torch.clamp(s_to**2 - up2, min=0.0))
    prev = sample.float() + eps.float() * (s_down - s_from)
    prev = prev + noise.float() * s_up
    return (), prev.to(sample.dtype)
