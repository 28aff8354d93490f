"""K-LMS (Katherine Crowson's linear multistep); port of
``flexdiffuse_tpu/schedulers/lms.py``.

* The Lagrange-basis integrals over each σ interval are cubics at most and
  are integrated exactly on the host, in float64, into an ``[L, 4]``
  coefficient table (the port's own copy of the JAX package's
  ``lms_coefficient_table``).
* The derivative history is a list, newest first, of at most 4 entries; the
  step uses as many terms as it holds, which is diffusers' ``zip``
  truncation and the JAX package's counter mask.

LMS is indexed by *position*: ``step(i)`` uses ``sigmas[i]``; the UNet sees
the float linspace timesteps and the input scaled by ``1/√(σ²+1)``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod)

# Derivative history, newest first (at most 4 entries).
State = List[torch.Tensor]


def _poly_integral(roots_num: np.ndarray, denom: float, lo: float,
                   hi: float) -> float:
    """∫_{lo}^{hi} Π_k (σ - r_k) dσ / denom, exactly (degree ≤ 3)."""
    coeffs = np.poly(roots_num) if len(roots_num) else np.array([1.0])
    integ = np.polyint(coeffs)
    return float((np.polyval(integ, hi) - np.polyval(integ, lo)) / denom)


def lms_coefficient_table(sigmas: np.ndarray, length: int) -> np.ndarray:
    """``table[i, j]`` = j-th LMS coefficient at step ``i`` (order
    min(i+1, 4)), fp32."""
    table = np.zeros((length, 4), dtype=np.float64)
    for i in range(length):
        order = min(i + 1, 4)
        for j in range(order):
            ks = [k for k in range(order) if k != j]
            roots = np.array([sigmas[i - k] for k in ks])
            denom = float(np.prod([sigmas[i - j] - sigmas[i - k]
                                   for k in ks])) if ks else 1.0
            table[i, j] = _poly_integral(roots, denom, sigmas[i],
                                         sigmas[i + 1])
    return table.astype(np.float32)


def make_schedule(config: SchedulerConfig, steps: int) -> Schedule:
    n = config.num_train_timesteps
    ts = np.linspace(n - 1, 0, steps, dtype=np.float64)
    acp = alphas_cumprod(config)
    sig_full = np.sqrt((1.0 - acp) / acp)
    low = np.floor(ts).astype(int)
    high = np.ceil(ts).astype(int)
    frac = np.mod(ts, 1.0)
    sigmas = (1.0 - frac) * sig_full[low] + frac * sig_full[high]
    sigmas = np.concatenate([sigmas, [0.0]])
    return Schedule(
        kind='lms', num_steps=steps, num_train_timesteps=n, ratio=n // steps,
        steps_offset=0,   # LMS predates steps_offset; index-driven instead
        length=steps, timesteps=torch.tensor(ts, dtype=torch.float32),
        alphas_cumprod=torch.tensor(acp, dtype=torch.float32),
        final_alpha_cumprod=torch.tensor(acp[0], dtype=torch.float32),
        sigmas=torch.tensor(sigmas, dtype=torch.float32),
        lms_coeffs=torch.from_numpy(lms_coefficient_table(sigmas, steps)))


def init_state(schedule: Schedule, latent_shape, dtype) -> State:
    del schedule, latent_shape, dtype
    return []


def scale_model_input(schedule: Schedule, sample: torch.Tensor,
                      i: int) -> torch.Tensor:
    """K-LMS input scaling ``x/√(σ²+1)``."""
    sigma = schedule.sigmas[i]
    return (sample.float() / torch.sqrt(sigma**2 + 1.0)).to(sample.dtype)


def step(schedule: Schedule, state: State, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None
         ) -> Tuple[State, torch.Tensor]:
    """One LMS update at table position ``i``. The derivative (x - x₀)/σ is
    ε itself for the ε-prediction type; ``eta`` and ``noise`` are unused."""
    del counter, eta, noise
    derivs = ([eps.float()] + state)[:4]
    coeffs = schedule.lms_coeffs[i]
    update = sum(coeffs[j] * d for j, d in enumerate(derivs))
    return derivs, (sample.float() + update).to(sample.dtype)


def add_noise(schedule: Schedule, sample: torch.Tensor, noise: torch.Tensor,
              index: int) -> torch.Tensor:
    """LMS img2img noising ``x + σ[index]·ε`` (index-driven)."""
    sigma = schedule.sigmas[int(index)]
    return (sample.float() + noise.float() * sigma).to(sample.dtype)
