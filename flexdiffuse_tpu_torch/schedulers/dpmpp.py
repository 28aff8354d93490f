"""DPM-Solver++ (2M) in data-prediction form; port of
``flexdiffuse_tpu/schedulers/dpmpp.py``.

Every per-position coefficient of the update

    x ← (σ_t/σ_s)·x − α_t·(e^{−h} − 1)·D0 − ½·α_t·(e^{−h} − 1)·D1

is a host table (the exact σ → 0 limit on the final step included, where
the update is ``x ← x₀``); the state is the previous x₀ prediction. The
first and last steps are first order. VP space: identity input scaling,
``α·x + σ·ε`` img2img noising from the per-position (α, σ) tables, exact
for the fractional timesteps of Karras spacing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod, f32,
                                                   vp_table)


@dataclasses.dataclass(frozen=True)
class DPMSchedule(Schedule):
    """Schedule with DPM-Solver++ tables (``[L]`` each)."""
    c_x: Optional[torch.Tensor] = None
    c_d0: Optional[torch.Tensor] = None
    r0_inv: Optional[torch.Tensor] = None    # h/h_prev for the D1 term
    use_2nd: Tuple[bool, ...] = ()
    vp_alpha: Optional[torch.Tensor] = None  # (α_t, σ_t) per position
    vp_sigma: Optional[torch.Tensor] = None


def make_schedule(config: SchedulerConfig, steps: int) -> DPMSchedule:
    n = config.num_train_timesteps
    acp = alphas_cumprod(config)
    ts, alpha, sigma, sig_k = vp_table(config, steps)
    lam = np.log(alpha) - np.log(sigma)
    # Terminal state: σ → 0, α → 1, λ → ∞.
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    lam_next = np.concatenate([lam[1:], [np.inf]])
    h = lam_next - lam
    # The sample coefficient is the VP σ ratio (latents live in VP space);
    # the terminal σ = 0 gives c_x = 0.
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    c_x = sigma_next / np.maximum(sigma, 1e-20)
    c_d0 = -alpha_next * (np.exp(-np.minimum(h, 60.0)) - 1.0)
    h_prev = np.concatenate([[np.nan], h[:-1]])
    with np.errstate(invalid='ignore', divide='ignore'):
        r0_inv = np.where(np.isfinite(h_prev / h),
                          h / np.maximum(h_prev, 1e-20), 0.0)
    use_2nd = np.zeros(steps, bool)
    if steps > 2:
        # The first step has no history; the final one is first order at
        # any step count (the zero terminal σ makes h_final infinite).
        use_2nd[1:-1] = True
    r0_inv = np.where(use_2nd, np.nan_to_num(r0_inv), 0.0)
    return DPMSchedule(
        kind='dpmpp', num_steps=steps, num_train_timesteps=n,
        ratio=n // steps, steps_offset=0, length=steps, timesteps=f32(ts),
        alphas_cumprod=f32(acp), final_alpha_cumprod=f32(acp[0]),
        sigmas=f32(np.concatenate([sig_k, [0.0]])), c_x=f32(c_x),
        c_d0=f32(c_d0), r0_inv=f32(r0_inv),
        use_2nd=tuple(bool(u) for u in use_2nd), vp_alpha=f32(alpha),
        vp_sigma=f32(sigma))


def init_state(schedule: DPMSchedule, latent_shape, dtype):
    """The previous x₀ (None before the first step)."""
    del schedule, latent_shape, dtype
    return None


def step(schedule: DPMSchedule, state, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None):
    del eta, noise
    x = sample.float()
    x0 = (x - schedule.vp_sigma[i] * eps.float()) / schedule.vp_alpha[i]
    prev = schedule.c_x[i] * x + schedule.c_d0[i] * x0
    # D1 needs a previous x₀ of this run (counter ≥ 1).
    if schedule.use_2nd[i] and counter >= 1:
        d1 = (x0 - state) * schedule.r0_inv[i]
        prev = prev + 0.5 * schedule.c_d0[i] * d1
    return x0, prev.to(sample.dtype)
