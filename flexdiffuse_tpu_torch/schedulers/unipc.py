"""UniPC, the unified predictor-corrector sampler (Zhao et al. 2023) at
order 2; port of ``flexdiffuse_tpu/schedulers/unipc.py`` (data prediction,
B(h) = e^{−h} − 1 "bh2", ``lower_order_final``, zero terminal σ: diffusers'
``UniPCMultistepScheduler`` defaults).

Every position-dependent coefficient, the 2×2 corrector solve included, is
a host table computed in float64. The state is ``(m_prev, m_prev2,
x_last)``: the two previous x₀ predictions and the previous corrected
sample. Per position i:

1. m_i = (x − σ_i·ε)/α_i;
2. UniC (counter ≥ 1) corrects the incoming sample with m_i (order 1 at
   counter 1, order 2 after);
3. UniP predicts position i+1 from the corrected sample (second order
   except at the first and the final position).

VP space throughout, as DPM++.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod, f32,
                                                   vp_table)


@dataclasses.dataclass(frozen=True)
class UniPCSchedule(Schedule):
    """UniP/UniC coefficient tables (``[L]`` each).

    Predictor: ``x ← p_cx·x + p_m0·m_i + p_d1·(m_{i−1} − m_i)``.
    Corrector: ``x ← c_cx·x_last + c_m0·m_{i−1} + c_d10·(m_{i−2} −
    m_{i−1}) + c_d1t·(m_i − m_{i−1})``; order 1 uses ``c_d1t_o1`` alone.
    """
    p_cx: Optional[torch.Tensor] = None
    p_m0: Optional[torch.Tensor] = None
    p_d1: Optional[torch.Tensor] = None
    c_cx: Optional[torch.Tensor] = None
    c_m0: Optional[torch.Tensor] = None
    c_d10: Optional[torch.Tensor] = None
    c_d1t: Optional[torch.Tensor] = None
    c_d1t_o1: Optional[torch.Tensor] = None
    vp_alpha: Optional[torch.Tensor] = None
    vp_sigma: Optional[torch.Tensor] = None


def make_schedule(config: SchedulerConfig, steps: int) -> UniPCSchedule:
    n = config.num_train_timesteps
    acp = alphas_cumprod(config)
    ts, alpha, sigma, sig_k = vp_table(config, steps)
    lam = np.log(alpha) - np.log(sigma)
    L = steps
    # The terminal σ is 0, so h[L-1] is infinite: the final predictor is
    # x ← m, taken through the explicit limits below.
    lam_next = np.concatenate([lam[1:], [np.inf]])
    sigma_next = np.concatenate([sigma[1:], [0.0]])
    alpha_next = np.concatenate([alpha[1:], [1.0]])
    h = lam_next - lam

    def phi1(hv):  # e^{−h} − 1, safe at h = ∞
        return np.expm1(-np.minimum(hv, 60.0))

    p_cx = sigma_next / np.maximum(sigma, 1e-20)
    p_m0 = -alpha_next * phi1(h)
    p_d1 = np.zeros(L)
    for i in range(1, L - 1):
        r1p = -h[i - 1] / h[i]
        p_d1[i] = -alpha_next[i] * phi1(h[i]) * 0.5 / r1p

    c_cx, c_m0, c_d10, c_d1t, c_d1t_o1 = (np.zeros(L) for _ in range(5))
    for i in range(1, L):
        hc = h[i - 1]
        hh = -hc
        p1 = phi1(hc)
        c_cx[i] = sigma[i] / sigma[i - 1]
        c_m0[i] = -alpha[i] * p1
        c_d1t_o1[i] = -alpha[i] * p1 * 0.5
        if i >= 2:
            r1c = -h[i - 2] / hc
            b1 = (p1 / hh - 1.0) / p1
            b2 = 2.0 * ((p1 / hh - 1.0) / hh - 0.5) / p1
            rho0 = (b2 - b1) / (r1c - 1.0)
            rho1 = b1 - rho0
            c_d10[i] = -alpha[i] * p1 * rho0 / r1c
            c_d1t[i] = -alpha[i] * p1 * rho1

    return UniPCSchedule(
        kind='unipc', num_steps=steps, num_train_timesteps=n,
        ratio=n // steps, steps_offset=0, length=steps, timesteps=f32(ts),
        alphas_cumprod=f32(acp), final_alpha_cumprod=f32(acp[0]),
        sigmas=f32(np.concatenate([sig_k, [0.0]])), p_cx=f32(p_cx),
        p_m0=f32(p_m0), p_d1=f32(p_d1), c_cx=f32(c_cx), c_m0=f32(c_m0),
        c_d10=f32(c_d10), c_d1t=f32(c_d1t), c_d1t_o1=f32(c_d1t_o1),
        vp_alpha=f32(alpha), vp_sigma=f32(sigma))


def init_state(schedule: UniPCSchedule, latent_shape, dtype):
    """(m_prev, m_prev2, x_last), None before they exist."""
    del schedule, latent_shape, dtype
    return (None, None, None)


def step(schedule: UniPCSchedule, state, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None):
    del eta, noise
    m_prev, m_prev2, x_last = state
    x = sample.float()
    m = (x - schedule.vp_sigma[i] * eps.float()) / schedule.vp_alpha[i]
    if counter >= 1:
        # UniC: correct the incoming predictor sample with m_i.
        x = schedule.c_cx[i] * x_last + schedule.c_m0[i] * m_prev
        if counter == 1:
            x = x + schedule.c_d1t_o1[i] * (m - m_prev)
        else:
            x = (x + schedule.c_d10[i] * (m_prev2 - m_prev) +
                 schedule.c_d1t[i] * (m - m_prev))
    # UniP: predict position i+1 (p_d1 is 0 at the first and final rows).
    prev = schedule.p_cx[i] * x + schedule.p_m0[i] * m
    if counter >= 1:
        prev = prev + schedule.p_d1[i] * (m_prev - m)
    return (m, m_prev, x), prev.to(sample.dtype)
