"""DPM-Solver++(2M) (Lu et al. 2022, arXiv:2211.01095, algorithm 2) in
data-prediction form on the variance-preserving schedule.

With α_t = √ᾱ_t, σ_t = √(1 − ᾱ_t), λ_t = log(α_t/σ_t) and h_i = λ_{i+1} −
λ_i, each step predicts x₀ = (x − σ_i·ε)/α_i and moves

    x ← (σ_{i+1}/σ_i)·x − α_{i+1}·(e^{−h_i} − 1)·D_i,

D_i = x₀ on the first step (first order) and otherwise
x₀ + (h_i / 2h_{i−1})·(x₀ − x₀ of the previous step) (the 2M multistep
correction, r = h_{i−1}/h_i). The last step goes to σ = 0, where the update
is x ← x₀ (first order).

The training schedule is SD's "scaled linear" betas. The timesteps are
``linspace(0, T − 1, steps + 1)`` rounded, descending, the last (0)
dropped: diffusers' ``DPMSolverMultistepScheduler`` default spacing.
Departure: the snapshot's ``timestep_spacing`` and ``steps_offset``
('leading', 1) belong to its Euler scheduler and are not read here.

Config keys (group ``scheduler``): ``num_train_timesteps``,
``beta_start``, ``beta_end``, ``prediction_type`` ('epsilon' only).
"""
from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from bench_h100.reference.samplers import alphas_cumprod

Tensor = torch.Tensor


def timesteps(sc: dict, steps: int) -> np.ndarray:
    n = sc['num_train_timesteps']
    return np.linspace(0, n - 1, steps + 1).round()[::-1][:-1].astype(
        np.int64)


def sample(model: Callable, x: Tensor, steps: int, sc: dict) -> Tensor:
    """``model(x, t) -> ε``; ``x`` the unit noise; returns x₀."""
    if sc['prediction_type'] != 'epsilon':
        raise ValueError('this reference samples ε-prediction models only')
    acp = alphas_cumprod(sc)
    ts = timesteps(sc, steps)
    alpha = [math.sqrt(acp[t]) for t in ts]
    sigma = [math.sqrt(1.0 - acp[t]) for t in ts]
    lam = [math.log(a / s) for a, s in zip(alpha, sigma)]
    x0_prev, h_prev = None, None
    for i, t in enumerate(int(v) for v in ts):
        x0 = (x - sigma[i] * model(x, t)) / alpha[i]
        if i == len(ts) - 1:
            return x0
        h = lam[i + 1] - lam[i]
        d = x0 if x0_prev is None else \
            x0 + (h / (2.0 * h_prev)) * (x0 - x0_prev)
        x = (sigma[i + 1] / sigma[i]) * x - \
            alpha[i + 1] * math.expm1(-h) * d
        x0_prev, h_prev = x0, h
    return x
