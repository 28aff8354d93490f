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
# (x = x0 + sigma*eps; input scaling x/sqrt(sigma^2+1)).
SIGMA_SPACE_KINDS = ('lms', 'euler', 'euler_a', 'heun')


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """The training schedule and the per-kind switches of the JAX
    package's config.

    - ``beta_schedule``: 'scaled_linear' (SD) or 'linear';
      ``rescale_betas_zero_snr`` rescales the betas to a zero terminal SNR
      (Lin et al. 2023), for checkpoints trained so.
    - ``steps_offset``: the reference's shim (1).
    - DDIM's ``clip_sample`` and ``set_alpha_to_one`` (diffusers'
      defaults); PNDM's ``skip_prk_steps`` (True: PLMS, what SD ships;
      False: the PRK warm-up).
    - ``use_karras_sigmas``: Karras et al. (2022) ρ-7 σ spacing (euler,
      euler_a, dpmpp, unipc, heun).
    - ``prediction_type``: 'epsilon' or 'v_prediction' (SD-2.x 768-v; v is
      turned into ε once per step, :func:`~flexdiffuse_tpu_torch.
      schedulers.convert_v_prediction`).
    - LCM's ``original_inference_steps`` and ``timestep_scaling``.
    - ``timestep_spacing``: 'leading' (SD) or 'trailing' (the first step at
      T−1, which zero-SNR checkpoints need); DDIM and DDPM honour it.
    - ``kind`` is the JAX config's label; :func:`~flexdiffuse_tpu_torch.
      schedulers.make` takes the kind as its own argument.
    """
    kind: str = 'pndm'
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = 'scaled_linear'
    steps_offset: int = 1
    clip_sample: bool = True
    set_alpha_to_one: bool = True
    skip_prk_steps: bool = True
    use_karras_sigmas: bool = False
    prediction_type: str = 'epsilon'
    original_inference_steps: int = 50
    timestep_scaling: float = 10.0
    timestep_spacing: str = 'leading'
    rescale_betas_zero_snr: bool = False


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Shift and scale ``sqrt(alphas_cumprod)`` so the terminal SNR is zero
    and the first value is kept (Lin et al. 2023, algorithm 1). The
    terminal ᾱ is floored at 1e-12, not 0: the samplers recover x₀ as
    ``(x − √(1−ᾱ)·ε)/√ᾱ``, which is exact in fp32 for a tiny ᾱ."""
    abar_sqrt = np.sqrt(np.cumprod(1.0 - betas, axis=0))
    a0, a_t = abar_sqrt[0], abar_sqrt[-1]
    abar_sqrt = (abar_sqrt - a_t) * (a0 / (a0 - a_t))
    abar = abar_sqrt**2
    abar[-1] = max(abar[-1], 1e-12)
    alphas = np.concatenate([abar[:1], abar[1:] / abar[:-1]])
    return 1.0 - alphas


def spaced_timesteps(config: SchedulerConfig, steps: int,
                     offset: int = 0) -> np.ndarray:
    """Descending inference timesteps under ``config.timestep_spacing``:
    'leading' ``(arange(steps)·ratio)[::-1] + offset`` (SD's spacing, never
    reaching T−1); 'trailing' ``round(arange(T, 0, −T/steps)) − 1``."""
    n = config.num_train_timesteps
    if config.timestep_spacing == 'leading':
        ratio = n // steps
        return (np.arange(steps) * ratio)[::-1].copy() + offset
    if config.timestep_spacing == 'trailing':
        return np.round(np.arange(n, 0, -n / steps)).astype(np.int64) - 1
    raise ValueError(
        f'unknown timestep_spacing {config.timestep_spacing!r}')


def make_betas(config: SchedulerConfig) -> np.ndarray:
    n = config.num_train_timesteps
    if config.beta_schedule == 'scaled_linear':
        betas = np.linspace(config.beta_start**0.5, config.beta_end**0.5, n,
                            dtype=np.float64)**2
    elif config.beta_schedule == 'linear':
        betas = np.linspace(config.beta_start, config.beta_end, n,
                            dtype=np.float64)
    else:
        raise ValueError(f'unknown beta schedule {config.beta_schedule!r}')
    if config.rescale_betas_zero_snr:
        betas = rescale_zero_terminal_snr(betas)
    return betas


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
    clip_sample: bool = False       # DDIM/DDPM: clip x0 to [-1, 1]
    sigmas: Optional[torch.Tensor] = None      # [length + 1] (σ kinds)
    lms_coeffs: Optional[torch.Tensor] = None  # [length, 4] (LMS)
    # v-parameterised model (SD-2.x): step() turns v into ε first.
    v_prediction: bool = False
    # Table rows per sampling step (Heun's predictor and corrector: 2); an
    # img2img t_start in steps scales by it.
    rows_per_step: int = 1


def timestep_at(schedule: Schedule, i: int) -> torch.Tensor:
    """``timesteps[i]`` with ``i`` clamped to the last entry, as JAX's
    gather reads it: PNDM at one step has ``length`` 2 and one timestep,
    and its second call reads that timestep again."""
    return schedule.timesteps[min(i, schedule.timesteps.shape[0] - 1)]


def f32(a) -> torch.Tensor:
    """A host table as an fp32 CPU tensor."""
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float32)


def karras_sigmas(sigma_min: float, sigma_max: float, steps: int,
                  rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) σ spacing (descending, no terminal 0)."""
    ramp = np.linspace(0.0, 1.0, steps)
    inv_rho = 1.0 / rho
    return (sigma_max**inv_rho +
            ramp * (sigma_min**inv_rho - sigma_max**inv_rho))**rho


def sigmas_to_timesteps(sigmas: np.ndarray,
                        sig_full: np.ndarray) -> np.ndarray:
    """Invert σ(t) (monotonic in t) to fractional train timesteps."""
    return np.interp(sigmas, sig_full, np.arange(len(sig_full)))


def sigma_table(config: SchedulerConfig, steps: int):
    """``(train timesteps, σ per step)`` of the σ-space kinds: the float
    linspace from T−1 to 0 with σ interpolated linearly in t, or under
    ``use_karras_sigmas`` Karras's σ with their fractional timesteps."""
    n = config.num_train_timesteps
    acp = alphas_cumprod(config)
    sig_full = np.sqrt((1.0 - acp) / acp)
    if config.use_karras_sigmas:
        sigmas = karras_sigmas(float(sig_full[0]), float(sig_full[-1]),
                               steps)
        return sigmas_to_timesteps(sigmas, sig_full), sigmas
    ts = np.linspace(n - 1, 0, steps, dtype=np.float64)
    low = np.floor(ts).astype(int)
    high = np.ceil(ts).astype(int)
    frac = np.mod(ts, 1.0)
    return ts, (1.0 - frac) * sig_full[low] + frac * sig_full[high]


def vp_table(config: SchedulerConfig, steps: int):
    """``(timesteps, α, σ, σ/α)`` per position of the VP-table kinds (dpmpp,
    unipc): integer timesteps spaced over [0, T−1] inclusive, trailing
    style; under ``use_karras_sigmas`` Karras's σ/α with fractional
    timesteps and exact (α, σ) from them."""
    n = config.num_train_timesteps
    acp = alphas_cumprod(config)
    if config.use_karras_sigmas:
        sig_full = np.sqrt((1.0 - acp) / acp)
        sig_k = karras_sigmas(float(sig_full[0]), float(sig_full[-1]), steps)
        ts = sigmas_to_timesteps(sig_k, sig_full)
        alpha = 1.0 / np.sqrt(sig_k**2 + 1.0)
        return ts, alpha, sig_k * alpha, sig_k
    ts = np.linspace(0, n - 1, steps + 1).round()[::-1][:-1].astype(
        np.float64)
    idx = ts.astype(int)
    alpha = np.sqrt(acp[idx])
    sigma = np.sqrt(1.0 - acp[idx])
    return ts, alpha, sigma, sigma / alpha


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
