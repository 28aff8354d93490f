"""PNDM in PLMS mode (``skip_prk_steps=True``, SD v1.x's shipped scheduler)
and in the Runge–Kutta warm-up mode (``skip_prk_steps=False``); port of
``flexdiffuse_tpu/schedulers/pndm.py``.

PLMS:

* ``timesteps`` has ``steps+1`` entries with the second-to-last duplicated
  (the PLMS warm-up), so the pipeline makes ``steps+1`` UNet calls.
* call 0 stashes the sample, call 1 re-uses it with the averaged ε and a
  shifted timestep pair; later calls use the Adams–Bashforth formula with
  the same ramp of weights as the JAX package's coefficient table.

PRK (diffusers 0.3.0 PNDM): three RK4 transitions over the three highest
timestep intervals (12 UNet calls that build a 3-deep ε history), then
4th-order PLMS over the other ``steps-3`` timesteps, ``steps+9`` calls in
all. As in the JAX package every branch is a per-position table (anchor and
target timesteps, RK accumulator gains, ε weights, stash and push flags)
indexed by the absolute position, so img2img would enter the table mid
warm-up: the pipeline rejects it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch.schedulers.base import (Schedule, SchedulerConfig,
                                                   alphas_cumprod,
                                                   timestep_at)

# ε-combination weights over the history [newest, ..., oldest] per call
# counter (clipped at 4).
_BUFFER_WEIGHTS = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.5, 0.0, 0.0, 0.0],
    [3 / 2, -1 / 2, 0.0, 0.0],
    [23 / 12, -16 / 12, 5 / 12, 0.0],
    [55 / 24, -59 / 24, 37 / 24, -9 / 24],
], dtype=np.float32)

# PLMS: (ε history newest first, at most 4 entries; stashed sample or
# None); PRK: the same and the RK accumulator (0.0 until the first call).
State = tuple


@dataclasses.dataclass(frozen=True)
class PRKSchedule(Schedule):
    """PNDM schedule in PRK mode: per-position tables (``[L]`` or ``[L, 4]``
    fp32; flags as bools), indexed by the absolute position."""
    t_tr: Optional[torch.Tensor] = None       # transfer anchor timestep
    prev_tr: Optional[torch.Tensor] = None    # transfer target timestep
    eps_a: Optional[torch.Tensor] = None      # weight of the raw ε
    eps_b: Optional[torch.Tensor] = None      # weight of the RK accumulator
    eps_w: Optional[torch.Tensor] = None      # [L, 4] over the ε history
    acc_g: Optional[torch.Tensor] = None      # accumulator gain on ε
    acc_keep: Optional[torch.Tensor] = None   # 0 resets the accumulator
    push: Tuple[bool, ...] = ()               # push ε into the history
    stash: Tuple[bool, ...] = ()              # stash the incoming sample
    use_stash: Tuple[bool, ...] = ()          # transfer from the stash


def make_schedule(config: SchedulerConfig, steps: int) -> Schedule:
    if not config.skip_prk_steps:
        return _make_prk_schedule(config, steps)
    ratio = config.num_train_timesteps // steps
    base = np.arange(steps) * ratio + config.steps_offset
    ts = np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1].copy()
    acp = alphas_cumprod(config)
    return Schedule(
        kind='pndm', num_steps=steps,
        num_train_timesteps=config.num_train_timesteps, ratio=ratio,
        steps_offset=config.steps_offset, length=steps + 1,
        timesteps=torch.tensor(ts, dtype=torch.float32),
        alphas_cumprod=torch.tensor(acp, dtype=torch.float32),
        # PNDM: set_alpha_to_one=False semantics.
        final_alpha_cumprod=torch.tensor(acp[0], dtype=torch.float32))


def _make_prk_schedule(config: SchedulerConfig, steps: int) -> PRKSchedule:
    """12 PRK positions (3 RK4 groups over the top 3 intervals), then
    ``steps-3`` PLMS positions (JAX ``_make_prk_schedule``)."""
    if steps < 4:
        raise ValueError('PRK warm-up needs steps >= 4')
    n = config.num_train_timesteps
    ratio = n // steps
    base = np.arange(steps) * ratio + config.steps_offset   # ascending
    half = ratio // 2
    # diffusers 0.3.0 prk_timesteps: the last 4 repeated with [0, ratio//2]
    # added in turn, drop-last, repeated, ends trimmed, reversed.
    pairs = np.repeat(base[-4:], 2) + np.tile([0, half], 4)
    prk_feed = np.repeat(pairs[:-1], 2)[1:-1][::-1].copy()  # [12]
    plms_feed = base[:-3][::-1].copy()                      # [steps-3]
    feed = np.concatenate([prk_feed, plms_feed]).astype(np.float64)
    length = len(feed)                                      # steps + 9

    t_tr = np.zeros(length)
    prev_tr = np.zeros(length)
    eps_a = np.zeros(length)
    eps_b = np.zeros(length)
    eps_w = np.zeros((length, 4))
    acc_g = np.zeros(length)
    acc_keep = np.ones(length)
    push = np.zeros(length, bool)
    stash = np.zeros(length, bool)
    use_stash = np.zeros(length, bool)
    for c in range(12):
        anchor = prk_feed[(c // 4) * 4]
        phase = c % 4
        t_tr[c] = anchor
        prev_tr[c] = anchor - (half if phase < 2 else ratio)
        eps_a[c] = 1.0 if phase < 3 else 1.0 / 6.0
        eps_b[c] = 0.0 if phase < 3 else 1.0
        acc_g[c] = (1.0 / 6.0, 1.0 / 3.0, 1.0 / 3.0, 0.0)[phase]
        acc_keep[c] = 0.0 if phase == 3 else 1.0
        push[c] = phase == 0
        stash[c] = phase == 0
        use_stash[c] = True
    for j, t in enumerate(plms_feed):
        c = 12 + j
        t_tr[c] = t
        prev_tr[c] = t - ratio
        eps_w[c] = _BUFFER_WEIGHTS[4]   # 3-deep history + push: 4th order
        push[c] = True

    acp = alphas_cumprod(config)
    f32 = lambda a: torch.tensor(a, dtype=torch.float32)
    return PRKSchedule(
        kind='pndm', num_steps=steps, num_train_timesteps=n, ratio=ratio,
        steps_offset=config.steps_offset, length=length,
        timesteps=f32(feed), alphas_cumprod=f32(acp),
        final_alpha_cumprod=f32(acp[0]), t_tr=f32(t_tr),
        prev_tr=f32(prev_tr), eps_a=f32(eps_a), eps_b=f32(eps_b),
        eps_w=f32(eps_w), acc_g=f32(acc_g), acc_keep=f32(acc_keep),
        push=tuple(bool(v) for v in push),
        stash=tuple(bool(v) for v in stash),
        use_stash=tuple(bool(v) for v in use_stash))


def init_state(schedule: Schedule, latent_shape, dtype) -> State:
    del latent_shape, dtype
    if isinstance(schedule, PRKSchedule):
        return [], None, 0.0
    return [], None


def _transfer(schedule: Schedule, sample: torch.Tensor, t: int, prev_t: int,
              eps: torch.Tensor) -> torch.Tensor:
    """The PNDM x_t → x_{t-δ} transfer formula (PNDM paper eq. 11), with
    fp32 coefficients."""
    n = schedule.num_train_timesteps
    acp = schedule.alphas_cumprod
    ap_t = acp[min(max(t, 0), n - 1)]
    ap_prev = acp[prev_t] if prev_t >= 0 else schedule.final_alpha_cumprod
    sample_coeff = torch.sqrt(ap_prev / ap_t)
    denom = (ap_t * torch.sqrt(1.0 - ap_prev) +
             torch.sqrt(ap_t * (1.0 - ap_t) * ap_prev))
    return sample_coeff * sample - (ap_prev - ap_t) * eps / denom


def _step_prk(schedule: PRKSchedule, state: State, eps: torch.Tensor,
              i: int, sample: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """Table-driven PRK+PLMS step (JAX ``_step_prk``)."""
    ets, cur_sample, acc = state
    eps32 = eps.float()
    sample32 = sample.float()
    if schedule.stash[i]:
        cur_sample = sample32
    sample_used = cur_sample if schedule.use_stash[i] else sample32
    if schedule.push[i]:
        ets = ([eps32] + ets)[:4]
    eps_used = schedule.eps_a[i] * eps32 + schedule.eps_b[i] * acc
    for j, e in enumerate(ets):
        eps_used = eps_used + schedule.eps_w[i, j] * e
    acc = (acc + schedule.acc_g[i] * eps32) * schedule.acc_keep[i]
    prev = _transfer(schedule, sample_used, int(schedule.t_tr[i]),
                     int(schedule.prev_tr[i]), eps_used)
    return (ets, cur_sample, acc), prev.to(sample.dtype)


def step(schedule: Schedule, state: State, eps: torch.Tensor, i: int,
         counter: int, sample: torch.Tensor, eta: float = 0.0,
         noise: Optional[torch.Tensor] = None) -> Tuple[State, torch.Tensor]:
    """One PLMS (or PRK-mode) update at table position ``i``, ``counter``
    calls after the first active one; ``eta`` and ``noise`` are unused."""
    del eta, noise
    if isinstance(schedule, PRKSchedule):
        return _step_prk(schedule, state, eps, i, sample)
    ets, cur_sample = state
    eps32 = eps.float()
    sample32 = sample.float()

    t = int(timestep_at(schedule, i))
    is_c1 = counter == 1
    t_used = t + schedule.ratio if is_c1 else t
    prev_t = t if is_c1 else t - schedule.ratio

    if counter == 0:
        cur_sample = sample32
    sample_used = cur_sample if is_c1 else sample32

    if not is_c1:
        ets = ([eps32] + ets)[:4]

    w = _BUFFER_WEIGHTS[min(counter, 4)]
    eps_prime = sum(float(w[j]) * e for j, e in enumerate(ets))
    if is_c1:
        eps_prime = eps_prime + 0.5 * eps32

    prev = _transfer(schedule, sample_used, t_used, prev_t, eps_prime)
    return (ets, cur_sample), prev.to(sample.dtype)
