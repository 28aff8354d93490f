"""Shared parts of the ported bench and A/B tools (``bench_*.py``,
``*_exp.py``): synchronised host timing, seeded models and inputs, and the
JSON line each tool prints.

The JAX scripts time with a host fetch (``np.asarray``), which waits for
the device; the port has no fetch to force, so every timed call ends in
``torch.cuda.synchronize()``. Every line names the device it ran on: the
card's name and power limit as ``nvidia-smi`` prints them, or 'cpu'.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import time
from typing import Callable, List, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.pipeline import SimpleGuidance
from flexdiffuse_tpu_torch.tools import BF16

# The text context of SD-1.x (CLIP ViT-L/14: 77 tokens of 768).
TOKENS = 77


def sync(device: torch.device) -> None:
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def timed(fn: Callable, device: torch.device, reps: int,
          warm: bool = True) -> Tuple[List[float], object, float]:
    """``fn()`` once to warm up (kernel builds, allocator) when ``warm``,
    then ``reps`` more times, each ending in a synchronise: (seconds of
    each timed call, the last output, the warm-up's seconds)."""
    t0 = time.perf_counter()
    out = fn() if warm else None
    sync(device)
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        times.append(time.perf_counter() - t0)
    return times, out, first


def seeded(cls, config, device: torch.device, dtype: torch.dtype = BF16,
           seed: int = 0) -> torch.nn.Module:
    """``cls(config)`` with seeded random weights, made on ``device``, in
    ``dtype``, frozen and in eval mode."""
    torch.manual_seed(seed)
    with torch.device(device):
        model = cls(config)
    return model.to(dtype).eval().requires_grad_(False)


def card(device: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or 'cpu'."""
    device = torch.device(device)
    if device.type != 'cuda':
        return 'cpu'
    smi = shutil.which('nvidia-smi')
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if smi:
        out = subprocess.run(
            [smi, '--query-gpu=name,power.limit', '--format=csv,noheader',
             f'--id={index}'], capture_output=True, text=True)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    return torch.cuda.get_device_name(index)


def emit(res: dict, device: torch.device) -> dict:
    """Print ``res`` with the device as one JSON line; returns it."""
    res = dict(res, device=card(device))
    print(json.dumps(res), flush=True)
    return res


def cfg_guide(batch: int, ctx_dim: int, device: torch.device,
              scale: float = 8.0, seed: int = 0) -> SimpleGuidance:
    """The JAX tools' CFG guide: prompt rows ``[batch, 77, ctx_dim]`` and one
    uncond row, normal·0.3 from numpy's ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(batch, TOKENS, ctx_dim)).astype(np.float32) * .3
    unc = rng.normal(size=(1, TOKENS, ctx_dim)).astype(np.float32) * .3
    return SimpleGuidance(embeddings=torch.from_numpy(emb).to(device),
                          uncond=torch.from_numpy(unc).to(device),
                          guidance_scale=scale)


def start_noise(batch: int, side: int, device: torch.device,
                seed: int = 7) -> torch.Tensor:
    """Unit-normal initial latents ``[batch, side, side, 4]`` from numpy's
    ``default_rng(seed)`` (the JAX tools draw ``PRNGKey(7)``)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, side, side, 4)).astype(np.float32)
    return torch.from_numpy(x).to(device)


def finite(x) -> bool:
    if isinstance(x, torch.Tensor):
        return bool(torch.isfinite(x.float()).all())
    return bool(np.isfinite(np.asarray(x, np.float32)).all())


def mse(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(((a.float() - b.float())**2).mean())



@torch.no_grad()
def cfg_loop(unet, schedule: schedulers.Schedule, latents: torch.Tensor,
             ctx: torch.Tensor, gs: float, added_cond=None,
             deepcache: int = 0) -> torch.Tensor:
    """The JAX tools' CFG scan body, row by row: the UNet on ``[lat,
    lat]`` at ``timesteps[i]``, ``ε_u + gs·(ε_c − ε_u)``, the scheduler's
    update. ``deepcache`` ≥ 2: every ``deepcache``-th row runs the full
    UNet and saves the deep feature ('save'), the rows between run the
    shallow levels around it ('use'). Returns the final latents."""
    lat = latents
    state = schedulers.init_state(schedule, lat.shape, lat.dtype)
    kw = {} if added_cond is None else dict(added_cond=added_cond)
    cache = None
    for i in range(schedule.length):
        t = schedulers.timestep_at(schedule, i).to(lat.device).expand(
            2 * lat.shape[0])
        lat2 = torch.cat([lat, lat])
        if deepcache < 2:
            eps = unet(lat2, t, ctx, **kw)
        elif i % deepcache == 0:
            eps, cache = unet(lat2, t, ctx, cache_mode='save', **kw)
        else:
            eps, _ = unet(lat2, t, ctx, deep_cache=cache, cache_mode='use',
                          **kw)
        eps_u, eps_c = eps.chunk(2)
        state, lat = schedulers.step(schedule, state,
                                     eps_u + gs * (eps_c - eps_u), i, i, lat)
    return lat
