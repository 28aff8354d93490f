"""LCM few-step bench: SD-1.4 geometry with the guidance embedding.

Port of ``tools/bench_lcm.py``. The LCM flow has no CFG (the guidance
scale enters through the embedding, ``time_cond_proj_dim`` 256), so each
step is one batch-1 UNet evaluation and an image takes 4 of them; then
the VAE decode and the uint8 quantization on the device (``round(255·x)``,
as the JAX script). Reported: the best of 7 latencies after the first call
(``compile_s``: the first call's seconds, kernel builds and allocator
warm-up included), images/min over 8 generations back to back, and
whether the image is finite. K1 and K6 serve the UNet, K6 the decode.

    python -m flexdiffuse_tpu_torch.tools.bench_lcm [--device cpu]

Prints one JSON line. On the CPU it runs the tiny models, as a check that
the path runs.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.config import LATENT_SCALE
from flexdiffuse_tpu_torch.models import (SD14_UNET, SD14_VAE, AutoencoderKL,
                                          UNet2DCondition)
from flexdiffuse_tpu_torch.models.configs import TINY_UNET, TINY_VAE
from flexdiffuse_tpu_torch.models.unet import guidance_scale_embedding
from flexdiffuse_tpu_torch.tools import parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (TOKENS, emit, finite,
                                                      seeded, sync, timed)

STEPS = 4
COND_DIM = 256


@torch.no_grad()
def generate(unet, vae, latents: torch.Tensor, ctx: torch.Tensor,
             tcond: torch.Tensor, schedule, gen: torch.Generator
             ) -> torch.Tensor:
    """The JAX script's ``generate``: the LCM loop (a fresh unit draw per
    step), then the decode to uint8 ``[B, H, W, 3]``."""
    lat = latents
    state = schedulers.init_state(schedule, lat.shape, lat.dtype)
    for i in range(schedule.length):
        t = schedulers.timestep_at(schedule, i).to(lat.device).expand(1)
        eps = unet(lat, t, ctx, timestep_cond=tcond)
        noise = torch.randn(lat.shape, generator=gen, device=lat.device)
        state, lat = schedulers.step(schedule, state, eps, i, i, lat,
                                     noise=noise)
    dtype = next(vae.parameters()).dtype
    img = vae.decode((lat / LATENT_SCALE).to(dtype)).float()
    img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)


def measure(unet, vae, device: torch.device, steps: int = STEPS,
            side: int = 64, reps: int = 7, queued: int = 8) -> dict:
    """``unet``: an LCM UNet (``time_cond_proj_dim``)."""
    cond_dim = unet.config.time_cond_proj_dim
    latents = torch.zeros((1, side, side, 4), device=device)
    ctx = torch.zeros((1, TOKENS, unet.config.cross_attention_dim),
                      device=device)
    tcond = guidance_scale_embedding(torch.tensor([7.0]), cond_dim).to(
        device)
    schedule = schedulers.make('lcm', steps)
    gen = torch.Generator(device).manual_seed(0)
    run = lambda: generate(unet, vae, latents, ctx, tcond, schedule, gen)
    times, out, first = timed(run, device, reps)
    t0 = time.perf_counter()
    for _ in range(queued):
        run()
    sync(device)
    queued_s = time.perf_counter() - t0
    return {
        'metric': f'sd1.4 {side * 8}x{side * 8} LCM {steps}-step image '
                  '(loop+decode, batch 1)',
        'p50_latency_s': min(times),
        'images_per_min': 60.0 * queued / queued_s,
        'compile_s': first,
        'finite': finite(out),
    }


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    if device.type == 'cuda':
        cfg = dataclasses.replace(SD14_UNET, time_cond_proj_dim=COND_DIM)
        res = measure(seeded(UNet2DCondition, cfg, device),
                      seeded(AutoencoderKL, SD14_VAE, device), device)
    else:
        cfg = dataclasses.replace(TINY_UNET, time_cond_proj_dim=COND_DIM)
        res = measure(seeded(UNet2DCondition, cfg, device, torch.float32),
                      seeded(AutoencoderKL, TINY_VAE, device, torch.float32),
                      device, side=8, reps=1, queued=1)
    emit(res, device)


if __name__ == '__main__':
    main()
