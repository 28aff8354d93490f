"""Throughput-mode bench: the SD-1.4 512² CFG PNDM loop at several batch
sizes.

Port of ``tools/bench_batch.py``: larger batches amortize the weight
traffic across images. Each batch runs the JAX script's loop (zero
latents and context, the UNet at 2B with CFG 8, the PNDM update), with
12 steps, timed as the best of 3 after a warm-up, each run ending in a
synchronise. K1 serves the eligible self-attentions, K6 the GroupNorms.

    python -m flexdiffuse_tpu_torch.tools.bench_batch [--device cpu]

Prints one JSON line per batch (1, 2, 4, 8). On the CPU it runs the tiny
UNet at batch 1 and 2 steps, as a check that the path runs.
"""
from __future__ import annotations

import torch

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.models import SD14_UNET, UNet2DCondition
from flexdiffuse_tpu_torch.models.configs import TINY_UNET
from flexdiffuse_tpu_torch.tools import parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (TOKENS, cfg_loop,
                                                      emit, seeded, timed)

STEPS = 12
BATCHES = (1, 2, 4, 8)


def bench(unet, batch: int, device: torch.device, steps: int = STEPS,
          reps: int = 3, side: int = 64) -> dict:
    latents = torch.zeros((batch, side, side, 4), device=device)
    ctx = torch.zeros((2 * batch, TOKENS, unet.config.cross_attention_dim),
                      device=device)
    schedule = schedulers.make('pndm', steps)
    times, _, _ = timed(lambda: cfg_loop(unet, schedule, latents, ctx, 8.0),
                        device, reps)
    best = min(times)
    scan_len = schedule.length
    # A 25-step generation is about 26 UNet calls.
    return dict(batch=batch, steps_per_sec=scan_len / best,
                images_per_min_25step=60.0 / (best / scan_len * 26) * batch)


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    if device.type == 'cuda':
        unet = seeded(UNet2DCondition, SD14_UNET, device)
        for b in BATCHES:
            emit(bench(unet, b, device), device)
    else:
        unet = seeded(UNet2DCondition, TINY_UNET, device, torch.float32)
        emit(bench(unet, 1, device, steps=2, reps=1, side=8), device)


if __name__ == '__main__':
    main()
