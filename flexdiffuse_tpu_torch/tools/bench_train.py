"""Training throughput at SD-1.4 geometry on one card.

Port of ``tools/bench_train.py``: the whole train step (forward, backward,
AdamW) at 512² latents (64×64×4) with the SD-1.4 UNet, bf16 compute
(autocast) over fp32 optimizer state, in both modes:

* **LoRA** (rank 8, attention and GEGLU targets, remat 'dots') over a
  frozen bf16 UNet;
* **full fine-tuning** (fp32 weights and AdamW, remat 'full') at the
  largest batch of 4, 2, 1 that fits; only ``torch.cuda.OutOfMemoryError``
  moves it to the next.

Timing: one warm-up step, then a chain of steps (each updates the weights
the next one reads), synchronised once at the end through the last loss.
K3–K5 serve the attention, K6 the LoRA steps' GroupNorms.

    python -m flexdiffuse_tpu_torch.tools.bench_train [--device cpu]

Prints one JSON line. On the CPU it runs the tiny UNet at batch 1, two
steps each, as a check that the path runs.
"""
from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch

from flexdiffuse_tpu_torch import training
from flexdiffuse_tpu_torch.models import SD14_UNET, UNet2DCondition
from flexdiffuse_tpu_torch.models.configs import TINY_UNET
from flexdiffuse_tpu_torch.tools import parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import TOKENS, emit, seeded

METRIC = 'sd1.4 512x512 train step (bf16 compute, fp32 Adam)'


def _batch(rng, b: int, side: int, ctx_dim: int, device):
    lat = rng.normal(size=(b, side, side, 4)).astype(np.float32)
    ctx = rng.normal(size=(b, TOKENS, ctx_dim)).astype(np.float32)
    return torch.from_numpy(lat).to(device), torch.from_numpy(ctx).to(device)


def _measure(step: Callable, lat, ctx, steps: int, device) -> tuple:
    """(seconds per step over ``steps`` chained steps after a warm-up, the
    last loss)."""
    gen = torch.Generator(device).manual_seed(0)
    step(lat, ctx, generator=gen)
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(lat, ctx, generator=gen)
    loss = float(loss)   # waits for the chain
    return (time.perf_counter() - t0) / steps, loss


def measure(lora_unet, full_unet: Callable[[], torch.nn.Module],
            device: torch.device, batch_lora: int = 4, batch_full: int = 4,
            lora_steps: int = 8, full_steps: int = 4, side: int = 64,
            seed: int = 0) -> dict:
    """``lora_unet``: the frozen (bf16) UNet the LoRA factors adapt;
    ``full_unet()``: a fresh fp32 UNet, requiring grad, for each full
    fine-tuning attempt."""
    rng = np.random.default_rng(seed)
    ctx_dim = lora_unet.config.cross_attention_dim
    out = {'metric': METRIC}

    lat, ctx = _batch(rng, batch_lora, side, ctx_dim, device)
    cfg = training.TrainConfig(learning_rate=1e-4, remat='dots')
    factors = training.init_lora(
        lora_unet, rank=8, generator=torch.Generator().manual_seed(seed))
    step, _ = training.make_lora_train_step(lora_unet, factors, cfg)
    dt, loss = _measure(step, lat, ctx, lora_steps, device)
    out['lora_rank8'] = {
        'batch': batch_lora, 'step_ms': dt * 1e3,
        'images_per_sec': batch_lora / dt, 'modules': len(factors),
        'remat': cfg.remat, 'finite': math.isfinite(loss)}
    del step, factors

    for b in dict.fromkeys((batch_full, 2, 1)):
        lat, ctx = _batch(rng, b, side, ctx_dim, device)
        cfg = training.TrainConfig(learning_rate=1e-5, remat='full')
        unet = None
        try:
            unet = full_unet()
            step, _ = training.make_train_step(unet, cfg)
            dt, loss = _measure(step, lat, ctx, full_steps, device)
        except torch.cuda.OutOfMemoryError:
            out['full_finetune'] = {'error': f'OOM at batch {b}'}
            del unet
            torch.cuda.empty_cache()
            continue
        out['full_finetune'] = {
            'batch': b, 'step_ms': dt * 1e3, 'images_per_sec': b / dt,
            'remat': cfg.remat, 'finite': math.isfinite(loss)}
        break
    return out


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    if device.type == 'cuda':
        lora = seeded(UNet2DCondition, SD14_UNET, device)
        full = lambda: seeded(UNet2DCondition, SD14_UNET, device,
                              torch.float32).requires_grad_(True)
        res = measure(lora, full, device)
    else:
        lora = seeded(UNet2DCondition, TINY_UNET, device, torch.float32)
        full = lambda: seeded(UNet2DCondition, TINY_UNET, device,
                              torch.float32).requires_grad_(True)
        res = measure(lora, full, device, batch_lora=1, batch_full=1,
                      lora_steps=2, full_steps=2, side=8)
    emit(res, device)


if __name__ == '__main__':
    main()
