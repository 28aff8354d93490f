"""A/B DeepCache on the SDXL-base 1024² CFG loop (one card).

Port of ``tools/sdxl_deepcache_exp.py``. SDXL's outermost level carries no
attention, so the DeepCache shallow evaluation is convolutions only at
128² latents (0 K1 and 11 K6 per 'use' evaluation, against 70 and 46 for
a full one). The loop is :func:`~.bench_common.cfg_loop`, the JAX script's
scan body with its full/shallow dispatch: DPM++ 25 steps, CFG 5, seeded
start latents and context·0.3, the text-time conditioning of a 1024²
image; steps/s best of 3 after a warm-up; the final latents' MSE from the
exact loop.

    python -m flexdiffuse_tpu_torch.tools.sdxl_deepcache_exp [intervals ...]
        [--device cpu]

(default intervals 0 3). Prints one JSON line. On the CPU it runs the tiny
SDXL UNet, 4 steps, as a check that the path runs.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.models import SDXL_UNET, UNet2DCondition
from flexdiffuse_tpu_torch.models.configs import TINY_SDXL_UNET
from flexdiffuse_tpu_torch.tools import parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (TOKENS, cfg_loop, emit,
                                                      finite, mse, seeded,
                                                      start_noise, timed)

STEPS = 25
IMAGE = 1024
GUIDANCE = 5.0


def added_cond(unet, image: int, device: torch.device) -> dict:
    """SDXL's text-time conditioning of the JAX scripts at CFG batch 2:
    zero pooled embeddings and the time ids of an ``image``² generation."""
    cfg = unet.config
    ids = torch.tensor([[image, image, 0, 0, image, image]],
                       dtype=torch.float32, device=device)
    return {'text_embeds': torch.zeros((2, cfg.addition_pooled_dim),
                                       device=device),
            'time_ids': ids.expand(2, cfg.num_time_ids).contiguous()}


def build(unet, deepcache: int, steps: int = STEPS, image: int = IMAGE,
          random: bool = True) -> tuple:
    """``(run, length)``: ``run()`` is one loop to the final latents at
    ``image``² (``random``: seeded start latents and context·0.3, as the
    A/B script; else zeros, as ``bench_sdxl``'s exact measure)."""
    device = next(unet.parameters()).device
    side = image // 8
    dim = unet.config.cross_attention_dim
    if random:
        latents = start_noise(1, side, device)
        rng = np.random.default_rng(2)
        ctx = torch.from_numpy(rng.normal(size=(2, TOKENS, dim)).astype(
            np.float32) * 0.3).to(device)
    else:
        latents = torch.zeros((1, side, side, 4), device=device)
        ctx = torch.zeros((2, TOKENS, dim), device=device)
    added = added_cond(unet, image, device)
    schedule = schedulers.make('dpmpp', steps)

    def run() -> torch.Tensor:
        return cfg_loop(unet, schedule, latents, ctx, GUIDANCE, added,
                        deepcache)

    return run, schedule.length


def run(unet, intervals: Sequence[int] = (0, 3), steps: int = STEPS,
        image: int = IMAGE, reps: int = 3) -> dict:
    device = next(unet.parameters()).device
    rows, outs, rates = [], {}, {}
    for dc in intervals:
        loop, length = build(unet, dc, steps, image)
        times, out, first = timed(loop, device, reps)
        best = min(times)
        outs[dc], rates[dc] = out, length / best
        rows.append(dict(deepcache=dc, warm_s=first, steps_per_sec=length /
                         best, ms_per_step=best / length * 1e3,
                         seconds_per_image_25step=best / length * 25,
                         finite=finite(out)))
    drift = [dict(deepcache=dc, latent_mse_vs_exact=mse(outs[dc], outs[0]),
                  steps_per_sec_change=rates[dc] / rates[0] - 1)
             for dc in intervals if dc and 0 in outs]
    return dict(metric=f'sdxl-base {image}x{image} CFG DPM++ {steps}-step '
                'loop, DeepCache intervals', rows=rows, drift=drift)


def sdxl_unet(device: torch.device):
    """Seeded SDXL-base UNet on the card, the tiny one (fp32) on the CPU."""
    if device.type == 'cuda':
        return seeded(UNet2DCondition, SDXL_UNET, device)
    return seeded(UNet2DCondition, TINY_SDXL_UNET, device, torch.float32)


def main() -> None:
    ap = parser(__doc__)
    ap.add_argument('intervals', nargs='*', type=int, default=[0, 3])
    args = ap.parse_args()
    device = resolve_device(args.device)
    kw = {} if device.type == 'cuda' else dict(steps=4, image=64, reps=1)
    emit(run(sdxl_unet(device), args.intervals, **kw), device)


if __name__ == '__main__':
    main()
