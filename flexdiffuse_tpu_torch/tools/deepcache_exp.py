"""A/B DeepCache on the SD-1.4 CFG product loop (``FlexPipeline``).

Port of ``tools/deepcache_exp.py``. DeepCache (Ma et al. 2023): the deep
UNet feature drifts slowly across denoise steps; cache it every Nth step
and recompute only the shallow levels in between (``models/unet.py``
``cache_mode``, ``pipeline/flex.py`` ``deepcache``). This measures the
product path, the pipeline's full/shallow dispatch inside the loop: 25
PNDM steps at 512², CFG 8, best of 4 after a warm-up per interval, and the
final latents' drift from the exact loop (a quality proxy; real-weight
quality is judged by eye, per the README's protocol, once weights are at
hand). Under 'use' evaluations K1 serves 5 of the 10 self-attentions and K6
16 of the 61 GroupNorms.

    python -m flexdiffuse_tpu_torch.tools.deepcache_exp [intervals ...]
        [--batch B] [--device cpu]

(default intervals 0 2 3). Prints one JSON line. On the CPU it runs the
tiny models, 4 steps, as a check that the path runs.
"""
from __future__ import annotations

from typing import Sequence

import torch

from flexdiffuse_tpu_torch.models import (SD14_UNET, SD14_VAE, AutoencoderKL,
                                          UNet2DCondition)
from flexdiffuse_tpu_torch.models.configs import TINY_UNET, TINY_VAE
from flexdiffuse_tpu_torch.pipeline import FlexPipeline
from flexdiffuse_tpu_torch.tools import BF16, parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (cfg_guide, emit,
                                                      finite, mse, seeded,
                                                      start_noise, timed)

STEPS = 25


def build_parts(unet, vae, deepcache: int, batch: int = 1,
                steps: int = STEPS, side: int = 64, guide=None,
                latents=None) -> dict:
    """The pipeline (PNDM, ``deepcache``), its guide (the JAX script's:
    :func:`cfg_guide`, CFG 8) and start latents (:func:`start_noise`, or
    the given ones), and ``sample()``, one ``steps``-step run to the final
    latents; ``length``: UNet rows per run."""
    pipe = FlexPipeline(unet, vae, scheduler='pndm', deepcache=deepcache)
    device = pipe.device
    if guide is None:
        guide = cfg_guide(batch, unet.config.cross_attention_dim, device)
    if latents is None:
        latents = start_noise(batch, side, device)
    size = (latents.shape[1] * pipe.vae_scale,
            latents.shape[2] * pipe.vae_scale)

    def sample() -> torch.Tensor:
        return pipe(guide, steps=steps, init_size=size, noise=latents,
                    output_type='latent').images

    return dict(pipe=pipe, sample=sample, guide=guide, latents=latents,
                length=pipe.schedule(steps).length)


def run(unet, vae, intervals: Sequence[int] = (0, 2, 3), batch: int = 1,
        steps: int = STEPS, side: int = 64, reps: int = 4, guide=None,
        latents=None) -> dict:
    """Each interval's steps/s (best of ``reps`` after a warm-up) and, with
    0 among them, every other's final-latent drift from the exact loop."""
    device = next(unet.parameters()).device
    rows, outs, rates = [], {}, {}
    for dc in intervals:
        parts = build_parts(unet, vae, dc, batch, steps, side, guide,
                            latents)
        times, out, first = timed(parts['sample'], device, reps)
        best = min(times)
        outs[dc], rates[dc] = out, parts['length'] / best
        rows.append(dict(deepcache=dc, batch=batch, warm_s=first,
                         steps_per_sec=rates[dc],
                         ms_per_step=best / parts['length'] * 1e3,
                         img_per_min_scan_only=batch * 60.0 / best,
                         finite=finite(out)))
    drift = []
    if 0 in outs:
        scale = float(outs[0].abs().max())
        for dc in intervals:
            if dc:
                drift.append(dict(
                    deepcache=dc,
                    latent_max_abs_vs_exact=float(
                        (outs[dc] - outs[0]).abs().max()),
                    latent_mse_vs_exact=mse(outs[dc], outs[0]),
                    scale=scale,
                    steps_per_sec_change=rates[dc] / rates[0] - 1))
    return dict(metric=f'sd1.4 {side * 8}x{side * 8} CFG PNDM {steps}-step '
                'loop, DeepCache intervals', rows=rows, drift=drift)


def models(device: torch.device, dtype: torch.dtype = BF16) -> tuple:
    """Seeded SD-1.4 UNet and VAE on the card (in ``dtype``), tiny ones
    (fp32) on the CPU."""
    if device.type == 'cuda':
        return (seeded(UNet2DCondition, SD14_UNET, device, dtype),
                seeded(AutoencoderKL, SD14_VAE, device, dtype))
    return (seeded(UNet2DCondition, TINY_UNET, device, torch.float32),
            seeded(AutoencoderKL, TINY_VAE, device, torch.float32))


def main() -> None:
    ap = parser(__doc__)
    ap.add_argument('intervals', nargs='*', type=int, default=[0, 2, 3])
    ap.add_argument('--batch', type=int, default=1)
    args = ap.parse_args()
    device = resolve_device(args.device)
    unet, vae = models(device)
    kw = {} if device.type == 'cuda' else dict(steps=4, side=8, reps=1)
    emit(run(unet, vae, args.intervals, args.batch, **kw), device)


if __name__ == '__main__':
    main()
