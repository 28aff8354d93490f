"""A/B ToMe token merging on the SD-1.4 CFG product loop.

Port of ``tools/tome_exp.py``. ToMe (Bolya & Hoffman 2023,
``ops/tome.py``): merge a fraction of the spatial tokens before every
self-attention on grids of at least 4096 tokens and copy the outputs back.
This measures the product path (``FlexPipeline`` over a UNet copy with
``tome=(ratio, 4096)``, ``UNet2DCondition.with_settings``) at 512² (4096
tokens: the default ``min_seq`` just engages) and 1024² (16384 tokens),
exact against a sweep of ratios: steps/s (median of 4 after a warm-up)
and the final latents' MSE from the exact loop (a drift proxy).

    python -m flexdiffuse_tpu_torch.tools.tome_exp [--size 512|1024]
        [--ratios 0.3,0.5] [--device cpu]

Prints one JSON line. On the CPU it runs the tiny models, 4 steps, with
``min_seq`` 64 (the tiny grid), as a check that the path runs.
"""
from __future__ import annotations

import statistics
from typing import Sequence

from flexdiffuse_tpu_torch.tools import parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (emit, finite, mse,
                                                      timed)
from flexdiffuse_tpu_torch.tools.deepcache_exp import (STEPS, build_parts,
                                                       models)

MIN_SEQ = 4096


def build(unet, vae, side: int, tome, steps: int = STEPS, guide=None,
          latents=None) -> dict:
    """:func:`~.deepcache_exp.build_parts` over ``unet`` with ``tome``
    (``(ratio, min_seq)``, or None: exact); same weights."""
    if tome:
        unet = unet.with_settings(tome=tuple(tome))
    return build_parts(unet, vae, 0, 1, steps, side, guide, latents)


def timed_run(parts: dict, reps: int = 4) -> tuple:
    times, lat, _ = timed(parts['sample'], parts['pipe'].device, reps)
    return parts['length'] / statistics.median(times), lat


def measure(unet, vae, size: int = 512, ratios: Sequence[float] = (0.5,),
            steps: int = STEPS, reps: int = 4, min_seq: int = MIN_SEQ,
            latent_side=None, guide=None, latents=None) -> dict:
    side = latent_side or size // 8
    base_sps, base_lat = timed_run(build(unet, vae, side, None, steps,
                                         guide, latents), reps)
    rows = []
    for ratio in ratios:
        sps, lat = timed_run(build(unet, vae, side, (ratio, min_seq), steps,
                                   guide, latents), reps)
        rows.append({'ratio': ratio, 'steps_per_sec': sps,
                     'speedup': sps / base_sps,
                     'latent_mse_vs_exact': mse(lat, base_lat),
                     'finite': finite(lat)})
    return {'metric': (f'sd1.4 {size}x{size} ToMe denoise steps/sec/card '
                       f'(bf16, PLMS, {steps}-step loop)'),
            'exact_steps_per_sec': base_sps, 'tome': rows}


def main() -> None:
    ap = parser(__doc__)
    ap.add_argument('--size', type=int, default=512)
    ap.add_argument('--ratios', default='0.5')
    args = ap.parse_args()
    device = resolve_device(args.device)
    ratios = [float(r) for r in args.ratios.split(',')]
    unet, vae = models(device)
    kw = {} if device.type == 'cuda' else dict(steps=4, reps=1, min_seq=64,
                                               latent_side=8)
    emit(measure(unet, vae, args.size, ratios, **kw), device)


if __name__ == '__main__':
    main()
