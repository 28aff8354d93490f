"""DeepCache bench: the SD-1.4 512² CFG loop with the cached deep feature
(``pipeline/flex.py`` ``deepcache``) against the exact loop.

Port of ``tools/bench_deepcache.py``, on :mod:`.deepcache_exp`'s
``build_parts``: steps/s at interval 3 and 0 (best of 4 after a warm-up),
the speed-up, the final latents' MSE from the exact loop, and the batch-4
serving throughput with DeepCache: rounds of the loop and the uint8 decode
on the device (``decode_u8_device``) back to back, images/min counting a
25-step image as 26 loop steps.

    python -m flexdiffuse_tpu_torch.tools.bench_deepcache [--device cpu]

Prints one JSON line. On the CPU it runs the tiny models, as a check that
the path runs.
"""
from __future__ import annotations

import time

from flexdiffuse_tpu_torch.tools import parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (emit, finite, mse,
                                                      sync, timed)
from flexdiffuse_tpu_torch.tools.deepcache_exp import (STEPS, build_parts,
                                                       models)


def serving_batch(unet, vae, interval: int = 3, batch: int = 4,
                  rounds: int = 3, steps: int = STEPS, side: int = 64
                  ) -> dict:
    parts = build_parts(unet, vae, interval, batch, steps, side)
    pipe, sample = parts['pipe'], parts['sample']
    device = pipe.device

    def round_out():
        return pipe.decode_u8_device(sample())

    round_out()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(rounds):
        round_out()
    sync(device)
    overlapped = time.perf_counter() - t0
    per_image_factor = (steps + 1) / steps   # 25 steps ≈ 26 loop steps
    return {'interval': interval, 'batch': batch,
            'images_per_min': 60.0 * batch * rounds /
            (overlapped * per_image_factor)}


def measure(unet, vae, steps: int = STEPS, side: int = 64, reps: int = 4,
            rounds: int = 3, interval: int = 3) -> dict:
    device = next(unet.parameters()).device
    out = {'metric': ('sd1.4 512x512 CFG denoise steps/sec/card (bf16, '
                      f'PLMS {steps}-step loop, DeepCache)')}
    results = {}
    for dc in (0, interval):
        parts = build_parts(unet, vae, dc, steps=steps, side=side)
        times, lat, first = timed(parts['sample'], device, reps)
        results[dc] = (parts['length'] / min(times), lat, first)
    (base_sps, base_lat, _), (dc_sps, dc_lat, _) = (results[0],
                                                    results[interval])
    out.update({
        'interval': interval,
        'value': dc_sps,
        'unit': 'steps/sec',
        'exact_steps_per_sec': base_sps,
        'speedup_vs_exact': dc_sps / base_sps,
        'latent_mse_vs_exact': mse(dc_lat, base_lat),
        'finite': finite(dc_lat),
    })
    out['serving_batch4'] = serving_batch(unet, vae, interval, 4, rounds,
                                          steps, side)
    return out


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    unet, vae = models(device)
    kw = {} if device.type == 'cuda' else dict(steps=4, side=8, reps=1,
                                               rounds=1)
    emit(measure(unet, vae, **kw), device)


if __name__ == '__main__':
    main()
