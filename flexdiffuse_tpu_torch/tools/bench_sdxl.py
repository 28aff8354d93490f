"""SDXL-base 1024² denoise-loop bench on one card.

Port of ``tools/bench_sdxl.py``: SDXL geometry (2.57 B parameters, bf16),
seeded weights, the CFG-doubled UNet and the DPM++ update per step (the
loop of :mod:`.sdxl_deepcache_exp`, zero latents and context), best of 3
after a warm-up; then the same with DeepCache at interval 3 (seeded
latents, as the A/B script). K1 serves 70 attentions and K6 46 GroupNorms
per full evaluation.

    python -m flexdiffuse_tpu_torch.tools.bench_sdxl [--device cpu]

Prints one JSON line. On the CPU it runs the tiny SDXL UNet, 4 steps, as a
check that the path runs.
"""
from __future__ import annotations

import gc

from flexdiffuse_tpu_torch.tools import parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import emit, finite, timed
from flexdiffuse_tpu_torch.tools.sdxl_deepcache_exp import (IMAGE, STEPS,
                                                            build, sdxl_unet)


def measure(unet, steps: int = STEPS, image: int = IMAGE, reps: int = 3
            ) -> dict:
    device = next(unet.parameters()).device
    loop, length = build(unet, 0, steps, image, random=False)
    times, out, first = timed(loop, device, reps)
    best = min(times)
    return {
        'metric': f'sdxl-base {image}x{image} CFG denoise steps/sec/card '
                  f'(bf16, DPM++ {steps}-step loop)',
        'steps_per_sec': length / best,
        'seconds_per_image_25step': best / length * 25,
        'first_run_s': first,
        'finite': finite(out),
    }


def measure_deepcache(unet, interval: int = 3, steps: int = STEPS,
                      image: int = IMAGE, reps: int = 3) -> dict:
    gc.collect()
    device = next(unet.parameters()).device
    loop, length = build(unet, interval, steps, image)
    times, out, _ = timed(loop, device, reps)
    best = min(times)
    return {'interval': interval, 'steps_per_sec': length / best,
            'seconds_per_image_25step': best / length * 25,
            'finite': finite(out)}


def bench(unet, steps: int = STEPS, image: int = IMAGE, reps: int = 3
          ) -> dict:
    out = measure(unet, steps, image, reps)
    out['value'] = out.pop('steps_per_sec')
    out['unit'] = 'steps/sec'
    out['deepcache'] = measure_deepcache(unet, 3, steps, image, reps)
    return out


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    kw = {} if device.type == 'cuda' else dict(steps=4, image=64, reps=1)
    emit(bench(sdxl_unet(device), **kw), device)


if __name__ == '__main__':
    main()
