"""A/B micro-experiments on the SDXL-base 1024² CFG loop: the baseline.

Port of ``tools/sdxl_exp.py``. The JAX script measured two knobs against
the loop of ``tools/bench_sdxl.py``; neither carries over as a knob:

* ``FLASH_BQ``/``FLASH_BK`` set the TPU kernel's block sizes at SDXL's
  shapes. On the card K1's tiles follow from the padded head width in the
  kernel source (``csrc/flash_attention.cu`` ``Tiling``, mirrored by
  ``ops.flash_attention.SM90_TILES``): at SDXL's 64-wide heads three
  consumer warpgroups of 64 q rows over a kv tile of 64. This tool reports
  the tiles ``plan`` gives at SDXL's two attention shapes beside the time;
  another tiling is an edit of the source, rebuilt.
* ``UPSAMPLE=broadcast`` replaced ``jax.image.resize`` to avoid the layout
  copies XLA placed around it. The port's ``Upsample`` is already one
  nearest-neighbour ``F.interpolate``; the knob has no meaning here
  (ROADMAP "do not port").

The loop: :func:`~.bench_common.cfg_loop` at DPM++ 25 steps, CFG 5, zero
latents and context, best of 3 after a warm-up.

    python -m flexdiffuse_tpu_torch.tools.sdxl_exp [--device cpu]

Prints one JSON line. On the CPU it runs the tiny SDXL UNet, 4 steps, as a
check that the path runs.
"""
from __future__ import annotations

import torch

from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.tools import BF16, parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import emit, finite, timed
from flexdiffuse_tpu_torch.tools.sdxl_deepcache_exp import (IMAGE, STEPS,
                                                            build, sdxl_unet)


def tiles(unet, image: int = IMAGE) -> list:
    """K1's plan at each self-attention shape of one CFG evaluation at
    ``image``² (the levels with transformers): shape, path, q rows and kv
    rows per tile."""
    cfg = unet.config
    out = []
    for level, channels in enumerate(cfg.block_channels):
        if not cfg.attention_levels[level]:
            continue
        tokens = (image // 8 // 2**level)**2
        heads = cfg.heads_for(channels)
        shape = (2, heads, tokens, channels // heads)
        q = torch.empty(shape, dtype=BF16, device='meta')
        how = fa.plan(q, q, q)
        out.append(dict(shape=list(shape), path=how.path,
                        block_q=how.block_q, block_kv=how.block_kv))
    return out


def measure(unet, steps: int = STEPS, image: int = IMAGE, reps: int = 3
            ) -> dict:
    device = next(unet.parameters()).device
    loop, length = build(unet, 0, steps, image, random=False)
    times, out, first = timed(loop, device, reps)
    return {'metric': f'sdxl-base {image}x{image} CFG DPM++ {steps}-step '
                      'loop, baseline',
            'upsample': 'interpolate', 'k1_tiles': tiles(unet, image),
            'first_run_s': first, 'steps_per_sec': length / min(times),
            'finite': finite(out)}


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    kw = {} if device.type == 'cuda' else dict(steps=4, image=64, reps=1)
    emit(measure(sdxl_unet(device), **kw), device)


if __name__ == '__main__':
    main()
