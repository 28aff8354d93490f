"""T1 and T2: the flash kernel's schedule experiments, on the card.

Port of ``tools/flash_opt.py``. Its variants give the TPU's scheduler
independent work; their Hopper forms (``csrc/flash_variants.cu``; vH on
its Hopper path, ``csrc/flash_variants_sm90.cu``, unless ``attn_h`` is
called with ``path='mma'``):

  v0   the plain kv loop (q scaled in its dtype, natural exp)
  vU   the next K/V tile's copy in flight while this one is computed (the
       TPU unrolled the kv loop so QK(j+1) could overlap softmax(j))
  vG   G ∈ {2, 4} independent 64-row q chains per block, sharing each
       staged K/V tile
  vH   all H heads of a q tile in one instance (T2): consumer warpgroups
       on different heads, the kv range split over a cluster of blocks
       where the instances fill at most half of the card

The JAX script sweeps TPU block sizes (256–2048 rows) per variant; those
do not exist here: the Hopper tile is 64 K/V rows and 64·G q rows, and each
line says which it ran. Each variant is checked against fp32 attention and
timed with a 40-deep data-dependent chain.

    python -m flexdiffuse_tpu_torch.tools.flash_opt [--device cpu]
"""
from __future__ import annotations

from typing import Optional

import torch

from flexdiffuse_tpu_torch.ops.flash_variants import attn_h
from flexdiffuse_tpu_torch.ops.flash_variants import attn_opt as attn
from flexdiffuse_tpu_torch.tools import (chain_ms, generator, max_err,
                                         parser, qkv, reference,
                                         resolve_device, tflops)

SHAPE = (2, 8, 4096, 40)
CPU_SHAPE = (1, 2, 256, 40)
N = 40

# (label, call, q rows per block)
CONFIGS = [
    ('v0 (round-1)', lambda q, k, v, sc: attn('v0', q, k, v, sc), 64),
    ('vU next tile in flight', lambda q, k, v, sc: attn('vU', q, k, v, sc),
     64),
    ('vG g=2', lambda q, k, v, sc: attn('vG', q, k, v, sc, g=2), 128),
    ('vG g=4', lambda q, k, v, sc: attn('vG', q, k, v, sc, g=4), 256),
    ('vH heads-in', attn_h, 64),
]


def bench(fn, q, k, v, scale):
    """ms per call of a chain that feeds each output back as q."""
    ms, _ = chain_ms(lambda qc: fn(qc, k, v, scale), q, N)
    return ms


def run(generator: torch.Generator, device: Optional[str] = None) -> list:
    dev = resolve_device(device)
    cpu = dev.type == 'cpu'
    shape = CPU_SHAPE if cpu else SHAPE
    q, k, v = qkv(shape, generator)
    scale = shape[-1]**-0.5
    ref = reference(q, k, v, scale)
    rows = []
    for name, fn, rows_q in CONFIGS:
        row = dict(config=name, tile=f'{rows_q}q x 64kv',
                   max_abs_err=max_err(fn(q, k, v, scale), ref))
        line = f'maxerr {row["max_abs_err"]:.2e}'
        if not cpu:
            row['ms'] = bench(fn, q, k, v, scale)
            row['tflops'] = tflops(shape, row['ms'])
            line = (f'{row["ms"]:7.3f} ms  {row["tflops"]:5.1f} TFLOP/s  '
                    + line)
        print(f'{name:24s} {row["tile"]:12s} {line}', flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device)


if __name__ == '__main__':
    main()
