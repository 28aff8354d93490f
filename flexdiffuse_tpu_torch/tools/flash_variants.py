"""T6: the softmax variants of the flash kernel, chain-timed on the card.

Port of ``tools/flash_variants.py``:
  v0: natural exp, fp32 row sum (on Hopper the same code as T1 v0)
  v1: exp2, log2(e) folded into q's 16-bit scale
  v2: exp2, the row sum taken over the probabilities rounded to bf16
Each is checked against fp32 attention on the same bf16 inputs and timed
with a 40-deep data-dependent chain (each output is the next q).

    python -m flexdiffuse_tpu_torch.tools.flash_variants [--device cpu]
"""
from __future__ import annotations

from typing import Optional

import torch

from flexdiffuse_tpu_torch.ops.flash_variants import attn_variants as attn
from flexdiffuse_tpu_torch.tools import (TILE_NOTE, chain_ms, generator,
                                         max_err, parser, qkv, reference,
                                         resolve_device, tflops)

SHAPE = (2, 8, 4096, 40)
CPU_SHAPE = (1, 2, 256, 40)
N = 40


def run(generator: torch.Generator, device: Optional[str] = None) -> list:
    """Exactness of v0–v2 against fp32 attention and, on the card, their
    chain times; one dict per variant."""
    dev = resolve_device(device)
    cpu = dev.type == 'cpu'
    shape = CPU_SHAPE if cpu else SHAPE
    q, k, v = qkv(shape, generator)
    scale = shape[-1]**-0.5
    ref = reference(q, k, v, scale)
    rows = []
    for variant in (0, 1, 2):
        row = dict(config=f'v{variant}', shape=list(shape),
                   max_abs_err=max_err(attn(variant, q, k, v, scale), ref))
        line = f'v{variant}: maxerr {row["max_abs_err"]:.2e}'
        if not cpu:
            row['ms'], _ = chain_ms(
                lambda qc, _v=variant: attn(_v, qc, k, v, scale), q, N)
            row['tflops'] = tflops(shape, row['ms'])
            line = (f'v{variant}: {row["ms"]:6.3f} ms/call  '
                    f'{row["tflops"]:5.1f} TFLOP/s  maxerr '
                    f'{row["max_abs_err"]:.2e}')
        print(f'{line}  ({TILE_NOTE})', flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device)


if __name__ == '__main__':
    main()
