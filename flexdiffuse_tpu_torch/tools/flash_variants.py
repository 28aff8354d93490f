"""T6: the softmax variants of the flash kernel, chain-timed on the card.

Port of ``tools/flash_variants.py``:
  v0: natural exp, fp32 row sum (on Hopper the same code as T1 v0)
  v1: exp2, log2(e) folded into q's 16-bit scale
  v2: exp2, the row sum taken over the probabilities rounded to bf16
Each is checked against fp32 attention on the same bf16 inputs and timed
with a 40-deep data-dependent chain (each output is the next q), on the
path its plan picks ('sm90', ``csrc/flash_variants_sm90.cu``) and, unless
``--path`` names one, on the kept kernel of ``csrc/flash_variants.cu``
too (``kept_ms``).

    python -m flexdiffuse_tpu_torch.tools.flash_variants [--device cpu]
        [--path sm90|mma]
"""
from __future__ import annotations

from typing import Optional

import torch

from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.ops.flash_variants import attn_variants as attn
from flexdiffuse_tpu_torch.tools import (chain_ms, generator, max_err,
                                         parser, qkv, reference,
                                         resolve_device, tflops)

SHAPE = (2, 8, 4096, 40)
CPU_SHAPE = (1, 2, 256, 40)
N = 40


def run(generator: torch.Generator, device: Optional[str] = None,
        path: Optional[str] = None) -> list:
    """Exactness of v0–v2 against fp32 attention on ``path`` (the planned
    'sm90' when None) and, on the card, their chain times there and, when
    ``path`` is None, on the kept 'mma' kernel (``kept_ms``); one dict per
    variant. On the CPU the wrappers return their twins."""
    dev = resolve_device(device)
    cpu = dev.type == 'cpu'
    shape = CPU_SHAPE if cpu else SHAPE
    q, k, v = qkv(shape, generator)
    scale = shape[-1]**-0.5
    ref = reference(q, k, v, scale)
    chain = lambda variant, p: chain_ms(
        lambda qc: attn(variant, qc, k, v, scale, path=p), q, N)[0]
    rows = []
    for variant in (0, 1, 2):
        how = fv.plan_attn_variants(q, k, variant, path=path)
        row = dict(config=f'v{variant}', shape=list(shape),
                   path='twin' if cpu else how.path,
                   max_abs_err=max_err(attn(variant, q, k, v, scale,
                                            path=path), ref))
        line = f'v{variant}: maxerr {row["max_abs_err"]:.2e}'
        if not cpu:
            row['ms'] = chain(variant, path)
            row['tflops'] = tflops(shape, row['ms'])
            line = (f'v{variant}: {row["ms"]:6.3f} ms/call  '
                    f'{row["tflops"]:5.1f} TFLOP/s  maxerr '
                    f'{row["max_abs_err"]:.2e}')
            if path is None:
                row['kept_ms'] = chain(variant, fv.MMA)
                line += f'  (kept mma {row["kept_ms"]:6.3f} ms/call)'
        print(f'{line}  ({row["path"]}, {how.block_q}q x {how.block_kv}kv '
              'tile)', flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument('--path', default=None, choices=fv.PATHS,
                    help='run one path only (default: the planned one, '
                    'and the kept kernel beside it)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device, args.path)


if __name__ == '__main__':
    main()
