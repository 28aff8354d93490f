"""T1 and T2: the flash kernel's schedule experiments, on the card.

Port of ``tools/flash_opt.py``. Its variants give the TPU's scheduler
independent work; their Hopper forms (``csrc/flash_variants_sm90.cu``,
the path every call plans, 'sm90'; the first port's kernels in
``csrc/flash_variants.cu`` with ``path='mma'``):

  v0   the plain kv loop (q scaled in its dtype, natural exp): one
       consumer warpgroup a block, three blocks an SM at d <= 64
  vU   v0 with a ring of 4 K/V stages and the kv loop written out two
       tiles at a time (the TPU unrolled the kv loop so QK(j+1) could
       overlap softmax(j))
  vG   G ∈ {2, 4} independent 64-row q chains per block, sharing each
       staged K/V tile
  vH   all H heads of a q tile in one instance (T2): consumer warpgroups
       on different heads, the kv range split over a cluster of blocks
       where the instances fill at most half of the card

The JAX script sweeps TPU block sizes (256–2048 rows) per variant; those
do not exist here: each line says which path and tile it ran (64·G q rows
by 64 kv rows; vG4's kv tile is 32 rows above d = 64 on 'sm90'). Each
variant is checked against fp32 attention and timed with a 40-deep
data-dependent chain, on the planned path and, unless ``--path`` names
one, T1's v0, vU and vG on the kept kernel too (``kept_ms``; vH's kept
kernel is timed by ``chip_smoke.py`` step 14, not here).

    python -m flexdiffuse_tpu_torch.tools.flash_opt [--device cpu]
        [--path sm90|mma]
"""
from __future__ import annotations

from typing import Optional

import torch

from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.tools import (chain_ms, generator, max_err,
                                         parser, qkv, reference,
                                         resolve_device, tflops)

SHAPE = (2, 8, 4096, 40)
CPU_SHAPE = (1, 2, 256, 40)
N = 40

# (the JAX script's label, the configuration in fv.PATH_CONFIGS)
CONFIGS = [('v0 (round-1)', 'T1 v0'), ('vU next tile in flight', 'T1 vU'),
           ('vG g=2', 'T1 vG2'), ('vG g=4', 'T1 vG4'), ('vH heads-in', 'T2')]


def bench(fn, q, k, v, scale, path):
    """ms per call of a chain that feeds each output back as q."""
    ms, _ = chain_ms(lambda qc: fn(qc, k, v, scale, path=path), q, N)
    return ms


def run(generator: torch.Generator, device: Optional[str] = None,
        path: Optional[str] = None) -> list:
    """Each variant's exactness against fp32 attention on ``path`` (the
    planned 'sm90' when None) and, on the card, its chain time there and,
    when ``path`` is None, T1's on the kept 'mma' kernel too
    (``kept_ms``). On the CPU the wrappers return their twins whatever the
    path."""
    dev = resolve_device(device)
    cpu = dev.type == 'cpu'
    shape = CPU_SHAPE if cpu else SHAPE
    q, k, v = qkv(shape, generator)
    scale = shape[-1]**-0.5
    ref = reference(q, k, v, scale)
    rows = []
    for name, label in CONFIGS:
        fn, plan, _, _ = fv.PATH_CONFIGS[label]
        how = plan(q, k, path=path)
        row = dict(config=name, path='twin' if cpu else how.path,
                   tile=f'{how.block_q}q x {how.block_kv}kv',
                   max_abs_err=max_err(fn(q, k, v, scale, path=path), ref))
        line = f'maxerr {row["max_abs_err"]:.2e}'
        if not cpu:
            row['ms'] = bench(fn, q, k, v, scale, path)
            row['tflops'] = tflops(shape, row['ms'])
            line = (f'{row["ms"]:7.3f} ms  {row["tflops"]:5.1f} TFLOP/s  '
                    + line)
            if path is None and label != 'T2':
                row['kept_ms'] = bench(fn, q, k, v, scale, fv.MMA)
                line += f'  (kept mma {row["kept_ms"]:7.3f} ms)'
        print(f'{name:24s} {row["path"]:5s} {row["tile"]:13s} {line}',
              flush=True)
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
