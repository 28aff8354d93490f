"""T5: fewer CUDA-core passes per score on the [B,H,D,S] flash kernel.

Port of ``tools/flash_tt3.py``. Variants (on the path the plan picks,
'sm90', ``csrc/flash_variants_sm90.cu``, or the one ``--path`` names;
'mma' is the first port's kernel in ``csrc/flash_variants.cu``):

  tt       K1, the product kernel (on ``[B,H,S,D]`` in the port)
  ttv3     exp2 with log2(e) folded into q's 16-bit scale, and the row sum
           folded into P·V: V's first zero-padded head column holds ones,
           so that column of the accumulator is Σ P, with no shuffles
  ttv4     ttv3 with exp2 evaluated on bf16 arguments, two per instruction
  no-fold  ttv3 without the fold: the row sum per 64-column tile of the
           bf16 P, rounded to bf16 (the JAX script's ``sum_fold=False``,
           which its ``main`` does not run; run here so that the setting
           is measured too)

``main`` checks each against fp32 attention and times 12-deep chains at
three shapes (without ``--path`` also each T5 setting on the kept kernel,
``kept_ms``); ``step_ab`` runs the SD-1.4 UNet chain with random
normal·0.02 bf16 weights through K1 and through ttv3 and ttv4 swapped in
for the kernel ``ops/attention.py`` calls, and reports each one's max|Δ|
to K1's output.

    python -m flexdiffuse_tpu_torch.tools.flash_tt3 [step] [--device cpu]
        [--path sm90|mma]

On the CPU only the exactness check runs, at a small shape.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from flexdiffuse_tpu_torch.ops.flash_attention import flash_attention
from flexdiffuse_tpu_torch.ops.flash_variants import (MMA, PATHS, flash_ttv3,
                                                      plan_ttv3)
from flexdiffuse_tpu_torch.tools import (TILE_NOTE, chain_ms, generator,
                                         max_err, parser, qkv, reference,
                                         resolve_device, tflops)
from flexdiffuse_tpu_torch.tools import transposed as _t
from flexdiffuse_tpu_torch.tools import perf_experiment as pe
from flexdiffuse_tpu_torch.tools.flash_pipelined import kernel_swapped

STEPS = 12
SHAPES = [(2, 8, 4096, 40), (8, 8, 4096, 40), (2, 8, 1024, 80)]
CPU_SHAPES = [(1, 2, 256, 40), (1, 2, 128, 80)]


# label → (kernel on [B,H,D,S] operands, keyword arguments); 'tt' is K1.
VARIANTS = {
    'tt': None,
    'ttv3': dict(),
    'ttv4': dict(bf16_p=True),
    'no-fold': dict(sum_fold=False),
}


def _call(label: str, path: Optional[str] = None):
    """The variant (T5 on ``path``) as a ``[B,H,S,D]`` attention call."""
    kw = VARIANTS[label]
    if kw is None:
        return flash_attention
    return lambda q, k, v, s: _t(flash_ttv3(_t(q), _t(k), _t(v), s,
                                            path=path, **kw))


def main_run(generator: torch.Generator, path: Optional[str] = None) -> list:
    """Each variant against fp32 attention and, on the card, chain-timed:
    T5 on ``path`` (None: the planned path, and the kept kernel beside it
    as ``kept_ms``)."""
    cpu = generator.device.type == 'cpu'
    rows = []
    for shape in CPU_SHAPES if cpu else SHAPES:
        q, k, v = qkv(shape, generator)
        qt, kt, vt = _t(q), _t(k), _t(v)
        scale = shape[-1]**-0.5
        ref = reference(q, k, v, scale)
        print(f'shape {shape}:', flush=True)
        for label, kw in VARIANTS.items():
            if kw is None:
                fn, args, x0 = flash_attention, (k, v), q
            else:
                fn = lambda q_, k_, v_, s_, _kw=kw, path=path: flash_ttv3(
                    q_, k_, v_, s_, path=path, **_kw)
                args, x0 = (kt, vt), qt
            got = fn(x0, *args, scale)
            err = max_err(got if kw is None else _t(got), ref)
            row = dict(variant=label, shape=list(shape), max_abs_err=err)
            tile = TILE_NOTE
            if kw is not None and not cpu:
                how = plan_ttv3(qt, kt, **kw, path=path)
                row['path'] = how.path
                tile = f'{how.path} {how.block_q}q x {how.block_kv}kv tile'
            line = f'err {err:.4f} {"OK" if err < 0.04 else "FAIL"}'
            if not cpu:
                chain = lambda f: chain_ms(
                    lambda c: 0.999 * f(c, *args, scale) + 0.001 * x0, x0,
                    STEPS)[0]
                row['ms'] = chain(fn)
                line = (f'{row["ms"]:6.3f} ms/call '
                        f'{tflops(shape, row["ms"]):6.1f} TFLOP/s ' + line)
                if kw is not None and path is None:
                    row['kept_ms'] = chain(lambda *a, _fn=fn: _fn(
                        *a, path=MMA))
                    line += f' (kept mma {row["kept_ms"]:6.3f} ms)'
            print(f'  {label:7s}: {line} ({tile})', flush=True)
            rows.append(row)
    return rows


STEP_VARIANTS = ('tt', 'ttv3', 'ttv4')


def step_ab(generator: torch.Generator, path: Optional[str] = None) -> dict:
    """One SD-1.4 UNet with random normal·0.02 weights (bf16), its chain
    through each variant (T5 on ``path``) on the same inputs; max|Δ|
    against the first."""
    unet = pe.build_unet(pe.SD14_UNET, generator.device)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * 0.02)
    lat, ctx = pe.chain_inputs(unet, 2, 64, generator)
    res, ref = {}, None
    for label in STEP_VARIANTS:
        with kernel_swapped(_call(label, path)):
            r = pe.unet_chain(unet, lat, ctx, f'{label} UNet chain')
        ref = r['out'] if ref is None else ref
        r['max_abs_diff_vs_first'] = (r.pop('out') - ref).abs().max().item()
        print(f'{label:5s}: {r["ms"]:6.2f} ms/forward max|d| vs '
              f'{STEP_VARIANTS[0]} = {r["max_abs_diff_vs_first"]:.2e}',
              flush=True)
        res[label] = r
    return res


def run(generator: torch.Generator, device: Optional[str] = None,
        step: bool = False, path: Optional[str] = None) -> dict:
    dev = resolve_device(device)
    if step and dev.type != 'cpu':
        return dict(step=step_ab(generator, path))
    return dict(main=main_run(generator, path))


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument('which', nargs='?', default='main',
                    choices=('main', 'step'))
    ap.add_argument('--path', default=None, choices=PATHS,
                    help='run T5 on one path only (default: the planned '
                    'one, and the kept kernel beside it in main)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device, args.which == 'step', args.path)


if __name__ == '__main__':
    main(sys.argv[1:])
