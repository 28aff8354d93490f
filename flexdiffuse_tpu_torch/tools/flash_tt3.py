"""T5: fewer CUDA-core passes per score on the [B,H,D,S] flash kernel.

Port of ``tools/flash_tt3.py``. Variants (``csrc/flash_variants.cu``):

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
three shapes; ``step_ab`` runs the SD-1.4 UNet chain with random
normal·0.02 bf16 weights through K1 and through ttv3 and ttv4 swapped in
for the kernel ``ops/attention.py`` calls, and reports each one's max|Δ|
to K1's output.

    python -m flexdiffuse_tpu_torch.tools.flash_tt3 [step] [--device cpu]

On the CPU only the exactness check runs, at a small shape.
"""
from __future__ import annotations

import sys
from typing import Optional

import torch

from flexdiffuse_tpu_torch.ops.flash_attention import flash_attention
from flexdiffuse_tpu_torch.ops.flash_variants import flash_ttv3
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


def _call(label: str):
    """The variant as a ``[B,H,S,D]`` attention call."""
    kw = VARIANTS[label]
    if kw is None:
        return flash_attention
    return lambda q, k, v, s: _t(flash_ttv3(_t(q), _t(k), _t(v), s, **kw))


def main_run(generator: torch.Generator) -> list:
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
                fn = lambda q_, k_, v_, s_, _kw=kw: flash_ttv3(
                    q_, k_, v_, s_, **_kw)
                args, x0 = (kt, vt), qt
            got = fn(x0, *args, scale)
            err = max_err(got if kw is None else _t(got), ref)
            row = dict(variant=label, shape=list(shape), max_abs_err=err)
            line = f'err {err:.4f} {"OK" if err < 0.04 else "FAIL"}'
            if not cpu:
                row['ms'], _ = chain_ms(
                    lambda c, _fn=fn, _a=args, _x=x0:
                        0.999 * _fn(c, *_a, scale) + 0.001 * _x, x0, STEPS)
                line = (f'{row["ms"]:6.3f} ms/call '
                        f'{tflops(shape, row["ms"]):6.1f} TFLOP/s ' + line)
            print(f'  {label:7s}: {line} ({TILE_NOTE})', flush=True)
            rows.append(row)
    return rows


STEP_VARIANTS = ('tt', 'ttv3', 'ttv4')


def step_ab(generator: torch.Generator) -> dict:
    """One SD-1.4 UNet with random normal·0.02 weights (bf16), its chain
    through each variant on the same inputs; max|Δ| against the first."""
    unet = pe.build_unet(pe.SD14_UNET, generator.device)
    with torch.no_grad():
        for p in unet.parameters():
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device) * 0.02)
    lat, ctx = pe.chain_inputs(unet, 2, 64, generator)
    res, ref = {}, None
    for label in STEP_VARIANTS:
        with kernel_swapped(_call(label)):
            r = pe.unet_chain(unet, lat, ctx, f'{label} UNet chain')
        ref = r['out'] if ref is None else ref
        r['max_abs_diff_vs_first'] = (r.pop('out') - ref).abs().max().item()
        print(f'{label:5s}: {r["ms"]:6.2f} ms/forward max|d| vs '
              f'{STEP_VARIANTS[0]} = {r["max_abs_diff_vs_first"]:.2e}',
              flush=True)
        res[label] = r
    return res


def run(generator: torch.Generator, device: Optional[str] = None,
        step: bool = False) -> dict:
    dev = resolve_device(device)
    if step and dev.type != 'cpu':
        return dict(step=step_ab(generator))
    return dict(main=main_run(generator))


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument('which', nargs='?', default='main',
                    choices=('main', 'step'))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device, args.which == 'step')


if __name__ == '__main__':
    main(sys.argv[1:])
