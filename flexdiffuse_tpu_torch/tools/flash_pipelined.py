"""T3: the software-pipelined flash kernel, measured in the full UNet chain.

Port of ``tools/flash_pipelined.py``: tile j+1's QKᵀ is issued before tile
j's softmax and P·V, so the tensor-core and CUDA-core work of neighbouring
tiles are independent. The kernel is T3's Hopper path
(``csrc/flash_variants_sm90.cu``: TMA, wgmma, warp specialisation; the
first port, ``csrc/flash_variants.cu`` kScoreAhead, runs with
``pipelined_attention(..., path='mma')``). The
kernel is checked against fp32 attention, then the SD-1.4 UNet chain
(``perf_experiment.scan_time``) runs with K1 and with T3 swapped in for
the kernel that ``ops/attention.py`` calls on eligible shapes.

    python -m flexdiffuse_tpu_torch.tools.flash_pipelined [--device cpu]

On the CPU only the exactness check runs, at a small shape.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch

from flexdiffuse_tpu_torch.ops import attention as attn_mod
from flexdiffuse_tpu_torch.ops.flash_variants import pipelined_attention
from flexdiffuse_tpu_torch.tools import (generator, max_err, parser, qkv,
                                         reference, resolve_device)
from flexdiffuse_tpu_torch.tools import perf_experiment as pe

SHAPE = (2, 8, 4096, 40)
CPU_SHAPE = (1, 2, 256, 40)


@contextlib.contextmanager
def kernel_swapped(kernel: Callable):
    """``ops/attention.py`` calls ``kernel(q, k, v, scale)`` instead of K1
    for eligible shapes inside the block."""
    orig = attn_mod.flash_attention
    attn_mod.flash_attention = kernel
    try:
        yield
    finally:
        attn_mod.flash_attention = orig


def run(generator: torch.Generator, device: Optional[str] = None) -> dict:
    dev = resolve_device(device)
    cpu = dev.type == 'cpu'
    shape = CPU_SHAPE if cpu else SHAPE
    q, k, v = qkv(shape, generator)
    scale = shape[-1]**-0.5
    err = max_err(pipelined_attention(q, k, v, scale),
                  reference(q, k, v, scale))
    print(f'pipelined maxerr: {err}', flush=True)
    res = dict(max_abs_err=err)
    if cpu:
        return res
    make_unet = pe.unet_maker(dev)
    res['base'] = pe.scan_time(make_unet, 'production kernel (K1)',
                               generator=generator)
    with kernel_swapped(pipelined_attention):
        res['piped'] = pe.scan_time(make_unet, 'pipelined kernel (T3)',
                                    generator=generator)
    base, piped = res['base']['ms'], res['piped']['ms']
    print(f'delta: {base - piped:+.2f} ms/forward '
          f'({100 * (base - piped) / base:+.1f}%)')
    return res


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device)


if __name__ == '__main__':
    main()
