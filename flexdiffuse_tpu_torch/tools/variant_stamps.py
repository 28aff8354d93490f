"""Where the Hopper kernels of T1–T6 spend a consumer's time: clock stamps
per phase.

    python -m flexdiffuse_tpu_torch.tools.variant_stamps [--calls N]

Compiles ``csrc/flash_variants_sm90.cu`` once more with ``-DFV_STAMPS`` (one
part holding bf16 at the main shapes' widths only, in a temporary
directory: the library the port loads is not touched), runs T2
(``flash_opt_attn_h_sm90``, with the kv split its plan picks), T3
(``flash_pipelined_attn_sm90``), T1's v0, vU, vG2 and vG4
(``flash_opt_attn_sm90``; T6 runs v0's schedule), T4
(``flash_tt2_attn_sm90``) and T5's ttv3, ttv4 and no-fold
(``flash_ttv3_attn_sm90``, on ``[B, H, D, S]`` operands), each with the
tiles and split its plan picks, ``--calls`` times on seeded bf16 inputs at
the two main shapes, and prints one JSON line per kernel and shape: the
cycles that thread 0 of consumer 0 of block (0, 0, 0)
spent in each phase of the source's ``Phase`` per call and per kv tile of
its loop, and each phase's share. The stamps' own ``clock64`` reads slow
the kernel a little; compare phases, not totals. Needs the card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import tempfile

import torch

from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_variants as fv

PHASES = ('turn', 'tile', 'issue', 'wait_s', 'softmax', 'wait_all', 'tail',
          'other')
SHAPES = [(2, 8, 4096, 40), (2, 8, 1024, 80)]
# Each configuration's row of the stamps: 0 T2, 1 T3, 2 the chains kernel
# (T1, T4, T5, T6).
KERNELS = {'T2': 0, 'T3': 1, 'T1 v0': 2, 'T1 vU': 2, 'T1 vG2': 2,
           'T1 vG4': 2, 'T4': 2, 'T5 ttv3': 2, 'T5 ttv4': 2,
           'T5 no-fold': 2}


def build(tmp: str) -> ctypes.CDLL:
    """The stamped library, compiled into ``tmp`` and loaded."""
    lib = os.path.join(tmp, 'flash_variants_sm90_stamps.so')
    proc = subprocess.run([fa._nvcc(), *fa.NVCC_FLAGS, '-DFV_STAMPS', '-o',
                           lib, str(fv.SM90_SOURCE)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed:\n{proc.stderr}')
    cdll = ctypes.CDLL(lib)
    for name, argtypes in fv.SM90_SIGNATURES.items():
        getattr(cdll, name).argtypes = list(argtypes)
    cdll.flash_variants_sm90_stamps.argtypes = [ctypes.c_void_p]
    return cdll


def tiles_per_call(kernel: str, how: fv.Plan, shape) -> int:
    """The kv tiles consumer 0 of block (0, 0, 0) walks in one call."""
    b, h, s, d = shape
    tiles = s // how.block_kv
    if kernel != 'T2':
        return -(-tiles // how.parts)
    consumers = how.threads // 128 - 1
    return -(-h // consumers) * -(-tiles // how.parts)


def stamps(lib: ctypes.CDLL, kernel: str, shape, calls: int,
           gen: torch.Generator) -> dict:
    b, h, s, d = shape
    bhds = fv.CONFIGS[kernel][2]
    q, k, v = (torch.randn((b, h, d, s) if bhds else shape, generator=gen,
                           device='cuda', dtype=torch.bfloat16)
               for _ in range(3))
    out = torch.empty_like(q)
    _, plan, fn, options = fv.PATH_CONFIGS[kernel]
    entry = fv.ENTRIES[fn.__name__][fv.SM90]
    how = plan(q, k)
    options = fv.entry_options(fn, how, *options)
    raw = (ctypes.c_ulonglong * (3 * len(PHASES)))()
    for i in range(calls + 1):   # the first call warms up
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), b, h, s, s, d, d**-0.5,
                                 fa.DTYPES[q.dtype], *options, stream)
        fa.raise_on_error(rc, entry, q, k)
        if i == 0:
            torch.cuda.synchronize()
            fa.raise_on_error(lib.flash_variants_sm90_stamps(raw), entry, q,
                              k)
    torch.cuda.synchronize()
    fa.raise_on_error(lib.flash_variants_sm90_stamps(raw), entry, q, k)
    row = list(raw)[KERNELS[kernel] * len(PHASES):][:len(PHASES)]
    total = sum(row)
    tiles = tiles_per_call(kernel, how, shape)
    return dict(kernel=kernel, shape=list(shape), parts=how.parts,
                block_kv=how.block_kv, tiles_per_call=tiles,
                cycles_per_call=total / calls,
                cycles_per_tile={p: c / calls / tiles
                                 for p, c in zip(PHASES, row)},
                share={p: c / total for p, c in zip(PHASES, row)})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--calls', type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError('variant_stamps needs a CUDA card')
    gen = torch.Generator('cuda').manual_seed(0)
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for shape in SHAPES:
            for kernel in KERNELS:
                print(json.dumps(stamps(lib, kernel, shape, args.calls, gen)),
                      flush=True)


if __name__ == '__main__':
    main()
