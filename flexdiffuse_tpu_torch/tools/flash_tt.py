"""T4: the flash kernel over [B,H,D,S] operands, against K1 and in the UNet.

Port of ``tools/flash_tt.py``: ``python -m flexdiffuse_tpu_torch.tools.flash_tt
[exact|micro|micro2|step|all] [--device cpu] [--path sm90|mma]`` (``all``,
the default, runs exact, micro and step, as the JAX script does). T4 runs
on the path its plan picks ('sm90', ``csrc/flash_variants_sm90.cu``) or the
one ``--path`` names ('mma': the first port's kernel in
``csrc/flash_variants.cu``); without ``--path``, ``micro`` times the kept
kernel beside it (``tt2_kept_ms``).

* ``check_exact``: K1, K1's transposed entry (``fa.flash_attention_tt``,
  the script's own subject) and T4 against fp32 attention at the script's
  four shapes (OK below 0.04 absolute, the script's threshold).
* ``micro`` / ``micro2``: 12-deep chains of K1 on ``[B,H,S,D]``, of
  ``flash_attention_tt`` (the script's 'tt') and of T4 on ``[B,H,D,S]``
  (``micro2`` checks T4's exactness first).
* ``step``: the SD-1.4 UNet chain (``perf_experiment.scan_time``), ``base``
  (K1) and ``tt`` (T4 through :func:`_attention_tt_bhsd`). The script's
  GroupNorm variants (``gn``, ``gn-nb``, ``gn-stats``, ``tt+gn``) need
  ``ops/group_norm_xla.py``, which is not ported (an XLA fusion
  experiment); ``chip_smoke.py --profile-gen`` compares K6 with the plain
  GroupNorm instead.

On the CPU only ``check_exact`` runs, at a small shape.
"""
from __future__ import annotations

import contextlib
import sys
from typing import Optional

import torch

import flexdiffuse_tpu_torch.models.unet as unet_mod
from flexdiffuse_tpu_torch.ops.attention import flash_eligible
from flexdiffuse_tpu_torch.ops.flash_attention import (flash_attention,
                                                       flash_attention_tt,
                                                       plain_attention,
                                                       plan_ds)
from flexdiffuse_tpu_torch.ops.flash_variants import (MMA, PATHS, flash_tt2,
                                                      plan_tt2)
from flexdiffuse_tpu_torch.tools import (TILE_NOTE, chain_ms, generator,
                                         max_err, parser, qkv, reference,
                                         resolve_device, tflops)
from flexdiffuse_tpu_torch.tools import transposed as _t
from flexdiffuse_tpu_torch.tools import perf_experiment as pe

STEPS = 12
EXACT_SHAPES = [(2, 8, 4096, 40), (2, 8, 1024, 80), (8, 8, 4096, 40),
                (2, 8, 1536, 40)]
MICRO_SHAPES = [(2, 8, 4096, 40), (8, 8, 4096, 40), (2, 8, 1024, 80)]
CPU_SHAPES = [(1, 2, 256, 40), (1, 2, 128, 80)]


def _tt2(path: Optional[str]):
    """T4 on ``path`` (the planned one when None), ``[B,H,D,S]``."""
    return lambda q, k, v, s: flash_tt2(q, k, v, s, path=path)


def check_exact(generator: torch.Generator,
                path: Optional[str] = None) -> list:
    """K1 on [B,H,S,D], K1's transposed entry and T4 (on ``path``) on
    [B,H,D,S] against fp32 attention."""
    cpu = generator.device.type == 'cpu'
    rows = []
    for shape in CPU_SHAPES if cpu else EXACT_SHAPES:
        q, k, v = qkv(shape, generator)
        scale = shape[-1]**-0.5
        ref = reference(q, k, v, scale)
        for label, got in (
                ('flash (K1)', flash_attention(q, k, v, scale)),
                ('tt (K1)', _t(flash_attention_tt(_t(q), _t(k), _t(v),
                                                  scale))),
                ('tt2 (T4)', _t(_tt2(path)(_t(q), _t(k), _t(v), scale)))):
            err = max_err(got, ref)
            print(f'{label} exactness {shape}: max abs err {err:.4f} '
                  f'{"OK" if err < 0.04 else "FAIL"}', flush=True)
            rows.append(dict(kernel=label, shape=list(shape),
                             max_abs_err=err))
    return rows


def _bench(fn, q, k, v, label, shape, tile: str = TILE_NOTE) -> float:
    """A 12-deep chain ``c ← 0.999·fn(c, k, v) + 0.001·q``."""
    scale = shape[-1]**-0.5
    ms, _ = chain_ms(lambda c: 0.999 * fn(c, k, v, scale) + 0.001 * q, q,
                     STEPS)
    print(f'  {label:10s} {shape}: {ms:6.3f} ms/call '
          f'{tflops(shape, ms):6.1f} TFLOP/s ({tile})', flush=True)
    return ms


def _tile(q, k, path: Optional[str]) -> str:
    how = plan_tt2(q, k, path=path)
    return f'{how.path} {how.block_q}q x {how.block_kv}kv tile'



def micro(generator: torch.Generator, exact: bool = False,
          path: Optional[str] = None) -> list:
    """K1 on [B,H,S,D] against K1's transposed entry and T4 on [B,H,D,S]
    (T4 on ``path``; with None the planned path and the kept kernel beside
    it), chain-timed."""
    rows = []
    for shape in MICRO_SHAPES:
        q, k, v = qkv(shape, generator)
        qt, kt, vt = _t(q), _t(k), _t(v)
        row = dict(shape=list(shape))
        if exact:
            ref = reference(q, k, v, shape[-1]**-0.5)
            row['tt2_max_abs_err'] = max_err(
                _t(_tt2(path)(qt, kt, vt, shape[-1]**-0.5)), ref)
            print(f'tt2 exact {shape}: {row["tt2_max_abs_err"]:.4f} '
                  f'{"OK" if row["tt2_max_abs_err"] < 0.04 else "FAIL"}')
        print(f'shape {shape}:')
        row['flash_ms'] = _bench(flash_attention, q, k, v, 'flash (K1)',
                                 shape)
        how = plan_ds(qt, kt, layout='tt')
        row['tt_ms'] = _bench(flash_attention_tt, qt, kt, vt, 'tt (K1)',
                              shape, f'{how.path} {how.block_q}q x '
                              f'{how.block_kv}kv tile')
        row['tt2_ms'] = _bench(_tt2(path), qt, kt, vt, 'tt2 (T4)', shape,
                               _tile(qt, kt, path))
        if path is None:
            row['tt2_kept_ms'] = _bench(_tt2(MMA), qt, kt, vt, 'tt2 kept',
                                        shape, _tile(qt, kt, MMA))
        rows.append(row)
    return rows


def micro2(generator: torch.Generator, path: Optional[str] = None) -> list:
    return micro(generator, exact=True, path=path)


def _attention_tt_bhsd(path: Optional[str] = None):
    """Dispatcher-compatible ``[B,H,S,D]`` attention over T4 (on ``path``)
    for the flash-eligible shapes, plain attention otherwise (``backend``
    is accepted and ignored, as in the JAX script)."""
    def attend(q, k, v, scale=None, backend=None):
        if scale is None:
            scale = q.shape[-1]**-0.5
        if not flash_eligible(q, k):
            return plain_attention(q, k, v, scale)
        return _t(_tt2(path)(_t(q), _t(k), _t(v), scale))
    return attend


@contextlib.contextmanager
def unet_attention(fn):
    """The UNet's attention calls go to ``fn`` inside the block."""
    orig = unet_mod.attention
    unet_mod.attention = fn
    try:
        yield
    finally:
        unet_mod.attention = orig


def step(generator: torch.Generator, path: Optional[str] = None) -> dict:
    """The UNet chain through K1 (``base``) and through T4 (``tt``, on
    ``path``)."""
    make_unet = pe.unet_maker(generator.device)
    res = {'base': pe.scan_time(make_unet, 'baseline (K1)',
                                generator=generator)}
    with unet_attention(_attention_tt_bhsd(path)):
        res['tt'] = pe.scan_time(make_unet, 'tt-attn (T4)',
                                 generator=generator)
    return res


def run(generator: torch.Generator, device: Optional[str] = None,
        which: str = 'all', path: Optional[str] = None) -> dict:
    """The parts ``which`` names, T4 on ``path`` (the planned one when
    None; on the CPU the twin whatever the path)."""
    dev = resolve_device(device)
    res = {}
    if which in ('exact', 'all') or dev.type == 'cpu':
        res['exact'] = check_exact(generator, path)
    if dev.type == 'cpu':
        return res
    if which in ('micro', 'all'):
        res['micro'] = micro(generator, path=path)
    if which == 'micro2':
        res['micro2'] = micro2(generator, path)
    if which in ('step', 'all'):
        res['step'] = step(generator, path)
    return res


def main(argv=None) -> None:
    ap = parser(__doc__)
    ap.add_argument('which', nargs='?', default='all',
                    choices=('exact', 'micro', 'micro2', 'step', 'all'))
    ap.add_argument('--path', default=None, choices=PATHS,
                    help='run T4 on one path only (default: the planned '
                    'one, and the kept kernel beside it in micro)')
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device, args.which, args.path)


if __name__ == '__main__':
    main(sys.argv[1:])
