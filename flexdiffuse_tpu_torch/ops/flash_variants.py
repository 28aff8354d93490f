"""Attention variants T1–T6 — build, bind and launch, plus their plain twins.

The kernels are ``csrc/flash_variants.cu``: one CUDA C++ template for
sm_90a with six plain C entry points, the Hopper counterparts of the Pallas
kernels in the JAX package's flash-kernel experiment tools (see the note at
the top of the source). The wrappers keep those tools' names and arguments,
less the TPU block sizes (the Hopper tile is 64 K/V rows and 64·G q rows):

=====  ======================================  =======================
id     wrapper here (the tool's name)          TPU kernel
=====  ======================================  =======================
T1     :func:`attn_opt` (``flash_opt.attn``)   ``tools/flash_opt.py:57``
T2     :func:`attn_h`                          ``tools/flash_opt.py:120``
T3     :func:`pipelined_attention`             ``tools/flash_pipelined.py:22``
T4     :func:`flash_tt2`                       ``tools/flash_tt.py:87``
T5     :func:`flash_ttv3`                      ``tools/flash_tt3.py:41``
T6     :func:`attn_variants` (``flash_variants.attn``)  ``tools/flash_variants.py:27``
=====  ======================================  =======================

The two ``attn``\\ s stay apart as ``flexdiffuse_tpu_torch.tools.flash_opt.attn``
and ``flexdiffuse_tpu_torch.tools.flash_variants.attn``. T1, T2, T3 and T6
take ``[B, H, S, D]``; T4 and T5 take and return ``[B, H, D, S]``.

Each wrapper launches its kernel for CUDA tensors and raises on anything the
kernel does not take; only CPU tensors take its plain twin, which keeps the
variant's rounding points (:func:`plain_variant`): q scaled in its own dtype,
the base of the exponential, where P is rounded and how the row sum l is
formed. Each wrapper counts its launches per configuration in
``launches`` (a ``Counter``; :func:`launch_counts` sums them). Outputs carry
no gradient. The library is built at first use, as K1's
(``ops/flash_attention.build``/``load``), in :data:`BUILD_PARTS` compiles
at once.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Callable

import torch

from flexdiffuse_tpu_torch.ops import flash_attention as fa

SOURCE = fa.SOURCE.parent / 'flash_variants.cu'
# The source's 192 instantiations build in this many nvcc runs at once.
BUILD_PARTS = 8
LOG2E = 1.4426950408889634
TILE = 64            # K/V rows per tile; q rows per tile are 64·G
MAX_HEAD_DIM = 128
MAX_FOLD_HEAD_DIM = 120   # the fold needs a free padded column, d + 1 ≤ 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, o, batch, heads, sq, skv, d, scale, dtype[, options], stream)
_ARGS = (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I)
SIGNATURES = {
    'flash_opt_attn': _ARGS + (_I, _P),
    'flash_opt_attn_h': _ARGS + (_P,),
    'flash_pipelined_attn': _ARGS + (_P,),
    'flash_tt2_attn': _ARGS + (_P,),
    'flash_ttv3_attn': _ARGS + (_I, _I, _P),
    'flash_variants_attn': _ARGS + (_I, _P),
}

# Softmax modes (the kernel's template argument of the same name).
EXP, EXP2, EXP2_P16, EXP2_BF16 = 'exp', 'exp2', 'exp2_p16', 'exp2_bf16'


def plain_variant(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float, mode: str = EXP, fold: bool = False,
                  tile_round: bool = False) -> torch.Tensor:
    """One-pass twin of the variants over ``[B, H, S, D]``:

    * q̃ = q · scale (or scale·log2 e for the exp2 modes), both rounded to
      q's dtype, as the TPU kernels scale q in its own dtype;
    * s = q̃·kᵀ in fp32, p = exp(s − max) or exp2(s − max);
    * ``EXP2_BF16``: exp2 of the argument rounded to bf16, the result bf16
      (whatever q's dtype, as the TPU kernel casts to bfloat16);
    * P·V takes p rounded to v's dtype; l sums p in fp32 (``EXP``,
      ``EXP2``) or sums the rounded p (``EXP2_P16``, ``EXP2_BF16`` and the
      ``fold``, whose row sum is the ones column's product); with
      ``tile_round`` each 64-column tile's sum of the rounded p is rounded
      to v's dtype before l adds it.

    The kernels run this online over 64-column tiles (the running max
    rescales), so they differ from it by their fp32 order and, in 16 bits,
    by where p is rounded relative to the running max."""
    base2 = mode != EXP
    c = scale * (LOG2E if base2 else 1.0)
    qs = q * torch.tensor(c, dtype=q.dtype)
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2))
    x = s - s.amax(dim=-1, keepdim=True)
    if mode == EXP2_BF16:
        p16 = torch.exp2(x.to(torch.bfloat16).float()).to(torch.bfloat16)
        p16 = p16.to(v.dtype)
        p = p16.float()
    else:
        p = torch.exp2(x) if base2 else torch.exp(x)
        p16 = p.to(v.dtype)
    if tile_round:
        if x.shape[-1] % TILE:
            raise ValueError(f'tile_round needs Skv % {TILE} == 0')
        tiles = p16.float().unflatten(-1, (-1, TILE)).sum(dim=-1)
        l = tiles.to(v.dtype).float().sum(dim=-1, keepdim=True)
    elif fold or mode in (EXP2_P16, EXP2_BF16):
        l = p16.float().sum(dim=-1, keepdim=True)
    else:
        l = p.sum(dim=-1, keepdim=True)
    return (torch.matmul(p16.float(), v.float()) / l).to(q.dtype)


def _bhds(fn: Callable, q, k, v, *args, **kw) -> torch.Tensor:
    """Run a ``[B, H, S, D]`` twin on ``[B, H, D, S]`` tensors."""
    t = lambda x: x.transpose(-1, -2)
    return t(fn(t(q), t(k), t(v), *args, **kw)).contiguous()


# T1's (variant, G) → the entry point's variant code.
T1_CODES = {('v0', 1): 0, ('vU', 1): 1, ('vG', 2): 2, ('vG', 4): 3}
T5_SETTINGS = {(False, True): 'ttv3', (True, True): 'ttv4',
               (False, False): 'no-fold'}
T6_MODES = {0: EXP, 1: EXP2, 2: EXP2_P16}


def plain_exp(q, k, v, scale: float):
    """The twin of T1 (every variant rounds as v0), T2, T3 and T6 v0:
    natural exp, fp32 l."""
    return plain_variant(q, k, v, scale, EXP)


def plain_flash_tt2(q, k, v, scale: float):
    """T4's twin over ``[B, H, D, S]``: natural exp, fp32 l, 16-bit P for
    P·V (the TPU kernel's P·V takes fp32 P; the tensor cores here do not)."""
    return _bhds(plain_variant, q, k, v, scale, EXP)


def plain_flash_ttv3(q, k, v, scale: float, bf16_p: bool = False,
                     sum_fold: bool = True):
    """T5's twin over ``[B, H, D, S]``: exp2; ``sum_fold`` l = Σ rounded p;
    ``bf16_p`` exp2 on bf16 arguments; neither: l from per-tile sums
    rounded to v's dtype (flash_tt3.py:68-69)."""
    if bf16_p and not sum_fold:
        raise ValueError('flash_ttv3: bf16_p needs sum_fold (the TPU tool '
                         'runs ttv4 folded)')
    mode = EXP2_BF16 if bf16_p else EXP2_P16
    return _bhds(plain_variant, q, k, v, scale, mode, fold=sum_fold,
                 tile_round=not sum_fold)


def plain_attn_variants(variant: int, q, k, v, scale: float):
    """T6's twin: v0 exp, v1 exp2, v2 exp2 with l from the 16-bit P."""
    return plain_variant(q, k, v, scale, T6_MODES[variant])


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


def _check(name: str, q, k, v, bhds: bool, g: int = 1,
           fold: bool = False, cpu: bool = False) -> None:
    """The kernels' domain: 4-d q [B,H,Sq,D] and k, v [B,H,Skv,D] (or
    [B,H,D,S]), S a multiple of 64 (Sq of 64·G), D a multiple of 8 up to
    128 (120 with the fold); on CUDA also bf16/fp16 of one dtype,
    contiguous and 16-byte aligned. CPU tensors may be fp32."""
    if not cpu:
        if not (q.is_cuda and k.is_cuda and v.is_cuda and
                q.device == k.device == v.device):
            raise ValueError(f'{name}: q, k and v must all be CUDA tensors '
                             'of one device (or all CPU tensors)')
        if q.dtype not in fa.DTYPES16 or k.dtype != q.dtype or \
                v.dtype != q.dtype:
            raise ValueError(f'{name} takes bf16 or fp16 q/k/v of one '
                             f'dtype, got {q.dtype}/{k.dtype}/{v.dtype}')
        if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
                   for t in (q, k, v)):
            raise ValueError(f'{name} takes contiguous, 16-byte aligned '
                             'q, k, v')
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f'{name} takes 4-d q, k, v with k and v alike, '
                         f'got {tuple(q.shape)}, {tuple(k.shape)}, '
                         f'{tuple(v.shape)}')
    sdim = 3 if bhds else 2
    ddim = 2 if bhds else 3
    b, h, d = q.shape[0], q.shape[1], q.shape[ddim]
    sq, skv = q.shape[sdim], k.shape[sdim]
    if (k.shape[0], k.shape[1], k.shape[ddim]) != (b, h, d):
        raise ValueError(f'{name}: q {tuple(q.shape)} and k '
                         f'{tuple(k.shape)} disagree on B, H or D')
    top = MAX_FOLD_HEAD_DIM if fold else MAX_HEAD_DIM
    if d % 8 or not 8 <= d <= top:
        raise ValueError(f'{name}: head dim {d} is not a multiple of 8 in '
                         f'[8, {top}]')
    if sq % (TILE * g) or skv % TILE or sq < 1 or skv < 1:
        raise ValueError(f'{name}: sequences {sq} x {skv} are not multiples '
                         f'of {TILE * g} and {TILE}')
    if b * h > 65535:
        raise ValueError(f'{name}: B·H = {b * h} > 65535')


def _launch(entry: str, name: str, q, k, v, scale: float,
            *options: int) -> torch.Tensor:
    lib = fa.load(SOURCE, SIGNATURES, parts=BUILD_PARTS)
    out = torch.empty_like(q)
    b, h = q.shape[:2]
    bhds = entry in ('flash_tt2_attn', 'flash_ttv3_attn')
    d, sq, skv = ((q.shape[2], q.shape[3], k.shape[3]) if bhds else
                  (q.shape[3], q.shape[2], k.shape[2]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), b, h, sq, skv, d,
                                 float(scale), fa.DTYPES[q.dtype], *options,
                                 stream)
    fa.raise_on_error(rc, name, q, k)
    return out


def attn_opt(variant: str, q, k, v, scale: float, g: int = 1):
    """T1 (``tools/flash_opt.py::attn``): ``variant`` 'v0' (the plain kv
    loop), 'vU' (next K/V tile loaded during this one) or 'vG' (``g`` ∈
    {2, 4} independent 64-row q chains per block). ``[B, H, S, D]``."""
    g = g if variant == 'vG' else 1
    if (variant, g) not in T1_CODES:
        raise ValueError(f'attn: unknown variant {variant!r} (vG takes g '
                         f'in (2, 4), got {g})')
    cpu = _on_cpu(q, k, v)
    _check('flash_opt.attn', q, k, v, False, g=g, cpu=cpu)
    if cpu:
        return plain_exp(q, k, v, scale)
    out = _launch('flash_opt_attn', 'flash_opt.attn', q, k, v, scale,
                  T1_CODES[(variant, g)])
    attn_opt.launches[variant if variant != 'vG' else f'vG{g}'] += 1
    return out


def attn_h(q, k, v, scale: float):
    """T2 (``tools/flash_opt.py::attn_h``): all H heads of a 64-row q tile
    in one block. ``[B, H, S, D]``."""
    cpu = _on_cpu(q, k, v)
    _check('flash_opt.attn_h', q, k, v, False, cpu=cpu)
    if cpu:
        return plain_exp(q, k, v, scale)
    out = _launch('flash_opt_attn_h', 'flash_opt.attn_h', q, k, v, scale)
    attn_h.launches['vH'] += 1
    return out


def pipelined_attention(q, k, v, scale: float):
    """T3 (``tools/flash_pipelined.py::pipelined_attention``): the next
    tile's QKᵀ before this tile's softmax. ``[B, H, S, D]``."""
    cpu = _on_cpu(q, k, v)
    _check('pipelined_attention', q, k, v, False, cpu=cpu)
    if cpu:
        return plain_exp(q, k, v, scale)
    out = _launch('flash_pipelined_attn', 'pipelined_attention', q, k, v,
                  scale)
    pipelined_attention.launches['pipelined'] += 1
    return out


def flash_tt2(q, k, v, scale: float):
    """T4 (``tools/flash_tt.py::flash_tt2``): ``[B, H, D, S]`` in and out."""
    cpu = _on_cpu(q, k, v)
    _check('flash_tt2', q, k, v, True, cpu=cpu)
    if cpu:
        return plain_flash_tt2(q, k, v, scale)
    out = _launch('flash_tt2_attn', 'flash_tt2', q, k, v, scale)
    flash_tt2.launches['tt2'] += 1
    return out


def flash_ttv3(q, k, v, scale: float, bf16_p: bool = False,
               sum_fold: bool = True):
    """T5 (``tools/flash_tt3.py::flash_ttv3``): ``[B, H, D, S]``, exp2;
    ``sum_fold`` takes the row sum from P·V (ttv3), ``bf16_p`` with it
    evaluates exp2 on bf16 arguments (ttv4); neither is the no-fold
    setting."""
    if bf16_p and not sum_fold:
        raise ValueError('flash_ttv3: bf16_p needs sum_fold')
    cpu = _on_cpu(q, k, v)
    _check('flash_ttv3', q, k, v, True, fold=sum_fold, cpu=cpu)
    if cpu:
        return plain_flash_ttv3(q, k, v, scale, bf16_p, sum_fold)
    out = _launch('flash_ttv3_attn', 'flash_ttv3', q, k, v, scale,
                  int(bf16_p), int(sum_fold))
    flash_ttv3.launches[T5_SETTINGS[(bool(bf16_p), bool(sum_fold))]] += 1
    return out


def attn_variants(variant: int, q, k, v, scale: float):
    """T6 (``tools/flash_variants.py::attn``): ``variant`` 0 (exp; on
    Hopper the same code as T1 v0), 1 (exp2), 2 (exp2, l from the 16-bit
    P). ``[B, H, S, D]``."""
    if variant not in T6_MODES:
        raise ValueError(f'attn: unknown variant {variant!r}')
    cpu = _on_cpu(q, k, v)
    _check('flash_variants.attn', q, k, v, False, cpu=cpu)
    if cpu:
        return plain_attn_variants(variant, q, k, v, scale)
    out = _launch('flash_variants_attn', 'flash_variants.attn', q, k, v,
                  scale, variant)
    attn_variants.launches[f'v{variant}'] += 1
    return out


WRAPPERS = (attn_opt, attn_h, pipelined_attention, flash_tt2, flash_ttv3,
            attn_variants)


def _bind(fn: Callable, *args, **kw) -> Callable:
    return lambda q, k, v, s: fn(*args, q, k, v, s, **kw)


# Every configuration the tools run: label → (kernel call, twin call,
# [B, H, D, S] operands?), each call (q, k, v, scale).
CONFIGS = {
    'T1 v0': (_bind(attn_opt, 'v0'), plain_exp, False),
    'T1 vU': (_bind(attn_opt, 'vU'), plain_exp, False),
    'T1 vG2': (_bind(attn_opt, 'vG', g=2), plain_exp, False),
    'T1 vG4': (_bind(attn_opt, 'vG', g=4), plain_exp, False),
    'T2': (attn_h, plain_exp, False),
    'T3': (pipelined_attention, plain_exp, False),
    'T4': (flash_tt2, plain_flash_tt2, True),
    'T5 ttv3': (flash_ttv3, plain_flash_ttv3, True),
    'T5 ttv4': (_bind(flash_ttv3, bf16_p=True),
                _bind(plain_flash_ttv3, bf16_p=True), True),
    'T5 no-fold': (_bind(flash_ttv3, sum_fold=False),
                   _bind(plain_flash_ttv3, sum_fold=False), True),
    'T6 v0': (_bind(attn_variants, 0), _bind(plain_attn_variants, 0), False),
    'T6 v1': (_bind(attn_variants, 1), _bind(plain_attn_variants, 1), False),
    'T6 v2': (_bind(attn_variants, 2), _bind(plain_attn_variants, 2), False),
}


def launch_counts() -> dict:
    """Each wrapper's launches, by name, its configurations summed."""
    return {fn.__name__: sum(fn.launches.values()) for fn in WRAPPERS}


def reset_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = collections.Counter()


reset_counts()
