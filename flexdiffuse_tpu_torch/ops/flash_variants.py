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

Every variant has a second path, its Hopper redesign in
``csrc/flash_variants_sm90.cu`` (TMA, wgmma, warp specialisation; its own
library, :data:`SM90_SOURCE` in :data:`SM90_BUILD_PARTS` compiles), which
:func:`plan_attn_opt`, :func:`plan_attn_h`, :func:`plan_pipelined`,
:func:`plan_tt2`, :func:`plan_ttv3` and :func:`plan_attn_variants` pick
for every CUDA call of the domain ('sm90'); the first port's kernel runs
only when the caller forces ``path='mma'``. They count their launches by
path in ``path_launches`` (:func:`path_counts`). A refused launch raises:
there is no fallback to the other path or to the twin. The plans of T1,
T2, T4 and T6 v0 split the kv range over a cluster of blocks where the
card has room; :func:`plain_split_exp` is that split's twin. A plan says
the layout of its call (``Plan.bhds``), and the launch passes D and S to
the kernel by it.
"""
from __future__ import annotations

import collections
import ctypes
from typing import Callable, Optional

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

# The Hopper redesigns: their own source and library, built in
# SM90_BUILD_PARTS compiles at once; (..., dtype[, variant or T5's
# bf16_p and sum_fold][, q chains][, parts], stream). The probe takes
# (q, k, v, s, o, d, dtype, stream).
SM90_SOURCE = fa.SOURCE.parent / 'flash_variants_sm90.cu'
SM90_BUILD_PARTS = 16
SM90_SIGNATURES = {'flash_opt_attn_h_sm90': _ARGS + (_I, _P),
                   'flash_pipelined_attn_sm90': _ARGS + (_P,),
                   'flash_opt_attn_sm90': _ARGS + (_I, _I, _P),
                   'flash_variants_attn_sm90': _ARGS + (_I, _I, _P),
                   'flash_tt2_attn_sm90': _ARGS + (_I, _I, _P),
                   'flash_ttv3_attn_sm90': _ARGS + (_I, _I, _I, _P),
                   'flash_variants_sm90_probe': (_P,) * 5 + (_I, _I, _P),
                   # K1 over [D, S] (fa.flash_attention_tt/_cm): (q, k, v,
                   # o, planes, batches, sq, skv, d, scale, dtype, chains,
                   # parts, stream)
                   'flash_attention_ds_sm90': _ARGS + (_I, _I, _P)}
SM90, MMA = 'sm90', 'mma'
PATHS = (SM90, MMA)   # the paths of every variant
# Their tiles on 'sm90', as the source's PipelinedTiling/HeadsTiling choose
# them (change both together): (consumer warpgroups of 64 q rows, K/V
# stages of TILE rows), T3's at every width, T2's keyed by the padded head
# width DP <= 64. T2 splits an instance's kv range only up to
# HEADS_SPLIT_MAX_DP (the merge buffers' room), into the first of
# HEADS_PARTS that fits the card (the kernel also takes 4 parts, which ran
# slower than 2 at (2,8,1024,80): PERF.md §6).
PIPELINED_TILES = (2, 4)
HEADS_TILES = {True: (3, 3), False: (2, 3)}
HEADS_SPLIT_MAX_DP = 96
HEADS_PARTS = (2,)
# T1's and T6's tiles on 'sm90', as the source's ChainsTiling chooses them
# (change both together), by the kernel's configuration and DP <= 64: (q
# chains of 64 rows, K/V stages, blocks an SM that the registers allow;
# the shared memory may allow fewer, chains_blocks). The kv tile is 64
# rows, 32 for four chains above DP = CHAINS_KV32_ABOVE. T6 v0 and v1 run
# v0's instantiation, v2 its own with v0's tiles. Where the blocks number
# at most the card's SMs, the plans of T1 and T6 v0 split the kv range over
# a cluster of the first of CHAINS_PARTS blocks with a tile for each part,
# where the merge buffers fit (chains_split_fits): measured, 2 parts won
# for vG4 and vG2 at (2,8,1024,80) (64 and 128 blocks) and lost or tied
# at every main-shape grid above 132 blocks but v0's and vU's at
# (2,8,4096,40) (PERF.md §6).
CHAINS_TILES = {
    ('v0', True): (1, 3, 3), ('v0', False): (1, 2, 2),
    ('vU', True): (1, 4, 3), ('vU', False): (1, 4, 2),
    ('vG2', True): (2, 3, 2), ('vG2', False): (2, 3, 1),
    ('vG4', True): (4, 3, 1), ('vG4', False): (4, 3, 1),
}
CHAINS_KV32_ABOVE = 96
# T4's and T5's q chains on 'sm90' (tt_chains): vG4's four where Sq is a
# multiple of 256 and DP <= CHAINS_KV32_ABOVE (their [D, S] kv tile stays
# 64 columns, so above it vG4's registers would not hold O, S and P), else
# vG2's two where Sq is a multiple of 128, else v0's one.
TT_CONFIGS = {4: 'vG4', 2: 'vG2', 1: 'v0'}
CHAINS_PARTS = (2,)
SMEM_PER_SM = 233472   # an H100 SM's shared memory, bytes

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


def plain_split_exp(q, k, v, scale: float, parts: int = 2):
    """T2's kv split on 'sm90' in plain PyTorch: q̃ as :func:`plain_exp`;
    the kv range cut as the kernel cuts it (⌈tiles/parts⌉ tiles of TILE rows
    a part); each part's raw row max m_i, p = exp(s − m_i), l_i = Σ p and
    o_i = round16(p)·v in fp32; then the merge in rank order,
    o = Σ o_i·e^(m_i − m) / Σ l_i·e^(m_i − m) with m = max m_i, cast to
    q's dtype."""
    qs = (q * torch.tensor(scale, dtype=q.dtype)).float()
    tiles = k.shape[2] // TILE
    step = -(-tiles // parts) * TILE
    states = []
    for start in range(0, k.shape[2], step):
        s = torch.matmul(qs, k[:, :, start:start + step].float()
                         .transpose(-1, -2))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        states.append((torch.matmul(p.to(v.dtype).float(),
                                    v[:, :, start:start + step].float()),
                       m, p.sum(dim=-1, keepdim=True)))
    m = torch.stack([m_i for _, m_i, _ in states]).amax(dim=0)
    o = l = 0.0
    for o_i, m_i, l_i in states:
        a = torch.exp(m_i - m)
        o, l = o + o_i * a, l + l_i * a
    return (o / l).to(q.dtype)


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


def _call(lib: ctypes.CDLL, entry: str, name: str, q, k, v, out,
          scale: float, bhds: bool, *options: int) -> None:
    """Launch ``lib``'s ``entry`` into ``out`` on the current stream, with
    q, k, v and ``out`` ``[B, H, D, S]`` where ``bhds``, else ``[B, H, S,
    D]``; raises (naming ``name``) if the launch is refused."""
    b, h = q.shape[:2]
    d, sq, skv = ((q.shape[2], q.shape[3], k.shape[3]) if bhds else
                  (q.shape[3], q.shape[2], k.shape[2]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, entry)(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), b, h, sq, skv, d,
                                 float(scale), fa.DTYPES[q.dtype], *options,
                                 stream)
    fa.raise_on_error(rc, name, q, k)


def _path(name: str, path: Optional[str]) -> str:
    if path not in (None, *PATHS):
        raise ValueError(f'{name}: path {path!r} not in {PATHS}')
    return path or SM90


def plan_pipelined(q: torch.Tensor, k: torch.Tensor,
                   path: Optional[str] = None) -> fa.Plan:
    """T3's path and tiling (an ``ops.flash_attention.Plan``) for ``q``
    ``[B, H, Sq, D]`` and ``k`` ``[B, H, Skv, D]`` of the domain
    (:func:`_check`), from their shapes alone: 'sm90' (C consumer
    warpgroups of 64 q rows sharing a ring of K/V stages, PIPELINED_TILES)
    unless ``path`` forces the kept 'mma' (one 4-warp block per 64 q rows,
    K/V double-buffered)."""
    b, h, sq, d = q.shape
    head_pad = -(-d // 16) * 16
    if _path('pipelined_attention', path) == MMA:
        return fa.Plan(MMA, head_pad, TILE, TILE, 2, (sq // TILE, b * h), 128)
    consumers, stages = PIPELINED_TILES
    block_q = TILE * consumers
    return fa.Plan(SM90, head_pad, block_q, TILE, stages,
                   (-(-sq // block_q), b * h), 128 * (consumers + 1))


def heads_parts(instances: int, tiles: int, head_pad: int) -> int:
    """How many blocks split each T2 instance's kv range on 'sm90': 1 where
    the ``instances`` (B·Sq/64) fill more than half of the card or DP >
    HEADS_SPLIT_MAX_DP; else the first of HEADS_PARTS whose blocks fit on
    the card with every part at least one of the ``tiles`` kv tiles."""
    if head_pad > HEADS_SPLIT_MAX_DP or 2 * instances > fa.SMS:
        return 1
    for parts in HEADS_PARTS:
        per = -(-tiles // parts)
        if instances * parts <= fa.SMS and (parts - 1) * per < tiles:
            return parts
    return 1


def plan_attn_h(q: torch.Tensor, k: torch.Tensor,
                path: Optional[str] = None) -> fa.Plan:
    """T2's path and tiling, as :func:`plan_pipelined`'s: on 'sm90' one
    instance per (b, 64 q rows), grid (q tiles, B), whose C consumer
    warpgroups (HEADS_TILES) each take every C-th head, its kv range split
    over ``parts`` = :func:`heads_parts` blocks; the kept 'mma' one 4-warp
    block per (b, 64 q rows) walking the heads in turn."""
    b, h, sq, d = q.shape
    head_pad = -(-d // 16) * 16
    if _path('flash_opt.attn_h', path) == MMA:
        return fa.Plan(MMA, head_pad, TILE, TILE, 1, (sq // TILE, b), 128)
    consumers, stages = HEADS_TILES[head_pad <= 64]
    parts = heads_parts(b * (sq // TILE), k.shape[2] // TILE, head_pad)
    return fa.Plan(SM90, head_pad, TILE, TILE, stages, (sq // TILE, b),
                   128 * (consumers + 1), parts)


def chains_tiling(config: str, head_pad: int, bhds: bool = False) -> tuple:
    """An 'sm90' chains configuration's (q chains, K/V stages, kv rows a
    tile, blocks an SM by registers) at DP ``head_pad``, as ChainsTiling;
    ``bhds`` for T4/T5's [D, S] operands, whose kv tile is 64 columns."""
    chains, stages, blocks = CHAINS_TILES[config.replace('v2', 'v0'),
                                          head_pad <= 64]
    kv = (TILE // 2 if not bhds and chains == 4 and
          head_pad > CHAINS_KV32_ABOVE else TILE)
    return chains, stages, kv, blocks


def _chains_smem(config: str, head_pad: int, bhds: bool = False) -> tuple:
    """(bytes before the barriers, all bytes) of one 'sm90' chains block's
    shared memory, as ChainsTiling counts them: the chains' Q tiles, the K
    and V stages (over [D, S] each DP rows of 128 bytes); then the barriers
    and 1 KB of alignment slack."""
    chains, stages, kv, _ = chains_tiling(config, head_pad, bhds)
    pitch = 128 if head_pad <= 64 else 32
    tile = ((lambda rows: head_pad * rows * 2) if bhds else
            (lambda rows: -(-head_pad // (pitch // 2)) * rows * pitch))
    bars = chains * tile(TILE) + 2 * stages * tile(kv)
    return bars, bars + (2 * stages + 1) * 8 + 1024


def chains_bytes(config: str, head_pad: int, bhds: bool = False) -> int:
    """Shared memory of one 'sm90' chains block (ChainsTiling::kBytes)."""
    return _chains_smem(config, head_pad, bhds)[1]


def chains_blocks(config: str, head_pad: int, bhds: bool = False) -> int:
    """'sm90' chains blocks an SM holds: the fewer of what the registers
    allow (CHAINS_TILES) and what the shared memory allows, 1 KB reserved a
    block."""
    by_regs = chains_tiling(config, head_pad, bhds)[3]
    return min(by_regs,
               SMEM_PER_SM // (chains_bytes(config, head_pad, bhds) + 1024))


def chains_split_fits(config: str, head_pad: int, bhds: bool = False) -> bool:
    """Whether the kv split's merge buffers (a float4 per thread for every
    8 columns of O, and one for m and l) fit where Q and the ring were
    (ChainsTiling::kSplit)."""
    chains = chains_tiling(config, head_pad, bhds)[0]
    return (chains * 128 * (head_pad // 8 + 1) * 16 <=
            _chains_smem(config, head_pad, bhds)[0])


def chains_parts(config: str, blocks: int, tiles: int,
                 head_pad: int, bhds: bool = False) -> int:
    """How many blocks split each 'sm90' T1, T4 (or T6 v0) block's kv
    range of ``tiles`` tiles: 1 where the ``blocks`` outnumber the card's
    SMs or the merge buffers do not fit; else the first of CHAINS_PARTS
    with every part at least one tile."""
    if blocks > fa.SMS or not chains_split_fits(config, head_pad, bhds):
        return 1
    for parts in CHAINS_PARTS:
        if (parts - 1) * -(-tiles // parts) < tiles:
            return parts
    return 1


def _plan_chains(name: str, config: str, q, k, g: int, stages_kept: int,
                 path: Optional[str], split: bool) -> fa.Plan:
    b, h, sq, d = q.shape
    head_pad = -(-d // 16) * 16
    if _path(name, path) == MMA:
        return fa.Plan(MMA, head_pad, TILE * g, TILE, stages_kept,
                       (sq // (TILE * g), b * h), 128 * g)
    chains, stages, kv, _ = chains_tiling(config, head_pad)
    grid = (sq // (TILE * chains), b * h)
    parts = (chains_parts(config, grid[0] * grid[1], k.shape[2] // kv,
                          head_pad) if split else 1)
    return fa.Plan(SM90, head_pad, TILE * chains, kv, stages, grid,
                   128 * chains, parts)


def plan_attn_opt(q: torch.Tensor, k: torch.Tensor, variant: str,
                  g: int = 1, path: Optional[str] = None) -> fa.Plan:
    """T1's path and tiling for ``variant`` ('v0', 'vU', 'vG' with ``g``
    2 or 4) on ``q`` ``[B, H, Sq, D]`` and ``k`` of the domain, from their
    shapes alone: 'sm90' (G = g consumer warpgroups of 64 q rows sharing a
    ring of K/V stages, CHAINS_TILES; the kv range split over ``parts`` =
    :func:`chains_parts` blocks) unless ``path`` forces the kept 'mma'
    (4·G warps of 16 q rows a block, one K/V tile staged at a time; vU
    two)."""
    g = g if variant == 'vG' else 1
    config = f'vG{g}' if variant == 'vG' else variant
    return _plan_chains('flash_opt.attn', config, q, k, g,
                        2 if variant == 'vU' else 1, path, split=True)


def plan_attn_variants(q: torch.Tensor, k: torch.Tensor, variant: int,
                       path: Optional[str] = None) -> fa.Plan:
    """T6's path and tiling for ``variant`` 0, 1 or 2, as
    :func:`plan_attn_opt`'s v0 (on 'sm90' one consumer warpgroup a block),
    the kv split for v0 only (natural exp, as T1's; the exp2 variants keep
    their one pass); the kept 'mma' one 4-warp block per 64 q rows."""
    return _plan_chains('flash_variants.attn', 'v2' if variant == 2 else
                        'v0', q, k, 1, 1, path, split=variant == 0)


def tt_chains(sq: int, head_pad: int) -> int:
    """T4's and T5's q chains a block on 'sm90' (TT_CONFIGS): 4 where ``sq``
    is a multiple of 256 and DP <= CHAINS_KV32_ABOVE, else 2 where it is a
    multiple of 128, else 1."""
    if sq % (4 * TILE) == 0 and head_pad <= CHAINS_KV32_ABOVE:
        return 4
    return 2 if sq % (2 * TILE) == 0 else 1


def _plan_tt(name: str, q, k, head_pad: int, path: Optional[str],
             split: bool) -> fa.Plan:
    b, h, _, sq = q.shape
    if _path(name, path) == MMA:
        return fa.Plan(MMA, head_pad, TILE, TILE, 1, (sq // TILE, b * h),
                       128, bhds=True)
    chains = tt_chains(sq, head_pad)
    config = TT_CONFIGS[chains]
    _, stages, kv, _ = chains_tiling(config, head_pad, bhds=True)
    grid = (sq // (TILE * chains), b * h)
    parts = (chains_parts(config, grid[0] * grid[1], k.shape[3] // kv,
                          head_pad, bhds=True) if split else 1)
    return fa.Plan(SM90, head_pad, TILE * chains, kv, stages, grid,
                   128 * chains, parts, bhds=True)


def plan_tt2(q: torch.Tensor, k: torch.Tensor,
             path: Optional[str] = None) -> fa.Plan:
    """T4's path and tiling for ``q`` ``[B, H, D, Sq]`` and ``k`` ``[B, H,
    D, Skv]`` of the domain, from their shapes alone: 'sm90' (the chains
    kernel over [D, S], :func:`tt_chains` consumer warpgroups of 64 q rows
    sharing a ring of K/V stages, the kv split of :func:`chains_parts`
    where the card has room) unless ``path`` forces the kept 'mma' (one
    4-warp block per 64 q rows)."""
    return _plan_tt('flash_tt2', q, k, -(-q.shape[2] // 16) * 16, path,
                    split=True)


def plan_ttv3(q: torch.Tensor, k: torch.Tensor, bf16_p: bool = False,
              sum_fold: bool = True,
              path: Optional[str] = None) -> fa.Plan:
    """T5's path and tiling, as :func:`plan_tt2`'s but never split; with
    the fold (``sum_fold``) the head is padded to round16(d + 1), V's last
    padded row holding ones. ``bf16_p`` does not change the tiling."""
    d = q.shape[2] + (1 if sum_fold else 0)
    return _plan_tt('flash_ttv3', q, k, -(-d // 16) * 16, path,
                    split=False)


# The entry points of each variant by path.
ENTRIES = {'attn_opt': {SM90: 'flash_opt_attn_sm90', MMA: 'flash_opt_attn'},
           'attn_h': {SM90: 'flash_opt_attn_h_sm90',
                      MMA: 'flash_opt_attn_h'},
           'pipelined_attention': {SM90: 'flash_pipelined_attn_sm90',
                                   MMA: 'flash_pipelined_attn'},
           'flash_tt2': {SM90: 'flash_tt2_attn_sm90', MMA: 'flash_tt2_attn'},
           'flash_ttv3': {SM90: 'flash_ttv3_attn_sm90',
                          MMA: 'flash_ttv3_attn'},
           'attn_variants': {SM90: 'flash_variants_attn_sm90',
                             MMA: 'flash_variants_attn'}}


def entry_options(fn: Callable, how: fa.Plan, *options: int) -> tuple:
    """The options after the dtype of wrapper ``fn``'s entry point on
    ``how.path``: ``options`` (T1's and T6's variant code, T5's bf16_p and
    sum_fold) and, on 'sm90', the q chains and the kv split's parts that
    ``how`` gives (T2 takes only its parts)."""
    if how.path == MMA:
        return options
    if fn is attn_h:
        return (how.parts,)
    if fn in (attn_opt, attn_variants):
        return (*options, how.parts)
    if fn is flash_tt2:
        return (how.block_q // TILE, how.parts)
    if fn is flash_ttv3:
        return (*options, how.block_q // TILE)
    return options


def launch(fn: Callable, q, k, v, out, scale: float, how: fa.Plan,
           *options: int) -> None:
    """Launch wrapper ``fn``'s kernel on ``how.path`` into ``out``, on the
    current stream, with :func:`entry_options` (the layout of q, k, v and
    ``out`` from ``how.bhds``); raises if the launch is refused."""
    entry = ENTRIES[fn.__name__][how.path]
    lib = (fa.load(SOURCE, SIGNATURES, parts=BUILD_PARTS) if how.path == MMA
           else fa.load(SM90_SOURCE, SM90_SIGNATURES,
                        parts=SM90_BUILD_PARTS))
    _call(lib, entry, entry, q, k, v, out, scale, how.bhds,
          *entry_options(fn, how, *options))


def _count(fn: Callable, path: str, config: str) -> None:
    """One more launch of ``fn`` (a wrapper with two paths) on ``path``,
    counted in ``launches`` under ``config``, in ``path_launches`` and in
    ``config_path_launches``."""
    fa.count_launch(fn, path, config)
    fn.config_path_launches[config, path] += 1


def _planned(fn: Callable, plan: Callable, config: str, q, k, v,
             scale: float, path: Optional[str]) -> torch.Tensor:
    name = 'flash_opt.attn_h' if fn.__name__ == 'attn_h' else fn.__name__
    cpu = _on_cpu(q, k, v)
    _check(name, q, k, v, False, cpu=cpu)
    _path(name, path)
    if cpu:
        return plain_exp(q, k, v, scale)
    how = plan(q, k, path=path)
    out = torch.empty_like(q)
    launch(fn, q, k, v, out, scale, how)
    _count(fn, how.path, config)
    return out


def attn_opt(variant: str, q, k, v, scale: float, g: int = 1,
             path: Optional[str] = None):
    """T1 (``tools/flash_opt.py::attn``): ``variant`` 'v0' (the plain kv
    loop), 'vU' (the loop unrolled over a deeper ring) or 'vG' (``g`` ∈
    {2, 4} independent 64-row q chains per block sharing each K/V tile).
    ``[B, H, S, D]``. On CUDA the path :func:`plan_attn_opt` picks
    ('sm90'; ``path='mma'`` forces the first port's kernel)."""
    g = g if variant == 'vG' else 1
    if (variant, g) not in T1_CODES:
        raise ValueError(f'attn: unknown variant {variant!r} (vG takes g '
                         f'in (2, 4), got {g})')
    cpu = _on_cpu(q, k, v)
    _check('flash_opt.attn', q, k, v, False, g=g, cpu=cpu)
    _path('flash_opt.attn', path)
    if cpu:
        return plain_exp(q, k, v, scale)
    how = plan_attn_opt(q, k, variant, g, path=path)
    out = torch.empty_like(q)
    launch(attn_opt, q, k, v, out, scale, how, T1_CODES[(variant, g)])
    _count(attn_opt, how.path, f'vG{g}' if variant == 'vG' else variant)
    return out


def attn_h(q, k, v, scale: float, path: Optional[str] = None):
    """T2 (``tools/flash_opt.py::attn_h``): all H heads of a 64-row q tile
    in one instance. ``[B, H, S, D]``. On CUDA the path
    :func:`plan_attn_h` picks ('sm90'; ``path='mma'`` forces the first
    port's kernel)."""
    return _planned(attn_h, plan_attn_h, 'vH', q, k, v, scale, path)


def pipelined_attention(q, k, v, scale: float, path: Optional[str] = None):
    """T3 (``tools/flash_pipelined.py::pipelined_attention``): the next
    tile's QKᵀ before this tile's softmax. ``[B, H, S, D]``. On CUDA the
    path :func:`plan_pipelined` picks ('sm90'; ``path='mma'`` forces the
    first port's kernel)."""
    return _planned(pipelined_attention, plan_pipelined, 'pipelined', q, k,
                    v, scale, path)


def attn_variants(variant: int, q, k, v, scale: float,
                  path: Optional[str] = None):
    """T6 (``tools/flash_variants.py::attn``): ``variant`` 0 (exp; T1
    v0's code on either path), 1 (exp2), 2 (exp2, l from the 16-bit P).
    ``[B, H, S, D]``. On CUDA the path :func:`plan_attn_variants` picks
    ('sm90'; ``path='mma'`` forces the first port's kernel)."""
    if variant not in T6_MODES:
        raise ValueError(f'attn: unknown variant {variant!r}')
    cpu = _on_cpu(q, k, v)
    _check('flash_variants.attn', q, k, v, False, cpu=cpu)
    _path('flash_variants.attn', path)
    if cpu:
        return plain_attn_variants(variant, q, k, v, scale)
    how = plan_attn_variants(q, k, variant, path=path)
    out = torch.empty_like(q)
    launch(attn_variants, q, k, v, out, scale, how, variant)
    _count(attn_variants, how.path, f'v{variant}')
    return out


def flash_tt2(q, k, v, scale: float, path: Optional[str] = None):
    """T4 (``tools/flash_tt.py::flash_tt2``): ``[B, H, D, S]`` in and out.
    On CUDA the path :func:`plan_tt2` picks ('sm90'; ``path='mma'`` forces
    the first port's kernel)."""
    cpu = _on_cpu(q, k, v)
    _check('flash_tt2', q, k, v, True, cpu=cpu)
    _path('flash_tt2', path)
    if cpu:
        return plain_flash_tt2(q, k, v, scale)
    how = plan_tt2(q, k, path=path)
    out = torch.empty_like(q)
    launch(flash_tt2, q, k, v, out, scale, how)
    _count(flash_tt2, how.path, 'tt2')
    return out


def flash_ttv3(q, k, v, scale: float, bf16_p: bool = False,
               sum_fold: bool = True, path: Optional[str] = None):
    """T5 (``tools/flash_tt3.py::flash_ttv3``): ``[B, H, D, S]``, exp2;
    ``sum_fold`` takes the row sum from P·V (ttv3), ``bf16_p`` with it
    evaluates exp2 on bf16 arguments (ttv4); neither is the no-fold
    setting. On CUDA the path :func:`plan_ttv3` picks ('sm90';
    ``path='mma'`` forces the first port's kernel)."""
    if bf16_p and not sum_fold:
        raise ValueError('flash_ttv3: bf16_p needs sum_fold')
    cpu = _on_cpu(q, k, v)
    _check('flash_ttv3', q, k, v, True, fold=sum_fold, cpu=cpu)
    _path('flash_ttv3', path)
    if cpu:
        return plain_flash_ttv3(q, k, v, scale, bf16_p, sum_fold)
    how = plan_ttv3(q, k, bf16_p, sum_fold, path=path)
    out = torch.empty_like(q)
    launch(flash_ttv3, q, k, v, out, scale, how, int(bf16_p), int(sum_fold))
    _count(flash_ttv3, how.path,
           T5_SETTINGS[(bool(bf16_p), bool(sum_fold))])
    return out


# Every wrapper, each with two paths.
WRAPPERS = (attn_opt, attn_h, pipelined_attention, flash_tt2, flash_ttv3,
            attn_variants)


def _bind(fn: Callable, *args, **kw) -> Callable:
    return lambda q, k, v, s, **more: fn(*args, q, k, v, s, **kw, **more)


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


def _plan_of(plan: Callable, **kw) -> Callable:
    return lambda q, k, path=None: plan(q, k, path=path, **kw)


# The configurations with two paths (all but T6 v0, which runs T1 v0's
# kernels): label → (call (q, k, v, scale, path=None), plan (q, k,
# path=None), the wrapper that counts its launches, the entry point's
# options for :func:`launch`), each on the configuration's own layout.
PATH_CONFIGS = {
    'T1 v0': (CONFIGS['T1 v0'][0], _plan_of(plan_attn_opt, variant='v0'),
              attn_opt, (T1_CODES['v0', 1],)),
    'T1 vU': (CONFIGS['T1 vU'][0], _plan_of(plan_attn_opt, variant='vU'),
              attn_opt, (T1_CODES['vU', 1],)),
    'T1 vG2': (CONFIGS['T1 vG2'][0],
               _plan_of(plan_attn_opt, variant='vG', g=2), attn_opt,
               (T1_CODES['vG', 2],)),
    'T1 vG4': (CONFIGS['T1 vG4'][0],
               _plan_of(plan_attn_opt, variant='vG', g=4), attn_opt,
               (T1_CODES['vG', 4],)),
    'T2': (attn_h, plan_attn_h, attn_h, ()),
    'T3': (pipelined_attention, plan_pipelined, pipelined_attention, ()),
    'T4': (flash_tt2, plan_tt2, flash_tt2, ()),
    'T5 ttv3': (flash_ttv3, plan_ttv3, flash_ttv3, (0, 1)),
    'T5 ttv4': (CONFIGS['T5 ttv4'][0], _plan_of(plan_ttv3, bf16_p=True),
                flash_ttv3, (1, 1)),
    'T5 no-fold': (CONFIGS['T5 no-fold'][0],
                   _plan_of(plan_ttv3, sum_fold=False), flash_ttv3, (0, 0)),
    'T6 v1': (CONFIGS['T6 v1'][0], _plan_of(plan_attn_variants, variant=1),
              attn_variants, (1,)),
    'T6 v2': (CONFIGS['T6 v2'][0], _plan_of(plan_attn_variants, variant=2),
              attn_variants, (2,)),
}


def planned_twin(label: str, q, k, v, scale: float) -> torch.Tensor:
    """The twin of configuration ``label``'s planned call on CUDA tensors
    (of its own layout): the kv split's (:func:`plain_split_exp`, over the
    transposed views for T4) where the plan splits, else the
    configuration's own (``CONFIGS``)."""
    how = (PATH_CONFIGS[label][1](q, k) if label in PATH_CONFIGS else
           plan_attn_variants(q, k, 0) if label == 'T6 v0' else None)
    if how is not None and how.parts > 1:
        if how.bhds:
            return _bhds(plain_split_exp, q, k, v, scale, how.parts)
        return plain_split_exp(q, k, v, scale, how.parts)
    return CONFIGS[label][1](q, k, v, scale)


def ds_products(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> tuple:
    """The T4/T5 kernels' two products alone, on one ``[d, 64]`` plane of
    each of q, k and v (CUDA, bf16 or fp16, contiguous): ``(s, o)`` in
    fp32, s = qᵀ·k ``[64, 64]`` by the MN-major SS wgmma and o =
    round16(s)·vᵀ ``[64, round16(d)]`` by the K-major RS wgmma, loaded and
    stored as the kernels hold them (``flash_variants_sm90_probe``). The
    unit check of those forms against ``torch.matmul``."""
    d = q.shape[0]
    if (q.shape != (d, TILE) or k.shape != q.shape or v.shape != q.shape
            or not q.is_cuda or q.dtype not in fa.DTYPES16):
        raise ValueError('ds_products takes three CUDA [d, 64] bf16/fp16 '
                         f'planes, got {tuple(q.shape)} {q.dtype}')
    s = torch.empty((TILE, TILE), device=q.device)
    o = torch.empty((TILE, -(-d // 16) * 16), device=q.device)
    lib = fa.load(SM90_SOURCE, SM90_SIGNATURES, parts=SM90_BUILD_PARTS)
    q, k, v = (x.contiguous() for x in (q, k, v))
    with torch.cuda.device(q.device):
        rc = lib.flash_variants_sm90_probe(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), s.data_ptr(),
            o.data_ptr(), d, fa.DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    fa.raise_on_error(rc, 'flash_variants_sm90_probe', q, k)
    return s, o


def launch_counts() -> dict:
    """Each wrapper's launches, by name, its configurations summed."""
    return {fn.__name__: sum(fn.launches.values()) for fn in WRAPPERS}


def path_counts() -> dict:
    """The launches by path of each wrapper: ``attn_opt_sm90``,
    ``attn_opt_mma``, ``attn_h_sm90``, ... ``attn_variants_mma``."""
    return {f'{fn.__name__}_{p}': n for fn in WRAPPERS
            for p, n in fn.path_launches.items()}


def config_path_counts() -> dict:
    """Their launches by configuration and path, ``'attn_opt v0 sm90'``
    and so on (each wrapper's ``config_path_launches``)."""
    return {f'{fn.__name__} {config} {p}': n for fn in WRAPPERS
            for (config, p), n in fn.config_path_launches.items()}


def reset_counts() -> None:
    for fn in WRAPPERS:
        fn.launches = collections.Counter()
        fn.path_launches = dict.fromkeys(PATHS, 0)
        fn.config_path_launches = collections.Counter()


reset_counts()
