"""Hopper flash attention (K1) — build, bind and launch, plus its plain twin.

The kernel is ``csrc/flash_attention.cu``: forward flash attention over
contiguous ``[B, H, S, D]`` bf16, fp16 or fp32 tensors, written by hand for
sm_90a (see the note at the top of the source). It replaces the JAX
package's Pallas kernel
``flexdiffuse_tpu/ops/flash_attention.py::_flash_tt_kernel``. It has two
paths, chosen by :func:`plan` from the dtype, the shape and the alignment
before the launch: 'sm90' (TMA, wgmma, a warp-specialised pipeline; bf16
or fp16, head dim a multiple of 8, 16-byte aligned tensors: every
main-path call) and 'mma' (the first port's mma.sync kernel, kept for
everything else). fp32 tensors take 'mma', which rounds them to bf16 as it
stages them: the operand precision at which the TPU multiplies fp32 at its
default precision, where the reference's Pallas kernel takes fp32 too.
Head widths above 128 take the two paths of ``csrc/flash_wide.cu``, which
replace the same Pallas function at those widths, where JAX runs
``_flash_tt_kernel`` (K1) or ``_flash_stream_kernel`` (K2): 'wide_sm90'
(TMA, wgmma, two warpgroups that split the head's columns; bf16 or fp16,
128 < D <= 512, D % 8 == 0, 16-byte aligned tensors; a kv split over a
cluster of two blocks where the q tiles fill at most half the card) and
'wide' (the first design's mma.sync kernel, kept
for everything else: fp32, D % 8 != 0, misaligned tensors, and every
D > 512, where each block owns a 512-column chunk of the output and sums S
over all of D). Neither has an lse instantiation: JAX trains wide heads
through XLA.

Every kernel source in ``csrc/`` is compiled at first use with ``nvcc``
into a shared library with plain C entry points and bound with ``ctypes``
(:func:`build`, :func:`load`; ``ops/flash_backward.py`` loads the training
kernels the same way, and K3, the lse instantiation of this source, through
:data:`SIGNATURES`). A library lands in ``flexdiffuse_tpu_torch/_build/``
(git-ignored) under a name keyed by a hash of its source, the shared
``csrc/*.cuh`` headers and the flags, so a fresh checkout builds it once and
an edited source rebuilds. Nothing is compiled or loaded at import time.

:func:`flash_attention` launches the kernel for CUDA tensors and raises on
anything the kernel does not take; only a CPU tensor takes
:func:`plain_attention`, the same math in plain PyTorch. Its output carries
no gradient: ``ops/attention.py`` routes calls that need one to
``ops/flash_backward.FlashAttentionFn``.

The transposed and channel-major entries, :func:`flash_attention_tt` over
``[B, H, D, S]`` and :func:`flash_attention_cm` over ``[H, D, B, S]``
(the JAX package's ``flash_attention_tt`` :202 and
``flash_attention_cm`` :260, which run ``_flash_tt_kernel`` under their
own grids), are K1 over ``[D, S]`` planes: a plane of d rows holds one run
of S columns (tt: B·H planes) or B runs (cm: H planes, the trailing
``(B, S)`` flattened), and a q tile reads its own run's K/V. Both layouts
are one kernel with two stride sets, on two paths that :func:`plan_ds`
picks before the launch: 'sm90', T4's Hopper chains kernel over ``[D, S]``
(``csrc/flash_variants_sm90.cu``, entry ``flash_attention_ds_sm90``: TMA
boxes of 64 columns by d rows, wgmma with both operands MN-major for S and
V K-major for P·V, the output staged transposed and stored by TMA) with
K1's arithmetic (q unscaled, ``p = 2^(s·c − m·c)``, ``c = scale·log2 e``);
and 'mma', K1's kept mma.sync kernel staging the ``[D, S]`` tiles
(``flash_attention_fwd_ds``; fp32, d % 8 != 0, misaligned tensors). Their
plain twins are :func:`plain_attention_tt` and :func:`plain_attention_cm`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from flexdiffuse_tpu_torch.utils.profiling import span

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / 'csrc' / 'flash_attention.cu'
WIDE_SOURCE = _PKG / 'csrc' / 'flash_wide.cu'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')
MAX_HEAD_DIM = 128        # K1/K3's kernels ('sm90', 'mma')
MAX_WIDE_HEAD_DIM = 512   # 'wide_sm90''s widest ('wide' takes any D > 128)
# The kernels' dtype codes, and the 16-bit ones: all that the Hopper path
# (and the T1–T6 variants, ops/flash_variants.py) take.
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
DTYPES16 = (torch.bfloat16, torch.float16)
# flash_attention.cu is compiled in this many parts at once: the kept kernel
# in part 0, the Hopper kernel's 32 instantiations split over the other two,
# so that no part takes much longer than part 0.
BUILD_PARTS = 3

_libs: Dict[Path, ctypes.CDLL] = {}


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v in plain PyTorch; mirrors ``xla_attention``
    (flexdiffuse_tpu/ops/attention.py:89): fp32 logits and softmax, the
    probabilities cast to q's dtype, then the second product.
    ``[B, H, Sq, D] × [B, H, Skv, D] → [B, H, Sq, D]``."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, v)


def plain_attention_tt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """:func:`plain_attention` over transposed operands, ``[B, H, D, Sq] ×
    [B, H, D, Skv] → [B, H, D, Sq]``: fp32 logits and softmax, the
    probabilities cast to q's dtype, then P·V."""
    logits = torch.einsum('bhdq,bhdk->bhqk', q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('bhqk,bhdk->bhdq', probs, v)


def plain_attention_cm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float) -> torch.Tensor:
    """:func:`plain_attention` over channel-major operands, ``[H, D, B, Sq]
    × [H, D, B, Skv] → [H, D, B, Sq]``; mirrors ``xla_attention_cm``
    (flexdiffuse_tpu/ops/attention.py:153)."""
    logits = torch.einsum('hdbq,hdbk->hbqk', q.float(), k.float()) * scale
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum('hbqk,hdbk->hdbq', probs, v)


def plain_split_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, scale: float,
                          parts: int = 2) -> torch.Tensor:
    """'wide_sm90''s kv split and merge in plain PyTorch: the kv range cut
    as the kernel cuts it (⌈tiles/parts⌉ tiles of WIDE_SM90_KV rows each),
    each part's unnormalised output ``o_i = Σ 2^((s − m_i)·c)·v``, raw row
    max ``m_i`` and sum ``l_i`` in fp32 (``c = scale·log2 e``), then the
    merge ``o = Σ o_i·a_i / Σ l_i·a_i`` with ``a_i = 2^((m_i − m)·c)``,
    ``m = max m_i``. Cast to q's dtype."""
    c = scale * math.log2(math.e)
    tiles = -(-k.shape[2] // WIDE_SM90_KV)
    step = -(-tiles // parts) * WIDE_SM90_KV
    states = []
    for start in range(0, k.shape[2], step):
        s = torch.matmul(q.float(), k[:, :, start:start + step].float()
                         .transpose(-1, -2))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2((s - m) * c)
        states.append((torch.matmul(p, v[:, :, start:start + step].float()),
                       m, p.sum(dim=-1, keepdim=True)))
    m = torch.stack([m_i for _, m_i, _ in states]).amax(dim=0)
    o = sum(o_i * torch.exp2((m_i - m) * c) for o_i, m_i, _ in states)
    l = sum(l_i * torch.exp2((m_i - m) * c) for _, m_i, l_i in states)
    return (o / l).to(q.dtype)


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    candidate = os.path.join(cuda_home, 'bin', 'nvcc')
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError('nvcc not found (PATH or $CUDA_HOME/bin): the '
                       'kernels cannot be built')


def library_path(source: Path = SOURCE) -> Path:
    """Where the build of ``source`` for the current sources and flags lives:
    the name carries a hash of the source, the shared headers in ``csrc/``
    and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob('*.cuh')):
        h.update(header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{source.stem}-{h.hexdigest()[:16]}.so'


def _nvcc_run(cmd: Sequence[str], source: Path) -> None:
    proc = subprocess.run(list(cmd), capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed on {source.name} ({proc.returncode}):'
                           f'\n{proc.stdout}\n{proc.stderr}')


def build(source: Path = SOURCE, parts: int = 1) -> float:
    """Compile ``source`` if its build is missing; returns the seconds the
    compile took (0.0 when the build already existed). Raises when nvcc is
    missing or the compile fails. With ``parts`` > 1 the source is compiled
    that many times at once, with ``-DBUILD_PART=p -DBUILD_PARTS=parts``
    (each compile holds its share of the source's instantiations), and the
    objects are linked into the one library."""
    out = library_path(source)
    if out.exists():
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        if parts == 1:
            _nvcc_run([nvcc, *NVCC_FLAGS, '-o', lib, str(source)], source)
        else:
            flags = [f for f in NVCC_FLAGS if f != '-shared']
            objs = [os.path.join(tmp, f'part{p}.o') for p in range(parts)]
            with ThreadPoolExecutor(parts) as pool:
                list(pool.map(lambda p: _nvcc_run(
                    [nvcc, *flags, '-c', f'-DBUILD_PART={p}',
                     f'-DBUILD_PARTS={parts}', '-o', objs[p], str(source)],
                    source), range(parts)))
            _nvcc_run([nvcc, *NVCC_FLAGS, '-o', lib, *objs], source)
        os.replace(lib, out)
    return time.perf_counter() - t0


def load(source: Path, signatures: Dict[str, Sequence],
         restypes: Optional[Dict[str, type]] = None,
         parts: int = 1) -> ctypes.CDLL:
    """The library built from ``source`` (built first if missing, in
    ``parts`` compiles as :func:`build`), with the argument types of each
    entry point in ``signatures`` declared; an entry point returns a CUDA
    error code (``ctypes.c_int``) unless ``restypes`` names another type for
    it. Loaded once per source."""
    lib = _libs.get(source)
    if lib is None:
        build(source, parts)
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = (restypes or {}).get(name, ctypes.c_int)
        _libs[source] = lib
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, o[, lse], batch_heads, sq, skv, d, scale, dtype[, vec], stream):
# the kept path also takes `vec`.
SIGNATURES = {
    'flash_attention_fwd': (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    'flash_attention_fwd_lse': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                _I, _P),
    'flash_attention_fwd_sm90': (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                 _P),
    'flash_attention_fwd_lse_sm90': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F,
                                     _I, _P),
    # (q, k, v, o, planes, batches, sq, skv, d, scale, dtype, stream)
    'flash_attention_fwd_ds': (_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                               _P),
}
# The entry point of each path: (without lse, with lse).
ENTRIES = {'sm90': ('flash_attention_fwd_sm90',
                    'flash_attention_fwd_lse_sm90'),
           'mma': ('flash_attention_fwd', 'flash_attention_fwd_lse')}
PATHS = tuple(ENTRIES)   # K1's and K3's paths, up to MAX_HEAD_DIM
# The wide kernels, in their own source, take the kept kernel's arguments
# ('wide_sm90' its kv split in place of `vec`). The source is compiled in
# WIDE_PARTS parts at once: the kept kernel in part 0, the Hopper kernel's
# bf16 and fp16 widths in parts 1 and 2.
WIDE, WIDE_SM90 = 'wide', 'wide_sm90'
WIDE_PATHS = (WIDE_SM90, WIDE)
WIDE_ENTRIES = {WIDE: 'flash_attention_fwd_wide',
                WIDE_SM90: 'flash_attention_fwd_wide_sm90'}
WIDE_SIGNATURES = dict.fromkeys(WIDE_ENTRIES.values(),
                                SIGNATURES['flash_attention_fwd'])
WIDE_PARTS = 3
FWD_PATHS = PATHS + WIDE_PATHS   # flash_attention's paths
ROWS = 64         # q rows per warpgroup (sm90) and per block (mma)
MMA_KV_TILE = 64  # the kept kernel's K/V tile
# The Hopper path's tiles, as csrc/flash_attention.cu's ``Tiling`` chooses
# them from the padded head width: (consumer warpgroups of ROWS q rows, kv
# tile), keyed by head_pad <= 64; SM90_STAGES K/V tiles in the ring.
SM90_TILES = {True: (3, 64), False: (2, 128)}
SM90_STAGES = 3
# The kept wide kernel's tiles (csrc/flash_wide.cu): WIDE_ROWS q rows per
# block of 8 warps (2 row groups × 4 quarters of 128 head columns), kv tile
# WIDE_KV_TILE, two K/V stages; above MAX_WIDE_HEAD_DIM one block per
# WIDE_CHUNK output columns.
WIDE_ROWS = WIDE_KV_TILE = 32
WIDE_CHUNK = 512
# The Hopper wide kernel's: ROWS q rows per block (two consumer
# warpgroups, each half of the head padded to a multiple of 128), kv tiles
# of WIDE_SM90_KV rows, K and V in a ring of at least two of each. Where
# the blocks fill at most half of the card's SMS, the kv range is split in
# two (a cluster of two blocks on the same q rows).
WIDE_SM90_KV = 32
SMS = 132   # an H100 SXM's streaming multiprocessors


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``path`` one of FWD_PATHS; ``head_pad`` DP, the
    head dim rounded up to 16 in shared memory (to 128 on 'wide_sm90');
    ``block_q`` q rows per block; ``block_kv`` kv rows per streamed tile;
    ``stages`` K/V tiles in flight (1: the kept kernel stages one at a
    time); ``grid`` (q tiles, B·H); ``threads`` per block; ``parts`` the
    grid's third dimension: on 'wide_sm90' the parts of the kv range (a
    cluster of that many blocks, merged before the store), on 'wide' the
    512-column chunks of the output above D = 512. The attention variants
    T1–T6 (``ops/flash_variants.py``) plan their calls in it too, on their
    paths ('sm90', 'mma'); T2's grid is (q tiles, B), its ``parts`` the
    split of each instance's kv range (T1's and T4's on 'sm90' too);
    ``bhds`` says that the call's tensors are ``[B, H, D, S]`` (T4, T5)."""
    path: str
    head_pad: int
    block_q: int
    block_kv: int
    stages: int
    grid: Tuple[int, int]
    threads: int
    parts: int = 1
    bhds: bool = False


def plan(q: torch.Tensor, k: torch.Tensor, *tensors: torch.Tensor,
         path: Optional[str] = None) -> Plan:
    """The path and tiling of a call on ``q`` ``[B, H, Sq, D]`` and ``k``
    ``[B, H, Skv, D]`` (checked by :func:`check`), from the dtype, the
    shape and the alignment of ``q``, ``k`` and ``tensors`` (v, the output)
    alone. Up to MAX_HEAD_DIM the Hopper path 'sm90' takes bf16 or fp16
    and needs what TMA needs: D % 8 == 0 (16-byte rows) and 16-byte aligned
    pointers; everything else, fp32 included, takes the kept kernel 'mma'.
    Above, 'wide_sm90' takes the same up to MAX_WIDE_HEAD_DIM, and the kept
    'wide' everything else (any dtype, alignment and width). ``path``
    forces one (a path raises where it cannot go)."""
    if path not in (None, *FWD_PATHS):
        raise ValueError(f'flash_attention: path {path!r} not in '
                         f'{FWD_PATHS}')
    b, h, sq, d = q.shape
    head_pad = -(-d // 16) * 16
    tma = q.dtype in DTYPES16 and bool(vec_ok(q, k, *tensors))
    if d > MAX_HEAD_DIM or path in WIDE_PATHS:
        if d <= MAX_HEAD_DIM or path not in (None, *WIDE_PATHS):
            raise ValueError(f'flash_attention: head dim {d} on path '
                             f'{path!r}: the wide paths take D > '
                             f'{MAX_HEAD_DIM}, the others D <= '
                             f'{MAX_HEAD_DIM}')
        hopper = tma and d <= MAX_WIDE_HEAD_DIM
        if path == WIDE_SM90 and not hopper:
            raise ValueError('flash_attention: the wide_sm90 path takes bf16 '
                             f'or fp16, {MAX_HEAD_DIM} < D <= '
                             f'{MAX_WIDE_HEAD_DIM}, D % 8 == 0 and 16-byte '
                             'aligned tensors')
        if path == WIDE or not hopper:
            return Plan(WIDE, head_pad, WIDE_ROWS, WIDE_KV_TILE, 2,
                        (-(-sq // WIDE_ROWS), b * h), 256,
                        -(-d // WIDE_CHUNK))
        tiles = -(-sq // ROWS)
        split = 2 if (2 * tiles * b * h <= SMS and
                      k.shape[2] > WIDE_SM90_KV) else 1
        return Plan(WIDE_SM90, -(-d // 128) * 128, ROWS, WIDE_SM90_KV, 2,
                    (tiles, b * h), 256, split)
    if path == 'sm90' and not tma:
        raise ValueError('flash_attention: the sm90 path takes bf16 or fp16, '
                         'D % 8 == 0 and 16-byte aligned tensors')
    if path == 'mma' or not tma:
        return Plan('mma', head_pad, ROWS, MMA_KV_TILE, 1,
                    (-(-sq // ROWS), b * h), 128)
    consumers, block_kv = SM90_TILES[head_pad <= 64]
    block_q = ROWS * consumers
    return Plan('sm90', head_pad, block_q, block_kv, SM90_STAGES,
                (-(-sq // block_q), b * h), 128 * (consumers + 1))


def count_launch(fn, path: str, config: Optional[str] = None) -> None:
    """One more launch of wrapper ``fn`` on ``path``: ``fn.launches`` counts
    every launch (in its ``Counter`` under ``config`` where one is named, as
    the attention variants count theirs), ``fn.path_launches[path]`` those
    of the path."""
    if config is None:
        fn.launches += 1
    else:
        fn.launches[config] += 1
    fn.path_launches[path] += 1


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, lse: Optional[torch.Tensor], scale: float,
           how: Plan) -> None:
    """Launch K1 (``lse`` None) or K3 on the current stream as ``how``
    says; raises if the launch is refused."""
    lib = load(SOURCE, SIGNATURES, parts=BUILD_PARTS)
    b, h, sq, d = q.shape
    entry = getattr(lib, ENTRIES[how.path][lse is not None])
    vec = () if how.path == 'sm90' else (vec_ok(q, k, v, out),)
    rows = () if lse is None else (lse.data_ptr(),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   *rows, b * h, sq, k.shape[2], d, float(scale),
                   DTYPES[q.dtype], *vec, stream)
    raise_on_error(rc, entry.__name__, q, k)


def vec_ok(*tensors: torch.Tensor) -> int:
    """1 when the kernels may load rows 16 bytes at a time: the head dim is
    a multiple of 8 and every pointer is 16-byte aligned."""
    return int(tensors[0].shape[-1] % 8 == 0 and
               all(t.data_ptr() % 16 == 0 for t in tensors))


def raise_on_error(rc: int, name: str, q: torch.Tensor,
                   k: torch.Tensor) -> None:
    if rc != 0:
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {rc} at '
                           f'q {tuple(q.shape)}, k {tuple(k.shape)}')


def launch_wide(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                out: torch.Tensor, scale: float, how: Plan) -> None:
    """Launch a wide kernel on the current stream as ``how`` says; raises
    if the launch is refused."""
    lib = load(WIDE_SOURCE, WIDE_SIGNATURES, parts=WIDE_PARTS)
    entry = getattr(lib, WIDE_ENTRIES[how.path])
    last = how.parts if how.path == WIDE_SM90 else vec_ok(q, k, v, out)
    b, h, sq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b * h, sq, k.shape[2], d, float(scale), DTYPES[q.dtype],
                   last, stream)
    raise_on_error(rc, entry.__name__, q, k)


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          max_head_dim: Optional[int] = MAX_HEAD_DIM) -> None:
    """Raises on what the kernels do not take: K1/K3's up to
    ``max_head_dim`` = MAX_HEAD_DIM; :func:`flash_attention` passes None
    (any width: the wide kernels take every D > MAX_HEAD_DIM)."""
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError('flash_attention: q, k and v must all be CUDA '
                         'tensors (or all CPU tensors)')
    if not (q.device == k.device == v.device):
        raise ValueError('flash_attention: q, k, v on different devices')
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError('flash_attention takes bf16, fp16 or fp32 q/k/v of '
                         f'one dtype, got {q.dtype}/{k.dtype}/{v.dtype}')
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError('flash_attention takes q [B,H,Sq,D] and k, v '
                         f'[B,H,Skv,D], got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    b, h, sq, d = q.shape
    if k.shape[0] != b or k.shape[1] != h or k.shape[3] != d:
        raise ValueError(f'flash_attention: q {tuple(q.shape)} and k '
                         f'{tuple(k.shape)} disagree on B, H or D')
    if d < 1 or (max_head_dim is not None and d > max_head_dim):
        raise ValueError(f'flash_attention: head dim {d} not in '
                         f'[1, {max_head_dim}]')
    if sq < 1 or k.shape[2] < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f'flash_attention: unsupported shape '
                         f'{tuple(q.shape)} x {tuple(k.shape)}')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('flash_attention takes contiguous q, k, v')


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, path: Optional[str] = None) -> torch.Tensor:
    """``[B, H, Sq, D] × [B, H, Skv, D] → [B, H, Sq, D]`` through the Hopper
    kernel, launched on the current stream on the path :func:`plan` picks
    (``path``: forced, as :func:`plan` takes it, for comparisons); head
    widths above 128 on the wide kernels. CPU tensors take
    :func:`plain_attention`; CUDA tensors the kernels do not take raise.
    ``flash_attention.launches`` counts kernel launches,
    ``flash_attention.path_launches`` them by path. A launch's host work
    (checks, allocation, plan, the call) is the profiler span ``fd.k1``, as
    in :func:`flash_attention_tt` and :func:`flash_attention_cm`."""
    if q.device.type == 'cpu' and k.device.type == 'cpu' \
            and v.device.type == 'cpu':
        return plain_attention(q, k, v, scale)
    with span('fd.k1'):
        check(q, k, v, None)
        out = torch.empty_like(q)
        how = plan(q, k, v, out, path=path)
        if how.path in WIDE_PATHS:
            launch_wide(q, k, v, out, scale, how)
        else:
            launch(q, k, v, out, None, scale, how)
        count_launch(flash_attention, how.path)
    return out


flash_attention.launches = 0
flash_attention.path_launches = dict.fromkeys(FWD_PATHS, 0)


# The transposed ('tt', [B, H, D, S]) and channel-major ('cm', [H, D, B,
# S]) entries: their layouts and twins. Both sequences must be multiples of
# DS_SEQ_MULTIPLE (attention_cm's rule; a q tile then never straddles two
# runs of a channel-major plane).
LAYOUTS = {'tt': '[B,H,D,S]', 'cm': '[H,D,B,S]'}
DS_SEQ_MULTIPLE = 128


def ds_geometry(q: torch.Tensor, k: torch.Tensor, layout: str) -> tuple:
    """``(planes, batches, d, sq, skv)`` of a call in ``layout``: tt's
    B·H planes of one run of S columns, cm's H planes of B runs."""
    if layout == 'tt':
        b, h, d, sq = q.shape
        return b * h, 1, d, sq, k.shape[3]
    h, d, b, sq = q.shape
    return h, b, d, sq, k.shape[3]


def check_ds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             layout: str) -> None:
    """Raises on what the [D, S] kernels do not take: CUDA tensors of one
    device and dtype (bf16, fp16, fp32), q ``[B, H, D, Sq]`` (tt) or ``[H,
    D, B, Sq]`` (cm), k and v of q's leading dims with Skv columns, D <=
    MAX_HEAD_DIM, both sequences multiples of DS_SEQ_MULTIPLE, contiguous."""
    name = f'flash_attention_{layout}'
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f'{name}: q, k and v must all be CUDA tensors (or '
                         'all CPU tensors)')
    if not (q.device == k.device == v.device):
        raise ValueError(f'{name}: q, k, v on different devices')
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f'{name} takes bf16, fp16 or fp32 q/k/v of one '
                         f'dtype, got {q.dtype}/{k.dtype}/{v.dtype}')
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or
            q.shape[:3] != k.shape[:3]):
        raise ValueError(f'{name} takes q {LAYOUTS[layout]} and k, v of its '
                         f'leading dims, got {tuple(q.shape)}, '
                         f'{tuple(k.shape)}, {tuple(v.shape)}')
    planes, _, d, sq, skv = ds_geometry(q, k, layout)
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f'{name}: head dim {d} not in [1, {MAX_HEAD_DIM}]')
    if sq % DS_SEQ_MULTIPLE or skv % DS_SEQ_MULTIPLE or not sq or not skv:
        raise ValueError(f'{name}: sequences ({sq}, {skv}) must be positive '
                         f'multiples of {DS_SEQ_MULTIPLE}')
    if planes > 65535:
        raise ValueError(f'{name}: {planes} planes, at most 65535')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f'{name} takes contiguous q, k, v')


def plan_ds(q: torch.Tensor, k: torch.Tensor, *tensors: torch.Tensor,
            layout: str, path: Optional[str] = None) -> Plan:
    """The path and tiling of a :func:`flash_attention_tt` (``layout``
    'tt') or :func:`flash_attention_cm` ('cm') call, from the dtype, the
    shape and the alignment of q, k and ``tensors`` (v, the output) alone:
    'sm90' (T4's chains kernel over [D, S]: ``flash_variants.tt_chains``
    consumer warpgroups of 64 q rows sharing a ring of K/V tiles of 64
    columns, the kv split of ``flash_variants.chains_parts`` where the card
    has room) for bf16 or fp16, D % 8 == 0 and 16-byte aligned tensors;
    the kept 'mma' (one 4-warp block per 64 q rows) for everything else.
    ``path`` forces one (a path raises where it cannot go). The grid is
    (q tiles over every run, planes)."""
    from flexdiffuse_tpu_torch.ops import flash_variants as fv
    if path not in (None, *PATHS):
        raise ValueError(f'flash_attention_{layout}: path {path!r} not in '
                         f'{PATHS}')
    planes, batches, d, sq, skv = ds_geometry(q, k, layout)
    head_pad = -(-d // 16) * 16
    hopper = (q.dtype in DTYPES16 and d % 8 == 0 and
              all(t.data_ptr() % 16 == 0 for t in (q, k, *tensors)))
    if path == 'sm90' and not hopper:
        raise ValueError(f'flash_attention_{layout}: the sm90 path takes '
                         'bf16 or fp16, D % 8 == 0 and 16-byte aligned '
                         'tensors')
    if path == 'mma' or not hopper:
        return Plan('mma', head_pad, ROWS, MMA_KV_TILE, 1,
                    (batches * sq // ROWS, planes), 128, bhds=True)
    chains = fv.tt_chains(sq, head_pad)
    config = fv.TT_CONFIGS[chains]
    _, stages, kv, _ = fv.chains_tiling(config, head_pad, bhds=True)
    grid = (batches * sq // (ROWS * chains), planes)
    parts = fv.chains_parts(config, grid[0] * grid[1], skv // kv, head_pad,
                            bhds=True)
    return Plan('sm90', head_pad, ROWS * chains, kv, stages, grid,
                128 * chains, parts, bhds=True)


def launch_ds(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              out: torch.Tensor, scale: float, how: Plan,
              layout: str) -> None:
    """Launch the [D, S] kernel of ``how.path`` on the current stream;
    raises if the launch is refused."""
    from flexdiffuse_tpu_torch.ops import flash_variants as fv
    planes, batches, d, sq, skv = ds_geometry(q, k, layout)
    if how.path == 'sm90':
        lib = load(fv.SM90_SOURCE, fv.SM90_SIGNATURES,
                   parts=fv.SM90_BUILD_PARTS)
        entry = lib.flash_attention_ds_sm90
        options = (how.block_q // ROWS, how.parts)
    else:
        entry = load(SOURCE, SIGNATURES, parts=BUILD_PARTS)\
            .flash_attention_fwd_ds
        options = ()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   planes, batches, sq, skv, d, float(scale),
                   DTYPES[q.dtype], *options, stream)
    raise_on_error(rc, entry.__name__, q, k)


def _flash_ds(fn, layout: str, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, scale: float,
              path: Optional[str]) -> torch.Tensor:
    if q.device.type == 'cpu' and k.device.type == 'cpu' \
            and v.device.type == 'cpu':
        twin = plain_attention_tt if layout == 'tt' else plain_attention_cm
        return twin(q, k, v, scale)
    with span('fd.k1'):
        check_ds(q, k, v, layout)
        out = torch.empty_like(q)
        how = plan_ds(q, k, v, out, layout=layout, path=path)
        launch_ds(q, k, v, out, scale, how, layout)
        count_launch(fn, how.path)
    return out


def flash_attention_tt(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float,
                       path: Optional[str] = None) -> torch.Tensor:
    """``[B, H, D, Sq] × [B, H, D, Skv] → [B, H, D, Sq]`` (the JAX
    package's ``flash_attention_tt``, flash_attention.py:202) through the
    [D, S] kernel on the path :func:`plan_ds` picks (``path``: forced).
    CPU tensors take :func:`plain_attention_tt`; CUDA tensors the kernels
    do not take (:func:`check_ds`) raise. Counts its launches in
    ``launches`` and ``path_launches``, as :func:`flash_attention`."""
    return _flash_ds(flash_attention_tt, 'tt', q, k, v, scale, path)


def flash_attention_cm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       scale: float,
                       path: Optional[str] = None) -> torch.Tensor:
    """``[H, D, B, Sq] × [H, D, B, Skv] → [H, D, B, Sq]`` (the JAX
    package's ``flash_attention_cm``, flash_attention.py:260: the layout
    the channel-major transformer interiors keep, models/unet.py) through
    the [D, S] kernel, each q tile reading its batch's K/V; otherwise as
    :func:`flash_attention_tt`, with :func:`plain_attention_cm` on CPU
    tensors."""
    return _flash_ds(flash_attention_cm, 'cm', q, k, v, scale, path)


for _fn in (flash_attention_tt, flash_attention_cm):
    _fn.launches = 0
    _fn.path_launches = dict.fromkeys(PATHS, 0)
