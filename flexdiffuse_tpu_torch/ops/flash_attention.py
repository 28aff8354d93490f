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
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / 'csrc' / 'flash_attention.cu'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')
MAX_HEAD_DIM = 128
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
}
# The entry point of each path: (without lse, with lse).
ENTRIES = {'sm90': ('flash_attention_fwd_sm90',
                    'flash_attention_fwd_lse_sm90'),
           'mma': ('flash_attention_fwd', 'flash_attention_fwd_lse')}
PATHS = tuple(ENTRIES)
ROWS = 64         # q rows per warpgroup (sm90) and per block (mma)
MMA_KV_TILE = 64  # the kept kernel's K/V tile
# The Hopper path's tiles, as csrc/flash_attention.cu's ``Tiling`` chooses
# them from the padded head width: (consumer warpgroups of ROWS q rows, kv
# tile), keyed by head_pad <= 64; SM90_STAGES K/V tiles in the ring.
SM90_TILES = {True: (3, 64), False: (2, 128)}
SM90_STAGES = 3


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``path`` 'sm90' or 'mma'; ``head_pad`` DP, the head
    dim rounded up to 16 in shared memory; ``block_q`` q rows per block;
    ``block_kv`` kv rows per streamed tile; ``stages`` K/V tiles in flight
    (1: the kept kernel stages one at a time); ``grid`` (q tiles, B·H);
    ``threads`` per block."""
    path: str
    head_pad: int
    block_q: int
    block_kv: int
    stages: int
    grid: Tuple[int, int]
    threads: int


def plan(q: torch.Tensor, k: torch.Tensor, *tensors: torch.Tensor,
         path: Optional[str] = None) -> Plan:
    """The path and tiling of a call on ``q`` ``[B, H, Sq, D]`` and ``k``
    ``[B, H, Skv, D]`` (checked by :func:`check`), from the dtype, the
    shape and the alignment of ``q``, ``k`` and ``tensors`` (v, the output)
    alone. The Hopper path takes bf16 or fp16 and needs what TMA needs:
    D % 8 == 0 (16-byte rows) and 16-byte aligned pointers; everything else,
    fp32 included, takes the kept kernel. ``path`` forces one ('sm90'
    raises where it cannot go)."""
    if path not in (None, *PATHS):
        raise ValueError(f'flash_attention: path {path!r} not in {PATHS}')
    b, h, sq, d = q.shape
    head_pad = -(-d // 16) * 16
    tma = q.dtype in DTYPES16 and bool(vec_ok(q, k, *tensors))
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


def count_launch(fn, path: str) -> None:
    """One more launch of wrapper ``fn`` on ``path``: ``fn.launches`` counts
    every launch, ``fn.path_launches[path]`` those of the path."""
    fn.launches += 1
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


def check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
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
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f'flash_attention: head dim {d} not in '
                         f'[1, {MAX_HEAD_DIM}]')
    if sq < 1 or k.shape[2] < 1 or not 1 <= b * h <= 65535:
        raise ValueError(f'flash_attention: unsupported shape '
                         f'{tuple(q.shape)} x {tuple(k.shape)}')
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError('flash_attention takes contiguous q, k, v')


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, path: Optional[str] = None) -> torch.Tensor:
    """``[B, H, Sq, D] × [B, H, Skv, D] → [B, H, Sq, D]`` through the Hopper
    kernel, launched on the current stream on the path :func:`plan` picks
    (``path``: forced, as :func:`plan` takes it, for comparisons). CPU tensors take :func:`plain_attention`; CUDA tensors
    the kernel does not take raise. ``flash_attention.launches`` counts
    kernel launches, ``flash_attention.path_launches`` them by path."""
    if q.device.type == 'cpu' and k.device.type == 'cpu' \
            and v.device.type == 'cpu':
        return plain_attention(q, k, v, scale)
    check(q, k, v)
    out = torch.empty_like(q)
    how = plan(q, k, v, out, path=path)
    launch(q, k, v, out, None, scale, how)
    count_launch(flash_attention, how.path)
    return out


flash_attention.launches = 0
flash_attention.path_launches = dict.fromkeys(PATHS, 0)
