"""Hopper flash attention (K1) — build, bind and launch, plus its plain twin.

The kernel is ``csrc/flash_attention.cu``: forward flash attention over
contiguous ``[B, H, S, D]`` bf16/fp16 tensors, written by hand for sm_90a
(see the note at the top of the source). It replaces the JAX package's
Pallas kernel ``flexdiffuse_tpu/ops/flash_attention.py::_flash_tt_kernel``.

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
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / 'csrc' / 'flash_attention.cu'
BUILD_DIR = _PKG / '_build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC')
MAX_HEAD_DIM = 128
DTYPES = {torch.bfloat16: 0, torch.float16: 1}

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


def build(source: Path = SOURCE) -> float:
    """Compile ``source`` if its build is missing; returns the seconds the
    compile took (0.0 when the build already existed). Raises when nvcc is
    missing or the compile fails."""
    out = library_path(source)
    if out.exists():
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, str(source)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed on {source.name} '
                               f'({proc.returncode}):\n{proc.stdout}\n'
                               f'{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return time.perf_counter() - t0


def load(source: Path, signatures: Dict[str, Sequence],
         restypes: Optional[Dict[str, type]] = None) -> ctypes.CDLL:
    """The library built from ``source`` (built first if missing), with the
    argument types of each entry point in ``signatures`` declared; an entry
    point returns a CUDA error code (``ctypes.c_int``) unless ``restypes``
    names another type for it. Loaded once per source."""
    lib = _libs.get(source)
    if lib is None:
        build(source)
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in signatures.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = (restypes or {}).get(name, ctypes.c_int)
        _libs[source] = lib
    return lib


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, o[, lse], batch_heads, sq, skv, d, scale, dtype, vec, stream)
SIGNATURES = {
    'flash_attention_fwd': (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    'flash_attention_fwd_lse': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                                _I, _P),
}


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
        raise ValueError('flash_attention takes bf16 or fp16 q/k/v of one '
                         f'dtype, got {q.dtype}/{k.dtype}/{v.dtype}')
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
                    scale: float) -> torch.Tensor:
    """``[B, H, Sq, D] × [B, H, Skv, D] → [B, H, Sq, D]`` through the Hopper
    kernel, launched on the current stream. CPU tensors take
    :func:`plain_attention`; CUDA tensors the kernel does not take raise.
    ``flash_attention.launches`` counts kernel launches."""
    if q.device.type == 'cpu' and k.device.type == 'cpu' \
            and v.device.type == 'cpu':
        return plain_attention(q, k, v, scale)
    check(q, k, v)
    lib = load(SOURCE, SIGNATURES)
    out = torch.empty_like(q)
    b, h, sq, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_fwd(q.data_ptr(), k.data_ptr(),
                                     v.data_ptr(), out.data_ptr(), b * h, sq,
                                     k.shape[2], d, float(scale),
                                     DTYPES[q.dtype], vec_ok(q, k, v, out),
                                     stream)
    raise_on_error(rc, 'flash_attention', q, k)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
