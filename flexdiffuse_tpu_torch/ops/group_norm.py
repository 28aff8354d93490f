"""Fused GroupNorm (+affine, optional SiLU): K6, its plain twin and the
dispatcher (port of ``flexdiffuse_tpu/ops/group_norm.py``).

* K6, :func:`fused_group_norm`: the Hopper kernel ``csrc/group_norm.cu``
  (replaces the Pallas ``_gn_kernel`` :41). Over ``[B, C, H, W]`` in bf16,
  fp16 or fp32, channels-last in memory, it computes fp32 statistics per
  (batch, group), the affine, an optional SiLU, and writes the result in
  the dtype asked for (bf16, fp16 or fp32), channels-last too. The port's
  UNet and VAE activations are channels-last on the card (the models'
  NHWC → NCHW permute at entry propagates through cuDNN), so that is the
  one layout K6 takes. Unlike the JAX package's 8 MiB gate it takes any
  size: the VAE's activations too. Built and loaded with
  ``ops/flash_attention.build``/``load`` at first use.
* :func:`plain_group_norm`: the same function in plain PyTorch (``x.float()``
  → ``F.group_norm`` → SiLU → cast), the CPU path and the test oracle.
* :func:`group_norm`: the dispatcher the models call. A call that needs a
  gradient (grad mode on and any of x, weight, bias requiring grad) runs the
  plain version: the JAX package has no backward kernel for K6, so the port
  has none. Any other call on a CUDA tensor goes to K6 under the 'auto'
  backend; CPU tensors take the plain version.

On a CUDA tensor :func:`fused_group_norm` launches or raises; there is no
fallback. ``fused_group_norm.launches`` counts its calls (each launches the
stats, the finalize and the apply kernel).
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from flexdiffuse_tpu_torch.ops import flash_attention as fa

SOURCE = fa.SOURCE.parent / 'group_norm.cu'
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # (batch, channels, groups, hw) -> workspace floats, -1 if the kernel
    # does not take the shape
    'group_norm_workspace': (_I, _I, _I, _I),
    # (x, gamma, beta, y, work, batch, channels, groups, hw, eps, silu,
    #  in_dtype, out_dtype, w_dtype, vec, stream)
    'group_norm_fwd': (_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _I,
                       _I, _I, _P),
}
RESTYPES = {'group_norm_workspace': ctypes.c_longlong}

# Context-local: 'auto' (K6 for CUDA tensors) | 'plain'.
_BACKEND: contextvars.ContextVar = contextvars.ContextVar(
    'group_norm_backend', default='auto')


@contextlib.contextmanager
def backend(name: str):
    """Scoped GroupNorm-backend override: ``with backend('plain'): ...``."""
    if name not in ('auto', 'plain'):
        raise ValueError(f'unknown group-norm backend {name!r}')
    token = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(token)


def plain_group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, silu: bool = False,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm over ``[B, C, ...]`` with fp32 statistics and affine, then
    SiLU if asked, cast to ``dtype`` (x's dtype by default). Mirrors
    ``_gn_reference`` (flexdiffuse_tpu/ops/group_norm.py:72) in NCHW."""
    y = F.group_norm(x.float(), num_groups, weight.float(), bias.float(), eps)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype if dtype is None else dtype)


def _check(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
           bias: torch.Tensor, dtype: torch.dtype) -> None:
    if not x.is_cuda:
        raise ValueError('fused_group_norm: x must be a CUDA tensor (or a '
                         'CPU tensor)')
    if x.dtype not in DTYPES or dtype not in DTYPES:
        raise ValueError(f'fused_group_norm takes and gives bf16, fp16 or '
                         f'fp32, got {x.dtype} -> {dtype}')
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'fused_group_norm takes a non-empty [B, C, H, W] '
                         f'tensor, got {tuple(x.shape)}')
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('fused_group_norm takes a channels-last x, got '
                         f'strides {x.stride()} for {tuple(x.shape)}')
    b, c = x.shape[:2]
    if num_groups < 1 or c % num_groups:
        raise ValueError(f'fused_group_norm: {c} channels do not split into '
                         f'{num_groups} groups')
    if x.numel() // b >= 2**31:
        raise ValueError('fused_group_norm: more than 2^31 elements per batch '
                         'row')
    for name, t in (('weight', weight), ('bias', bias)):
        if t.shape != (c,) or t.device != x.device or \
                t.dtype not in DTYPES or t.dtype != weight.dtype or \
                not t.is_contiguous():
            raise ValueError(f'fused_group_norm takes a contiguous {name} '
                             f'[{c}] on {x.device} in the dtype of weight, '
                             f'got {t.dtype} {tuple(t.shape)} on {t.device}')


def fused_group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, silu: bool = False,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K6: :func:`plain_group_norm`'s function through the Hopper kernel,
    launched on the current stream; the result is channels-last, as x must
    be. CPU tensors take :func:`plain_group_norm`; CUDA tensors the kernel
    does not take raise."""
    dtype = x.dtype if dtype is None else dtype
    if x.device.type == 'cpu':
        return plain_group_norm(x, num_groups, weight, bias, eps, silu, dtype)
    _check(x, num_groups, weight, bias, dtype)
    lib = fa.load(SOURCE, SIGNATURES, RESTYPES)
    b, c = x.shape[:2]
    hw = x.numel() // (b * c)
    floats = lib.group_norm_workspace(b, c, num_groups, hw)
    if floats < 0:
        raise ValueError(f'fused_group_norm does not take x '
                         f'{tuple(x.shape)} with {num_groups} groups (batch '
                         f'or channels too many)')
    y = torch.empty_like(x, dtype=dtype)
    work = torch.empty(floats, dtype=torch.float32, device=x.device)
    vec = int(c * hw % 8 == 0 and x.data_ptr() % 16 == 0 and
              y.data_ptr() % 16 == 0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.group_norm_fwd(x.data_ptr(), weight.data_ptr(),
                                bias.data_ptr(), y.data_ptr(),
                                work.data_ptr(), b, c, num_groups, hw,
                                float(eps), int(silu),
                                DTYPES[x.dtype], DTYPES[dtype],
                                DTYPES[weight.dtype], vec, stream)
    if rc != 0:
        raise RuntimeError(f'fused_group_norm kernel launch failed: CUDA '
                           f'error {rc} at x {tuple(x.shape)} {x.dtype}, '
                           f'{num_groups} groups')
    fused_group_norm.launches += 1
    return y


fused_group_norm.launches = 0


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float, silu: bool = False,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm (+SiLU) cast to ``dtype``, routed to K6 or the plain
    version: under the 'auto' backend (the default; see :func:`backend`)
    CUDA tensors take K6, CPU tensors the plain version; under 'plain'
    every call takes the plain version. A call that needs a gradient always
    runs the plain version."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or bias.requires_grad)
    if needs_grad or _BACKEND.get() == 'plain' or not x.is_cuda:
        return plain_group_norm(x, num_groups, weight, bias, eps, silu, dtype)
    return fused_group_norm(x, num_groups, weight, bias, eps, silu, dtype)
