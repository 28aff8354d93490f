"""Attention dispatch: the Hopper flash kernel or plain PyTorch math.

Mirrors ``flexdiffuse_tpu/ops/attention.py:100-150``. Self-attention whose
both sequences are ≥1024 tokens and divisible by 128, with heads ≤128 wide,
is eligible for the flash kernels; at 512² that is the UNet's 4096- and
1024-token levels. Everything else — cross attention over 77 context
tokens, the 256-token level, the VAE's single 512-wide head — runs
:func:`plain_attention`.

Routing (:func:`route`, decided before any launch): an eligible call that
the backend sends to the kernels and that needs a gradient (grad mode on
and any of q, k, v requiring grad) goes to :class:`FlashAttentionFn` (K3
forward, K4/K5 backward, ``ops/flash_backward.py``); any other such call
goes to the inference kernel K1 (``ops/flash_attention.py``), whose output
carries no gradient. As in the reference, no dtype test: bf16 and fp16
calls take the kernels' Hopper path, fp32 calls their kept path
(``fa.plan``). On CUDA tensors the kernels launch or raise; CPU tensors
take the plain twins. There is no fallback from a kernel to a plain
version.

Sequence parallelism (:func:`sp_context`, ``flexdiffuse_tpu/ops/
attention.py:56-78,108-120``): under the context the tensors are this
rank's row shard of the token sequence. Self-attention (``sq == skv``)
whose global length (local × the axis size) is at least ``min_seq`` rides
:func:`~flexdiffuse_tpu_torch.ops.ring_attention.ring_attention` (K3 per
round); shorter self-attention all-gathers K/V over the axis and takes
:func:`route` with the local q rows; cross-attention (77 context tokens,
replicated) stays local. JAX takes the ring only when the global length
also splits evenly over the ranks (``sq % n == 0``); here that holds by
construction: a level runs sharded only when its rows split evenly
(``ops/row_shard.py`` ``Plan``), so every rank holds ``sq / n`` tokens,
and a level that does not runs whole, outside the context.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Sequence

import torch

from flexdiffuse_tpu_torch.ops.flash_attention import (flash_attention,
                                                       plain_attention)
from flexdiffuse_tpu_torch.ops.flash_backward import FlashAttentionFn

FLASH_MIN_SEQ = 1024

# Context-local: 'auto' | 'plain' | 'flash' ('plain' is the JAX package's
# 'xla').
_BACKEND: contextvars.ContextVar = contextvars.ContextVar(
    'attention_backend', default='auto')


def _validate(name: str) -> None:
    if name not in ('auto', 'plain', 'flash'):
        raise ValueError(f'unknown attention backend {name!r}')


@contextlib.contextmanager
def backend(name: str):
    """Scoped attention-backend override: ``with backend('plain'): ...``."""
    _validate(name)
    token = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(token)


# Sequence-parallel mode: a parallel.axis.MeshAxis, or None.
_SP: contextvars.ContextVar = contextvars.ContextVar('attention_sp',
                                                     default=None)


@contextlib.contextmanager
def sp_context(mesh, axis: str, min_seq: int = 4096):
    """Scoped sequence-parallel attention over ``mesh`` (a torch
    ``DeviceMesh``) axis ``axis``: the layers of ``models/`` read it too
    (``ops/row_shard.py``: halo rows for the 3×3 convs, GroupNorm
    statistics over the axis)."""
    from flexdiffuse_tpu_torch.parallel.axis import MeshAxis
    with sp_scope(MeshAxis.of(mesh, axis, min_seq)):
        yield


@contextlib.contextmanager
def sp_scope(axis):
    """Scoped SP axis: the layers inside see ``axis`` (a
    :class:`~flexdiffuse_tpu_torch.parallel.axis.MeshAxis`), or no sequence
    parallelism when it is None (a level that runs whole,
    ``ops/row_shard.py`` ``Plan``)."""
    token = _SP.set(axis)
    try:
        yield
    finally:
        _SP.reset(token)


def sp_axis():
    """The active :class:`~flexdiffuse_tpu_torch.parallel.axis.MeshAxis`
    (None outside :func:`sp_context`)."""
    return _SP.get()


def _eligible(sq: int, skv: int, d: int) -> bool:
    big = sq >= FLASH_MIN_SEQ and skv >= FLASH_MIN_SEQ
    divisible = sq % 128 == 0 and skv % 128 == 0
    return big and divisible and d <= 128


def flash_eligible(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's eligibility rule (attention.py:125-136)."""
    return _eligible(q.shape[-2], k.shape[-2], q.shape[-1])


def route(q_shape: Sequence[int], k_shape: Sequence[int], device_type: str,
          backend: str) -> str:
    """'flash' (the kernels' wrappers) or 'plain' (:func:`plain_attention`)
    for a call on q ``[..., Sq, D]`` and k ``[..., Skv, D]``, from the
    shapes, the device type and the resolved backend alone.

    - A shape that :func:`flash_eligible` refuses is 'plain' under every
      backend.
    - 'plain' is 'plain'.
    - 'flash' takes the wrappers for every eligible call: a CPU tensor then
      runs their plain twins.
    - 'auto' takes them for CUDA tensors, and runs :func:`plain_attention`
      for CPU tensors.

    The dtype does not enter, as in the reference's dispatcher
    (attention.py:125-149): the wrappers take bf16, fp16 and fp32 (fp32 on
    the kernels' kept path) and raise on anything else.
    """
    if backend == 'plain' or not _eligible(q_shape[-2], k_shape[-2],
                                           q_shape[-1]):
        return 'plain'
    if backend == 'auto' and device_type != 'cuda':
        return 'plain'
    return 'flash'


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention ``[B, H, Sq, D] × [B, H, Skv, D] -> [B, H, Sq, D]``.

    ``backend`` overrides the context-local setting for this call;
    :func:`route` says where each backend sends it.
    """
    if scale is None:
        scale = q.shape[-1]**-0.5
    if backend is None:
        backend = _BACKEND.get()
    else:
        _validate(backend)
    sp = _SP.get()
    if sp is not None and q.shape[-2] == k.shape[-2]:
        from flexdiffuse_tpu_torch.ops import ring_attention as _ring
        if q.shape[-2] * sp.size >= sp.min_seq:
            return _ring.ring_attention(q, k, v, sp.mesh, sp.axis, scale)
        from flexdiffuse_tpu_torch.parallel.axis import gather
        k, v = (gather(t, sp, -2) for t in (k, v))
    if route(q.shape, k.shape, q.device.type, backend) == 'flash':
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, scale)
        return flash_attention(q, k, v, scale)
    return plain_attention(q, k, v, scale)
