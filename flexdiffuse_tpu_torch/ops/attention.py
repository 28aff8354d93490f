"""Attention dispatch: the Hopper flash kernel or plain PyTorch math.

Mirrors ``flexdiffuse_tpu/ops/attention.py:100-150``. Self-attention whose
both sequences are ≥1024 tokens and divisible by 128, with heads ≤128 wide,
is eligible for the flash kernels; at 512² that is the UNet's 4096- and
1024-token levels. Everything else — cross attention over 77 context
tokens, the 256-token level, the VAE's single 512-wide head — runs
:func:`plain_attention`.

Routing: an eligible call that needs a gradient (grad mode on and any of
q, k, v requiring grad) goes to :class:`FlashAttentionFn` (K3 forward,
K4/K5 backward, ``ops/flash_backward.py``); any other eligible call goes to
the inference kernel K1 (``ops/flash_attention.py``), whose output carries
no gradient. On CUDA tensors the kernels launch or raise; CPU tensors take
the plain twins. There is no fallback from a kernel to a plain version.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

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


def flash_eligible(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The JAX package's eligibility rule (attention.py:125-136)."""
    sq, skv = q.shape[-2], k.shape[-2]
    big = sq >= FLASH_MIN_SEQ and skv >= FLASH_MIN_SEQ
    divisible = sq % 128 == 0 and skv % 128 == 0
    narrow = q.shape[-1] <= 128
    return big and divisible and narrow


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: Optional[float] = None,
              backend: Optional[str] = None) -> torch.Tensor:
    """Multi-head attention ``[B, H, Sq, D] × [B, H, Skv, D] -> [B, H, Sq, D]``.

    ``backend`` overrides the context-local setting for this call. 'auto'
    takes the kernel for eligible CUDA tensors; 'flash' takes it for every
    eligible shape (a CPU tensor then runs the wrapper's plain path);
    'plain' never takes it.
    """
    if scale is None:
        scale = q.shape[-1]**-0.5
    if backend is None:
        backend = _BACKEND.get()
    else:
        _validate(backend)
    eligible = flash_eligible(q, k)
    if backend == 'auto':
        backend = 'flash' if q.is_cuda and eligible else 'plain'
    elif backend == 'flash' and not eligible:
        backend = 'plain'
    if backend == 'flash':
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, scale)
        return flash_attention(q, k, v, scale)
    return plain_attention(q, k, v, scale)
