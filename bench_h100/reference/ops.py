"""Plain fp32 building blocks of the reference, and its one switch of
precision.

``Ops(weights, precision)`` holds the weights and computes every linear
and convolution in fp32 (``precision='fp32'``) or, for the benchmark's
control, with both operands rounded to fp8 e4m3 under one scale per tensor
(``'fp8'``), the step below the bf16 that the configurations serve in.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Sequence, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
PRECISIONS = ('fp32', 'fp8')
E4M3_MAX = 448.0
# Attention scores are computed in slices of at most this many fp32 entries.
SCORE_CHUNK = 1 << 28


@contextlib.contextmanager
def exact_fp32() -> Iterator[None]:
    """TF32 off for matmuls and cuDNN convolutions while the block runs."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cd = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cd


def fp8(x: Tensor) -> Tensor:
    """``x`` rounded to e4m3 under the per-tensor scale amax/448, back in
    fp32; the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Recorder:
    """Stands in for the weights on the meta device: records each name the
    reference reads with the shape it expects."""

    def __init__(self) -> None:
        self.shapes: Dict[str, Tuple[int, ...]] = {}

    def get(self, name: str, shape: Sequence[int]) -> Tensor:
        shape = tuple(int(s) for s in shape)
        if self.shapes.setdefault(name, shape) != shape:
            raise ValueError(f'{name} read as {shape} and as '
                             f'{self.shapes[name]}')
        return torch.empty(shape, device='meta')


class Weights:
    """A dict of fp32 tensors, fetched with the shape the reference
    expects."""

    def __init__(self, tensors: Dict[str, Tensor]) -> None:
        self.tensors = tensors

    def get(self, name: str, shape: Sequence[int]) -> Tensor:
        t = self.tensors[name]
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f'{name}: weight {tuple(t.shape)}, reference '
                             f'expects {tuple(shape)}')
        return t


class Ops:
    def __init__(self, weights, precision: str = 'fp32') -> None:
        if precision not in PRECISIONS:
            raise ValueError(f'precision must be one of {PRECISIONS}')
        self.weights = weights
        self.low = precision == 'fp8'

    def w(self, name: str, shape: Sequence[int]) -> Tensor:
        return self.weights.get(name, shape)

    def _q(self, x: Tensor) -> Tensor:
        return fp8(x) if self.low else x

    def linear(self, x: Tensor, name: str, n_in: int, n_out: int,
               bias: bool = True) -> Tensor:
        w = self.w(f'{name}.weight', (n_out, n_in))
        b = self.w(f'{name}.bias', (n_out,)) if bias else None
        return F.linear(self._q(x), self._q(w), b)

    def conv(self, x: Tensor, name: str, c_in: int, c_out: int, k: int,
             stride: int = 1, padding: int = 0) -> Tensor:
        w = self.w(f'{name}.weight', (c_out, c_in, k, k))
        b = self.w(f'{name}.bias', (c_out,))
        return F.conv2d(self._q(x), self._q(w), b, stride, padding)

    def group_norm(self, x: Tensor, name: str, groups: int, eps: float,
                   silu: bool = False) -> Tensor:
        c = x.shape[1]
        y = F.group_norm(x, groups, self.w(f'{name}.weight', (c,)),
                         self.w(f'{name}.bias', (c,)), eps)
        return F.silu(y) if silu else y

    def layer_norm(self, x: Tensor, name: str, eps: float = 1e-5) -> Tensor:
        d = x.shape[-1]
        return F.layer_norm(x, (d,), self.w(f'{name}.weight', (d,)),
                            self.w(f'{name}.bias', (d,)), eps)


def attention(q: Tensor, k: Tensor, v: Tensor, scale: float,
              mask: Tensor = None) -> Tensor:
    """``softmax(q·kᵀ·scale + mask)·v`` over ``[N, S, D]`` operands, in
    slices of the leading dimension that keep the scores small."""
    step = max(1, SCORE_CHUNK // max(1, q.shape[1] * k.shape[1]))
    outs = []
    for i in range(0, q.shape[0], step):
        s = torch.bmm(q[i:i + step], k[i:i + step].transpose(1, 2)) * scale
        if mask is not None:
            s = s + mask
        outs.append(torch.bmm(torch.softmax(s, dim=-1), v[i:i + step]))
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def heads(x: Tensor, h: int) -> Tensor:
    """``[B, S, h·d]`` → ``[B·h, S, d]``."""
    b, s, c = x.shape
    return x.reshape(b, s, h, c // h).transpose(1, 2).reshape(b * h, s,
                                                               c // h)


def merge_heads(x: Tensor, b: int) -> Tensor:
    """``[B·h, S, d]`` → ``[B, S, h·d]``."""
    bh, s, d = x.shape
    h = bh // b
    return x.reshape(b, h, s, d).transpose(1, 2).reshape(b, s, h * d)


def sinusoid(t: Tensor, dim: int) -> Tensor:
    """Timestep features ``[B] → [B, dim]``: cos | sin of ``t·10000^(−i/
    (dim/2))`` (diffusers' ``flip_sin_to_cos=True``, shift 0)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
