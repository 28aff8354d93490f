"""Differentiable flash attention for training: K3, K4, K5 and their plain
twins (port of ``flexdiffuse_tpu/ops/flash_backward.py``).

* K3, :func:`flash_attention_lse`: the forward that also returns the
  base-2 log-sum-exp rows ``lse = m + log2(l)`` (replaces
  ``_fwd_lse_kernel`` :62). It is K1's source instantiated with an lse
  output (``csrc/flash_attention.cu``, entry ``flash_attention_fwd_lse``).
* K4, :func:`flash_attention_dq`: ``dq`` from ``p = exp2(s̃ − lse)`` and
  ``ds = p∘(dp − D)·scale`` (replaces ``_dq_kernel`` :146).
* K5, :func:`flash_attention_dkv`: ``dv = pᵀ·dO``, ``dk = dsᵀ·q`` (replaces
  ``_dkv_kernel`` :174). K4 and K5 are ``csrc/flash_backward.cu``, each on
  two paths that :func:`plan_backward` chooses before the launch, as
  ``fa.plan`` does for K1: 'sm90' (TMA, wgmma, a warp-specialised
  pipeline; bf16 or fp16, head dim a multiple of 8, 16-byte aligned
  tensors: every main-path call) and 'mma' (the first port's mma.sync
  kernels, kept for everything else; fp32 tensors are rounded to bf16 as
  they are staged, as K1's kept kernel does).
* ``D = Σ_d dO∘O`` is one plain torch reduction, as the JAX package
  computes it in XLA outside its kernels (:229-231).

:class:`FlashAttentionCmFn` is the channel-major counterpart
(``flash_attention_cm_diff``, :398-430): under a gradient it permutes
``[H, D, B, S]`` to ``[B, H, S, D]``, runs K3 forward and K4/K5 backward
there and permutes the gradients back, as JAX's ``_cm_fwd``/``_cm_bwd``
transpose only under differentiation; inference runs
``fa.flash_attention_cm`` (``ops/attention.py`` ``attention_cm``).

:class:`FlashAttentionFn` runs K3 forward and K4/K5 backward on CUDA
tensors (launch or raise, never a fallback) and the plain twins
(:func:`plain_attention_lse`, :func:`plain_attention_dq`,
:func:`plain_attention_dkv`: fp32 math, ``[B, H, S, D]``) on CPU tensors.
Each kernel wrapper counts its launches in a plain int attribute
``launches``, and by path in ``path_launches``.

Not ported: ``_chunked_backward``, ``_chunked_lse`` and the ``_resident``
split, the JAX package's fallbacks for K/V that overflow the TPU's VMEM; on
Hopper K/V stream through shared memory at any length.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from flexdiffuse_tpu_torch.ops import flash_attention as fa

SOURCE = fa.SOURCE.parent / 'flash_backward.cu'
LOG2E = 1.4426950408889634
# flash_backward.cu is compiled in this many parts at once: the kept kernels
# in part 0, the Hopper kernels' 32 instantiations split over the others.
BUILD_PARTS = 4

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# (q, k, v, dout, lse, dvec, dq | dk, dv, batch_heads, sq, skv, d, scale,
#  dtype[, vec], stream): the kept path also takes `vec`.
SIGNATURES = {
    'flash_attention_bwd_dq': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _F, _I, _I, _P),
    'flash_attention_bwd_dkv': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _F, _I, _I, _P),
    'flash_attention_bwd_dq_sm90': (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _F, _I, _P),
    'flash_attention_bwd_dkv_sm90': (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                     _I, _I, _F, _I, _P),
}
# The entry point of each (kernel, path).
ENTRIES = {('dq', 'sm90'): 'flash_attention_bwd_dq_sm90',
           ('dq', 'mma'): 'flash_attention_bwd_dq',
           ('dkv', 'sm90'): 'flash_attention_bwd_dkv_sm90',
           ('dkv', 'mma'): 'flash_attention_bwd_dkv'}
KINDS = ('dq', 'dkv')


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one K4 (``kind`` 'dq') or K5 ('dkv') call runs: ``path`` 'sm90'
    or 'mma', and ``head_pad`` DP, the head dim rounded up to 16, from
    which each path's source picks its own tiles (``BwdTiling`` on the
    Hopper path)."""
    kind: str
    path: str
    head_pad: int


def plan_backward(kind: str, q: torch.Tensor, k: torch.Tensor,
                  *tensors: torch.Tensor, path: Optional[str] = None) -> Plan:
    """The path of a K4 (``kind`` 'dq') or K5 ('dkv') call on ``q``
    ``[B, H, Sq, D]`` and ``k`` ``[B, H, Skv, D]``, from the dtype, the
    shape and the alignment of ``q``, ``k`` and ``tensors`` (v, dO, the
    outputs) alone, before any launch: ``fa.plan``'s rule. The Hopper path
    takes bf16 or fp16 and needs what TMA needs: D % 8 == 0 (16-byte rows)
    and 16-byte aligned pointers; everything else, fp32 included, takes the
    kept kernels. ``path`` forces one ('sm90' raises where it cannot
    go)."""
    if kind not in KINDS:
        raise ValueError(f'flash backward: kind {kind!r} not in {KINDS}')
    if path not in (None, *fa.PATHS):
        raise ValueError(f'flash backward: path {path!r} not in {fa.PATHS}')
    head_pad = -(-q.shape[-1] // 16) * 16
    tma = q.dtype in fa.DTYPES16 and bool(fa.vec_ok(q, k, *tensors))
    if path == 'sm90' and not tma:
        raise ValueError('flash backward: the sm90 path takes bf16 or fp16, '
                         'D % 8 == 0 and 16-byte aligned tensors')
    return Plan(kind, 'mma' if path == 'mma' or not tma else 'sm90',
                head_pad)


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """Base-2 logits ``q·kᵀ·scale·log2(e)`` in fp32, ``[B, H, Sq, Skv]``."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * (scale *
                                                                  LOG2E)


def plain_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's twin: ``(o, lse)`` with ``o`` in q's dtype and fp32 base-2
    ``lse [B, H, Sq]`` (``_fwd_lse_kernel``, flash_backward.py:62-94)."""
    s = _scores(q, k, scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()) / l
    return o.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def _probs_and_ds(q, k, v, dout, lse, dvec, scale):
    p = torch.exp2(_scores(q, k, scale) - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    return p, p * (dp - dvec[..., None]) * scale


def plain_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       dvec: torch.Tensor, scale: float) -> torch.Tensor:
    """K4's twin (``_dq_kernel``, flash_backward.py:146-171):
    ``dq = ds·k`` with ``ds = p∘(dO·vᵀ − D)·scale``, ``p = exp2(s̃ − lse)``."""
    _, ds = _probs_and_ds(q, k, v, dout, lse, dvec, scale)
    return torch.matmul(ds, k.float()).to(q.dtype)


def plain_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        dvec: torch.Tensor, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5's twin (``_dkv_kernel``, flash_backward.py:174-206):
    ``dk = dsᵀ·q`` (unscaled q), ``dv = pᵀ·dO``."""
    p, ds = _probs_and_ds(q, k, v, dout, lse, dvec, scale)
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dv = torch.matmul(p.transpose(-1, -2), dout.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(dout: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """``D = Σ_d dO∘O`` in fp32, ``[B, H, Sq]``."""
    return (dout.float() * o.float()).sum(dim=-1)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == 'cpu' for t in tensors)


def _check_rows(lse: torch.Tensor, dvec: torch.Tensor,
                q: torch.Tensor) -> None:
    want = q.shape[:3]
    for name, t in (('lse', lse), ('D', dvec)):
        if t.dtype != torch.float32 or t.shape != want or \
                not t.is_contiguous() or t.device != q.device:
            raise ValueError(f'flash attention backward takes a contiguous '
                             f'fp32 {name} {tuple(want)} on {q.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')


def _check_backward(q, k, v, dout, lse, dvec) -> None:
    fa.check(q, k, v)
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            dout.device != q.device or not dout.is_contiguous():
        raise ValueError(f'flash attention backward takes dO like q '
                         f'{tuple(q.shape)} {q.dtype}, got '
                         f'{tuple(dout.shape)} {dout.dtype}')
    _check_rows(lse, dvec, q)


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float, path: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: ``(o, lse)`` through the Hopper kernel for CUDA tensors, on the
    path ``fa.plan`` picks, as K1 (``path``: forced, for comparisons); CPU
    tensors take :func:`plain_attention_lse`. ``o`` equals K1's output on
    the same plan. ``.launches`` counts launches, ``.path_launches`` them by
    path."""
    if _on_cpu(q, k, v):
        return plain_attention_lse(q, k, v, scale)
    fa.check(q, k, v)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), device=q.device, dtype=torch.float32)
    how = fa.plan(q, k, v, out, path=path)
    fa.launch(q, k, v, out, lse, scale, how)
    fa.count_launch(flash_attention_lse, how.path)
    return out, lse


def _launch(how: Plan, q, k, v, dout, lse, dvec, outs, scale: float
            ) -> None:
    """Launch K4 (``outs`` (dq,)) or K5 (``outs`` (dk, dv)) on the current
    stream as ``how`` says; raises if the launch is refused."""
    lib = fa.load(SOURCE, SIGNATURES, parts=BUILD_PARTS)
    entry = getattr(lib, ENTRIES[how.kind, how.path])
    b, h, sq, d = q.shape
    vec = () if how.path == 'sm90' else (fa.vec_ok(q, k, v, dout, *outs),)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                   lse.data_ptr(), dvec.data_ptr(),
                   *(t.data_ptr() for t in outs), b * h, sq, k.shape[2], d,
                   float(scale), fa.DTYPES[q.dtype], *vec, stream)
    fa.raise_on_error(rc, entry.__name__, q, k)


def flash_attention_dq(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       dout: torch.Tensor, lse: torch.Tensor,
                       dvec: torch.Tensor, scale: float,
                       path: Optional[str] = None) -> torch.Tensor:
    """K4: ``dq`` through the Hopper kernel for CUDA tensors, on the path
    :func:`plan_backward` picks (``path``: forced, for comparisons); CPU
    tensors take :func:`plain_attention_dq`. ``.launches`` counts launches,
    ``.path_launches`` them by path."""
    if _on_cpu(q, k, v, dout, lse, dvec):
        return plain_attention_dq(q, k, v, dout, lse, dvec, scale)
    _check_backward(q, k, v, dout, lse, dvec)
    dq = torch.empty_like(q)
    how = plan_backward('dq', q, k, v, dout, dq, path=path)
    _launch(how, q, k, v, dout, lse, dvec, (dq,), scale)
    fa.count_launch(flash_attention_dq, how.path)
    return dq


def flash_attention_dkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor, lse: torch.Tensor,
                        dvec: torch.Tensor, scale: float,
                        path: Optional[str] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5: ``(dk, dv)`` through the Hopper kernel for CUDA tensors, on the
    path :func:`plan_backward` picks (``path``: forced, for comparisons);
    CPU tensors take :func:`plain_attention_dkv`. ``.launches`` counts
    launches, ``.path_launches`` them by path."""
    if _on_cpu(q, k, v, dout, lse, dvec):
        return plain_attention_dkv(q, k, v, dout, lse, dvec, scale)
    _check_backward(q, k, v, dout, lse, dvec)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    how = plan_backward('dkv', q, k, v, dout, dk, dv, path=path)
    _launch(how, q, k, v, dout, lse, dvec, (dk, dv), scale)
    fa.count_launch(flash_attention_dkv, how.path)
    return dk, dv


flash_attention_lse.launches = 0
flash_attention_lse.path_launches = dict.fromkeys(fa.PATHS, 0)
flash_attention_dq.launches = 0
flash_attention_dq.path_launches = dict.fromkeys(fa.PATHS, 0)
flash_attention_dkv.launches = 0
flash_attention_dkv.path_launches = dict.fromkeys(fa.PATHS, 0)


class FlashAttentionFn(torch.autograd.Function):
    """``[B, H, S, D]`` flash attention with a gradient (the port of
    ``flash_attention_diff``): K3 forward saving ``q, k, v, o, lse``; the
    backward forms ``D`` and runs K4 and K5. CPU tensors run the plain
    twins. ``FlashAttentionFn.apply(q, k, v, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        o, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        dvec = attention_delta(dout, o)
        dq = flash_attention_dq(q, k, v, dout, lse, dvec, ctx.scale)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, dvec, ctx.scale)
        return dq, dk, dv, None


def _to_bhsd(t: torch.Tensor) -> torch.Tensor:
    """``[H, D, B, S]`` → contiguous ``[B, H, S, D]``."""
    return t.permute(2, 0, 3, 1).contiguous()


def _to_hdbs(t: torch.Tensor) -> torch.Tensor:
    """``[B, H, S, D]`` → contiguous ``[H, D, B, S]``."""
    return t.permute(1, 3, 0, 2).contiguous()


class FlashAttentionCmFn(torch.autograd.Function):
    """``[H, D, B, S]`` flash attention with a gradient (the port of
    ``flash_attention_cm_diff``): the operands permuted to ``[B, H, S,
    D]``, K3 forward saving them with ``o`` and ``lse``, K4 and K5 in the
    backward, the output and the gradients permuted back. CPU tensors run
    the plain twins. ``FlashAttentionCmFn.apply(q, k, v, scale)``."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        q, k, v = (_to_bhsd(t) for t in (q, k, v))
        o, lse = flash_attention_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return _to_hdbs(o)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dout = _to_bhsd(dout.to(q.dtype))
        dvec = attention_delta(dout, o)
        dq = flash_attention_dq(q, k, v, dout, lse, dvec, ctx.scale)
        dk, dv = flash_attention_dkv(q, k, v, dout, lse, dvec, ctx.scale)
        return _to_hdbs(dq), _to_hdbs(dk), _to_hdbs(dv), None
