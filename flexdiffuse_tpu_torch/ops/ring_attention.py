"""Ring attention: exact attention with the token sequence sharded over the
ranks of one mesh axis (port of ``flexdiffuse_tpu/ops/ring_attention.py``).

Each rank holds its shard ``[B, H, S/n, D]`` of q, k and v. For n rounds
it attends its queries to the resident K/V block (:func:`ring_round`) and
merges the block's normalised output into a running ``(o, lse)`` in fp32;
between rounds K/V move one rank on around the ring, with one
``batch_isend_irecv`` (the JAX package's ``lax.ppermute``). There is no
rotation after the last round, and none at n = 1.

A round runs K3 (:func:`~flexdiffuse_tpu_torch.ops.flash_backward.
flash_attention_lse`: the block output and the base-2 ``lse = m +
log2(l)``) where :func:`~flexdiffuse_tpu_torch.ops.attention.route` sends
the block to the kernels: a head ≤ 128 wide, ≥ 1024 rows in the shard and
in the block, row counts divisible by 128, a CUDA tensor. Every other
round (the VAE's 512-wide head, short shards, CPU tensors) is
:func:`~flexdiffuse_tpu_torch.ops.flash_backward.plain_attention_lse`. The
choice is by shape, before any launch; a K3 failure on a CUDA tensor
raises. The ring carries no gradient: sequence parallelism serves
generation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from flexdiffuse_tpu_torch.ops.flash_backward import (flash_attention_lse,
                                                      plain_attention_lse)

State = Tuple[torch.Tensor, torch.Tensor]


def merge(state: Optional[State], o: torch.Tensor,
          lse: torch.Tensor) -> State:
    """Fold a block's normalised output ``o`` and base-2 ``lse`` into the
    running ``(o, lse)`` (fp32): the outputs weighted by ``exp2(lse_i −
    lse)`` with ``lse = log2(Σ exp2(lse_i))``."""
    if state is None:
        return o.float(), lse
    o_run, lse_run = state
    m = torch.maximum(lse_run, lse)
    w_run, w_blk = torch.exp2(lse_run - m), torch.exp2(lse - m)
    total = w_run + w_blk
    o_new = (o_run * w_run[..., None] + o.float() * w_blk[..., None]) / \
        total[..., None]
    return o_new, m + torch.log2(total)


def ring_round(q: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor,
               state: Optional[State], scale: float) -> State:
    """One round: this rank's queries against the resident block ``(kb,
    vb)`` through K3 or the plain round (see the module doc), merged into
    ``state`` (None before the first round)."""
    from flexdiffuse_tpu_torch.ops import attention as _attn
    if _attn.route(q.shape, kb.shape, q.device.type,
                   _attn._BACKEND.get()) == 'flash':
        o, lse = flash_attention_lse(q.contiguous(), kb.contiguous(),
                                     vb.contiguous(), scale)
    else:
        o, lse = plain_attention_lse(q, kb, vb, scale)
    return merge(state, o, lse)


def rotate(tensors, sp):
    """Send each tensor to the next rank of the axis ``sp`` (a
    :class:`~flexdiffuse_tpu_torch.parallel.axis.MeshAxis`) and receive the
    previous rank's, in one ``batch_isend_irecv``."""
    nxt, prev = sp.peer(1), sp.peer(-1)
    ops, out = [], []
    for t in tensors:
        t = t.contiguous()
        r = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, nxt, sp.group))
        ops.append(dist.P2POp(dist.irecv, r, prev, sp.group))
        out.append(r)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


@torch.no_grad()
def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention over the sequence sharded on ``mesh`` axis
    ``axis``: q, k, v are this rank's shards ``[B, H, S/n, D]``; returns
    this rank's rows of the output, in q's dtype."""
    from flexdiffuse_tpu_torch.parallel.axis import MeshAxis
    if scale is None:
        scale = q.shape[-1]**-0.5
    sp = MeshAxis.of(mesh, axis)
    state = None
    kb, vb = k, v
    for i in range(sp.size):
        state = ring_round(q, kb, vb, state, scale)
        if i + 1 < sp.size:
            kb, vb = rotate((kb, vb), sp)
    return state[0].to(q.dtype)
