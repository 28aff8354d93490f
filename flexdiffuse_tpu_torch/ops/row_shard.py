"""Row-sharded model layers for sequence-parallel generation.

Under :func:`~flexdiffuse_tpu_torch.ops.attention.sp_context` the UNet,
the ControlNet and the VAE take and return whole tensors, and inside run
each level of their row chain either on this rank's block of rows
(sharded: rank r holds the r-th of n equal blocks of every activation
``[B, C, h, W]``) or whole on every rank, as :class:`Plan` decides. The
JAX package leaves the layers that then need other ranks' data to GSPMD
(``flexdiffuse_tpu/pipeline/flex.py:193-213``, ``parallel/sp.py``), which
pads uneven splits; here they are written out:

* :class:`Plan`: a model call's levels. Level d of a chain whose finest
  map has R global rows (d stride-2 convs below it) is sharded when
  ``R % (n·2^d) == 0``: its rows and those of every finer level split
  evenly over the n ranks, and a stride-2 conv into a sharded level gets
  an even local row count. The first level that fails, and every coarser
  one, runs whole: its input all-gathered on the way in, the layers with
  the SP axis suspended (no halo, no all-reduce, no ring: K1 and K6 on
  the card, as without SP), its output cut to this rank's rows on the way
  back to a sharded level. The plan is a pure function of R and n, so
  every rank makes the same one without communicating. A map whose rows
  do not split at all runs whole throughout: correct, and logged once.
* :class:`Conv2d`: the models' 3×3 convolutions. On a sharded level one
  takes the rows its window reaches from the neighbouring ranks (halo
  rows, one ``batch_isend_irecv``), with zeros at the global edges, then
  convolves without row padding. A conv with stride s and top padding p
  needs p rows from above and ``3 − s − p`` from below: 1 and 1 for the
  stride-1 convs, 1 and 0 for the UNet's Downsample (pad 1), 0 and 1 for
  the VAE's down resample (pad (0,1,0,1), whose bottom row is the halo).
  1×1 convs need nothing and stay ``nn.Conv2d``.
* :func:`group_norm`: GroupNorm on a sharded level, its statistics
  all-reduced over the axis (fp32 sums: the mean, then the centred
  squares). It runs the plain path, never K6: the reference's SP
  GroupNorm is XLA too, and K6 computes its statistics inside one launch.
* :func:`observe`: a hook on every level a model enters, for tools that
  attribute work to the plan's levels (``tools/sp_plan.py``).

Every sharded level holds equal blocks, which the halo exchange, the
GroupNorm's count (local × n), the ring's rotation and :func:`~flexdiffuse_
tpu_torch.parallel.axis.gather` rely on.
"""
from __future__ import annotations

import contextlib
import contextvars
import logging
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from flexdiffuse_tpu_torch.ops.attention import sp_axis, sp_scope

log = logging.getLogger(__name__)
_LOGGED: set = set()
_OBSERVER: contextvars.ContextVar = contextvars.ContextVar(
    'row_plan_observer', default=None)


def splits(rows: int, n: int, depth: int) -> bool:
    """Whether level ``depth`` of a chain with ``rows`` global rows at
    depth 0 is sharded over ``n`` ranks (see the module doc)."""
    if depth < 0:
        rows <<= -depth
    else:
        n <<= depth
    return rows % n == 0


@contextlib.contextmanager
def observe(fn: Callable):
    """For the block, every level a model enters runs inside
    ``fn(rows, depth)`` (a context manager): ``rows`` is its plan's
    depth-0 row count."""
    token = _OBSERVER.set(fn)
    try:
        yield
    finally:
        _OBSERVER.reset(token)


class Plan:
    """The levels of one model call (see the module doc): ``rows`` global
    rows at depth 0 of the chain, depth d (negative above depth 0) at
    ``rows · 2^-d``. Read at construction from the active SP axis; without
    one every level is whole and the plan changes nothing."""

    def __init__(self, rows: int) -> None:
        self.axis = sp_axis()
        self.rows = int(rows)
        if self.axis is not None and not self.sharded(0) and \
                (self.rows, self.axis.size) not in _LOGGED:
            _LOGGED.add((self.rows, self.axis.size))
            log.warning('sequence parallelism: a map of %d rows does not '
                        'split over %d ranks; it runs whole on every rank',
                        self.rows, self.axis.size)

    def sharded(self, depth: int) -> bool:
        """Whether level ``depth`` holds this rank's rows."""
        return self.axis is not None and splits(self.rows, self.axis.size,
                                                depth)

    def move(self, x: torch.Tensor, src: Optional[int],
             dst: Optional[int]) -> torch.Tensor:
        """NCHW ``x`` laid out for level ``src`` (None: whole), laid out
        for level ``dst`` (None: whole)."""
        from flexdiffuse_tpu_torch.parallel.axis import gather, local
        was = src is not None and self.sharded(src)
        now = dst is not None and self.sharded(dst)
        if was and not now:
            return gather(x, self.axis, 2)
        if now and not was:
            return local(x, self.axis, 2)
        return x

    @contextlib.contextmanager
    def at(self, depth: int):
        """The context of level ``depth``'s layers: the SP axis on a
        sharded level, none on a whole one (and the :func:`observe` hook's,
        if one is set)."""
        observer = _OBSERVER.get()
        with sp_scope(self.axis if self.sharded(depth) else None), (
                contextlib.nullcontext() if observer is None
                else observer(self.rows, depth)):
            yield


def _halo(x: torch.Tensor, sp, above: int, below: int) -> torch.Tensor:
    """``x`` with ``above`` rows of the previous rank on top and ``below``
    rows of the next rank underneath; zeros beyond the global edges."""
    b, c, _, w = x.shape
    zeros = lambda n: x.new_zeros((b, c, n, w))
    top, bottom = zeros(above), zeros(below)
    if sp.size > 1:
        ops = []
        has_prev, has_next = sp.rank > 0, sp.rank < sp.size - 1
        if above and has_prev:
            ops.append(dist.P2POp(dist.irecv, top, sp.peer(-1), sp.group))
        if above and has_next:
            ops.append(dist.P2POp(dist.isend,
                                  x[:, :, -above:].contiguous(),
                                  sp.peer(1), sp.group))
        if below and has_next:
            ops.append(dist.P2POp(dist.irecv, bottom, sp.peer(1), sp.group))
        if below and has_prev:
            ops.append(dist.P2POp(dist.isend, x[:, :, :below].contiguous(),
                                  sp.peer(-1), sp.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return torch.cat([top, x, bottom], dim=2)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` that, under sequence parallelism, takes the halo rows
    its window needs (see the module doc). NCHW."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sp = sp_axis()
        kh = self.kernel_size[0]
        if sp is None or kh == 1:
            return super().forward(x)
        stride, pad = self.stride[0], self.padding[0]
        xh = _halo(x, sp, pad, kh - stride - pad)
        return F.conv2d(xh, self.weight, self.bias, self.stride,
                        (0, self.padding[1]), self.dilation, self.groups)


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float, silu: bool = False,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``plain_group_norm`` over the global map whose rows are sharded on
    the active axis (equal blocks): fp32 statistics all-reduced over it,
    then the affine, SiLU if asked, cast to ``dtype``."""
    sp = sp_axis()
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    count = torch.tensor(float(xf.shape[-1] * sp.size), device=x.device)

    def total(t):
        if sp.size > 1:
            dist.all_reduce(t, group=sp.group)
        return t

    mean = total(xf.sum(dim=-1)) / count
    d = xf - mean[..., None]
    var = total(d.square().sum(dim=-1)) / count
    y = (d * torch.rsqrt(var + eps)[..., None]).reshape(x.shape)
    shape = (1, c) + (1,) * (x.dim() - 2)
    y = y * weight.float().reshape(shape) + bias.float().reshape(shape)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype if dtype is None else dtype)

