"""Row-sharded model layers for sequence-parallel generation.

Under :func:`~flexdiffuse_tpu_torch.ops.attention.sp_context` every
activation ``[B, C, h, W]`` of the UNet, the ControlNet and the VAE holds
this rank's block of ``h`` consecutive rows (rank r the r-th block). The
JAX package leaves the layers that then need other ranks' data to GSPMD
(``flexdiffuse_tpu/pipeline/flex.py:193-213``, ``parallel/sp.py``); here
they are written out:

* :class:`Conv2d`: the models' 3×3 convolutions. Under the context one
  takes the rows its window reaches from the neighbouring ranks (halo
  rows, one ``batch_isend_irecv``), with zeros at the global edges, then
  convolves without row padding. A conv with stride s and top padding p
  needs p rows from above and ``3 − s − p`` from below: 1 and 1 for the
  stride-1 convs, 1 and 0 for the UNet's Downsample (pad 1), 0 and 1 for
  the VAE's down resample (pad (0,1,0,1), whose bottom row is the halo).
  A stride-2 conv needs an even local row count. 1×1 convs need nothing
  and stay ``nn.Conv2d``.
* :func:`group_norm`: GroupNorm with its statistics all-reduced over the
  axis (fp32 sums: the mean, then the centred squares). It runs the plain
  path, never K6: the reference's SP GroupNorm is XLA too, and K6 computes
  its statistics inside one launch.
* :func:`gather_rows` / :func:`local_rows`: the whole tensor and this
  rank's rows of it, on any dim: the pipeline's NHWC tensors (dim 1) and
  FreeU's Fourier filter (NCHW, dim 2).

An uneven split raises ``ValueError`` naming the shape: the pipeline
checks every level before it starts (``pipeline/flex.py``
``check_sp_split``), and a stride-2 conv checks its rows again.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from flexdiffuse_tpu_torch.ops.attention import sp_axis


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
        if x.shape[2] % stride:
            raise ValueError(
                f'sequence parallelism: a stride-{stride} conv needs an '
                f'even local row count, got x {tuple(x.shape)} on '
                f'{sp.size} ranks')
        xh = _halo(x, sp, pad, kh - stride - pad)
        return F.conv2d(xh, self.weight, self.bias, self.stride,
                        (0, self.padding[1]), self.dilation, self.groups)


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float, silu: bool = False,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``plain_group_norm`` over the global map whose rows are sharded on
    the active axis: fp32 statistics all-reduced over it, then the affine,
    SiLU if asked, cast to ``dtype``."""
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


def gather_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole tensor from every rank's rows on ``dim`` (x when SP is
    off)."""
    from flexdiffuse_tpu_torch.parallel.axis import gather
    sp = sp_axis()
    return x if sp is None else gather(x, sp, dim)


def local_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's rows on ``dim`` of a whole tensor (x when SP is off)."""
    from flexdiffuse_tpu_torch.parallel.axis import local
    sp = sp_axis()
    return x if sp is None else local(x, sp, dim)
