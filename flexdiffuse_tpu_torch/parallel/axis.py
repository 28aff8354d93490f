"""One axis of a torch ``DeviceMesh``, and a tensor's blocks along it.

:class:`MeshAxis` resolves a mesh axis to its process group, this rank's
place in it and its size. :func:`gather` and :func:`local` move between a
whole tensor and this rank's block of one of its dims: the data axis's
batch rows (``parallel/mesh.py``), the sequence axis's tokens
(``ops/ring_attention.py``, ``ops/attention.py``) and image rows
(``ops/row_shard.py``).

This module imports nothing of the port, so ``ops/`` imports it without a
cycle (inside its functions: the package's ``__init__`` loads the sweeps
and through them the pipeline).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshAxis:
    """One axis of a torch ``DeviceMesh``: its process ``group``, this
    rank's index ``rank`` in it, its ``size``, and the ring's ``min_seq``
    (global tokens)."""
    mesh: object
    axis: str
    group: object
    rank: int
    size: int
    min_seq: int = 0

    @classmethod
    def of(cls, mesh, axis: str, min_seq: int = 0) -> 'MeshAxis':
        group = mesh.get_group(axis)
        return cls(mesh, axis, group, dist.get_rank(group),
                   dist.get_world_size(group), int(min_seq))

    def peer(self, offset: int) -> int:
        """The global rank ``offset`` places on around the axis."""
        return dist.get_global_rank(self.group,
                                    (self.rank + offset) % self.size)


def gather(t: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    """Every rank's block of ``t`` concatenated along ``dim`` in rank
    order: the whole tensor."""
    if ax.size == 1:
        return t
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
             for _ in range(ax.size)]
    dist.all_gather(parts, t.contiguous(), group=ax.group)
    return torch.cat(parts, dim=dim)


def local(t: torch.Tensor, ax: MeshAxis, dim: int) -> torch.Tensor:
    """This rank's block of the whole ``t`` along ``dim`` (the caller has
    checked that the axis size divides it)."""
    n = t.shape[dim] // ax.size
    return t.narrow(dim, ax.rank * n, n)
