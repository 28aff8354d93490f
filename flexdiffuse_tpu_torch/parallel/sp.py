"""Sequence-parallel generation, the ≥1024² multi-device mode (port of
``flexdiffuse_tpu/parallel/sp.py``).

The latent rows shard over a 1-D ``('seq',)`` mesh: each rank holds a
block of rows of every activation; the 3×3 convs exchange halo rows and
the GroupNorms reduce their statistics over the ranks
(``ops/row_shard.py``), self-attention over at least ``sp_min_seq`` tokens
rides exact ring attention (``ops/ring_attention.py``, K3 per round), and
shorter self-attention gathers K/V; cross-attention (77-token K/V) stays
local. Every rank runs the same call; see ``pipeline/flex.py``.

Usage, in each rank of a process group (``parallel/launch.py``)::

    mesh = make_sp_mesh()                        # every rank
    pipe = sp_pipeline(unet, vae, mesh=mesh, scheduler='ddim')
    out = pipe(guide, steps=30, init_size=(2048, 2048), noise=noise)
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from flexdiffuse_tpu_torch.parallel.mesh import device_type

SEQ_AXIS = 'seq'


def make_sp_mesh(devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A 1-D sequence-parallel mesh over ``devices`` (global ranks;
    default: every rank of the default group)."""
    if devices is None:
        return init_device_mesh(device_type(), (dist.get_world_size(),),
                                mesh_dim_names=(SEQ_AXIS,))
    return DeviceMesh(device_type(), torch.tensor([int(r) for r in devices]),
                      mesh_dim_names=(SEQ_AXIS,))


def sp_pipeline(unet, vae, mesh: Optional[DeviceMesh] = None,
                sp_min_seq: int = 4096, **kw):
    """A sequence-parallel :class:`~flexdiffuse_tpu_torch.pipeline.
    FlexPipeline` over ``mesh`` (default: :func:`make_sp_mesh`)."""
    from flexdiffuse_tpu_torch.pipeline.flex import FlexPipeline
    mesh = mesh if mesh is not None else make_sp_mesh()
    return FlexPipeline(unet, vae, sp_mesh=mesh, sp_axis=SEQ_AXIS,
                        sp_min_seq=sp_min_seq, **kw)
