"""Device meshes over ``torch.distributed``: the data and model axes,
batch sharding, and the tensor-parallel layout (port of
``flexdiffuse_tpu/parallel/mesh.py``).

A mesh is a torch ``DeviceMesh`` over the ranks of the default process
group (``parallel/launch.py`` starts them: NCCL on the card, gloo on the
CPU), shaped ``(data, model)``; the model groups are adjacent ranks.

* **data axis**: every data rank takes its rows of the batch
  (:func:`shard_batch`); the training steps average their gradients over
  it and the sweeps gather their images over it.
* **model axis** (tensor parallelism): :func:`shard_params` keeps this
  rank's slice of the output features of every ``nn.Linear`` and
  ``nn.Conv2d`` whose output count divides by the axis size, and of the
  affine of every such ``GroupNorm``/``LayerNorm``: the JAX rule
  (``_param_spec``: the last, output-feature dim of each leaf) in torch's
  layout, where it is dim 0. A sharded Linear or conv computes its slice of
  the output channels and all-gathers them over the model group; a sharded
  norm all-gathers its affine before use. The model's numbers stay those
  of the replicated model, and K1 and K6 keep running on the gathered,
  full activations (DTensor does not serve: the ctypes-bound kernels take
  plain tensors).

The gather's backward keeps this rank's slice of the output gradient
(exact: every rank of a model group computes the same, replicated
activations from the gather on), and a sharded layer's input sums its
gradient over the model group (each rank's slice contributes a part), as
Megatron's column-parallel layers do. A replicated tensor used only
through sliced weights (LoRA factors) has partial gradients too, which the
LoRA step sums over the model group. As the JAX module says of
GSPMD's plan, tensor parallelism is correct here, not fast: scale SD-1.x
with the data axis.
"""
from __future__ import annotations

import types
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from flexdiffuse_tpu_torch.parallel.axis import MeshAxis, local

DATA_AXIS = 'data'
MODEL_AXIS = 'model'


def device_type() -> str:
    """'cuda' for an NCCL default group, else 'cpu'."""
    return 'cuda' if dist.get_backend() == 'nccl' else 'cpu'


def make_mesh(devices: Optional[Sequence[int]] = None,
              model_parallel: int = 1) -> DeviceMesh:
    """A ``(data, model)`` mesh over ``devices`` (global ranks; default:
    every rank of the initialised default group), ``model_parallel``
    adjacent ranks per model group. Raises ``ValueError`` when the rank
    count does not divide by ``model_parallel``."""
    ranks = list(range(dist.get_world_size())) if devices is None \
        else [int(r) for r in devices]
    n = len(ranks)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f'{n} devices not divisible by '
                         f'model_parallel={model_parallel}')
    shape = (n // model_parallel, model_parallel)
    names = (DATA_AXIS, MODEL_AXIS)
    if devices is None:
        return init_device_mesh(device_type(), shape, mesh_dim_names=names)
    return DeviceMesh(device_type(), torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def batch_sharding(mesh: DeviceMesh) -> MeshAxis:
    """The data axis, over which a leading batch dim is sharded."""
    return MeshAxis.of(mesh, DATA_AXIS)


def _rows(x, data: MeshAxis):
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _rows(v, data) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_rows(v, data) for v in x)
    n = x.shape[0]
    if n % data.size:
        raise ValueError(f'batch of {n} rows does not split over '
                         f'{data.size} data ranks')
    return local(x, data, 0)


def shard_batch(tree, mesh: DeviceMesh):
    """This rank's rows of every tensor (or array) in ``tree`` (a tensor,
    or a tuple, list or dict of them; None passes), by its leading batch
    dim over the data axis. Raises ``ValueError`` on an uneven split."""
    return _rows(tree, batch_sharding(mesh))


def replicated(tree, mesh: DeviceMesh):
    """``tree``'s tensors made equal on every rank of ``mesh``: rank 0's
    values broadcast, in place; returns ``tree``."""
    src = int(mesh.mesh.flatten()[0])
    leaves = tree.values() if isinstance(tree, dict) else \
        (tree if isinstance(tree, (tuple, list)) else [tree])
    for t in leaves:
        dist.broadcast(t, src)
    return tree


def seed_sweep_keys(seed: int, num: int) -> torch.Tensor:
    """``num`` independent 63-bit seeds ``[num]`` (int64) for a multi-seed
    sweep: one ``torch.Generator`` each. JAX's ``PRNGKey`` streams cannot
    be reproduced; parity tests pass the noise in."""
    words = np.random.SeedSequence(int(seed)).generate_state(num, np.uint64)
    return torch.as_tensor((words >> np.uint64(1)).astype(np.int64))


# ---------------------------------------------------------------------------
# Tensor parallelism

_LAYERS = (nn.Linear, nn.Conv2d, nn.GroupNorm, nn.LayerNorm)


def _out_features(m: nn.Module) -> Optional[int]:
    """The output-feature count of a layer :func:`shard_params` can shard
    (None for anything else)."""
    if isinstance(m, nn.Linear):
        return m.out_features
    if isinstance(m, nn.Conv2d):
        return m.out_channels
    if isinstance(m, nn.GroupNorm) and m.affine:
        return m.num_channels
    if isinstance(m, nn.LayerNorm) and m.elementwise_affine and \
            len(m.normalized_shape) == 1:
        return m.normalized_shape[0]
    return None


def _tp_size(mesh_or_tp) -> int:
    if isinstance(mesh_or_tp, int):
        return mesh_or_tp
    return dict(zip(mesh_or_tp.mesh_dim_names, mesh_or_tp.shape))[MODEL_AXIS]


def param_shardings(params, mesh) -> Dict[str, Optional[int]]:
    """The tensor-parallel rule for each parameter, by name: 0 (dim 0, the
    output features, sharded over the model axis) or None (replicated).
    ``params``: a module (the layers :func:`shard_params` shards) or a dict
    of tensors (dim 0 of every tensor with one that divides). ``mesh``: a
    mesh or the model-axis size."""
    tp = _tp_size(mesh)

    def rule(n) -> Optional[int]:
        return 0 if tp > 1 and n is not None and n % tp == 0 else None

    if isinstance(params, nn.Module):
        out = {}
        for mname, m in params.named_modules():
            n = _out_features(m) if isinstance(m, _LAYERS) else None
            spec = 0 if hasattr(m, '_tp') else rule(n)
            for pname, _ in m.named_parameters(recurse=False):
                out[f'{mname}.{pname}' if mname else pname] = spec
        return out
    return {name: rule(t.shape[0] if t.dim() else None)
            for name, t in params.items()}


class _GatherChannels(torch.autograd.Function):
    """All-gather ``x`` over a model group along ``dim``; the backward
    keeps this rank's slice of the gradient (exact: the group's ranks
    compute the same activations from here on; see the module doc)."""

    @staticmethod
    def forward(ctx, x, dim: int, tp: MeshAxis):
        ctx.dim, ctx.tp, ctx.n = dim, tp, x.shape[dim]
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(tp.size)]
        dist.all_gather(parts, x.contiguous(), group=tp.group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.tp.rank * ctx.n, ctx.n), None, None


class _SumGradients(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the model
    group: a sharded layer's input feeds every rank's slice."""

    @staticmethod
    def forward(ctx, x, tp: MeshAxis):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.tp.group)
        return grad, None


def gather_channels(x: torch.Tensor, dim: int, tp: MeshAxis) -> torch.Tensor:
    """Every model rank's slice of ``x`` concatenated along ``dim``."""
    return _GatherChannels.apply(x, dim, tp)


def _linear_tp_forward(self, x):
    x = _SumGradients.apply(x, self._tp)
    return gather_channels(F.linear(x, self.weight, self.bias), -1, self._tp)


def _conv_tp_forward(self, x):
    x = _SumGradients.apply(x, self._tp)
    return gather_channels(self._conv_forward(x, self.weight, self.bias), 1,
                           self._tp)


def _norm_forward(self, *args, **kwargs):
    """The layer's own forward with its affine gathered."""
    saved = dict(self._parameters)
    try:
        for name in ('weight', 'bias'):
            if saved.get(name) is not None:
                self._parameters[name] = gather_channels(saved[name], 0,
                                                         self._tp)
        return type(self).forward(self, *args, **kwargs)
    finally:
        self._parameters.update(saved)


def shard_params(module: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Tensor-parallel layout of ``module`` over the model axis, in place
    (see the module doc); returns ``module``. Each sharded parameter is
    replaced by this rank's dim-0 slice (a new ``nn.Parameter`` with the
    same ``requires_grad``, marked ``tp_sharded``); a model axis of size 1
    changes nothing."""
    tp = MeshAxis.of(mesh, MODEL_AXIS)
    if tp.size == 1:
        return module
    for m in module.modules():
        n = _out_features(m) if isinstance(m, _LAYERS) else None
        if n is None or n % tp.size or hasattr(m, '_tp'):
            continue
        per = n // tp.size
        lo = tp.rank * per
        for name, p in list(m.named_parameters(recurse=False)):
            piece = nn.Parameter(p.detach()[lo:lo + per].clone(),
                                 requires_grad=p.requires_grad)
            piece.tp_sharded = True
            setattr(m, name, piece)
        m._tp = tp
        fwd = _linear_tp_forward if isinstance(m, nn.Linear) else \
            _conv_tp_forward if isinstance(m, nn.Conv2d) else _norm_forward
        m.forward = types.MethodType(fwd, m)
    return module


def tp_slice(m: nn.Module) -> Optional[slice]:
    """The dim-0 rows of the full parameters that a sharded layer ``m``
    keeps (None when ``m`` is not sharded)."""
    tp = getattr(m, '_tp', None)
    if tp is None:
        return None
    per = _out_features(m) // tp.size
    return slice(tp.rank * per, (tp.rank + 1) * per)


def unshard(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The full tensor of a ``tp_sharded`` parameter (or of a copy of one
    that keeps its shape); any other tensor as it is."""
    if not getattr(t, 'tp_sharded', False):
        return t
    tp = MeshAxis.of(mesh, MODEL_AXIS)
    parts = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=tp.group)
    return torch.cat(parts)
