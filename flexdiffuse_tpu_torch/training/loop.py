"""Training loop driver: steps × batches → trained UNet or LoRA adapter
(port of ``flexdiffuse_tpu/training/loop.py``).

One function per mode, shaped the same way: build the step
(``training/train.py``), pull shuffled batches off the device-resident
:class:`~flexdiffuse_tpu_torch.training.data.EncodedDataset`, log the loss
at a cadence, and return the trained tensors with the loss history.

Randomness comes from ``torch.Generator``s on the dataset's device, seeded
from ``seed``: the batch stream from ``seed``, the timesteps and noise of
the steps from ``seed + 1`` and the LoRA ``down`` init from ``seed + 2``.

``mesh`` (data parallelism; every rank runs the same call): every rank
draws the same global batches and the step keeps its rows; rank 0 alone
writes checkpoints and ``save_path``, every rank restores the checkpoint.
Under tensor parallelism (a UNet that ``parallel.shard_params`` laid out)
``save_path`` and the checkpoints hold the global state, as the JAX
package's orbax checkpoints hold global arrays: every tensor of a sharded
parameter (the weight, its EMA, its AdamW moments and accumulated
gradient) is gathered over the model group before rank 0 writes, and on
restore every rank keeps its dim-0 slice by ``shard_params``' rule. A
checkpoint therefore resumes under any model axis, or none. LoRA factors
are replicated over the model group and need neither.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from flexdiffuse_tpu_torch.training import train as _train
from flexdiffuse_tpu_torch.training.checkpoint import TrainCheckpointer
from flexdiffuse_tpu_torch.training.data import EncodedDataset
from flexdiffuse_tpu_torch.weights import convert as _convert
from flexdiffuse_tpu_torch.weights import msgpack as _msgpack

Tensor = torch.Tensor
log = logging.getLogger(__name__)


def generators(seed: int, device, count: int) -> List[torch.Generator]:
    """``count`` generators on ``device`` seeded ``seed``, ``seed + 1``, …"""
    return [torch.Generator(device).manual_seed(seed + i)
            for i in range(count)]


def writes(mesh) -> bool:
    """Whether this process writes files: without a mesh, or as rank 0."""
    return mesh is None or dist.get_rank() == 0


def _model_parallel(mesh) -> bool:
    from flexdiffuse_tpu_torch.parallel.axis import MeshAxis
    from flexdiffuse_tpu_torch.parallel.mesh import MODEL_AXIS
    return mesh is not None and MeshAxis.of(mesh, MODEL_AXIS).size > 1


def full_tree(unet, tree: Dict[str, Tensor], mesh) -> Dict[str, Tensor]:
    """``tree`` (tensors by parameter name) with every tensor of a
    tensor-parallel parameter gathered whole (collective: every rank
    calls it)."""
    if not _model_parallel(mesh):
        return tree
    from flexdiffuse_tpu_torch.parallel.mesh import unshard
    params = dict(unet.named_parameters())
    out = {}
    for name, t in tree.items():
        p = params.get(name)
        if p is not None and getattr(p, 'tp_sharded', False):
            t = t.detach()
            t.tp_sharded = True
        out[name] = unshard(t, mesh)
    return out


def _tp_map(st: dict, names: set, idx: set, fn) -> dict:
    """Checkpoint state ``st`` with ``fn`` applied to every tensor of a
    tensor-parallel parameter: the trained tensors and their EMA named in
    ``names``, the AdamW moments and accumulated gradients of the optimizer
    parameters numbered in ``idx``."""
    out = dict(st)
    for key in ('tree', 'ema'):
        if key in st:
            out[key] = {n: fn(t) if n in names else t
                        for n, t in st[key].items()}
    opt = st['opt_state']
    adamw = opt['adamw']
    moments = {i: {k: fn(v) if i in idx and torch.is_tensor(v) and v.dim()
                   else v for k, v in m.items()}
               for i, m in adamw['state'].items()}
    out['opt_state'] = dict(
        opt, adamw=dict(adamw, state=moments),
        acc=[fn(a) if i in idx else a for i, a in enumerate(opt['acc'])])
    return out


def _run(step_fn, opt, tree: Dict[str, Tensor], dataset: EncodedDataset,
         steps: int, batch_size: int, seed: int, log_every: int,
         on_step: Optional[Callable[[int, float], None]],
         ema_decay: float = 0.0, ckpt: Optional[TrainCheckpointer] = None,
         mesh=None) -> Tuple[Dict[str, Tensor], List[float]]:
    """Run steps ``[start, steps)``; returns the trained tensors (their EMA
    when ``ema_decay > 0``) and the logged losses."""
    data_gen, step_gen = generators(seed, dataset.device, 2)
    data_state = data_gen.get_state()   # the batch stream replays from it
    losses: List[float] = []
    start = 0
    ema = ({n: t.detach().clone() for n, t in tree.items()}
           if ema_decay > 0 else None)

    def state() -> dict:
        st = {'tree': {n: t.detach() for n, t in tree.items()},
              'opt_state': opt.state_dict(), 'data_gen': data_state,
              'step_gen': step_gen.get_state()}
        if ema is not None:
            st['ema'] = ema
        return st

    # Tensor parallelism: checkpoints hold the global state (the module
    # doc); these gather it for saving and cut this rank's part on restore.
    to_file = from_file = None
    if _model_parallel(mesh):
        from flexdiffuse_tpu_torch.parallel.axis import MeshAxis, gather, \
            local
        from flexdiffuse_tpu_torch.parallel.mesh import MODEL_AXIS
        tp = MeshAxis.of(mesh, MODEL_AXIS)
        names = {n for n, t in tree.items() if getattr(t, 'tp_sharded',
                                                       False)}
        idx = {i for i, p in enumerate(opt.params)
               if getattr(p, 'tp_sharded', False)}
        to_file = lambda st: _tp_map(st, names, idx,
                                     lambda t: gather(t.detach(), tp, 0))
        from_file = lambda st: _tp_map(st, names, idx,
                                       lambda t: local(t, tp, 0).clone())
    if ckpt is not None:
        restored = ckpt.restore_latest(state(), from_file)
        if restored is not None:
            saved, start, losses = restored
            with torch.no_grad():
                for n, t in tree.items():
                    t.copy_(saved['tree'][n])
                for n, t in (ema or {}).items():
                    t.copy_(saved['ema'][n])
            opt.load_state_dict(saved['opt_state'])
            data_gen.set_state(saved['data_gen'])
            step_gen.set_state(saved['step_gen'])
    it = dataset.batches(batch_size, data_gen, skip=start)
    t0 = time.monotonic()
    for i in range(start, steps):
        batch = next(it)
        extra = batch[2] if len(batch) == 3 else None   # SDXL added_cond
        loss = step_fn(batch[0], batch[1], extra, generator=step_gen)
        if ema is not None:
            _train.ema_update(ema, tree, ema_decay)
        if log_every and (i % log_every == 0 or i == steps - 1):
            val = float(loss)   # synchronises with the device
            losses.append(val)
            log.info('step %d/%d  loss %.5f  (%.2f steps/s)', i + 1, steps,
                     val, (i + 1 - start) / max(time.monotonic() - t0, 1e-6))
            if on_step is not None:
                on_step(i, val)
        if ckpt is not None and ckpt.should_save(i, steps):
            st = state() if to_file is None else to_file(state())
            if writes(mesh):
                ckpt.save(i + 1, st, losses)
            if mesh is not None:
                dist.barrier()   # no rank reads it before it is whole
    return (ema if ema is not None else tree), losses


def _ckpt(checkpoint_dir: Optional[str],
          checkpoint_every: int) -> Optional[TrainCheckpointer]:
    if not checkpoint_dir:
        return None
    return TrainCheckpointer(checkpoint_dir, every=checkpoint_every)


def train_lora(unet, dataset: EncodedDataset,
               cfg: Optional[_train.TrainConfig] = None, rank: int = 8,
               steps: int = 500, batch_size: int = 4, seed: int = 0,
               mesh=None, save_path: Optional[str] = None,
               log_every: int = 10, include_ff: bool = True,
               on_step: Optional[Callable[[int, float], None]] = None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 100,
               ) -> Tuple[_train.Factors, List[float]]:
    """LoRA fine-tune of ``unet`` (its weights stay frozen): returns
    ``(factors, loss_history)``; ``save_path`` also writes a kohya
    safetensors adapter. ``checkpoint_dir`` enables checkpoints every
    ``checkpoint_every`` steps; when the directory already holds one,
    training resumes from it bit-exactly (``training/checkpoint.py``)."""
    cfg = cfg or _train.TrainConfig()
    init_gen = generators(seed + 2, dataset.device, 1)[0]
    factors = _train.init_lora(unet, rank=rank, generator=init_gen,
                               include_ff=include_ff)
    step_fn, opt = _train.make_lora_train_step(unet, factors, cfg, mesh=mesh)
    log.info('LoRA training: %d modules at rank %d, %d steps, batch %d',
             len(factors), rank, steps, batch_size)
    tree, losses = _run(step_fn, opt, _train.factor_tree(factors), dataset,
                        steps, batch_size, seed, log_every, on_step,
                        ema_decay=cfg.ema_decay,
                        ckpt=_ckpt(checkpoint_dir, checkpoint_every),
                        mesh=mesh)
    factors = _train.unflatten_factors(tree)
    if save_path and writes(mesh):
        n = _train.export_lora_safetensors(factors, save_path)
        log.info('wrote %d LoRA modules to %s', n, save_path)
    return factors, losses


def save_full(unet, tree: Dict[str, Tensor], path: str, mesh=None) -> None:
    """Write a full fine-tune as the JAX package's ``{'params': tree}`` in
    flax's msgpack format (the bytes ``flax.serialization.
    msgpack_serialize`` gives; ``weights/msgpack.py``): ``tree``'s tensors
    over the rest of ``unet``'s parameters. With ``mesh`` every rank calls
    it (tensor-parallel shards are gathered) and rank 0 writes."""
    params = {n: p.detach() for n, p in unet.named_parameters()}
    sd = {**unet.state_dict(),
          **full_tree(unet, {**params, **tree}, mesh)}
    if not writes(mesh):
        return
    sd = {n: t.detach() for n, t in sd.items()}
    _msgpack.save(_convert.state_dict_to_params(sd, unet.config), path)
    log.info('wrote trained params to %s', path)


def train_full(unet, dataset: EncodedDataset,
               cfg: Optional[_train.TrainConfig] = None, steps: int = 500,
               batch_size: int = 4, seed: int = 0, mesh=None,
               save_path: Optional[str] = None, log_every: int = 10,
               on_step: Optional[Callable[[int, float], None]] = None,
               checkpoint_dir: Optional[str] = None,
               checkpoint_every: int = 100,
               ) -> Tuple[Dict[str, Tensor], List[float]]:
    """Full-model fine-tune of ``unet``, in place: returns the trained
    parameters by name (their EMA when ``cfg.ema_decay > 0``) and the loss
    history. ``save_path`` also writes them in the JAX package's format
    (:func:`save_full`; ``weights.load.load_unet_msgpack`` reads it back).
    ``checkpoint_dir`` as in :func:`train_lora`."""
    cfg = cfg or _train.TrainConfig()
    step_fn, opt = _train.make_train_step(unet, cfg, mesh=mesh)
    log.info('full fine-tune: %d steps, batch %d', steps, batch_size)
    tree, losses = _run(step_fn, opt, _train.trainable_tree(unet), dataset,
                        steps, batch_size, seed, log_every, on_step,
                        ema_decay=cfg.ema_decay,
                        ckpt=_ckpt(checkpoint_dir, checkpoint_every),
                        mesh=mesh)
    if save_path:
        save_full(unet, tree, save_path, mesh)
    return tree, losses
