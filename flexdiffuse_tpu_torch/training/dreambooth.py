"""DreamBooth — subject-driven fine-tuning with prior preservation (port of
``flexdiffuse_tpu/training/dreambooth.py``).

Ruiz et al. 2022: fine-tune on a handful of instance images captioned with
a rare identifier ("a photo of sks dog") while also training on
model-generated class images ("a photo of a dog") so the class prior
survives. Loss = L_instance + w·L_prior.

Every step's batch is the concatenation of an instance half and a class
half: one UNet forward for both, with the per-row weights
``[1,…,1, w,…,w]`` folded into the loss (``training/train.py``
``sample_weights``). Class images are conventionally pre-generated with
the base model itself (:func:`generate_class_images` drives the port's
``Runner``).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from flexdiffuse_tpu_torch.training import train as _train
from flexdiffuse_tpu_torch.training.data import EncodedDataset
from flexdiffuse_tpu_torch.training.loop import (generators, save_full,
                                                 writes)

log = logging.getLogger(__name__)


def generate_class_images(runner, class_prompt: str, out_dir: str,
                          count: int = 50, steps: int = 30,
                          seed: int = 0) -> List[str]:
    """Pre-generate prior-preservation images with the port's ``Runner``.
    Returns the written paths; skips work already on disk (re-runs are
    incremental)."""
    os.makedirs(out_dir, exist_ok=True)
    have = sorted(
        os.path.join(out_dir, f) for f in os.listdir(out_dir)
        if f.lower().endswith('.png'))
    i = len(have)
    paths = list(have)
    while len(paths) < count:
        n = min(4, count - len(paths))
        imgs, _ = runner.gen(prompt=class_prompt, samples=n, steps=steps,
                             seed=seed + i, save=False)
        for img in imgs:
            p = os.path.join(out_dir, f'class_{i:05d}.png')
            img.save(p)
            paths.append(p)
            i += 1
    return paths[:count]


def train_dreambooth(unet, instance_ds: EncodedDataset,
                     class_ds: EncodedDataset,
                     cfg: Optional[_train.TrainConfig] = None,
                     prior_weight: float = 1.0, mode: str = 'lora',
                     rank: int = 8, steps: int = 800, batch_size: int = 2,
                     seed: int = 0, mesh=None,
                     save_path: Optional[str] = None, log_every: int = 10,
                     on_step: Optional[Callable[[int, float], None]] = None,
                     ) -> Tuple[dict, List[float]]:
    """DreamBooth fine-tune: ``batch_size`` instance rows + ``batch_size``
    class rows per step, the class half weighted by ``prior_weight``.

    ``mode``: 'lora' (returns the factors; ``save_path`` writes kohya
    safetensors) or 'full' (trains ``unet`` in place and returns its
    trained parameters; ``save_path`` writes them in the JAX package's
    msgpack format, ``training.loop.save_full``). The weights
    make the mean loss ``(L_inst + w·L_prior) / 2``: the published objective
    up to the constant 2, which the learning rate absorbs. Generators:
    instance stream ``seed``, class stream ``seed + 1``, steps
    ``seed + 2``, LoRA init ``seed + 3``. ``mesh``: data parallelism, as
    in ``training.loop`` (the per-row weights are sharded with their
    rows; rank 0 writes ``save_path``).
    """
    if mode not in ('lora', 'full'):
        raise ValueError(f'unknown mode {mode!r}')
    cfg = cfg or _train.TrainConfig(learning_rate=(1e-4 if mode == 'lora'
                                                   else 2e-6),
                                    weight_decay=0.0)
    weights = np.concatenate([np.ones(batch_size, np.float32),
                              np.full(batch_size, prior_weight, np.float32)])
    inst_gen, cls_gen, step_gen, init_gen = generators(
        seed, instance_ds.device, 4)
    if mode == 'lora':
        tree = _train.init_lora(unet, rank=rank, generator=init_gen)
        step_fn, _ = _train.make_lora_train_step(
            unet, tree, cfg, mesh=mesh, sample_weights=weights)
    else:
        tree = _train.trainable_tree(unet)
        step_fn, _ = _train.make_train_step(unet, cfg, mesh=mesh,
                                            sample_weights=weights)
    inst_it = instance_ds.batches(batch_size, inst_gen)
    cls_it = class_ds.batches(batch_size, cls_gen)
    losses: List[float] = []
    t0 = time.monotonic()
    log.info('dreambooth (%s): %d instance + %d class images, %d steps, '
             'prior weight %.2f', mode, len(instance_ds), len(class_ds),
             steps, prior_weight)
    for i in range(steps):
        (li, ci), (lc, cc) = next(inst_it), next(cls_it)
        loss = step_fn(torch.cat([li, lc]), torch.cat([ci, cc]),
                       generator=step_gen)
        if log_every and (i % log_every == 0 or i == steps - 1):
            val = float(loss)
            losses.append(val)
            log.info('step %d/%d  loss %.5f  (%.2f steps/s)', i + 1, steps,
                     val, (i + 1) / max(time.monotonic() - t0, 1e-6))
            if on_step is not None:
                on_step(i, val)
    if save_path and mode == 'full':
        save_full(unet, tree, save_path, mesh)
    elif save_path and writes(mesh):
        n = _train.export_lora_safetensors(tree, save_path)
        log.info('wrote %d LoRA modules to %s', n, save_path)
    return tree, losses
