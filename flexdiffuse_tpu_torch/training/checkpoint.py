"""Training checkpoint/resume with ``torch.save`` (port of
``flexdiffuse_tpu/training/checkpoint.py``).

A fine-tune interrupted at step N resumes bit-exactly, because every
source of randomness in the loop is checkpointed or replayable:

* the step generator (timesteps and noise) is saved in the state it had
  after the last finished step;
* the shuffled batch stream is a function of the data generator's initial
  state, which is saved, so resume replays it with
  ``batches(..., skip=next_step)`` (the draws without the sampling).

Each checkpoint is one file ``step_<next_step>.pt`` holding the state
(trained tensors, optimizer state, EMA, generator states), ``next_step`` and
the logged losses; the newest ``keep`` survive. Files are read back with
``torch.load(weights_only=True)``: tensors, numbers and containers only.
"""
from __future__ import annotations

import logging
import os
import re
from typing import List, Optional, Tuple

import torch

log = logging.getLogger(__name__)

_NAME = re.compile(r'^step_(\d+)\.pt$')


def _structure(state: dict) -> dict:
    """What must match between a checkpoint and the current run: the names,
    shapes and dtypes of the trained tensors and the EMA, whether EMA is on,
    and the optimizer's hyper-parameters and accumulation."""
    out = {}
    for key in ('tree', 'ema'):
        if key in state:
            out[key] = {n: (tuple(t.shape), str(t.dtype))
                        for n, t in state[key].items()}
    opt = state['opt_state']
    out['opt'] = ([{k: v for k, v in g.items() if k != 'params'}
                   for g in opt['adamw']['param_groups']],
                  opt['every'], opt['max_norm'])
    return out


class TrainCheckpointer:
    """Checkpoint manager for the training loop (``loop._run``).

    ``state`` is a flat dict: ``tree`` (trained tensors by name),
    ``opt_state`` (``ClippedAdamW.state_dict()``), ``data_gen`` and
    ``step_gen`` (generator states), plus ``ema`` when EMA is on.
    """

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.every = int(every)
        self.keep = int(keep)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            m = _NAME.match(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f'step_{step:08d}.pt')

    # -- save ---------------------------------------------------------
    def should_save(self, i: int, steps: int) -> bool:
        """Save every ``every`` optimizer steps and always at the end."""
        return self.every > 0 and ((i + 1) % self.every == 0
                                   or i == steps - 1)

    def save(self, next_step: int, state: dict,
             losses: List[float]) -> None:
        path = self._path(next_step)
        tmp = path + '.tmp'
        torch.save({'state': state, 'next_step': int(next_step),
                    'losses': [float(x) for x in losses]}, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.keep]:
            os.unlink(self._path(old))
        log.info('checkpoint written: step %d -> %s', next_step,
                 self.directory)

    # -- restore ------------------------------------------------------
    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore_latest(
            self, template: dict) -> Optional[Tuple[dict, int, List[float]]]:
        """Load the newest checkpoint, checked against ``template`` (the
        current run's state).

        Returns ``(state, next_step, losses)``, or ``None`` when the
        directory holds no checkpoint yet. A checkpoint whose trained
        tensors, EMA or optimizer configuration differ from the template's
        raises ``RuntimeError``.
        """
        step = self.latest_step()
        if step is None:
            return None
        blob = torch.load(self._path(step), map_location='cpu',
                          weights_only=True)
        state = blob['state']
        if _structure(template) != _structure(state):
            raise RuntimeError(
                f'checkpoint at {self.directory} step {step} does not match '
                f'the current training configuration (same model/rank/'
                f'optimizer/ema_decay required to resume)')
        log.info('resuming from checkpoint step %d (%s)', blob['next_step'],
                 self.directory)
        return state, int(blob['next_step']), list(blob['losses'])
