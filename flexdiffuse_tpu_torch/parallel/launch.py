"""Start the ranks of a multi-process run (the port's own module: the JAX
package's single controller drives every device from one process, torch
runs one process per device).

:func:`spawn` starts ``world`` processes with ``torch.multiprocessing``,
initialises the default process group in each over a ``file://`` store in
a fresh temporary directory (no TCP port to collide), and calls ``fn(rank,
world, *args)``:

* on the card (``device='cuda'``, the default): NCCL, rank r on
  ``cuda:r``. It raises before starting anything when fewer than ``world``
  cards are visible; it never drops to fewer ranks or to the CPU.
* on the CPU (``device='cpu'``, only when the caller asks): gloo.

A rank that fails fails the whole run: :func:`spawn` raises with that
rank's error, and every rank's collectives time out after ``timeout``
seconds instead of hanging.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = {'cuda': 'nccl', 'cpu': 'gloo'}


def check_cards(world: int, device: str = 'cuda') -> None:
    """Raise ``RuntimeError`` unless ``world`` ranks can run on
    ``device`` (one card per rank on 'cuda')."""
    if device not in BACKENDS:
        raise ValueError(f'device {device!r} not in {tuple(BACKENDS)}')
    if device == 'cuda':
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(
                f'{world} ranks need {world} CUDA cards, {have} visible; '
                'pass --device cpu to run the ranks on the CPU (gloo)')


def init_rank(rank: int, world: int, store: str, device: str = 'cuda',
              timeout: float = 600.0) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` through the
    ``file://`` store ``store``; returns this rank's device."""
    if device == 'cuda':
        torch.cuda.set_device(rank)
        dev = torch.device('cuda', rank)
    else:
        dev = torch.device('cpu')
    dist.init_process_group(
        BACKENDS[device], init_method=f'file://{store}', rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout))
    return dev


def _entry(rank: int, fn: Callable, world: int, store: str, device: str,
           timeout: float, args: tuple) -> None:
    torch.set_num_threads(1)
    init_rank(rank, world, store, device, timeout)
    try:
        fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device: str = 'cuda', args: tuple = (),
          timeout: float = 600.0,
          join_timeout: Optional[float] = None) -> None:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes, each a
    rank of the default process group (see the module doc). ``fn`` must be
    importable by name (a module-level function). Returns when every rank
    has finished; raises if one failed, if a collective waited longer than
    ``timeout`` seconds, or (``TimeoutError``, the ranks killed) if the run
    outlasted ``join_timeout`` seconds."""
    check_cards(world, device)
    with tempfile.TemporaryDirectory(prefix='fdt_store_') as tmp:
        store = os.path.join(tmp, 'store')
        ctx = mp.start_processes(
            _entry, args=(fn, world, store, device, timeout, tuple(args)),
            nprocs=world, join=False, start_method='spawn')
        deadline = None if join_timeout is None else \
            time.monotonic() + join_timeout
        while not ctx.join(timeout=0.5):
            if deadline is not None and time.monotonic() > deadline:
                for proc in ctx.processes:
                    if proc.is_alive():
                        proc.kill()
                for proc in ctx.processes:
                    proc.join()
                raise TimeoutError(f'{world} ranks of {fn.__name__} did not '
                                   f'finish within {join_timeout} s')
