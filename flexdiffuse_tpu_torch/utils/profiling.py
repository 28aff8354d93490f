"""Profiling and phase timing (port of ``flexdiffuse_tpu/utils/profiling.py``).

:class:`PhaseTimer` accumulates host wall-clock seconds per named phase
(``Runner.timer``: ``'embeds'`` and ``'generate'``). On the card, PyTorch
returns before the device finishes, so a phase's host time covers its
device work only up to the last synchronisation inside it: ``Runner.gen``
synchronises at the end of ``'embeds'`` and ``'generate'`` ends with the
images copied to the host, so each phase holds its own device time.

:func:`trace` records a ``torch.profiler`` trace (CPU and, on a card, CUDA
activity) and writes it as a Chrome trace into a directory.
"""
from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

log = logging.getLogger(__name__)


class PhaseTimer:
    """Accumulating named-phase timer.

    >>> timer = PhaseTimer()
    >>> with timer.phase('encode'): ...
    >>> timer.summary()  # {'encode': {'total_s': ..., 'count': ...}}
    """

    def __init__(self) -> None:
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._totals[name] += dt
            self._counts[name] += 1
            log.debug('phase %s: %.3fs', name, dt)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                'total_s': self._totals[name],
                'count': self._counts[name],
                'mean_s': self._totals[name] / max(self._counts[name], 1),
            }
            for name in self._totals
        }

    def reset(self) -> None:
        self._totals.clear()
        self._counts.clear()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """``torch.profiler`` trace context; writes ``trace.json`` (Chrome trace
    format) into ``log_dir``; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, 'trace.json')
    prof.export_chrome_trace(path)
    log.info('profiler trace written to %s', path)
