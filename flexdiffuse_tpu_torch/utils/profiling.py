"""Profiling, phase timing and program spans (port of
``flexdiffuse_tpu/utils/profiling.py``).

:func:`span` marks a stretch of the program's host work, named
``fd.<what>``, in a running ``torch.profiler`` trace: a CPU op on the
profiler's clock, the clock of the device activity, so an idle stretch of
the card can be set against the layer the host was in. With no profiler
running it returns one shared no-op context. A span is a
``_RecordFunctionFast`` (a ``cpu_op`` event), never a ``record_function``
(a ``user_annotation``, which the profiler mirrors as a range on the
device that reads as busy time). A span opened before the profiler started
is not recorded; one still open when it stops ends at the stop.

:class:`PhaseTimer` accumulates host wall-clock seconds per named phase
(``Runner.timer``: ``'embeds'`` and ``'generate'``), each phase also a span
``fd.<phase>``. On the card PyTorch returns before the device finishes, so
a phase's host time is the time the host took to enqueue it, plus any wait
for the device inside it ('generate' ends with the images copied to the
host). Each layer's device time comes from a trace with its spans.

:func:`trace` records a ``torch.profiler`` trace (CPU and, on a card, CUDA
activity) and writes it as a Chrome trace into a directory; the spans
appear on the same timeline as the kernels.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from collections import defaultdict
from typing import Callable, ContextManager, Dict, Iterator, Optional

import torch

try:
    from torch._C._profiler import _RecordFunctionFast
except ImportError:            # a torch without it: spans stay no-ops
    _RecordFunctionFast = None

log = logging.getLogger(__name__)

_NO_SPAN = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """A span ``name`` in the running profiler's trace; the shared no-op
    context when none runs (about 0.2 µs of host)."""
    if _RecordFunctionFast is None or \
            not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return _RecordFunctionFast(name)


def spanned(name: str) -> Callable:
    """Decorator: every call of the function inside :func:`span` ``name``."""
    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


class PhaseTimer:
    """Accumulating named-phase timer; each phase is also a span
    ``fd.<name>``.

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
            with span('fd.' + name):
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
    format, the ``fd.*`` spans beside the kernels) into ``log_dir``; a
    no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
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
