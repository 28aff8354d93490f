"""Traffic generators: one module per kind of driving, found by the
``traffic`` key of a workload file (``workloads/<cell>.json``), each with
``run(ctx) -> Outcome``. The mix itself (rates, lengths, steps, sizes) is
the workload file's ``params``: a new mix of a known kind is a data file.

- ``open_loop_serve``: requests to ``GenerationService.generate`` on a
  fixed schedule of Poisson gaps, one thread per request in flight;
- ``closed_loop_gen``: ``Runner.gen`` calls back to back from one client;
- ``train_steps``: LoRA train steps over a seeded on-device dataset.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

from bench_h100.harness import Check, Definition, TraceWindow


@dataclasses.dataclass
class RunContext:
    definition: Definition
    seed: int
    seconds: float
    trace: bool
    device: object                 # torch.device
    root: str                      # the checkout


@dataclasses.dataclass
class Outcome:
    """What a traffic run hands back once its window has closed and the
    program is freed: the counts, the end-to-end metrics, the window's
    peak memory, the per-layer readers' context, and ``check()`` for the
    reference comparison."""
    attempted: int
    failed: int
    metrics: Dict[str, float]
    memory_peak_bytes: int
    check: Callable[[], List[Check]]
    layer: Dict[str, object] = dataclasses.field(default_factory=dict)
    window: Optional[TraceWindow] = None
