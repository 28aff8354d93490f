"""The card's idle time put down to the layer the host was in, from the
program's spans (``fd.*``: ``flexdiffuse_tpu_torch/utils/profiling.span``,
``cpu_op`` events on the profiler's clock) in the traced part's kineto
events (``ctx['window'].prof``).

- Device busy: the union of the CUDA-device events, user-annotation
  ranges left out (the profiler's mirrors of ``record_function`` ranges,
  such as ``Optimizer.step#AdamW.step``, which are no work of the card).
- The hull: from the start of the first whole top-level span (``fd.gen``,
  ``fd.train_step``) to the end of the last. A span still open when the
  profiler stopped ends at the stop, after every event that is not a span:
  it is not whole. One opened before the profiler started is not in the
  trace at all. So the partial calls at the traced part's edges fall
  outside the hull.
- Attribution: each idle µs inside the hull goes to the first layer, in the
  cell's order (innermost first), whose spans cover it, and to ``client``
  where none does: the shares add up to the hull's idle share.
- Every share is a percent of the hull's length.

A trace without the spans (a program that lacks them) gives no hull, and
every reader returns None.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from bench_h100 import harness

Ivs = List[Tuple[float, float]]

# Per cell: the top-level span, then each layer's spans in the order a
# covered idle µs is given to them (innermost first); idle in the hull that
# no layer covers is 'client', the benchmark's own work between calls.
GEN = ('fd.gen', (('unet', ('fd.unet',)),
                  ('loop', ('fd.denoise',)),
                  ('edge', ('fd.gen',))))
# The step's own lines outside its first three phases (a few µs of Python a
# step) count with the optimizer, which ends the step.
TRAIN = ('fd.train_step', (('merge', ('fd.lora_merge',)),
                           ('forward', ('fd.forward',)),
                           ('backward', ('fd.backward',)),
                           ('optimizer', ('fd.optimizer',
                                          'fd.train_step'))))
KERNEL_SPANS = ('fd.k1', 'fd.k6')


def union(ivs: Iterable[Tuple[float, float]]) -> Ivs:
    """Sorted, disjoint, merged intervals."""
    out: Ivs = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        elif e > s:
            out.append((s, e))
    return out


def intersect(a: Ivs, b: Ivs) -> Ivs:
    """The overlap of two sorted disjoint lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def subtract(a: Ivs, b: Ivs) -> Ivs:
    """``a`` less ``b`` (sorted disjoint lists)."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k, cur = j, s
        while k < len(b) and b[k][0] < e:
            if b[k][0] > cur:
                out.append((cur, b[k][0]))
            cur = max(cur, b[k][1])
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def length(ivs: Ivs) -> float:
    return sum(e - s for s, e in ivs)


@dataclasses.dataclass
class Split:
    """The hull (µs), its idle stretches, the idle µs of each layer (and
    ``client``), and the spans inside the hull by name."""
    hull: Tuple[float, float]
    idle: Ivs
    layers: Dict[str, float]
    spans: Dict[str, Ivs]

    @property
    def hull_us(self) -> float:
        return self.hull[1] - self.hull[0]

    def idle_pct(self, layer: str) -> float:
        return 100.0 * self.layers[layer] / self.hull_us

    def mean_span_us(self, names: Sequence[str]) -> Optional[float]:
        """Mean length of the spans named ``names`` inside the hull."""
        got = [e - s for n in names for s, e in self.spans.get(n, [])]
        return sum(got) / len(got) if got else None


def split(events, cell: tuple) -> Optional[Split]:
    """The traced part's idle time by layer (``cell``: :data:`GEN` or
    :data:`TRAIN`) from kineto-like events (``name()``, ``device_type()``,
    ``is_user_annotation()``, and ``start_ns``/``duration_ns`` or
    ``start_us``/``duration_us``); None without a whole top-level span."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    busy, spans, last = [], [], float('-inf')
    for ev in events:
        s, e = harness._ev_start_end_us(ev)
        name = ev.name()
        if ev.device_type() == cuda:
            if not ev.is_user_annotation():
                busy.append((s, e))
            last = max(last, e)
        elif name.startswith('fd.'):
            spans.append((name, s, e))
        else:
            last = max(last, e)
    top, layers = cell
    whole = [(s, e) for n, s, e in spans if n == top and e <= last]
    if not whole:
        return None
    hull = (min(s for s, _ in whole), max(e for _, e in whole))
    inside = {}
    for n, s, e in spans:
        if hull[0] <= s and e <= hull[1]:
            inside.setdefault(n, []).append((s, e))
    idle = subtract([hull], union(busy))
    left, shares = idle, {}
    for layer, names in layers:
        cover = union(iv for n in names for iv in inside.get(n, []))
        part = intersect(left, cover)
        shares[layer] = length(part)
        left = subtract(left, part)
    shares['client'] = length(left)
    return Split(hull, idle, shares, inside)


def from_ctx(ctx: dict, cell: tuple) -> Optional[Split]:
    """:func:`split` of the run's traced part, computed once a run and kept
    in the layer context (every metric of the cell reads the same)."""
    key = f'span_split.{cell[0]}'
    if key not in ctx:
        window = ctx.get('window')
        prof = getattr(window, 'prof', None)
        ctx[key] = None if prof is None or \
            getattr(window, 'state', None) != 'done' else \
            split(harness._kineto_events(prof), cell)
    return ctx[key]


def idle_pct(ctx: dict, cell: tuple, layer: str) -> Optional[float]:
    """Percent of the hull in which the card was idle while the host was in
    ``layer``."""
    s = from_ctx(ctx, cell)
    return None if s is None else s.idle_pct(layer)
