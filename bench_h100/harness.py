"""The harness's common parts: the definitions it reads, the clocks, the
card, the traced window, the per-layer readers and the result line.

A run (``python -m bench_h100.run --workload <cell> ...``) reads
``BENCHMARK.json`` at the checkout's root and, by the cell's name,
``bench_h100/workloads/<cell>.json`` (its configuration, traffic kind,
parameters and correctness limits), ``bench_h100/configs/<config>.json``
(the sizes as run), ``bench_h100/traffic/<kind>.py`` (the generator that
drives the program) and, with ``--trace 1``, ``bench_h100/metrics/
<metric>.py`` for every per-layer metric that ``BENCHMARK.json`` gives
this cell. Adding a cell, a configuration or a metric adds files and
entries; no file here needs an edit.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'flexdiffuse_tpu')
GIB = float(2**30)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense): bf16
# tensor cores, fp32 outside them, HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12


_T_IMPORT = time.monotonic()


def setup_seconds() -> float:
    """Seconds from the process's start to now (from this module's
    import where ``/proc`` cannot say)."""
    try:
        return process_age()
    except OSError:
        return time.monotonic() - _T_IMPORT


def process_age() -> float:
    """Seconds since this process started (``/proc/self/stat``'s start
    time against ``/proc/uptime``)."""
    with open('/proc/self/stat') as f:
        start_ticks = float(f.read().rsplit(')', 1)[1].split()[19])
    with open('/proc/uptime') as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf('SC_CLK_TCK')


def forbidden_modules(modules: Sequence[str]) -> List[str]:
    """Top-level module names (before the first dot, compared whole) of
    :data:`FORBIDDEN` among ``modules``."""
    return sorted({m.split('.', 1)[0] for m in modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Definition:
    """What one cell's run reads: its entry in ``BENCHMARK.json``, its
    workload file, its configuration file and the per-layer metrics it
    reports."""
    name: str
    workload: dict
    config: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_definition(name: str, root: str) -> Definition:
    """The cell ``name`` from the benchmark at checkout ``root`` (its
    ``BENCHMARK.json`` and ``bench_h100/`` data)."""
    bench = _read(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    data = os.path.join(root, 'bench_h100')
    workload = _read(os.path.join(data, 'workloads', f'{name}.json'))
    entry = cells[name]
    if workload['config'] != entry['config']:
        raise ValueError(f'{name}: workload file names config '
                         f'{workload["config"]!r}, BENCHMARK.json '
                         f'{entry["config"]!r}')
    config = _read(os.path.join(data, 'configs',
                                f'{workload["config"]}.json'))
    reports = lambda m: name in m.get('workloads', [name])
    e2e = [m for m in bench['end_to_end'] if reports(m)]
    e2e_names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer']
                 if reports(m) and m['moves'] in e2e_names]
    return Definition(name, workload, config, e2e, per_layer)


def traffic_module(kind: str):
    return importlib.import_module(f'bench_h100.traffic.{kind}')


def metric_reader(name: str, root: str) -> Callable:
    """``read(ctx)`` of ``bench_h100/metrics/<name>.py`` (a file per
    metric; its name may hold dots)."""
    path = os.path.join(root, 'bench_h100', 'metrics', f'{name}.py')
    spec = importlib.util.spec_from_file_location(
        f'bench_h100_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or ''."""
    smi = shutil.which('nvidia-smi')
    if not smi:
        return ''
    out = subprocess.run([smi, '--query-gpu=name,power.limit',
                          '--format=csv,noheader', '--id=0'],
                         capture_output=True, text=True, check=False)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else ''


# ---------------------------------------------------------------------------
# Percentiles and the window's rules


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q``-quantile by nearest rank: the ⌈q·n⌉-th smallest value
    (``inf`` for a failed request sorts last)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


# ---------------------------------------------------------------------------
# The traced window


def _kineto_events(prof) -> list:
    return list(prof.profiler.kineto_results.events())


def _ev_start_end_us(ev) -> tuple:
    """(start, end) in µs; older torch has ``start_us`` only."""
    if hasattr(ev, 'start_ns'):
        s = ev.start_ns() / 1e3
        return s, s + ev.duration_ns() / 1e3
    s = ev.start_us()
    return s, s + ev.duration_us()


@dataclasses.dataclass
class Interval:
    name: str
    start: float      # µs
    end: float        # µs


def intervals(prof, device_type) -> List[Interval]:
    """Every profiled operation of ``device_type`` (``DeviceType.CUDA``:
    what ran on the card, kernels, copies and sets; ``.CPU``: host ops)."""
    return [Interval(ev.name(), *_ev_start_end_us(ev))
            for ev in _kineto_events(prof) if ev.device_type() == device_type]


def union_seconds(intervals: Sequence[Interval]) -> float:
    """The length of the union of the intervals, in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for iv in sorted(intervals, key=lambda i: i.start):
        if cur_e is None or iv.start > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = iv.start, iv.end
        else:
            cur_e = max(cur_e, iv.end)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def gaps(intervals: Sequence[Interval], t0: float, t1: float
         ) -> List[tuple]:
    """Idle stretches ``(start, end)`` (µs) of the card within [t0, t1]."""
    out, edge = [], t0
    for iv in sorted(intervals, key=lambda i: i.start):
        if iv.start > edge:
            out.append((edge, iv.start))
        edge = max(edge, iv.end)
    if t1 > edge:
        out.append((edge, t1))
    return out


def kernel_named(trace_name: str, names: Sequence[str]) -> bool:
    """Whether a device operation's demangled name is a function named
    one of ``names`` at the global or an anonymous namespace's scope (so
    ``pytorch_flash::flash_fwd_kernel`` is not ``flash_fwd_kernel``)."""
    return any(re.search(r'(^|\s|\(anonymous namespace\)::)' +
                         re.escape(n) + r'\b', trace_name) for n in names)


@dataclasses.dataclass
class Traced:
    """One profiled part of the window: its length on the host's clock,
    the device and host intervals inside it, and their bounds (µs, the
    profiler's clock)."""
    window_s: float
    device: List[Interval]
    host: List[Interval]
    t0: float
    t1: float

    def busy_s(self) -> float:
        return union_seconds(self.device)

    def kernel_seconds(self, names: Sequence[str]) -> float:
        """Device seconds of the kernels named ``names``
        (:func:`kernel_named`)."""
        return sum(iv.end - iv.start for iv in self.device
                   if kernel_named(iv.name, names)) / 1e6

    def kernel_count(self, names: Sequence[str]) -> int:
        return sum(1 for iv in self.device if kernel_named(iv.name, names))

    def breakdown(self, top: int = 10) -> dict:
        by_name: Dict[str, float] = {}
        for iv in self.device:
            by_name[iv.name] = by_name.get(iv.name, 0.0) + \
                (iv.end - iv.start) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(self.device, self.t0, self.t1),
                      key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in idle:
            mid = (s + e) / 2
            around = [h for h in self.host if h.start <= mid <= h.end]
            what = min(around, key=lambda h: h.end - h.start).name \
                if around else 'no host op'
            named.append([what[:120], (e - s) / 1e6])
        return {'device_ops': [[n[:160], v] for n, v in ops],
                'idle_gaps': named}


class TraceWindow:
    """Starts ``torch.profiler`` on the thread that runs the model at a
    model-call boundary after ``start_after`` seconds of the window and
    stops it at the first boundary after ``stop_after``, synchronising
    the card at both ends, so the window holds whole calls only.
    :meth:`at_boundary` is called by the traffic before and after each
    model call (``before`` True before it)."""

    def __init__(self, enabled: bool, start_after: float,
                 stop_after: float) -> None:
        self.enabled = enabled
        self.start_after = start_after
        self.stop_after = stop_after
        self.t_open: Optional[float] = None
        self.prof = None
        self.state = 'idle'      # idle → running → done
        self._result: Optional[Traced] = None
        # Monotonic times at which the profiler started and stopped.
        self.m_start: Optional[float] = None
        self.m_stop: Optional[float] = None

    def open(self, t_open: float) -> None:
        self.t_open = t_open

    def at_boundary(self, before: bool) -> None:
        if not self.enabled or self.t_open is None or self.state == 'done':
            return
        import torch
        now = time.monotonic() - self.t_open
        cuda = torch.cuda.is_available()
        if self.state == 'idle' and before and now >= self.start_after:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                torch.cuda.synchronize()
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self._host0 = time.perf_counter()
            self.m_start = time.monotonic()
            self.state = 'running'
        elif self.state == 'running' and not before and \
                now >= self.stop_after:
            if cuda:
                torch.cuda.synchronize()
            self._window_s = time.perf_counter() - self._host0
            self.m_stop = time.monotonic()
            self.prof.stop()
            self.state = 'done'

    @property
    def result(self) -> Optional[Traced]:
        """The profiled part, read from the profiler once it is needed
        (after the window, so the parsing costs the window nothing)."""
        if self.state != 'done':
            return None
        if self._result is None:
            import torch
            kinds = torch.autograd.DeviceType
            dev = intervals(self.prof, kinds.CUDA)
            host = intervals(self.prof, kinds.CPU)
            lo = min([iv.start for iv in dev + host], default=0.0)
            hi = max([iv.end for iv in dev + host], default=0.0)
            self._result = Traced(self._window_s, dev, host, lo, hi)
        return self._result

    @property
    def running(self) -> bool:
        return self.state == 'running'

    def overlaps(self, t0: float, t1: float) -> bool:
        """Whether the monotonic span [t0, t1] meets the traced part."""
        if self.m_start is None:
            return False
        return t0 < (self.m_stop or float('inf')) and t1 > self.m_start


class ModelProbe:
    """Forward hooks on a module: every call after the window opens is
    recorded with its input's shape and, on the card, a pair of CUDA
    events, and marked ``traced`` when it ran inside the profiled part;
    with ``boundary`` the profiled part starts and stops at this module's
    calls."""

    def __init__(self, module, window: TraceWindow, name: str,
                 boundary: bool) -> None:
        self.window = window
        self.name = name
        self.boundary = boundary
        self.calls: List[dict] = []
        self._open = None
        self.handles = [module.register_forward_pre_hook(self._pre),
                        module.register_forward_hook(self._post)]

    def _pre(self, module, args):
        if self.boundary:
            self.window.at_boundary(True)
        self._open = None
        if self.window.t_open is None:
            return
        import torch
        x = args[0]
        call = {'batch': int(x.shape[0]), 'shape': tuple(x.shape),
                'traced': self.window.running}
        if x.is_cuda:
            call['ev'] = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            call['ev'][0].record()
        self.calls.append(call)
        self._open = call

    def _post(self, module, args, out):
        if self._open is not None:
            if 'ev' in self._open:
                self._open['ev'][1].record()
            self._open['done'] = True
        self._open = None
        if self.boundary:
            self.window.at_boundary(False)

    def traced_calls(self) -> List[dict]:
        return [c for c in self.calls if c['traced'] and c.get('done')]

    def device_ms(self, traced: bool = False) -> List[tuple]:
        """``(milliseconds between the call's events, its batch)`` of the
        calls inside (``traced``) or outside the profiled part (call
        after the card has synchronised)."""
        return [(c['ev'][0].elapsed_time(c['ev'][1]), c['batch'])
                for c in self.calls
                if 'ev' in c and c.get('done') and c['traced'] == traced]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


# ---------------------------------------------------------------------------
# The result


@dataclasses.dataclass
class Check:
    """One number compared, with its limit (pass when ``value <=
    limit``)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def emit(correct: bool, attempted: int, failed: int, metrics: dict,
         device: dict, checks: List[Check], breakdown: dict = None) -> dict:
    """Print the compared numbers beside their limits on standard error,
    then the result as the last line of standard output."""
    for c in checks:
        print(f'check {c.name} {c.value!r} limit {c.limit!r} '
              f'{"ok" if c.ok else "FAIL"}', file=sys.stderr, flush=True)
    res: Dict[str, Any] = {'correct': bool(correct),
                           'attempted': int(attempted),
                           'failed': int(failed), 'metrics': metrics,
                           'device': device}
    if breakdown is not None:
        res['breakdown'] = breakdown
    res['checks'] = {c.name: {'value': c.value, 'limit': c.limit}
                     for c in checks}
    print(json.dumps(res), flush=True)
    return res
