"""The span readers (``bench_h100/spans.py``) on synthetic kineto-like
events, and the new metrics in a CPU ``--trace 1`` run of the tiny cells."""
import json
import os

import pytest
import torch

from bench_h100 import spans
from bench_h100.tests import tiny

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
GEN_SHARES = ('unet', 'loop', 'edge', 'client')
TRAIN_SHARES = ('merge', 'forward', 'backward', 'optimizer', 'client')


class Ev:
    """A kineto event as the readers see it; times in µs."""

    def __init__(self, name, start, end, device=CPU, annotation=False):
        self._name, self._dev, self._ann = name, device, annotation
        self._start, self._dur = int(start * 1000), int((end - start) * 1000)

    def name(self):
        return self._name

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._ann

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur


def _busy(*ivs):
    return [Ev('kernel', s, e, CUDA) for s, e in ivs]


def gen_events():
    """A traced part of three and a half ``Runner.gen`` calls: the end of
    a call begun before the profiler (no ``fd.gen``), two whole calls, and
    one cut by the stop at 200 (its open spans end there)."""
    return [
        # The partial first call: its last UNet call and its decode.
        Ev('fd.unet', 0, 6), Ev('fd.k6', 1, 2), Ev('fd.decode', 7, 9),
        *_busy((0, 8)),
        # Call A, 20-100.
        Ev('fd.gen', 20, 100), Ev('fd.embeds', 21, 25),
        Ev('fd.encode', 21, 24), Ev('fd.encode', 25, 26),
        Ev('fd.generate', 26, 99), Ev('fd.denoise', 30, 80),
        Ev('fd.unet', 31, 50), Ev('fd.k1', 33, 34), Ev('fd.k6', 36, 39),
        Ev('fd.scheduler', 51, 54), Ev('fd.unet', 55, 75),
        Ev('fd.decode', 81, 85), Ev('fd.to_host', 85, 90),
        Ev('fd.to_pil', 90, 95), Ev('fd.grid', 95, 98),
        *_busy((22, 23), (32, 45), (56, 70), (82, 84)),
        Ev('aten::copy_', 85, 90),
        # The client between calls, 100-110; call B, 110-150.
        Ev('fd.gen', 110, 150), Ev('fd.denoise', 112, 140),
        Ev('fd.unet', 113, 139), *_busy((114, 138), (141, 149)),
        # Call C, cut at 200: its spans end at the stop, after the last
        # host op (the synchronisation at 195).
        Ev('fd.gen', 160, 200), Ev('fd.generate', 161, 200),
        Ev('fd.denoise', 162, 200), Ev('fd.unet', 163, 190),
        Ev('fd.k1', 165, 170), *_busy((164, 191)),
        Ev('cudaDeviceSynchronize', 191, 195),
    ]


def test_gen_shares_partition_the_hull_idle():
    s = spans.split(gen_events(), spans.GEN)
    # The partial calls at both edges fall outside the hull.
    assert s.hull == (20.0, 150.0)
    idle = spans.length(s.idle)
    # Busy 1 + 13 + 14 + 2 in call A, 24 + 8 in call B.
    assert idle == pytest.approx(130 - 62)
    assert sum(s.layers[k] for k in GEN_SHARES) == pytest.approx(idle)
    assert sum(s.idle_pct(k) for k in GEN_SHARES) == pytest.approx(
        100.0 * idle / 130)
    # Inside fd.unet: 31-32, 45-50, 55-56, 70-75 (A); 113-114, 138-139 (B).
    assert s.layers['unet'] == pytest.approx(1 + 5 + 1 + 5 + 1 + 1)
    # fd.denoise outside fd.unet: 30-31, 50-55, 75-80 (A); 112-113,
    # 139-140 (B).
    assert s.layers['loop'] == pytest.approx(1 + 5 + 5 + 1 + 1)
    # fd.gen outside fd.denoise: 20-22, 23-30, 80-82, 84-100 (A); 110-112,
    # 140-141, 149-150 (B).
    assert s.layers['edge'] == pytest.approx(2 + 7 + 2 + 16 + 2 + 1 + 1)
    assert s.layers['client'] == pytest.approx(10)


def test_a_nested_gap_counts_once_in_the_innermost_layer():
    events = [Ev('fd.gen', 0, 100), Ev('fd.denoise', 10, 90),
              Ev('fd.unet', 20, 80), Ev('fd.unet', 30, 40),
              Ev('fd.k1', 32, 33), *_busy((0, 30), (40, 100)),
              Ev('aten::item', 100, 101)]
    s = spans.split(events, spans.GEN)
    assert s.layers == {'unet': 10.0, 'loop': 0.0, 'edge': 0.0,
                        'client': 0.0}


def test_user_annotation_ranges_are_not_busy():
    plain = spans.split(gen_events(), spans.GEN)
    mirror = Ev('Optimizer.step#AdamW.step', 20, 150, CUDA, annotation=True)
    with_mirror = spans.split(gen_events() + [mirror], spans.GEN)
    assert with_mirror.layers == plain.layers
    assert with_mirror.idle == plain.idle


def test_kernel_launch_us_is_the_mean_inside_the_hull():
    s = spans.split(gen_events(), spans.GEN)
    # fd.k1 33-34 and fd.k6 36-39 in call A; the partial calls' are left
    # out.
    assert s.mean_span_us(spans.KERNEL_SPANS) == pytest.approx(2.0)


def train_events():
    """Two whole steps, the client between them, and the host's read of
    the last loss after the last."""
    out = []
    for t0 in (0, 100):
        out += [Ev('fd.train_step', t0, t0 + 90),
                Ev('fd.lora_merge', t0 + 2, t0 + 10),
                Ev('fd.forward', t0 + 11, t0 + 40),
                Ev('fd.unet', t0 + 12, t0 + 39),
                Ev('fd.backward', t0 + 41, t0 + 80),
                Ev('fd.optimizer', t0 + 80, t0 + 88),
                *_busy((t0 + 5, t0 + 9), (t0 + 13, t0 + 35),
                       (t0 + 45, t0 + 92))]
    return out + [Ev('aten::item', 190, 193)]


def test_train_shares_partition_the_hull_idle():
    s = spans.split(train_events(), spans.TRAIN)
    assert s.hull == (0.0, 190.0)
    idle = spans.length(s.idle)
    assert sum(s.layers[k] for k in TRAIN_SHARES) == pytest.approx(idle)
    # Per step: merge 2-5, 9-10; forward 11-13, 35-40; backward 41-45;
    # optimizer (with the step's lines) 0-2, 10-11, 40-41.
    assert s.layers['merge'] == pytest.approx(2 * 4)
    assert s.layers['forward'] == pytest.approx(2 * 7)
    assert s.layers['backward'] == pytest.approx(2 * 4)
    assert s.layers['optimizer'] == pytest.approx(2 * 4)
    assert s.layers['client'] == pytest.approx(8)   # 92-100


def test_no_spans_no_metric():
    events = [Ev('aten::mm', 0, 10), *_busy((1, 9))]
    assert spans.split(events, spans.GEN) is None
    assert spans.split(gen_events(), spans.TRAIN) is None
    assert spans.from_ctx({}, spans.GEN) is None


def test_interval_algebra():
    a = spans.union([(5, 7), (0, 2), (1, 3), (7, 8)])
    assert a == [(0, 3), (5, 8)]
    assert spans.intersect(a, [(2, 6)]) == [(2, 3), (5, 6)]
    assert spans.subtract(a, [(1, 2), (6, 10)]) == [(0, 1), (2, 3), (5, 6)]


# The tiny cells' runs, their traced parts long enough on the CPU to hold
# whole calls (a 25-step tiny call takes seconds under the profiler).
TRACED = {'tiny21.gen': dict(steps=4, trace_start_s=0.1, trace_stop_s=2.5),
          'tiny.train': dict(trace_start_s=0.1, trace_stop_s=1.5)}


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    root = tiny.make_root(str(tmp_path_factory.mktemp('bench')))
    for cell, params in TRACED.items():
        path = os.path.join(root, 'bench_h100', 'workloads', f'{cell}.json')
        with open(path) as f:
            w = json.load(f)
        w['params'].update(params)
        with open(path, 'w') as f:
            json.dump(w, f)
    return root


@pytest.mark.parametrize('cell,names', [
    ('tiny21.gen', [f'{k}_idle_pct.gen' for k in GEN_SHARES]),
    ('tiny.train', [f'{k}_idle_pct.train' for k in TRAIN_SHARES])])
def test_traced_run_reports_the_span_metrics(root, cell, names):
    rc, last, err = tiny.run_cell(root, cell, seconds=3.0, trace=1)
    assert rc == 0, err[-2000:]
    got = last['metrics']
    assert set(names) <= set(got), sorted(got)
    # No card: the hull is all idle, and the shares are all of it.
    assert sum(got[n]['value'] for n in names) == pytest.approx(100.0)
    assert all(got[n]['unit'] == '%' for n in names)
    # K1 and K6 launch only on a card; on the CPU their metric reads
    # nothing and is left out.
    assert 'kernel_launch_us.gen' not in got
