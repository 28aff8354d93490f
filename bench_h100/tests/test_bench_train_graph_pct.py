"""``train_graph_pct.train`` (``metrics/train_graph_pct.train.py``) on the
synthetic kineto-like events of ``test_bench_spans.py``."""
import pytest

from bench_h100 import harness, spans
from bench_h100.tests import tiny
from bench_h100.tests.test_bench_spans import Ev, _busy, train_events


def _with_replays(events):
    """``events`` with an ``fd.train_replay`` inside every
    ``fd.train_step``."""
    return events + [Ev('fd.train_replay', ev._start / 1000 + 0.1,
                        (ev._start + ev._dur) / 1000 - 0.1)
                     for ev in events if ev.name() == 'fd.train_step']


@pytest.mark.parametrize('events,want', [
    (train_events(), 0.0),
    (_with_replays(train_events()), 100.0),
    ([Ev('aten::mm', 0, 10), *_busy((1, 9))], None)],
    ids=['no_replay', 'every_step', 'no_hull'])
def test_train_graph_pct_counts_replayed_steps(events, want):
    read = harness.metric_reader('train_graph_pct.train', tiny.REPO)
    ctx = {f'span_split.{spans.TRAIN[0]}': spans.split(events, spans.TRAIN)}
    assert read(ctx) == (None if want is None else pytest.approx(want))
