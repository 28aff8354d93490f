"""``unet_graph_pct.gen`` (``metrics/unet_graph_pct.gen.py``) on the
synthetic kineto-like events of ``test_bench_spans.py``."""
import pytest

from bench_h100 import harness, spans
from bench_h100.tests import tiny
from bench_h100.tests.test_bench_spans import Ev, _busy, gen_events


def _with_replays(events):
    """``events`` with an ``fd.unet_replay`` inside every ``fd.unet``."""
    return events + [Ev('fd.unet_replay', ev._start / 1000 + 0.1,
                        (ev._start + ev._dur) / 1000 - 0.1)
                     for ev in events if ev.name() == 'fd.unet']


@pytest.mark.parametrize('events,want', [
    (gen_events(), 0.0),
    (_with_replays(gen_events()), 100.0),
    ([Ev('aten::mm', 0, 10), *_busy((1, 9))], None)],
    ids=['no_replay', 'every_call', 'no_hull'])
def test_unet_graph_pct_counts_replayed_unet_calls(events, want):
    read = harness.metric_reader('unet_graph_pct.gen', tiny.REPO)
    ctx = {f'span_split.{spans.GEN[0]}': spans.split(events, spans.GEN)}
    assert read(ctx) == (None if want is None else pytest.approx(want))
