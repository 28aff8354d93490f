"""Percent of the train hull in which the card was idle while the host was
outside every ``fd.train_step``: the benchmark's ``float(loss)`` and its
row gather between steps."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.TRAIN, 'client')
