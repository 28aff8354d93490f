"""Percent of the train hull in which the card was idle while the host was
inside ``fd.backward`` (``loss.backward()``, remat's second forward
included)."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.TRAIN, 'backward')
