"""Percent of the gen hull in which the card was idle while the host was
outside every ``fd.gen``: the benchmark's own client between calls."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.GEN, 'client')
