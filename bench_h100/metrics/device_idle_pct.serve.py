"""Percent of the profiled part of the serve window in which no operation
ran on the card: 1 − (union of the device intervals) / window."""
from bench_h100 import layers


def read(ctx):
    return layers.device_idle_pct(ctx)
