"""The serve steps' model FLOPs (counted once on the reference, on the meta
device) over their summed wall time, as a percent of the card's bf16 peak
of 989 TFLOP/s; steps overlapping the profiled part are left out."""
from bench_h100 import layers


def read(ctx):
    return layers.mfu(ctx)
