"""K6's share of its roofline in the serve window's profiled part: every
GroupNorm(+SiLU) of the UNet calls and the decodes, bytes-bound (bf16 read
and written once at 3.35 TB/s), over the device time of the kernels named
in ``layers.K6``; left out unless the calls are the expected count."""
from bench_h100 import layers


def read(ctx):
    return layers.k6_roofline(ctx)
