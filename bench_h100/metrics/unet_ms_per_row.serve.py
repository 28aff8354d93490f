"""Device milliseconds per UNet row in the profiled part of the serve
window: CUDA events recorded by forward pre- and post-hooks on the UNet,
summed over its calls, over the rows of their batches (CFG rows count)."""
from bench_h100 import layers


def read(ctx):
    return layers.device_ms_per_row(ctx, 'unet')
