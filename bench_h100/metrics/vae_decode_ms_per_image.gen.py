"""Device milliseconds per image of the VAE decodes in the profiled part
of the gen window: CUDA events around ``AutoencoderKL``'s decoder."""
from bench_h100 import layers


def read(ctx):
    return layers.device_ms_per_row(ctx, 'vae')
