"""K1's share of its roofline in the SDXL window's profiled part: the
bound of every self-attention the dispatcher sends to the flash kernel
(4·B·H·S²·D operations at 989 TFLOP/s; q, k, v, o once at 3.35 TB/s), 70 a
UNet call at SDXL base's depths (10 at 4096 tokens, 60 at 1024), from the
configuration's shapes at each call's batch, over the device time of the
kernels named here; left out unless their launches equal that count."""
from bench_h100 import layers_xl

KERNELS = ('flash_fwd_sm90_kernel', 'flash_fwd_kernel')


def read(ctx):
    return layers_xl.k1_roofline(ctx, KERNELS)
