"""K1's share of its roofline in the gen window's profiled part: the
bound of every self-attention the dispatcher sends to the flash kernel
(4·B·H·S²·D operations at 989 TFLOP/s; q, k, v, o once at 3.35 TB/s),
from the configuration's shapes at each UNet call's batch, over the device
time of the kernels named here; left out unless their launches are one
per eligible call."""
from bench_h100 import layers

KERNELS = ('flash_fwd_sm90_kernel', 'flash_fwd_kernel')


def read(ctx):
    return layers.k1_roofline(ctx, KERNELS)
