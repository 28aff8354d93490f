"""The flash backward kernels' share of their roofline (K3's forward with
the log-sum-exp, K4's dq, K5's dk/dv together) over the train steps of the
profiled part: 4, 6 and 8·B·H·S²·D operations per launch at 989 TFLOP/s,
or their operands once at 3.35 TB/s, over the kernels' device time; left
out unless the launches are the expected count."""
from bench_h100 import layers


def read(ctx):
    return layers.flash_bwd_roofline(ctx)
