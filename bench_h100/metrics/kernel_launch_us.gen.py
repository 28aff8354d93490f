"""Mean host microseconds of a K1 or K6 launch in the gen hull: the
``fd.k1`` and ``fd.k6`` spans of the kernel wrappers (checks, allocation,
plan, the ctypes call), summed over their count."""
from bench_h100 import spans


def read(ctx):
    s = spans.from_ctx(ctx, spans.GEN)
    return None if s is None else s.mean_span_us(spans.KERNEL_SPANS)
