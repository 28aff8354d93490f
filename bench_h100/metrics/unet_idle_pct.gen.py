"""Percent of the gen hull (the whole ``Runner.gen`` calls of the profiled
part, ``spans.py``) in which the card was idle while the host was inside
``fd.unet`` (``UNet2DCondition.forward``): the launch-bound share of the
UNet."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.GEN, 'unet')
