"""Percent of the gen hull in which the card was idle while the host was
inside ``fd.denoise`` (the denoise loop of ``FlexPipeline._call``) but
outside ``fd.unet``: timestep and input scaling, the CFG combine,
``fd.scheduler``."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.GEN, 'loop')
