"""Percent of the gen hull in which the card was idle while the host was
inside ``fd.gen`` (``Runner.gen``) but outside ``fd.denoise``: the prompt
encodes, the decode, the copy to the host, the PIL images, the grid."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.GEN, 'edge')
