"""Percent of the train hull in which the card was idle while the host was
inside ``fd.forward`` (``diffusion_loss``: the noising and the UNet's
forward)."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.TRAIN, 'forward')
