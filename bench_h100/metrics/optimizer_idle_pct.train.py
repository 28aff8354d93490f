"""Percent of the train hull in which the card was idle while the host was
inside ``fd.optimizer`` (the gradient sync, clipping and AdamW), or inside
``fd.train_step`` outside its merge, forward and backward (the step's own
lines, a few microseconds of Python a step)."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.TRAIN, 'optimizer')
