"""Rows per dispatch of the serving micro-batcher over the window:
``serving/batcher.py`` ``stats()`` ``rows / batches``, the counters'
change from the window's start to its close. Moves ``latency_p90_s``."""


def read(ctx):
    b = ctx.get('batcher')
    if not b or not b['batches']:
        return None
    return b['rows'] / b['batches']
