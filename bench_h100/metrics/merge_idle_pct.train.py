"""Percent of the train hull (the whole train steps of the profiled part,
``spans.py``) in which the card was idle while the host was inside
``fd.lora_merge`` (``merge_lora_params``)."""
from bench_h100 import spans


def read(ctx):
    return spans.idle_pct(ctx, spans.TRAIN, 'merge')
