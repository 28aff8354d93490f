"""Percent of the UNet calls in the gen hull (``spans.py``) that replayed a
CUDA graph: the ``fd.unet_replay`` spans (``models/unet_graph.py``) over
the ``fd.unet`` spans (every ``UNet2DCondition.forward``). A program
without the graphs has no ``fd.unet_replay`` span and reads 0."""
from bench_h100 import spans


def read(ctx):
    s = spans.from_ctx(ctx, spans.GEN)
    calls = None if s is None else len(s.spans.get('fd.unet', []))
    if not calls:
        return None
    return 100.0 * len(s.spans.get('fd.unet_replay', [])) / calls
