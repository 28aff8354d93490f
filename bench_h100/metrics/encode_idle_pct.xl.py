"""Percent of the SDXL gen hull in which the card was idle while the host
was inside ``fd.encode`` (``SDXLTextEncoder.encode``: the CLIP-L and bigG
towers, the tokenizer, the ids' copy to the card). A program without the
span reads nothing."""
from bench_h100 import layers_xl


def read(ctx):
    s = layers_xl.split(ctx)
    if s is None or not s.spans.get('fd.encode'):
        return None
    return s.idle_pct('encode')
