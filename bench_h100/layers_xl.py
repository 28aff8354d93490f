"""Readers of the SDXL cell's own per-layer metrics (``metrics/
<name>.xl.py``): the two readings that differ from SD's. Its other
metrics are the gen cell's readers (``layers.py``, ``spans.py``).

- :data:`XL`: the gen cell's layers with the prompt encodes as one of
  their own (``fd.encode``, the SDXL towers' spans), innermost first.
- :func:`k1_roofline`: ``layers.k1_roofline`` with the per-level count of
  ``work_sdxl.unet_flash_calls``.
"""
from __future__ import annotations

from typing import Optional, Sequence

from bench_h100 import harness, layers, spans, work, work_sdxl

XL = ('fd.gen', (('encode', ('fd.encode',)),
                 ('unet', ('fd.unet',)),
                 ('loop', ('fd.denoise',)),
                 ('edge', ('fd.gen',))))


def split(ctx: dict) -> Optional[spans.Split]:
    """:func:`spans.split` of the traced part by :data:`XL`, computed once a
    run and kept in the layer context."""
    if 'span_split.xl' not in ctx:
        window = ctx.get('window')
        prof = getattr(window, 'prof', None)
        ctx['span_split.xl'] = None if prof is None or \
            getattr(window, 'state', None) != 'done' else \
            spans.split(harness._kineto_events(prof), XL)
    return ctx['span_split.xl']


def k1_roofline(ctx: dict, kernels: Sequence[str]) -> Optional[float]:
    """K1's share of its roofline over the traced part's UNet evaluations,
    from the per-level count; None unless the launches equal it."""
    traced, probe = ctx.get('traced'), ctx.get('probes', {}).get('unet')
    if traced is None or probe is None or not probe.traced_calls():
        return None
    u = ctx['config']['unet']
    bound_s, expected = 0.0, 0
    for c in probe.traced_calls():
        _, hh, ww, _ = c['shape']
        calls = work_sdxl.unet_flash_calls(u, c['batch'], hh, ww)
        expected += len(calls)
        bound_s += sum(work.bound(*work.k1_work(*x)) for x in calls)
    if traced.kernel_count(kernels) != expected:
        return None
    return layers._share(bound_s, traced.kernel_seconds(kernels))
