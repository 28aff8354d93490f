"""Readers shared by the per-layer metric files (``metrics/<name>.py``).

Each takes the run's layer context: ``traced`` (the profiled part of the
window, :class:`~bench_h100.harness.Traced`), ``probes`` (per-call CUDA
events on the UNet and the VAE decoder inside it), ``steps`` (host spans
of each step of the window with ``step_flops``), ``config``,
``workload`` and ``window``. A reader that finds nothing returns None and
the metric is left out of the line.
"""
from __future__ import annotations

from typing import Optional, Sequence

from bench_h100 import work

# The port's kernels by name (``flexdiffuse_tpu_torch/csrc``); K1's are
# named in its metric files.
K6 = ('gn_resident_kernel', 'gn_stream_stats_kernel',
      'gn_stream_apply_kernel')
K6_CALLS = ('gn_resident_kernel', 'gn_stream_stats_kernel')
K3_K5 = ('flash_fwd_sm90_kernel', 'flash_fwd_kernel',
         'flash_bwd_dq_sm90_kernel', 'flash_bwd_dq_kernel',
         'flash_bwd_dkv_sm90_kernel', 'flash_bwd_dkv_kernel')


def _share(bound_s: float, seconds: float) -> Optional[float]:
    return 100.0 * bound_s / seconds if seconds > 0 and bound_s > 0 \
        else None


def k1_roofline(ctx: dict, kernels: Sequence[str]) -> Optional[float]:
    """K1's share of its roofline over the UNet evaluations of the traced
    part: the bound of each eligible self-attention, from the
    configuration's shapes at the evaluation's batch, over the device
    time of ``kernels``; None unless the launches are the expected count
    (every eligible call one K1)."""
    traced, probe = ctx.get('traced'), ctx.get('probes', {}).get('unet')
    if traced is None or probe is None or not probe.traced_calls():
        return None
    u = ctx['config']['unet']
    bound_s, expected = 0.0, 0
    for c in probe.traced_calls():
        _, hh, ww, _ = c['shape']
        calls = work.unet_flash_calls(u, c['batch'], hh, ww)
        expected += len(calls)
        bound_s += sum(work.bound(*work.k1_work(*x)) for x in calls)
    if traced.kernel_count(kernels) != expected:
        return None
    return _share(bound_s, traced.kernel_seconds(kernels))


def k6_roofline(ctx: dict) -> Optional[float]:
    """K6's share of its roofline over the GroupNorms of the traced part's
    UNet evaluations and decodes (bytes-bound: bf16 in, bf16 out); None
    unless the calls are the expected count."""
    traced = ctx.get('traced')
    probes = ctx.get('probes', {})
    if traced is None or 'unet' not in probes:
        return None
    bound_s, expected = 0.0, 0
    for c in probes['unet'].traced_calls():
        _, hh, ww, _ = c['shape']
        shapes = work.unet_group_norms(ctx['config']['unet'], c['batch'],
                                       hh, ww)
        expected += len(shapes)
        bound_s += sum(work.gn_bound(*s) for s in shapes)
    for c in probes['vae'].traced_calls() if 'vae' in probes else []:
        _, _, hh, ww = c['shape']       # the decoder takes NCHW latents
        shapes = work.vae_decode_group_norms(ctx['config']['vae'],
                                             c['batch'], hh, ww)
        expected += len(shapes)
        bound_s += sum(work.gn_bound(*s) for s in shapes)
    if traced.kernel_count(K6_CALLS) != expected:
        return None
    return _share(bound_s, traced.kernel_seconds(K6))


def device_ms_per_row(ctx: dict, probe_name: str) -> Optional[float]:
    """Milliseconds on the card's clock per row of the probed module's
    calls outside the profiled part (CUDA events before and after each
    call: the call's kernels and any wait for the host between them)."""
    probe = ctx.get('probes', {}).get(probe_name)
    if probe is None:
        return None
    pairs = probe.device_ms(traced=False)
    rows = sum(b for _, b in pairs)
    return sum(ms for ms, _ in pairs) / rows if rows else None


def mfu(ctx: dict) -> Optional[float]:
    """The steps' model FLOPs over their summed wall time, percent of the
    bf16 peak; steps that overlap the profiled part are left out."""
    window, steps = ctx.get('window'), ctx.get('steps') or []
    steps = [s for s in steps
             if window is None or not window.overlaps(s['start'], s['end'])]
    if not steps:
        return None
    flops = ctx['step_flops']
    return work.mfu(sum(flops(s) for s in steps),
                    sum(s['end'] - s['start'] for s in steps))


def device_idle_pct(ctx: dict) -> Optional[float]:
    traced = ctx.get('traced')
    if traced is None or traced.window_s <= 0:
        return None
    return 100.0 * (1.0 - traced.busy_s() / traced.window_s)


def flash_bwd_roofline(ctx: dict) -> Optional[float]:
    """K3, K4 and K5 together over the train steps of the traced part:
    the bound of every launch the step's eligible attentions imply
    (``launches`` per step and kind, from the traffic) over their device
    time; None unless the launches are the expected count."""
    traced = ctx.get('traced')
    steps = ctx.get('traced_steps') or []
    if traced is None or not steps:
        return None
    u = ctx['config']['unet']
    per = ctx['launches']
    bound_s, expected = 0.0, 0
    for s in steps:
        calls = work.unet_flash_calls(u, s['batch'], s['side'], s['side'])
        for kind, fn in (('k3', work.k3_work), ('k4', work.k4_work),
                         ('k5', work.k5_work)):
            expected += per[kind] * len(calls)
            bound_s += per[kind] * sum(work.bound(*fn(*x)) for x in calls)
    if traced.kernel_count(K3_K5) != expected:
        return None
    return _share(bound_s, traced.kernel_seconds(K3_K5))
