"""Open-loop serving: independent users send text-to-image requests to
``GenerationService.generate`` (in process, no HTTP) on a schedule that
does not wait for answers.

Params (workload file): ``rate_per_s``, ``arrival_seed``; ``steps``, ``size``,
``guidance_scale``; ``words`` ``[lo, hi]`` (prompt lengths, spread evenly
over the requests); ``negative_share`` (requests with a negative prompt);
``negative_words`` ``[lo, hi]``; the service's ``max_batch_rows`` and
``max_wait_ms``; ``warmup_steps``; ``drain_s`` (how long past the window
an answer is awaited); ``threads`` (callers in flight at most);
``trace_start_s``/``trace_stop_s`` (the traced part of the window);
``ref_batch`` (requests per reference call). Check: ``sample`` requests
compared, ``image_rms`` the limit.

The gaps between arrivals are evenly spaced quantiles of the exponential
at the rate, in an order drawn from the mix's ``arrival_seed``: one
replayed Poisson trace, the same for every seed. Every seed gets the same
multiset of prompt lengths and negative prompts in an order it draws; the
words and the requests' seeds differ.

``served_images_per_s`` counts each dispatch's requests in proportion to
the part of its span inside the window (:func:`window_images`). A
request's latency runs from when it was due to when ``generate``
returned; one that fails or does not return within ``drain_s`` counts as
missing (infinite latency) and makes the run not correct.
"""
from __future__ import annotations

import concurrent.futures as cf
import sys
import threading
import time
from typing import List

import numpy as np
import torch

from bench_h100 import build, check, seeded, work
from bench_h100.harness import GIB, Check, ModelProbe, TraceWindow, \
    nearest_rank, setup_seconds
from bench_h100.traffic import Outcome, RunContext


def schedule(p: dict, seed: int, seconds: float) -> List[dict]:
    n = max(1, int(round(p['rate_per_s'] * seconds)))
    # The arrival pattern is the mix's own, the same for every seed (a
    # replayed Poisson trace); prompts, negatives and noise are the seed's.
    gaps = seeded.spread(seeded.exp_quantiles(n, 1.0 / p['rate_per_s']),
                         seeded.rng(p['arrival_seed'], 'arrivals'))
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    r = seeded.rng(seed, 'serve')
    words = seeded.spread(seeded.uniform_ints(n, *p['words']), r)
    n_neg = int(round(n * p['negative_share']))
    neg = seeded.spread([True] * n_neg + [False] * (n - n_neg), r)
    neg_words = seeded.spread(seeded.uniform_ints(n, *p['negative_words']),
                              r)
    out = []
    for i in range(n):
        out.append({
            'due': float(due[i]), 'words': int(words[i]),
            'prompt': seeded.prompt(r, int(words[i])),
            'negative': seeded.prompt(r, int(neg_words[i])) if neg[i]
            else '',
            'seed': int(r.integers(1, 2**31 - 1))})
    return out


def make_service(ctx: RunContext):
    from flexdiffuse_tpu_torch.runner import Runner
    from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
    from flexdiffuse_tpu_torch.serving.api import GenerationService
    from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
    cfg = ctx.definition.config
    p = ctx.definition.workload['params']
    parts = {k: build.build_part(cfg, k, ctx.seed, ctx.device)
             for k in build.PARTS}
    sc = build.port_config(SchedulerConfig, cfg['scheduler'])
    runner = Runner.from_models(parts['text'], None, parts['unet'],
                                parts['vae'],
                                FakeTokenizer(cfg['text']['vocab_size']),
                                scheduler=sc.kind, scheduler_config=sc)
    return GenerationService(runner, max_batch_rows=p['max_batch_rows'],
                             max_wait_ms=p['max_wait_ms']), runner


def dispatch_flops(cfg: dict, p: dict):
    """``flops(dispatch)``: the UNet at twice the padded rows (CFG) for
    every evaluation of the loop (PLMS: steps + 1), the decode of every
    padded row, and two text encodes (prompt, negative) a request."""
    counts = {}

    def flops(d: dict) -> float:
        if not counts:
            lat = p['size'] // build.vae_factor(cfg)
            counts.update(unet=work.unet_flops(cfg['unet'], lat, lat),
                          vae=work.vae_flops(cfg['vae'], lat, lat),
                          text=work.text_flops(cfg['text']))
        evals = p['steps'] + (cfg['scheduler']['kind'] == 'pndm')
        return (evals * 2 * d['rows'] * counts['unet'] +
                d['rows'] * counts['vae'] + 2 * d['requests'] * counts['text'])
    return flops


def window_images(dispatches: List[dict], t_open: float,
                  seconds: float) -> float:
    """Images answered in the window ``[t_open, t_open + seconds]``: each
    dispatch's requests in proportion to the part of its span inside it,
    so a dispatch cut by the window's edge counts by its share."""
    t_close = t_open + seconds
    total = 0.0
    for d in dispatches:
        inside = min(d['end'], t_close) - max(d['start'], t_open)
        if inside > 0:
            total += d['requests'] * inside / (d['end'] - d['start'])
    return total


def _payload(req: dict, p: dict, steps: int) -> dict:
    return {'prompt': req['prompt'], 'negative_prompt': req['negative'],
            'steps': steps, 'width': p['size'], 'height': p['size'],
            'guidance_scale': p['guidance_scale'], 'seed': req['seed'],
            'samples': 1}


def warm(service, p: dict, pool: cf.Executor) -> None:
    """One dispatch at every padded row count the window can use (1, 2,
    4, …, ``max_batch_rows``), ``warmup_steps`` steps each."""
    rows = 1
    while rows <= p['max_batch_rows']:
        reqs = [{'prompt': 'warm up', 'negative': '', 'seed': 1 + i}
                for i in range(rows)]
        futs = [pool.submit(service.generate,
                            _payload(q, p, p['warmup_steps']))
                for q in reqs]
        for f in futs:
            f.result()
        rows *= 2


def drive(service, reqs: List[dict], p: dict, seconds: float,
          pool: cf.Executor, window: TraceWindow = None):
    """Send ``reqs`` at their due times from one thread, each answered on
    a caller thread of ``pool``; wait ``drain_s`` past the window for the
    last answers. Returns (per request ``(latency, png, error)`` or None
    if it never came, the generator's largest lateness, the window's
    start on the monotonic clock)."""
    done = [None] * len(reqs)
    lock = threading.Lock()

    def call(i: int, t_due: float):
        try:
            res = service.generate(_payload(reqs[i], p, p['steps']))
            out = (time.monotonic() - t_due, res['images'][0], None)
        except Exception as e:  # a failed request is recorded, not raised
            out = (float('inf'), None, repr(e))
        with lock:
            done[i] = out

    t_open = time.monotonic()
    if window is not None:
        window.open(t_open)
    late = 0.0
    futs = []
    for i, q in enumerate(reqs):
        t_due = t_open + q['due']
        wait = t_due - time.monotonic()
        if wait > 0:
            time.sleep(wait)
        late = max(late, time.monotonic() - t_due)
        futs.append(pool.submit(call, i, t_due))
    rest = t_open + seconds + p['drain_s'] - time.monotonic()
    cf.wait(futs, timeout=max(0.0, rest))
    with lock:
        return list(done), late, t_open


def run(ctx: RunContext) -> Outcome:
    p = ctx.definition.workload['params']
    reqs = schedule(p, ctx.seed, ctx.seconds)
    service, runner = make_service(ctx)
    runner.pipe.schedule(p['steps'])
    pool = cf.ThreadPoolExecutor(max_workers=p['threads'])
    warm(service, p, pool)
    cuda = ctx.device.type == 'cuda'

    window = TraceWindow(ctx.trace, p['trace_start_s'], p['trace_stop_s'])
    probes = {}
    if ctx.trace:
        probes = {'unet': ModelProbe(runner.pipe.unet, window, 'unet', True),
                  'vae': ModelProbe(runner.pipe.vae.decoder, window, 'vae',
                                    False)}
    dispatches = []
    run_batch = service.batcher._run

    def timed_batch(payloads, total_rows):
        t0 = time.monotonic()
        out = run_batch(payloads, total_rows)
        dispatches.append({'requests': len(payloads), 'rows': total_rows,
                           'start': t0, 'end': time.monotonic()})
        return out
    service.batcher._run = timed_batch

    stats0 = service.batcher.stats()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = setup_seconds()
    results, late, t_open = drive(service, reqs, p, ctx.seconds, pool,
                                  window)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stats1 = service.batcher.stats()
    lat = [r[0] if r is not None else float('inf') for r in results]
    failed = sum(1 for v in lat if v == float('inf'))
    for r in results:
        if r is not None and r[2] is not None:
            print(f'request failed: {r[2]}', file=sys.stderr)
    print(f'serve: {len(reqs)} requests, p50 {nearest_rank(lat, 0.5)!r} s, '
          f'generator late by at most {late!r} s', file=sys.stderr)

    c = ctx.definition.workload['check']
    ok = [i for i, r in enumerate(results) if r is not None and r[1]]
    longest = max(ok, key=lambda i: reqs[i]['words']) if ok else None
    chosen = [] if longest is None else [
        ok[j] for j in check.pick(len(ok), ok.index(longest), c['sample'],
                                  seeded.rng(ctx.seed, 'sample'))]
    served = {i: check.png_to_array(results[i][1]) for i in chosen}
    for probe in probes.values():
        probe.remove()
    service.batcher.shutdown()
    pool.shutdown(wait=False)
    side = p['size'] // build.vae_factor(ctx.definition.config)
    shape = (side, side, ctx.definition.config['unet']['in_channels'])
    del service, runner, results
    check.free_card()

    def compare(control: bool = False) -> List[Check]:
        rows = [{'prompt': reqs[i]['prompt'], 'negative': reqs[i]['negative'],
                 'noise': seeded.row_noise(reqs[i]['seed'], 0, shape,
                                           ctx.device)} for i in chosen]
        out = check.compare_images(
            ctx.definition.config, ctx.seed, ctx.device, rows,
            [served[i] for i in chosen], p['steps'], p['guidance_scale'],
            p['ref_batch'], c['image_rms'], control)
        if failed or not chosen:
            out.append(Check('failed_requests', float(failed), 0.0))
        return out

    metrics = {'latency_p90_s': nearest_rank(lat, 0.9),
               'served_images_per_s': window_images(dispatches, t_open,
                                             ctx.seconds) / ctx.seconds,
               'peak_mem_gib': peak / GIB, 'setup_s': setup_s}
    layer = {'probes': probes, 'steps': dispatches, 'latencies': lat,
             'step_flops': dispatch_flops(ctx.definition.config, p),
             'batcher': {k: stats1[k] - stats0[k]
                         for k in ('requests', 'batches', 'rows',
                                   'padded_rows')}}
    return Outcome(len(reqs), failed, metrics, peak, compare, layer, window)
