"""Closed-loop generation: one client calls ``Runner.gen`` back to back,
each call a prompt rendered twice (two variants, one noise draw of two
rows) under a negative prompt, as a UI user asks for variants.

Params (workload file): ``steps``, ``size``, ``guidance_scale``,
``variants`` (images a call), ``requests`` (the planned list, cycled),
``words`` and ``negative_words`` ``[lo, hi]``, ``negative_share``,
``warmup_steps``, ``trace_start_s``/``trace_stop_s``, ``ref_batch``
(rows a reference call). Check: ``sample`` calls compared (their every
image), ``image_rms`` the limit.

``images_per_s`` counts every image of the calls started inside the
window over the time from the window's start to the end of the last of
them: no call is cut, so the rule does not depend on where the nominal
end falls.
"""
from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from bench_h100 import build, check, seeded, work
from bench_h100.harness import GIB, Check, ModelProbe, TraceWindow, \
    setup_seconds
from bench_h100.traffic import Outcome, RunContext


def plan(p: dict, seed: int) -> List[dict]:
    n = p['requests']
    r = seeded.rng(seed, 'gen')
    words = seeded.spread(seeded.uniform_ints(n, *p['words']), r)
    n_neg = int(round(n * p['negative_share']))
    neg = seeded.spread([True] * n_neg + [False] * (n - n_neg), r)
    neg_words = seeded.spread(seeded.uniform_ints(n, *p['negative_words']),
                              r)
    return [{'words': int(words[i]), 'prompt': seeded.prompt(r, words[i]),
             'negative': seeded.prompt(r, neg_words[i]) if neg[i] else '',
             'seed': int(r.integers(1, 2**31 - 1))} for i in range(n)]


def make_runner(ctx: RunContext):
    from flexdiffuse_tpu_torch.runner import Runner
    from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
    from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
    cfg = ctx.definition.config
    parts = {k: build.build_part(cfg, k, ctx.seed, ctx.device)
             for k in build.PARTS}
    sc = build.port_config(SchedulerConfig, cfg['scheduler'])
    return Runner.from_models(parts['text'], None, parts['unet'],
                              parts['vae'],
                              FakeTokenizer(cfg['text']['vocab_size']),
                              scheduler=sc.kind, scheduler_config=sc)


def generate(runner, req: dict, p: dict, steps: int):
    images, _ = runner.gen(prompt=[req['prompt']] * p['variants'],
                           negative_prompt=req['negative'], steps=steps,
                           guidance_scale=p['guidance_scale'], samples=1,
                           seed=req['seed'], save=False,
                           init_size=(p['size'], p['size']))
    return [np.asarray(im.convert('RGB')) for im in images]


def step_flops(cfg: dict, p: dict):
    """``flops(call)``: the prompt rows and the negative through the text
    tower, the UNet at twice the variants for every step (CFG), and a
    decode per image."""
    counts = {}

    def flops(s: dict) -> float:
        if not counts:
            side = p['size'] // build.vae_factor(cfg)
            counts.update(unet=work.unet_flops(cfg['unet'], side, side),
                          vae=work.vae_flops(cfg['vae'], side, side),
                          text=work.text_flops(cfg['text']))
        v = p['variants']
        evals = p['steps'] + (cfg['scheduler']['kind'] == 'pndm')
        return ((v + 1) * counts['text'] + evals * 2 * v * counts['unet'] +
                v * counts['vae'])
    return flops


def run(ctx: RunContext) -> Outcome:
    p = ctx.definition.workload['params']
    reqs = plan(p, ctx.seed)
    runner = make_runner(ctx)
    runner.pipe.schedule(p['steps'])
    generate(runner, reqs[0], p, p['warmup_steps'])
    cuda = ctx.device.type == 'cuda'

    window = TraceWindow(ctx.trace, p['trace_start_s'], p['trace_stop_s'])
    probes = {}
    if ctx.trace:
        probes = {'unet': ModelProbe(runner.pipe.unet, window, 'unet', True),
                  'vae': ModelProbe(runner.pipe.vae.decoder, window, 'vae',
                                    False)}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = setup_seconds()
    t_open = time.monotonic()
    window.open(t_open)
    steps, served, failed = [], {}, 0
    i = 0
    while time.monotonic() - t_open < ctx.seconds:
        req = reqs[i % len(reqs)]
        t0 = time.monotonic()
        try:
            served[i] = generate(runner, req, p, p['steps'])
        except Exception as e:  # a failed call is counted, not raised
            failed += 1
            print(f'call failed: {e!r}', file=sys.stderr)
        steps.append({'start': t0, 'end': time.monotonic()})
        i += 1
    elapsed = time.monotonic() - t_open
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_images = p['variants'] * len(served)
    print(f'gen: {i} calls in {elapsed!r} s', file=sys.stderr)

    c = ctx.definition.workload['check']
    ok = sorted(served)
    longest = max(ok, key=lambda j: reqs[j % len(reqs)]['words']) \
        if ok else None
    chosen = [] if longest is None else [
        ok[j] for j in check.pick(len(ok), ok.index(longest), c['sample'],
                                  seeded.rng(ctx.seed, 'sample'))]
    kept = {j: served[j] for j in chosen}
    for probe in probes.values():
        probe.remove()
    side = p['size'] // build.vae_factor(ctx.definition.config)
    shape = (p['variants'], side, side,
             ctx.definition.config['unet']['in_channels'])
    del runner, served
    check.free_card()

    def compare(control: bool = False) -> List[Check]:
        rows, images = [], []
        for j in chosen:
            req = reqs[j % len(reqs)]
            noise = seeded.generator_noise(req['seed'], shape, ctx.device)
            for v in range(p['variants']):
                rows.append({'prompt': req['prompt'],
                             'negative': req['negative'],
                             'noise': noise[v]})
                images.append(kept[j][v])
        out = check.compare_images(
            ctx.definition.config, ctx.seed, ctx.device, rows, images,
            p['steps'], p['guidance_scale'], p['ref_batch'],
            c['image_rms'], control)
        if failed or not chosen:
            out.append(Check('failed_calls', float(failed), 0.0))
        return out

    metrics = {'images_per_s': n_images / elapsed,
               'peak_mem_gib': peak / GIB, 'setup_s': setup_s}
    layer = {'probes': probes, 'steps': steps,
             'step_flops': step_flops(ctx.definition.config, p)}
    return Outcome(i, failed, metrics, peak, compare, layer, window)
