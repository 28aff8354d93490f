"""Closed-loop SDXL generation: one client calls ``SDXLRunner.gen`` back to
back, each call one prompt under an optional negative prompt and
``samples`` images made one after the other (a UI's "batch count"), as a
user of SDXL at its native size asks for a few images a prompt.

Params (workload file): ``steps``, ``size``, ``guidance_scale``,
``samples`` (images a call), ``requests`` (the planned list, cycled),
``words`` and ``negative_words`` ``[lo, hi]``, ``negative_share``,
``warmup_steps``, ``trace_start_s``/``trace_stop_s``, ``ref_batch`` (rows a
reference call). Check: ``sample`` calls compared (their every image),
``image_rms`` the limit.

The profiled part of a traced run starts at the first call to start
after ``trace_start_s`` and stops at the end of the first call to end
after ``trace_stop_s``: it holds whole ``gen`` calls, and the calls on
both sides of it are left for the per-call metrics (``mfu.gen``, the UNet
and decode times).

``images_per_s`` is ``closed_loop_gen``'s: every image of the calls
started inside the window over the time from the window's start to the
end of the last of them.
"""
from __future__ import annotations

import sys
import time
from typing import List

import numpy as np
import torch

from bench_h100 import (build, build_sdxl, check, check_sdxl, seeded, work,
                        work_sdxl)
from bench_h100.harness import GIB, Check, ModelProbe, TraceWindow, \
    setup_seconds
from bench_h100.traffic import Outcome, RunContext
from bench_h100.traffic.closed_loop_gen import plan


def make_runner(ctx: RunContext):
    from flexdiffuse_tpu_torch.sdxl_runner import SDXLRunner
    # Looked up first: a program without it fails before any weight is made.
    from_models = SDXLRunner.from_models
    from flexdiffuse_tpu_torch.models.sdxl import SDXLTextEncoder
    from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
    from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
    cfg = ctx.definition.config
    parts = {k: build_sdxl.build_part(cfg, k, ctx.seed, ctx.device)
             for k in build_sdxl.PARTS}
    text = SDXLTextEncoder(parts['text'], parts['text2'],
                           FakeTokenizer(cfg['text']['vocab_size']))
    sc = build.port_config(SchedulerConfig, cfg['scheduler'])
    return from_models(parts['unet'], parts['vae'], text, scheduler=sc.kind,
                       scheduler_config=sc)


def generate(runner, req: dict, p: dict, steps: int) -> List[np.ndarray]:
    images, _ = runner.gen(prompt=req['prompt'],
                           negative_prompt=req['negative'],
                           samples=p['samples'], steps=steps,
                           guidance_scale=p['guidance_scale'],
                           init_size=(p['size'], p['size']), save=False,
                           seed=req['seed'])
    return [np.asarray(im.convert('RGB')) for im in images]


def call_flops(cfg: dict, p: dict):
    """``flops(call)``: the prompt's and the negative's encodes through both
    towers, the UNet at two rows (CFG) for every step of every image, and
    a decode per image."""
    counts = {}

    def flops(_call: dict) -> float:
        if not counts:
            side = p['size'] // build.vae_factor(cfg)
            counts.update(unet=work_sdxl.unet_flops(cfg['unet'], side, side),
                          vae=work.vae_flops(cfg['vae'], side, side),
                          text=work_sdxl.text_flops(cfg))
        n = p['samples']
        return (2 * counts['text'] + n * p['steps'] * 2 * counts['unet'] +
                n * counts['vae'])
    return flops


def noise(seed: int, samples: int, shape, device) -> List[torch.Tensor]:
    """The pipeline's draws of one call: ``samples`` unit fp32 draws of
    ``shape`` in turn from one generator on ``device`` seeded with
    ``seed``."""
    gen = torch.Generator(device).manual_seed(int(seed))
    return [torch.randn(tuple(shape), generator=gen, device=device,
                        dtype=torch.float32) for _ in range(samples)]


def run(ctx: RunContext) -> Outcome:
    p = ctx.definition.workload['params']
    cfg = ctx.definition.config
    reqs = plan(p, ctx.seed)
    runner = make_runner(ctx)
    runner.pipe.schedule(p['steps'])
    generate(runner, reqs[0], p, p['warmup_steps'])
    cuda = ctx.device.type == 'cuda'

    window = TraceWindow(ctx.trace, p['trace_start_s'], p['trace_stop_s'])
    probes = {}
    if ctx.trace:
        probes = {'unet': ModelProbe(runner.pipe.unet, window, 'unet',
                                     False),
                  'vae': ModelProbe(runner.pipe.vae.decoder, window, 'vae',
                                    False)}
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = setup_seconds()
    t_open = time.monotonic()
    window.open(t_open)
    calls, served, failed = [], {}, 0
    i = 0
    while time.monotonic() - t_open < ctx.seconds:
        req = reqs[i % len(reqs)]
        window.at_boundary(True)
        t0 = time.monotonic()
        try:
            served[i] = generate(runner, req, p, p['steps'])
        except Exception as e:  # a failed call is counted, not raised
            failed += 1
            print(f'call failed: {e!r}', file=sys.stderr)
        calls.append({'start': t0, 'end': time.monotonic()})
        window.at_boundary(False)
        i += 1
    elapsed = time.monotonic() - t_open
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_images = p['samples'] * len(served)
    print(f'gen: {i} calls in {elapsed!r} s, each '
          f'{[round(c["end"] - c["start"], 3) for c in calls]}',
          file=sys.stderr)

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
    side = p['size'] // build.vae_factor(cfg)
    shape = (1, side, side, cfg['unet']['in_channels'])
    del runner, served
    check.free_card()

    def compare(control: bool = False) -> List[Check]:
        rows, images = [], []
        for j in chosen:
            req = reqs[j % len(reqs)]
            draws = noise(req['seed'], p['samples'], shape, ctx.device)
            for s in range(p['samples']):
                rows.append({'prompt': req['prompt'],
                             'negative': req['negative'],
                             'noise': draws[s][0]})
                images.append(kept[j][s])
        out = check_sdxl.compare_images(
            cfg, ctx.seed, ctx.device, rows, images, p['steps'],
            p['guidance_scale'], p['size'], p['ref_batch'], c['image_rms'],
            control)
        if failed or not chosen:
            out.append(Check('failed_calls', float(failed), 0.0))
        return out

    metrics = {'images_per_s': n_images / elapsed,
               'peak_mem_gib': peak / GIB, 'setup_s': setup_s}
    layer = {'probes': probes, 'steps': calls,
             'step_flops': call_flops(cfg, p)}
    return Outcome(i, failed, metrics, peak, compare, layer, window)

