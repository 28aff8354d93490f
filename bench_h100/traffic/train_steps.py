"""LoRA train steps: ``make_lora_train_step`` + ``make_optimizer`` over the
frozen bf16 UNet, fed batches of a seeded on-device encoded dataset
(latents and text contexts) in an order drawn from the seed; each step's
timesteps and noise come from the step's generator.

Params (workload file): ``batch``, ``side`` (latent side), ``rank``,
``include_ff``, ``remat``, ``learning_rate``, ``weight_decay``,
``max_grad_norm``, ``dataset_rows``, ``trace_start_s``/``trace_stop_s``,
``ref_block`` (rows a reference block). Check limits: ``loss1_rel``,
``grad_norm_gap``, ``update_norm_gap``.

Set-up builds the step once and drives it through its first three steps
(also its warm-up); the window then continues the same step object. The
reference follows those three steps: the first step's loss, its
gradient as the optimizer received it (from its first moment after one
step: m₁ = (1 − β₁)·g), and the factors' change after three steps, by the
worst leaf. ``train_images_per_s`` counts the rows of every step started
inside the window over the time to the end of the last of them.
"""
from __future__ import annotations

import math
import sys
import time
from typing import Dict, List

import torch

from bench_h100 import build, check, seeded, work
from bench_h100.harness import GIB, Check, TraceWindow, setup_seconds
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import train as ref_train
from bench_h100.traffic import Outcome, RunContext

CHECKED_STEPS = 3
# K3, K4, K5 launches per eligible attention and train step: remat
# 'dots' and 'full' run the forward again in the backward (K3 twice).
LAUNCHES = {'none': {'k3': 1, 'k4': 1, 'k5': 1},
            'dots': {'k3': 2, 'k4': 1, 'k5': 1},
            'full': {'k3': 2, 'k4': 1, 'k5': 1}}


def dataset(cfg: dict, p: dict, seed: int, device):
    """``(latents [N, s, s, C], contexts [N, 77, D], order)``: unit
    normals from the seed, and the rows' order."""
    gen = torch.Generator(device).manual_seed(seeded.derive(seed, 'data'))
    n, s = p['dataset_rows'], p['side']
    lat = torch.randn((n, s, s, cfg['unet']['in_channels']), generator=gen,
                      device=device)
    ctx = torch.randn((n, 77, cfg['unet']['cross_attention_dim']),
                      generator=gen, device=device)
    order = seeded.rng(seed, 'order').permutation(n).tolist()
    return lat, ctx, order


def factor_values(targets: Dict[str, tuple], rank: int, seed: int,
                  device) -> Dict[str, Dict[str, torch.Tensor]]:
    """LoRA factors by module: ``down`` unit normal / rank, ``up`` zero
    (the merge starts as the identity)."""
    gen = torch.Generator(device).manual_seed(seeded.derive(seed, 'lora'))
    out = {}
    for name in sorted(targets):
        n_out, n_in = targets[name]
        out[name] = {'down': torch.randn((rank, n_in), generator=gen,
                                         device=device) / rank,
                     'up': torch.zeros((n_out, rank), device=device)}
    return out


def batch_rows(order: List[int], k: int, b: int) -> List[int]:
    """Rows of the ``k``-th batch (cycling through ``order``)."""
    n = len(order)
    return [order[(k * b + j) % n] for j in range(b)]


def run(ctx: RunContext) -> Outcome:
    from flexdiffuse_tpu_torch import training
    cfg = ctx.definition.config
    p = ctx.definition.workload['params']
    dev = ctx.device
    unet = build.build_part(cfg, 'unet', ctx.seed, dev)
    targets = ref_train.lora_targets(build.port_spec(
        build.factories(cfg)['unet']))
    factors = training.init_lora(unet, rank=p['rank'],
                                 include_ff=p['include_ff'])
    if set(factors) != set(targets):
        raise ValueError('the port and the reference adapt different '
                         f'modules: {sorted(set(factors) ^ set(targets))}')
    init = factor_values(targets, p['rank'], ctx.seed, dev)
    with torch.no_grad():
        for name, f in factors.items():
            for k in ('down', 'up'):
                f[k].copy_(init[name][k])
    tc = training.TrainConfig(
        learning_rate=p['learning_rate'], weight_decay=p['weight_decay'],
        max_grad_norm=p['max_grad_norm'], remat=p['remat'],
        prediction_type=cfg['scheduler']['prediction_type'])
    step, opt = training.make_lora_train_step(unet, factors, tc)
    lat, ctxs, order = dataset(cfg, p, ctx.seed, dev)
    gen = torch.Generator(dev).manual_seed(seeded.derive(ctx.seed, 'steps'))
    b = p['batch']
    leaves = {(n, k): f[k] for n, f in factors.items() for k in ('down',
                                                                 'up')}
    counter = {'k': 0}

    def one_step() -> float:
        rows = torch.tensor(batch_rows(order, counter['k'], b), device=dev)
        counter['k'] += 1
        return float(step(lat[rows], ctxs[rows], generator=gen))

    losses, first_m = [], None
    for k in range(CHECKED_STEPS):
        losses.append(one_step())
        if k == 0:
            # AdamW's first moment after one step, (1 − β₁)·g; none if
            # the optimizer never stepped.
            first_m = {key: opt.adamw.state.get(t, {}).get(
                'exp_avg', torch.zeros_like(t)).detach().clone()
                for key, t in leaves.items()}
    after = {key: t.detach().clone() for key, t in leaves.items()}
    cuda = dev.type == 'cuda'

    window = TraceWindow(ctx.trace, p['trace_start_s'], p['trace_stop_s'])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = setup_seconds()
    t_open = time.monotonic()
    window.open(t_open)
    steps, traced_steps, failed = [], [], 0
    while time.monotonic() - t_open < ctx.seconds:
        window.at_boundary(True)
        running = window.running
        t0 = time.monotonic()
        try:
            value = one_step()
            if not math.isfinite(value):
                failed += 1
        except Exception as e:  # a failed step is counted, not raised
            failed += 1
            print(f'step failed: {e!r}', file=sys.stderr)
        steps.append({'start': t0, 'end': time.monotonic()})
        if running:
            traced_steps.append({'batch': b, 'side': p['side']})
        window.at_boundary(False)
    elapsed = time.monotonic() - t_open
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f'train: {len(steps)} steps in {elapsed!r} s, losses of the '
          f'checked steps {losses}', file=sys.stderr)
    del step, opt, unet, factors, leaves, lat, ctxs
    check.free_card()

    def compare(control: bool = False) -> List[Check]:
        return reference_check(ctx, p, losses, first_m, after, init,
                               targets, control)

    metrics = {'train_images_per_s': b * len(steps) / elapsed,
               'peak_mem_gib': peak / GIB, 'setup_s': setup_s}
    layer = {'steps': steps, 'traced_steps': traced_steps,
             'launches': LAUNCHES[p['remat']],
             'step_flops': step_flops(cfg, p)}
    return Outcome(len(steps), failed, metrics, peak, compare, layer, window)


def step_flops(cfg: dict, p: dict):
    """``flops(step)``: the reference's forward and backward of one LoRA
    step at the batch, counted on the meta device (remat's recomputation
    is not model work and is not counted)."""
    counts = {}

    def flops(_s: dict) -> float:
        if not counts:
            counts['step'] = train_step_flops(cfg, p)
        return counts['step']
    return flops


def train_step_flops(cfg: dict, p: dict) -> float:
    meta = torch.device('meta')
    rec = ref_ops.Recorder()
    targets = ref_train.lora_targets(build.port_spec(
        build.factories(cfg)['unet']))
    factors = {n: {'down': torch.empty((p['rank'], i), device=meta,
                                       requires_grad=True),
                   'up': torch.empty((o, p['rank']), device=meta,
                                     requires_grad=True)}
               for n, (o, i) in targets.items()}
    ops = ref_train.LoraOps(rec, factors)
    b, s, u = p['batch'], p['side'], cfg['unet']
    return work.count_flops(lambda: ref_train.loss(
        ops, cfg, torch.empty((b, s, s, u['in_channels']), device=meta),
        torch.empty((b, 77, u['cross_attention_dim']), device=meta),
        torch.zeros((b,), dtype=torch.long, device=meta),
        torch.empty((b, s, s, u['in_channels']), device=meta), b))


def reference_steps(ctx: RunContext, p: dict, init: dict,
                    precision: str) -> dict:
    """The reference's first three steps from the same weights, factors,
    rows and draws: each step's loss, the first step's clipped gradient
    norm and the factors' change after the three, by leaf."""
    cfg = ctx.definition.config
    dev = ctx.device
    w = build.reference_weights(cfg, 'unet', ctx.seed, dev)
    factors = {n: {k: v.clone().requires_grad_(True) for k, v in f.items()}
               for n, f in init.items()}
    keys = [(n, k) for n in sorted(factors) for k in ('down', 'up')]
    ops = ref_train.LoraOps(ref_ops.Weights(w), factors, precision)
    opt = ref_train.AdamW([factors[n][k] for n, k in keys],
                          p['learning_rate'], 0.9, 0.999, 1e-8,
                          p['weight_decay'], p['max_grad_norm'])
    lat, ctxs, order = dataset(cfg, p, ctx.seed, dev)
    gen = torch.Generator(dev).manual_seed(seeded.derive(ctx.seed, 'steps'))
    b = p['batch']
    losses, grads0 = [], None
    with ref_ops.exact_fp32():
        for k in range(CHECKED_STEPS):
            rows = torch.tensor(batch_rows(order, k, b), device=dev)
            x = lat[rows]
            t, noise = ref_train.draw_t_noise(
                gen, b, x.shape, cfg['scheduler']['num_train_timesteps'],
                dev)
            parts = ref_train.loss(ops, cfg, x, ctxs[rows], t, noise,
                                   p['ref_block'])
            losses.append(float(sum(parts)))
            grads = opt.step()
            if k == 0:
                grads0 = {key: _norm(g) for key, g in zip(keys, grads)}
    delta = {key: _norm(factors[key[0]][key[1]].detach() -
                        init[key[0]][key[1]]) for key in keys}
    del w, ops, opt, factors
    check.free_card()
    return {'losses': losses, 'grad': grads0, 'delta': delta}


def _norm(t: torch.Tensor) -> float:
    return float(t.double().norm())


def gaps(a: dict, r: dict, c: dict, prefix: str = '') -> List[Check]:
    """Side ``a`` against the reference ``r``: the first step's relative
    loss gap, the worst leaf's gap of first-gradient norms and of change
    norms. The later steps' loss gaps are printed, not compared: they
    follow the first update through a merge ``W + up·down`` that the
    program rounds to bf16, where an update of 1e-4 lies below the
    spacing of the weights (PERF.md)."""
    rel = [abs(x - y) / abs(y) for x, y in zip(a['losses'], r['losses'])]
    print(f'{prefix}loss gaps by step {rel}', file=sys.stderr)
    return [Check(prefix + 'loss1_rel', rel[0], c['loss1_rel']),
            Check(prefix + 'grad_norm_gap',
                  ref_train.leaf_gap(a['grad'], r['grad']),
                  c['grad_norm_gap']),
            Check(prefix + 'update_norm_gap',
                  ref_train.leaf_gap(a['delta'], r['delta']),
                  c['update_norm_gap'])]


def reference_check(ctx: RunContext, p: dict, losses: List[float],
                    first_m: dict, after: dict, init: dict,
                    targets: Dict[str, tuple], control: bool) -> List[Check]:
    """The program's three steps against the fp32 reference's; with
    ``control`` also the reference with fp8 operands in the program's
    place (``control_*``)."""
    c = ctx.definition.workload['check']
    prog = {'losses': losses,
            'grad': {key: _norm(m) / (1.0 - 0.9)
                     for key, m in first_m.items()},
            'delta': {key: _norm(after[key] - init[key[0]][key[1]])
                      for key in after}}
    ref = reference_steps(ctx, p, init, 'fp32')
    print(f'train check: losses {losses} reference {ref["losses"]}',
          file=sys.stderr)
    out = gaps(prog, ref, c)
    if control:
        low = reference_steps(ctx, p, init, 'fp8')
        print(f'train control: losses {low["losses"]}', file=sys.stderr)
        out += gaps(low, ref, c, 'control_')
    return out
