#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-train 3 [--profile-out DIR]

The second form skips the smoke test and profiles train steps instead
(``profile_training``). The first:

Inference (the first slice):

1. Prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions and the TF32 settings.
2. Builds both kernel libraries at once, one ``nvcc`` per source:
   ``flexdiffuse_tpu_torch/csrc/flash_attention.cu`` (K1, and K3 as its
   lse instantiation) and ``csrc/flash_backward.cu`` (K4, K5); prints the
   seconds of each.
3. Holds K1 against the fp32 plain attention on the same bf16 inputs at six
   shapes. A shape passes when the kernel's max|Δ| to the fp32 reference is
   at most twice the bf16 plain version's max|Δ| to it, plus
   1e-3·max|ref| (bf16 rounds the output and P; the slack covers the
   kernel's different summation order). Prints both errors, and the
   kernel's, the plain version's and ``scaled_dot_product_attention``'s
   times at the two main-path shapes.
4. Builds SD-1.4 geometry (CLIP ViT-L/14 text and vision towers, the SD-1.4
   UNet and VAE) with seeded random weights on the card in bf16, and checks
   one UNet evaluation through the kernel against the same evaluation with
   plain attention.
5. Drives ``Runner.gen`` — txt2img at 512² with a synthetic guide image,
   PNDM, 25 steps, CFG 8 — then one img2img ``gen`` at strength 0.6.
6. Asserts 512×512 uint8 images, finite latents and ε, and exactly 10 K1
   launches and no K3/K4/K5 launch per UNet evaluation; prints steps/s and
   end-to-end seconds.

Training (the second slice):

7. Holds K3 (``o`` and ``lse``), K4 (``dq``) and K5 (``dk``, ``dv``) against
   their fp32 plain twins on the same bf16 inputs at five shapes, by step
   3's rule (``lse``: 1e-3 absolute); at the two training shapes prints the
   kernels', the twins' and ``scaled_dot_product_attention``'s forward and
   backward times.
8. One LoRA train step's loss and factor gradients at SD-1.4 width (512²,
   batch 4, injected timesteps and noise) through the kernels against the
   same step with plain attention: max|Δg|/max|g| ≤ 5e-2.
9. Encodes 8 synthetic 512² images (VAE encoder) and their captions (CLIP
   text) into an ``EncodedDataset`` on the card.
10. ``train_lora`` for 10 steps (rank 8, batch 4, remat 'none') on the bf16
    UNet, then ``train_full`` for 4 steps (batch 4, fp32 weights and Adam,
    bf16 autocast, remat 'full') on an fp32 copy: finite losses and exactly
    the kernel launches the path implies (LAUNCHES_PER_STEP); prints the
    median ms per step, images/s and peak device memory.
11. Prints one JSON line about the kernels, then, only if every phase
    passed, ``{"ok": true, "device": {...}}`` as the last line.

Every kernel's launch count is set to 0 just before each main-path phase
(steps 5 and 10) and read just after; launches made to check a kernel
against its plain twin do not count. Any failed phase raises, so the script
exits non-zero; without CUDA it exits non-zero at once and prints no
result.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from flexdiffuse_tpu_torch.models import (CLIP_VIT_L14_TEXT,
                                          CLIP_VIT_L14_VISION, SD14_UNET,
                                          SD14_VAE, AutoencoderKL,
                                          CLIPTextModel, CLIPVisionModel,
                                          UNet2DCondition)
from flexdiffuse_tpu_torch import training
from flexdiffuse_tpu_torch.ops import attention as attn_mod
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.training import train as train_mod

SEED = 1337
PROMPT = 'Deer colorful, fantasy, intricate, highly detailed'
KERNEL_SHAPES = [(2, 8, 4096, 40), (4, 8, 4096, 40), (2, 8, 1024, 80),
                 (2, 8, 1536, 40), (2, 10, 4096, 64), (1, 2, 32768, 40)]
MAIN_SHAPES = [(2, 8, 4096, 40), (2, 8, 1024, 80)]
LAUNCHES_PER_UNET = 10   # 2 down + 3 up self-attentions at 4096 and 1024
# One UNet evaluation through K1 against the same one with plain attention,
# both bf16 end to end: max|Δε| / max|ε| must stay below this (bf16 rounding
# of 10 attention outputs carried through the rest of the network).
UNET_REL_TOL = 5e-2

# K3/K4/K5 check shapes: the two training shapes at 512² and batch 4, a
# non-power-of-two sequence, a ragged one, and Sq != Skv (q, kv tokens).
TRAIN_SHAPES = [((4, 8, 4096, 40), 4096), ((4, 8, 1024, 80), 1024),
                ((2, 8, 1536, 40), 1536), ((2, 4, 1000, 64), 1000),
                ((1, 8, 1024, 40), 2048)]
TRAIN_MAIN = [(4, 8, 4096, 40), (4, 8, 1024, 80)]
TRAIN_BATCH = 4
LORA_STEPS, FULL_STEPS = 10, 4
# Kernel launches per train step at 512²: each UNet forward runs the 10
# flash-eligible self-attentions through K3 (never K1: they need a
# gradient), the backward runs K4 and K5 once each; remat 'full' recomputes
# the forward in the backward, so K3 runs twice.
LAUNCHES_PER_STEP = {'none': dict(k1=0, k3=10, k4=10, k5=10),
                     'full': dict(k1=0, k3=20, k4=10, k5=10)}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, HBM3.
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
KERNELS = {'k1': fa.flash_attention, 'k3': fb.flash_attention_lse,
           'k4': fb.flash_attention_dq, 'k5': fb.flash_attention_dkv}


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def reset_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def bound(flops: float, nbytes: float) -> tuple:
    """The least time the card could take, in ms, and what bounds it."""
    by_flops, by_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(by_flops, by_bytes) * 1e3,
            'operations' if by_flops >= by_bytes else 'bytes')


def attention_bound(kind: str, b: int, h: int, sq: int, skv: int,
                    d: int) -> tuple:
    """Each input read once, each output written once (2-byte q/k/v/o/dO
    and grads, fp32 lse and D); 2·Sq·Skv·d flops per product: K1/K3 two
    (S, P·V), K4 three (S, dP, dQ), K5 four (S, dP, dV, dK)."""
    bh = b * h
    qo, kv, rows = 2 * bh * sq * d, 2 * bh * skv * d, 4 * bh * sq
    products, nbytes = {
        'k1': (2, 2 * qo + 2 * kv),
        'k3': (2, 2 * qo + 2 * kv + rows),
        'k4': (3, 3 * qo + 2 * kv + 2 * rows),
        'k5': (4, 2 * qo + 4 * kv + 2 * rows)}[kind]
    return bound(products * 2.0 * bh * sq * skv * d, nbytes)


def check_kernel(shape, gen: torch.Generator) -> dict:
    """K1 against fp32 plain attention on the same bf16 inputs."""
    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    scale = d**-0.5
    out = fa.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    # Head by head, so the [S, S] fp32 logits of K2's 32k regime fit.
    err = plain_err = max_ref = 0.0
    for hh in range(h):
        sl = (slice(None), slice(hh, hh + 1))
        ref = fa.plain_attention(q[sl].float(), k[sl].float(),
                                 v[sl].float(), scale)
        plain = fa.plain_attention(q[sl], k[sl], v[sl], scale)
        err = max(err, (out[sl].float() - ref).abs().max().item())
        plain_err = max(plain_err, (plain.float() - ref).abs().max().item())
        max_ref = max(max_ref, ref.abs().max().item())
        del ref, plain
    tol = 2.0 * plain_err + 1e-3 * max_ref
    res = dict(shape=list(shape), max_abs_err=err, plain_max_abs_err=plain_err,
               max_abs_ref=max_ref, tol=tol, ok=err <= tol)
    if shape in MAIN_SHAPES:
        res['ms'] = time_ms(lambda: fa.flash_attention(q, k, v, scale))
        res['plain_ms'] = time_ms(lambda: fa.plain_attention(q, k, v, scale))
        res['library_ms'] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale))
        res['bound_ms'], res['bound_by'] = attention_bound('k1', b, h, s, s,
                                                           d)
    return res


def build_models(device: str, dtype: torch.dtype, seed: int):
    """SD-1.4 + CLIP ViT-L/14 geometry with seeded random weights, created
    directly on ``device``."""
    torch.manual_seed(seed)
    with torch.device(device):
        models = (CLIPTextModel(CLIP_VIT_L14_TEXT),
                  CLIPVisionModel(CLIP_VIT_L14_VISION),
                  UNet2DCondition(SD14_UNET), AutoencoderKL(SD14_VAE))
    return tuple(m.to(dtype).eval().requires_grad_(False) for m in models)


def synthetic_image(size: int, seed: int) -> Image.Image:
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:size, 0:size] / size
    img = np.stack([x, y, 0.5 + 0.5 * np.sin(6 * x * y)], -1)
    img = img + 0.1 * rng.standard_normal(img.shape)
    return Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))


class UNetProbe:
    """Forward hooks on the UNet: counts evaluations, brackets the denoise
    loop with CUDA events, and keeps device-side finiteness flags of ε."""

    def __init__(self, unet) -> None:
        self.calls = 0
        self.first = self.last = None
        self.finite = []
        self.handles = [unet.register_forward_pre_hook(self._pre),
                        unet.register_forward_hook(self._post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def reset(self) -> None:
        self.calls = 0
        self.first = self.last = None
        self.finite = []

    def _pre(self, module, args):
        if self.first is None:
            self.first = torch.cuda.Event(enable_timing=True)
            self.first.record()

    def _post(self, module, args, out):
        self.calls += 1
        self.finite.append(torch.isfinite(out).all())
        self.last = torch.cuda.Event(enable_timing=True)
        self.last.record()

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return self.first.elapsed_time(self.last) / 1000.0


def _errs(got, ref, plain) -> dict:
    err = (got.float() - ref.float()).abs().max().item()
    plain_err = (plain.float() - ref.float()).abs().max().item()
    max_ref = ref.abs().max().item()
    tol = 2.0 * plain_err + 1e-3 * max_ref
    return dict(max_abs_err=err, plain_max_abs_err=plain_err,
                max_abs_ref=max_ref, tol=tol,
                ok=bool(err <= tol and torch.isfinite(got).all()))


def check_train_kernels(shape, skv: int, gen: torch.Generator) -> dict:
    """K3, K4 and K5 against their fp32 plain twins on the same bf16 inputs
    (the twins also run on the bf16 inputs, in fp32 math with 16-bit
    outputs, for the rule's 'plain' error); times at the training shapes."""
    b, h, sq, d = shape
    q, dout = (torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, skv, d), generator=gen, device='cuda',
                        dtype=torch.bfloat16) for _ in range(2))
    scale = d**-0.5
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    dvec = fb.attention_delta(dout, o)
    dq = fb.flash_attention_dq(q, k, v, dout, lse, dvec, scale)
    dk, dv = fb.flash_attention_dkv(q, k, v, dout, lse, dvec, scale)
    torch.cuda.synchronize()
    f32 = [t.float() for t in (q, k, v, dout)]
    res = dict(shape=list(shape), skv=skv)
    ref_o, ref_lse = fb.plain_attention_lse(*f32[:3], scale)
    res['k3'] = _errs(o, ref_o, fb.plain_attention_lse(q, k, v, scale)[0])
    res['k3']['lse_max_abs_err'] = (lse - ref_lse).abs().max().item()
    res['k3']['ok'] &= res['k3']['lse_max_abs_err'] <= 1e-3
    del ref_o, ref_lse
    rows = (lse, dvec, scale)
    res['k4'] = _errs(dq, fb.plain_attention_dq(*f32, *rows),
                      fb.plain_attention_dq(q, k, v, dout, *rows))
    ref = fb.plain_attention_dkv(*f32, *rows)
    plain = fb.plain_attention_dkv(q, k, v, dout, *rows)
    dk_res, dv_res = _errs(dk, ref[0], plain[0]), _errs(dv, ref[1], plain[1])
    res['k5'] = dict(dk=dk_res, dv=dv_res,
                     max_abs_err=max(dk_res['max_abs_err'],
                                     dv_res['max_abs_err']),
                     ok=dk_res['ok'] and dv_res['ok'])
    del ref, plain
    if shape in TRAIN_MAIN:
        args = (q, k, v, dout, lse, dvec, scale)
        timed = {
            'k3': (lambda: fb.flash_attention_lse(q, k, v, scale),
                   lambda: fb.plain_attention_lse(q, k, v, scale)),
            'k4': (lambda: fb.flash_attention_dq(*args),
                   lambda: fb.plain_attention_dq(*args)),
            'k5': (lambda: fb.flash_attention_dkv(*args),
                   lambda: fb.plain_attention_dkv(*args))}
        for name, (kern, plain_fn) in timed.items():
            res[name]['ms'] = time_ms(kern)
            res[name]['plain_ms'] = time_ms(plain_fn)
            res[name]['bound_ms'], res[name]['bound_by'] = attention_bound(
                name, b, h, sq, skv, d)
        # The yardstick: scaled_dot_product_attention's forward (keeping
        # what its backward needs) and its backward (dq, dk and dv in one
        # call), on the same inputs. The port never calls it.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        res['k3']['library_ms'] = time_ms(
            lambda: F.scaled_dot_product_attention(*leaves, scale=scale))
        out = F.scaled_dot_product_attention(*leaves, scale=scale)
        bwd = time_ms(lambda: torch.autograd.grad(out, leaves, dout,
                                                  retain_graph=True))
        res['k4']['library_ms'] = res['k5']['library_ms'] = bwd

        def ours():
            o_ = fb.FlashAttentionFn.apply(*leaves, scale)
            torch.autograd.grad(o_, leaves, dout)

        def library():
            o_ = F.scaled_dot_product_attention(*leaves, scale=scale)
            torch.autograd.grad(o_, leaves, dout)

        res['fwd_bwd_ms'] = time_ms(ours)
        res['library_fwd_bwd_ms'] = time_ms(library)
    res['ok'] = all(res[n]['ok'] for n in ('k3', 'k4', 'k5'))
    return res


def check_lora_step(unet, ctx, gen: torch.Generator) -> float:
    """One LoRA train step's loss and factor gradients at full width
    through the kernels and with plain attention, both under the training
    bf16 autocast; returns max|Δg|/max|g|. ``up`` starts at small random
    values here (not 0) so that ``down`` gets a gradient too."""
    factors = training.init_lora(unet, rank=8, generator=gen)
    with torch.no_grad():
        for f in factors.values():
            f['up'].normal_(generator=gen).mul_(1e-3)
    leaves = [f[p] for f in factors.values() for p in ('down', 'up')]
    cfg = training.TrainConfig()
    acp = train_mod.schedule_tables(cfg, 'cuda')
    lat = torch.randn((TRAIN_BATCH, 64, 64, 4), generator=gen,
                      device='cuda')
    t = torch.randint(0, cfg.num_train_timesteps, (TRAIN_BATCH,),
                      generator=gen, device='cuda')
    noise = torch.randn(lat.shape, generator=gen, device='cuda')

    def run(backend):
        eff = training.merge_lora_params(unet, factors)
        apply_fn = lambda *a: torch.func.functional_call(unet, eff, a)
        with attn_mod.backend(backend), train_mod.compute_context(
                lat.device):
            loss = training.diffusion_loss(apply_fn, lat, ctx, acp, cfg, t=t,
                                           noise=noise)
        return loss.item(), torch.autograd.grad(loss, leaves)

    before = counts()
    loss_k, g_k = run('auto')
    moved = {n: counts()[n] - before[n] for n in before}
    loss_p, g_p = run('plain')
    g_max = max(g.abs().max().item() for g in g_p)
    rel = max((a - b).abs().max().item() for a, b in zip(g_k, g_p)) / g_max
    print(f'LoRA step 512² batch {TRAIN_BATCH}: loss kernel {loss_k:.6f} '
          f'plain {loss_p:.6f}; factor grads max|Δg|/max|g| = {rel:.3e} '
          f'(limit {UNET_REL_TOL}); launches {moved}')
    if moved != LAUNCHES_PER_STEP['none']:
        raise AssertionError(f'LoRA check step launched {moved}')
    if not (np.isfinite(loss_k) and abs(loss_k - loss_p) <= UNET_REL_TOL *
            abs(loss_p) and rel <= UNET_REL_TOL):
        raise AssertionError('LoRA step through K3/K4/K5 disagrees with '
                             'the plain path')
    return rel


def encode_synthetic(runner, vae, n: int = 8):
    """``n`` synthetic 512² images with two captions, through
    ``find_items``/``encode_dataset`` into an ``EncodedDataset`` on the
    card."""
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(n):
            synthetic_image(512, SEED + i).save(os.path.join(tmp,
                                                             f'{i}.png'))
            with open(os.path.join(tmp, f'{i}.txt'), 'w') as f:
                f.write(f'{PROMPT}, view {i % 2}')
        return training.encode_dataset(training.find_items(tmp), vae,
                                       runner.encoder, resolution=512,
                                       encode_batch=4)


def run_training(label: str, train_fn, steps: int, remat: str) -> dict:
    """Drive one training entry point with the launch counts at 0; check
    finite losses and the exact launches; time the steps."""
    stamps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stamps.append(time.perf_counter())
    _, losses = train_fn(lambda i, loss: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    got = counts()
    per_step = [b - a for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(per_step[1:]) * 1e3   # the first step warms up
    want = {k: v * steps for k, v in LAUNCHES_PER_STEP[remat].items()}
    res = dict(label=label, steps=steps, losses=losses, median_step_ms=ms,
               images_per_s=TRAIN_BATCH / ms * 1e3,
               max_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches=got)
    print(f'{label}: {json.dumps(res)}')
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f'{label}: losses {losses}')
    if got != want:
        raise AssertionError(f'{label}: launches {got}, expected {want}')
    return res


# Kernel name fragment → group, first match wins.
GROUPS = [('flash_fwd_kernel', 'flash forward (K1/K3)'),
          ('flash_bwd_dq', 'flash dq (K4)'),
          ('flash_bwd_dkv', 'flash dk/dv (K5)'),
          ('nchwToNhwc', 'layout conversion'),
          ('nhwcToNchw', 'layout conversion'),
          ('fprop', 'convolution'), ('dgrad', 'convolution'),
          ('wgrad', 'convolution'), ('conv', 'convolution'),
          ('copy', 'copy/cast'), ('CatArray', 'copy/cast'),
          ('gemm', 'GEMM'), ('nvjet', 'GEMM'), ('cutlass', 'GEMM'),
          ('GroupNorm', 'norm'), ('RowwiseMoments', 'norm'),
          ('layer_norm', 'norm'), ('GammaBeta', 'norm'),
          ('ComputeInternalGradients', 'norm'),
          ('multi_tensor_apply', 'optimizer'), ('reduce', 'reduction'),
          ('softmax', 'softmax'), ('elementwise', 'other elementwise')]


def group(name: str) -> str:
    for frag, g in GROUPS:
        if frag in name:
            return g
    return 'other'


def busy_us(intervals) -> float:
    total, end = 0.0, float('-inf')
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def profile_steps(label: str, step, steps: int, out: str) -> dict:
    """Two warm-up steps, ``steps`` unprofiled steps (host time without the
    profiler's overhead), then ``steps`` steps under ``torch.profiler``."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # Device activity only: GPU-side user annotations (such as the
    # optimizer's record_function range) are not kernels.
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and
               not getattr(e, 'is_user_annotation', False) and
               not e.name.startswith('Optimizer.')]
    by_name, by_group = collections.Counter(), collections.Counter()
    for e in kernels:
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] += dur
        by_group[group(e.name)] += dur
    busy = busy_us((e.time_range.start, e.time_range.end) for e in kernels)
    total = sum(by_name.values())
    res = dict(label=label, steps=steps,
               host_s_per_step_unprofiled=plain_wall / steps,
               host_s_per_step_profiled=wall / steps,
               device_busy_ms_per_step=busy / 1e3 / steps,
               idle_share_profiled=1 - busy / 1e6 / wall,
               idle_share_vs_unprofiled=1 - busy / 1e6 / plain_wall,
               kernels_per_step=len(kernels) / steps,
               groups={g: round(t / total, 4)
                       for g, t in by_group.most_common()},
               top={n[:90]: round(t / total, 4)
                    for n, t in by_name.most_common(12)})
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f'{label}_kernels.txt'), 'w') as f:
        for n, t in by_name.most_common():
            f.write(f'{t / 1e3 / steps:10.3f} ms/step  {t / total:7.2%}  '
                    f'{n}\n')
    with open(os.path.join(out, f'{label}_summary.json'), 'w') as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res))
    return res


def profile_training(steps: int, out: str) -> None:
    """``--profile-train``: where a train step's time goes. The training
    setup of the smoke (seeded random SD-1.4 weights, 8 synthetic 512²
    images, batch 4; LoRA rank 8 over the bf16 UNet with remat 'none', then
    full fine-tuning of an fp32 UNet under bf16 autocast with remat
    'full'). For each mode: host seconds per step unprofiled and profiled,
    the device's busy time per step (the union of the kernels' intervals),
    the idle share against both host times, and device time by kernel group
    and by kernel, printed and written under ``out``."""
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(fa.build, (fa.SOURCE, fb.SOURCE)))
    text, vision, unet, vae = build_models('cuda', torch.bfloat16, SEED)
    runner = Runner.from_models(text, vision, unet, vae,
                                FakeTokenizer(CLIP_VIT_L14_TEXT.vocab_size))
    ds = encode_synthetic(runner, vae)
    gen = torch.Generator('cuda').manual_seed(SEED)
    batches = ds.batches(TRAIN_BATCH, gen)
    factors = training.init_lora(unet, rank=8, generator=gen)
    lora_step, _ = training.make_lora_train_step(
        unet, factors, training.TrainConfig(remat='none'))
    profile_steps('lora', lambda: lora_step(*next(batches), generator=gen),
                  steps, out)
    del text, vision, runner, factors, lora_step
    torch.manual_seed(SEED)
    with torch.device('cuda'):
        unet32 = UNet2DCondition(SD14_UNET)
    full_step, _ = training.make_train_step(
        unet32, training.TrainConfig(learning_rate=1e-5, remat='full'))
    profile_steps('full', lambda: full_step(*next(batches), generator=gen),
                  steps, out)


def main() -> int:
    ap = argparse.ArgumentParser(description='Smoke test of the PyTorch '
                                 'port on one CUDA card (see the module '
                                 'docstring).')
    ap.add_argument('--profile-train', type=int, default=0, metavar='STEPS',
                    help='instead of the smoke test, profile STEPS LoRA and '
                    'STEPS full fine-tuning steps')
    ap.add_argument('--profile-out', default='outputs/profile_train',
                    help='where --profile-train writes its tables')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    # Full fp32 where fp32 is asked for (the kernels' references); the
    # models run in bf16, which TF32 does not touch.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    print(card_line())
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; '
          f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')
    if args.profile_train:
        profile_training(args.profile_train, args.profile_out)
        return 0

    sources = (fa.SOURCE, fb.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        build_secs = list(pool.map(fa.build, sources))
    for src, secs in zip(sources, build_secs):
        print(f'build {src.name}: {secs:.1f} s ({fa.library_path(src).name})')

    gen = torch.Generator('cuda').manual_seed(SEED)
    results = [check_kernel(s, gen) for s in KERNEL_SHAPES]
    for r in results:
        print('K1', json.dumps(r))
    bad = [r['shape'] for r in results if not r['ok']]
    if bad:
        raise AssertionError(f'K1 disagrees with plain attention at {bad}')

    text, vision, unet, vae = build_models('cuda', torch.bfloat16, SEED)
    runner = Runner.from_models(text, vision, unet, vae,
                                FakeTokenizer(CLIP_VIT_L14_TEXT.vocab_size))

    # One full-width UNet evaluation, kernel path against plain path.
    ctx = runner.encoder.prompt(['', PROMPT])
    lat = torch.randn((2, 64, 64, 4), generator=gen, device='cuda')
    t = torch.full((2,), 981.0, device='cuda')
    with torch.no_grad():
        eps_flash = unet(lat, t, ctx)
        with attn_mod.backend('plain'):
            eps_plain = unet(lat, t, ctx)
    rel = ((eps_flash - eps_plain).abs().max() /
           eps_plain.abs().max()).item()
    print(f'UNet 512² bf16: max|Δε|/max|ε| kernel vs plain = {rel:.3e} '
          f'(limit {UNET_REL_TOL})')
    if not (torch.isfinite(eps_flash).all() and rel <= UNET_REL_TOL):
        raise AssertionError('UNet through K1 disagrees with plain path')

    probe = UNetProbe(unet)
    latent_finite = []
    hook = vae.post_quant_conv.register_forward_pre_hook(
        lambda m, args: latent_finite.append(torch.isfinite(args[0]).all()))
    guide = synthetic_image(512, SEED)
    common = dict(prompt=PROMPT, guide=guide, steps=25, guidance_scale=8,
                  samples=1, seed=SEED, save=False)

    runs = []
    k1_launches = 0
    for label, kw in (('txt2img', dict(init_size=(512, 512))),
                      ('img2img', dict(strength=0.6))):
        if label == 'img2img':
            kw['init_image'] = runs[0]['image']
        probe.reset()
        reset_counts()
        t0 = time.perf_counter()
        images, _ = runner.gen(**common, **kw)
        e2e = time.perf_counter() - t0
        denoise = probe.seconds()
        got = counts()
        arr = np.asarray(images[0])
        print(f'{label}: {probe.calls} UNet evaluations (CFG batch 2), '
              f'launches {got}, denoise {denoise:.3f} s = '
              f'{probe.calls / denoise:.2f} UNet evals/s, e2e {e2e:.3f} s, '
              f'image {arr.shape} {arr.dtype}')
        if arr.shape != (512, 512, 3) or arr.dtype != np.uint8:
            raise AssertionError(f'{label}: image {arr.shape} {arr.dtype}')
        if not all(bool(f) for f in probe.finite + latent_finite):
            raise AssertionError(f'{label}: non-finite ε or latents')
        if got != dict(k1=LAUNCHES_PER_UNET * probe.calls, k3=0, k4=0,
                       k5=0):
            raise AssertionError(f'{label}: launches {got} for '
                                 f'{probe.calls} UNet evaluations')
        k1_launches += got['k1']
        runs.append(dict(image=images[0], launches=got['k1']))
        latent_finite.clear()
    hook.remove()
    probe.remove()

    # Training: the kernels, then the full-width step, then the loops.
    t0 = time.perf_counter()
    train_res = [check_train_kernels(s, skv, gen) for s, skv in TRAIN_SHAPES]
    for r in train_res:
        print('K3-K5', json.dumps(r))
    bad = [(r['shape'], r['skv']) for r in train_res if not r['ok']]
    if bad:
        raise AssertionError(f'K3/K4/K5 disagree with their twins at {bad}')
    print(f'K3-K5 check: {time.perf_counter() - t0:.1f} s')

    t0 = time.perf_counter()
    lora_rel = check_lora_step(
        unet, runner.encoder.prompt([PROMPT] * TRAIN_BATCH), gen)
    print(f'LoRA step check: {time.perf_counter() - t0:.1f} s')

    t0 = time.perf_counter()
    ds = encode_synthetic(runner, vae)
    print(f'dataset: {len(ds)} images -> mean {tuple(ds.mean.shape)}, '
          f'context {tuple(ds.context.shape)} {ds.context.dtype} on '
          f'{ds.device}, {time.perf_counter() - t0:.1f} s')

    lora = run_training(
        'train_lora', lambda on_step: training.train_lora(
            unet, ds, training.TrainConfig(learning_rate=1e-4,
                                           remat='none'),
            rank=8, steps=LORA_STEPS, batch_size=TRAIN_BATCH, seed=SEED,
            log_every=1, on_step=on_step), LORA_STEPS, 'none')
    del text, vision, runner
    torch.manual_seed(SEED)
    with torch.device('cuda'):
        unet32 = UNet2DCondition(SD14_UNET)
    full = run_training(
        'train_full', lambda on_step: training.train_full(
            unet32, ds, training.TrainConfig(learning_rate=1e-5,
                                             remat='full'),
            steps=FULL_STEPS, batch_size=TRAIN_BATCH, seed=SEED,
            log_every=1, on_step=on_step), FULL_STEPS, 'full')
    train_launches = {n: lora['launches'][n] + full['launches'][n]
                      for n in ('k3', 'k4', 'k5')}

    main_res = results[0]
    train_main = train_res[0]
    kernels = [dict(
        name='flash_attention', route='cuda',
        source='flexdiffuse_tpu_torch/csrc/flash_attention.cu',
        replaces='flexdiffuse_tpu/ops/flash_attention.py:126',
        launches=k1_launches,
        max_abs_err=max(r['max_abs_err'] for r in results),
        ms=main_res['ms'], plain_ms=main_res['plain_ms'],
        bound_ms=main_res['bound_ms'], bound_by=main_res['bound_by'],
        library_ms=main_res['library_ms'])]
    for key, kname, src, line in (
            ('k3', 'flash_attention_lse', 'flash_attention.cu', 62),
            ('k4', 'flash_attention_dq', 'flash_backward.cu', 146),
            ('k5', 'flash_attention_dkv', 'flash_backward.cu', 174)):
        m = train_main[key]
        kernels.append(dict(
            name=kname, route='cuda',
            source=f'flexdiffuse_tpu_torch/csrc/{src}',
            replaces=f'flexdiffuse_tpu/ops/flash_backward.py:{line}',
            launches=train_launches[key],
            max_abs_err=max(r[key]['max_abs_err'] for r in train_res),
            ms=m['ms'], plain_ms=m['plain_ms'], bound_ms=m['bound_ms'],
            bound_by=m['bound_by'], library_ms=m['library_ms']))
    print(f'LoRA check max|Δg|/max|g| {lora_rel:.3e}; train_lora '
          f'{lora["median_step_ms"]:.1f} ms/step, train_full '
          f'{full["median_step_ms"]:.1f} ms/step')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
