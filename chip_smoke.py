#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-train 3 [--profile-out DIR]
    python3 chip_smoke.py --profile-gen 5 [--profile-out DIR]

The second and third forms skip the smoke test and profile train steps
(``profile_training``) or UNet evaluations at 512² with K6 and with the
plain GroupNorm (``profile_generate``) instead. The first:

Kernels and inference (the first and third slices):

1. Prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions and the TF32 settings.
2. Builds the four kernel libraries at once, one ``nvcc`` per source or
   part: ``flexdiffuse_tpu_torch/csrc/flash_attention.cu`` (K1, and K3 as
   its lse instantiation, on both paths; ``fa.BUILD_PARTS`` parts),
   ``csrc/flash_backward.cu`` (K4, K5), ``csrc/group_norm.cu`` (K6) and
   ``csrc/flash_variants.cu`` (T1–T6, ``flash_variants.BUILD_PARTS``
   parts), the parts of a source all started together, then linked; prints
   the seconds of each and of the step.
3. Holds K1 against the fp32 plain attention on the same bf16 inputs at six
   shapes, each on the Hopper path (``fa.plan``: TMA, wgmma, warp
   specialisation). A shape passes when the kernel's max|Δ| to the fp32
   reference is at most twice the bf16 plain version's max|Δ| to it, plus
   1e-3·max|ref| (bf16 rounds the output and P; the slack covers the
   kernel's different summation order). Prints both errors; at the two
   main-path shapes and at K2's (1,2,32768,40) the times, from CUDA-graph
   replays, of the Hopper path and of the kept mma.sync kernel (its own
   entry point, the same inputs; interleaved old, new, new, old), of
   ``scaled_dot_product_attention``, the plain version's, the bounds
   (tensor cores or bytes, and the exponential unit) and the host µs per
   call of both paths.
4. Holds K6 against the fp32 plain GroupNorm on the same inputs at eight
   shapes, by step 3's rule (fp32 outputs: 1e-4·max|ref|); at two shapes
   prints the times of K6, the plain version, ``F.group_norm`` and
   ``F.group_norm`` + ``F.silu``, and the bound.
5. Builds SD-1.4 geometry (CLIP ViT-L/14 text and vision towers, the SD-1.4
   UNet and VAE) with seeded random weights on the card in bf16; checks one
   UNet evaluation through K1 and K6 against the same evaluation with plain
   attention and plain GroupNorm, and one 512² VAE decode through K6
   against the plain GroupNorm.
6. Drives ``Runner.gen``: txt2img at 512² with a synthetic guide image,
   PNDM, 25 steps, CFG 8, then img2img at strength 0.6; DDIM (η 0 and 0.5)
   and LMS txt2img; latent inpainting of the left half; debug mode (5
   steps, one image per step). Then ``Runner.compose`` at 512²: a
   background and 2 entities (UNet batch 4), PNDM, 30 steps, CFG 8.
7. Asserts 512×512 uint8 images, finite latents and ε, and exactly the
   kernel launches each phase implies (K1: 10 per UNet evaluation, all on
   the Hopper path, none on the kept kernel; K6: 61 per UNet evaluation, 30
   per VAE decode, 22 per VAE encode; no K3-K5); prints UNet
   evaluations/s and end-to-end seconds.

Training (the second slice):

8. Holds K3 (``o`` and ``lse``), K4 (``dq``) and K5 (``dk``, ``dv``) against
   their fp32 plain twins on the same bf16 inputs at five shapes, by step
   3's rule (``lse``: 1e-3 absolute; K3 on the Hopper path with ``o``
   bit-equal to K1's; K4 and K5 fed K3's ``lse``, their bf16 plain version
   rounding P and dS before the products, as step 3's rounds P); at the
   two training shapes prints the kernels', the twins' and
   ``scaled_dot_product_attention``'s forward and backward times, K3's as
   step 3 times K1 (Hopper path against the kept kernel).
9. One LoRA train step's loss and factor gradients at SD-1.4 width (512²,
   batch 4, injected timesteps and noise) through the kernels against the
   same step with plain attention: max|Δg|/max|g| ≤ 5e-2.
10. Encodes 8 synthetic 512² images (VAE encoder) and their captions (CLIP
    text) into an ``EncodedDataset`` on the card.
11. ``train_lora`` for 10 steps (rank 8, batch 4, remat 'none') on the bf16
    UNet, then ``train_full`` for 4 steps (batch 4, fp32 weights and Adam,
    bf16 autocast, remat 'full') on an fp32 copy: finite losses and exactly
    the kernel launches the path implies (LAUNCHES_PER_STEP; every K3 on the
    Hopper path); prints the median ms per step, images/s and peak device
    memory.

The flash-kernel experiment tools (the fourth slice):

12. Holds every configuration of the attention variants T1–T6
    (``csrc/flash_variants.cu``: T1 v0/vU/vG2/vG4, T2, T3, T4, T5
    ttv3/ttv4/no-fold, T6 v0/v1/v2) against its twin by step 3's rule at
    every shape the tools give it: the two main shapes, and (8,8,4096,40)
    for T4 and T5, (2,8,1536,40) for T4 (T_EXTRA_SHAPES). At the main
    shapes prints each one's, its twin's, ``scaled_dot_product_attention``'s
    (contiguous ``[B,H,S,D]``; for the ``[B,H,D,S]`` T4/T5 also on the
    transposed views, which takes its slow path) and K1's times from this
    run, and the bound.
13. Runs the ported tools (``flexdiffuse_tpu_torch/tools/``) as a user
    would: ``flash_variants``, ``flash_opt``, ``flash_pipelined`` (with its
    UNet A/B, K1 against T3), ``flash_tt`` (exactness at four shapes, K1
    against T4, the UNet A/B), ``flash_tt3`` (its main and ``step_ab``, K1
    against ttv3 and ttv4). Asserts finite exactness errors (the scripts
    print OK or FAIL by their own 0.04; step 12 holds the kernels to
    step 3's rule) and, per UNet evaluation of each A/B, exactly 10
    launches of the kernel in use, none of the other, and 61 of K6.
14. Prints one JSON line about the kernels (K1 and K3 also with the kept
    kernel's time and the host µs per call),
    then, only if every phase passed, ``{"ok": true, "device": {...}}`` as
    the last line.

Every kernel's launch count is set to 0 just before each main-path phase
(steps 6, 11 and 13) and read just after; launches made to check a kernel
against its plain twin do not count. Any failed phase raises, so the script
exits non-zero; without CUDA it exits non-zero at once and prints no
result.
"""
from __future__ import annotations

import argparse
import collections
import copy
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
from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.tools import flash_opt as tool_opt
from flexdiffuse_tpu_torch.tools import flash_pipelined as tool_pipelined
from flexdiffuse_tpu_torch.tools import flash_tt as tool_tt
from flexdiffuse_tpu_torch.tools import flash_tt3 as tool_tt3
from flexdiffuse_tpu_torch.tools import flash_variants as tool_variants
from flexdiffuse_tpu_torch.tools import reference as fp32_reference
from flexdiffuse_tpu_torch.tools.perf_experiment import (
    KERNELS, kernel_counts as counts, reset_counts)
from flexdiffuse_tpu_torch.training import train as train_mod

SEED = 1337
PROMPT = 'Deer colorful, fantasy, intricate, highly detailed'
KERNEL_SHAPES = [(2, 8, 4096, 40), (4, 8, 4096, 40), (2, 8, 1024, 80),
                 (2, 8, 1536, 40), (2, 10, 4096, 64), (1, 2, 32768, 40)]
MAIN_SHAPES = [(2, 8, 4096, 40), (2, 8, 1024, 80)]
K2_SHAPE = (1, 2, 32768, 40)   # K2's regime, served by K1: timed too
TIMED_SHAPES = MAIN_SHAPES + [K2_SHAPE]
# K6 launches: SD-1.4's UNet has 61 GroupNorms per evaluation (22 resnets ×
# 2, 16 transformers, conv_norm_out), the VAE decoder 30 (14 resnets × 2,
# the mid attention, conv_norm_out), the encoder 22 (10 resnets × 2, the
# mid attention, conv_norm_out).
K6_PER_UNET, K6_PER_DECODE, K6_PER_ENCODE = 61, 30, 22
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
# the forward in the backward, so K3 runs twice. K6 serves only GroupNorms
# whose input and affine need no gradient: in LoRA training (frozen UNet,
# factors on the attention projections) the three GroupNorms that run
# before the first adapted layer, down_blocks[0].resnets[0].norm1 and
# .norm2 and down_blocks[0].attentions[0].norm; every later activation
# carries the factors' gradient. Full fine-tuning trains the affine of
# every GroupNorm, so none.
def want_launches(k1: int = 0, k3: int = 0, k4: int = 0, k5: int = 0,
                  k6: int = 0) -> dict:
    """The launch counts a main-path run must show (``kernel_counts``):
    every K1 and K3 launch on the Hopper path ('sm90'), none on the kept
    mma.sync kernel."""
    return dict(k1=k1, k3=k3, k4=k4, k5=k5, k6=k6, k1_sm90=k1, k1_mma=0,
                k3_sm90=k3, k3_mma=0)


LAUNCHES_PER_STEP = {'lora': want_launches(k3=10, k4=10, k5=10, k6=3),
                     'full': want_launches(k3=20, k4=10, k5=10)}
# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32
# outside the tensor cores, HBM3. And the exponential unit, printed beside
# K1/K3's times but kept out of the kernels line (it is a second bound on
# an assumed clock): 16 ex2 per clock per SM (the CUDA C++ programming
# guide's arithmetic-instruction throughput table, compute capability 9.0,
# "32-bit floating-point ... base-2 exponential") on 132 SMs at the 1.98
# GHz boost clock; under load the SM clock can sit lower.
PEAK_FLOPS, PEAK_FP32, PEAK_BYTES = 989e12, 67e12, 3.35e12
PEAK_EX2 = 16 * 132 * 1.98e9
BF16, FP32 = torch.bfloat16, torch.float32
# K6 check shapes (NCHW, silu, eps, in dtype, out dtype, timed), stored
# channels-last as the models' activations are on the card: the UNet's
# levels at 512² (CFG batch 2 and compose batch 4), the VAE's mid-block and
# largest decoder activation, fp32 in and out, a ragged one (C/G = 3,
# HW = 391). Groups: 32, as SD-1.4 everywhere.
GN_SHAPES = [((2, 320, 64, 64), True, 1e-5, BF16, BF16, True),
             ((2, 320, 64, 64), False, 1e-6, BF16, BF16, False),
             ((2, 2560, 8, 8), True, 1e-5, BF16, BF16, False),
             ((4, 640, 64, 64), True, 1e-5, BF16, BF16, False),
             ((1, 512, 64, 64), False, 1e-6, BF16, BF16, False),
             ((1, 256, 512, 512), True, 1e-6, BF16, BF16, True),
             ((4, 320, 64, 64), True, 1e-5, FP32, FP32, False),
             ((3, 96, 17, 23), True, 1e-5, FP32, BF16, False)]
# One VAE decode through K6 against the plain GroupNorm, both bf16:
# max|Δ|/max|ref| below this. Both are also held to an fp32 decode of the
# same z (fp32 weights copied from the bf16 ones, plain GroupNorm), by K1's
# rule: K6's error at most twice the bf16 plain decode's plus 1e-3·max|ref|.
VAE_REL_TOL = 5e-2


def card_line() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, graph: bool = False, reps: int = 3
            ) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls after 3 warm-ups,
    by CUDA events; the median of ``reps`` such runs (a lone run of a
    20-µs kernel spread 2× between calls). With ``graph`` the calls are
    captured once into a CUDA graph and replayed, so a call shorter than
    its own host-side launch (K6 at the UNet's sizes) is timed on the
    device, not at the rate the host enqueues it."""
    for _ in range(3):
        fn()
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            for _ in range(iters):
                fn()
        captured.replay()
        run = captured.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def time_pair(new, old, graph: bool = True) -> tuple:
    """(new ms, old ms): each timed twice, in the order old, new, new, old
    (``time_ms``, replayed from a CUDA graph so that a call shorter than its
    host-side launch is timed on the device), the two times averaged."""
    first_old = time_ms(old, graph=graph)
    new_ms = (time_ms(new, graph=graph) + time_ms(new, graph=graph)) / 2
    return new_ms, (first_old + time_ms(old, graph=graph)) / 2


def host_us(fn, calls: int = 200) -> float:
    """Host µs per call of ``fn``: ``calls`` calls enqueued back to back,
    timed on the host clock before the final synchronise."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return elapsed / calls * 1e6


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> tuple:
    """The least time the card could take, in ms, and what bounds it."""
    by_flops, by_bytes = flops / peak, nbytes / PEAK_BYTES
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


def exp_bound_ms(b: int, h: int, sq: int, skv: int) -> float:
    """The exponential unit's least time for one exp2 per score."""
    return b * h * sq * skv / PEAK_EX2 * 1e3


def time_forward(res: dict, kernel, scale: float, q, k, v, kind: str
                 ) -> None:
    """Times of K1 or K3 (``kernel``) on the Hopper path and on the kept
    mma.sync kernel (its own entry point, the same inputs), interleaved;
    ``scaled_dot_product_attention``'s; the bounds; host µs per call of
    both paths."""
    b, h, sq, d = q.shape
    res['ms'], res['kept_ms'] = time_pair(
        lambda: kernel(q, k, v, scale), lambda: kernel(q, k, v, scale,
                                                      path='mma'))
    res['bound_ms'], res['bound_by'] = attention_bound(kind, b, h, sq,
                                                       k.shape[2], d)
    res['exp_bound_ms'] = exp_bound_ms(b, h, sq, k.shape[2])
    res['host_us'] = host_us(lambda: kernel(q, k, v, scale))
    res['kept_host_us'] = host_us(lambda: kernel(q, k, v, scale, path='mma'))


def summary(res: dict) -> str:
    return (f'{res["ms"]:.4f} ms (kept mma.sync {res["kept_ms"]:.4f}, SDPA '
            f'{res["library_ms"]:.4f}, bound {res["bound_ms"]:.5f} '
            f'{res["bound_by"]}, exp2 {res["exp_bound_ms"]:.4f}); host '
            f'{res["host_us"]:.1f} µs per call (kept '
            f'{res["kept_host_us"]:.1f})')


def check_kernel(shape, gen: torch.Generator) -> dict:
    """K1 against fp32 plain attention on the same bf16 inputs, on the path
    ``fa.plan`` picks (every shape here is on the Hopper path)."""
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
    how = fa.plan(q, k, v, out)
    res = dict(shape=list(shape), path=how.path, block_q=how.block_q,
               max_abs_err=err, plain_max_abs_err=plain_err,
               max_abs_ref=max_ref, tol=tol,
               ok=err <= tol and how.path == 'sm90')
    if shape in TIMED_SHAPES:
        time_forward(res, fa.flash_attention, scale, q, k, v, 'k1')
        res['plain_ms'] = time_ms(lambda: fa.plain_attention(q, k, v, scale),
                                  iters=5 if shape == K2_SHAPE else 20)
        res['library_ms'] = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), graph=True)
    return res


def check_group_norm(shape, silu: bool, eps: float, din: torch.dtype,
                     dout: torch.dtype, timed: bool,
                     gen: torch.Generator) -> dict:
    """K6 against the fp32 plain GroupNorm on the same inputs (x not
    centred and channels-last, the affine in x's dtype as the models hold
    it), by K1's rule; fp32 outputs within 1e-4·max|ref|; y channels-last
    too. At the timed shapes, replayed from a CUDA graph: K6, the plain
    version, ``F.group_norm`` alone and with ``F.silu`` (the library call
    of K6's function); and the bound: one read of x and one write of y at
    3.35 TB/s against ~10 fp32 operations per element at 67 TFLOP/s."""
    x = (1.5 * torch.randn(shape, generator=gen, device='cuda') +
         0.7).to(din).contiguous(memory_format=torch.channels_last)
    w = (1.0 + 0.5 * torch.randn(shape[1], generator=gen,
                                 device='cuda')).to(din)
    b = (0.3 * torch.randn(shape[1], generator=gen, device='cuda')).to(din)
    args = (x, 32, w, b, eps, silu, dout)
    y = gn.fused_group_norm(*args)
    torch.cuda.synchronize()
    ref = gn.plain_group_norm(x, 32, w, b, eps, silu, FP32)
    plain = gn.plain_group_norm(*args)
    err = (y.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    max_ref = ref.abs().max().item()
    tol = 1e-4 * max_ref if dout == FP32 else 2.0 * plain_err + \
        1e-3 * max_ref
    res = dict(shape=list(shape), silu=silu,
               eps=eps, dtype=str(din), out_dtype=str(dout),
               max_abs_err=err, plain_max_abs_err=plain_err,
               max_abs_ref=max_ref, tol=tol,
               ok=bool(err <= tol and torch.isfinite(y).all() and
                       y.is_contiguous(memory_format=torch.channels_last)))
    del ref, plain
    if timed:
        res['ms'] = time_ms(lambda: gn.fused_group_norm(*args), graph=True)
        res['plain_ms'] = time_ms(lambda: gn.plain_group_norm(*args),
                                  graph=True)
        res['library_gn_ms'] = time_ms(
            lambda: F.group_norm(x, 32, w, b, eps), graph=True)
        res['library_ms'] = time_ms(
            lambda: F.silu(F.group_norm(x, 32, w, b, eps)), graph=True)
        nbytes = x.numel() * (x.element_size() + y.element_size()) + \
            2 * w.numel() * w.element_size()
        res['bound_ms'], res['bound_by'] = bound(10.0 * x.numel(), nbytes,
                                                 PEAK_FP32)
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
    """K3, K4 and K5 against their fp32 plain twins on the same bf16 inputs,
    by K1's rule; times at the training shapes. The rule's 'plain' error,
    as K1's bf16 plain version rounds P before P·V: for K3 the twin on the
    bf16 inputs (fp32 math, 16-bit output); for K4 and K5 the twins' math
    with P and dS rounded to the inputs' dtype before the products, as the
    kernels' tensor cores take them (``twin_max_abs_err``: without that
    rounding)."""
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
    res['k3']['equals_k1'] = torch.equal(o, fa.flash_attention(q, k, v,
                                                               scale))
    res['k3']['path'] = fa.plan(q, k, v, o).path
    res['k3']['ok'] &= (res['k3']['lse_max_abs_err'] <= 1e-3 and
                        res['k3']['equals_k1'] and
                        res['k3']['path'] == 'sm90')
    del ref_o, ref_lse
    rows = (lse, dvec, scale)
    p16, ds16 = (t.to(q.dtype).float() for t in fb._probs_and_ds(
        q, k, v, dout, *rows))
    ref = fb.plain_attention_dq(*f32, *rows)
    res['k4'] = _errs(dq, ref, torch.matmul(ds16, f32[1]).to(q.dtype))
    res['k4']['twin_max_abs_err'] = (fb.plain_attention_dq(
        q, k, v, dout, *rows).float() - ref).abs().max().item()
    ref = fb.plain_attention_dkv(*f32, *rows)
    plain = (torch.matmul(ds16.transpose(-1, -2), f32[0]).to(q.dtype),
             torch.matmul(p16.transpose(-1, -2), f32[3]).to(q.dtype))
    twin = fb.plain_attention_dkv(q, k, v, dout, *rows)
    dk_res, dv_res = _errs(dk, ref[0], plain[0]), _errs(dv, ref[1], plain[1])
    for r, t, want in ((dk_res, twin[0], ref[0]), (dv_res, twin[1], ref[1])):
        r['twin_max_abs_err'] = (t.float() - want).abs().max().item()
    del p16, ds16, twin
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
            if name == 'k3':
                time_forward(res['k3'], fb.flash_attention_lse, scale, q, k,
                             v, 'k3')
            else:
                res[name]['ms'] = time_ms(kern)
                res[name]['bound_ms'], res[name]['bound_by'] = \
                    attention_bound(name, b, h, sq, skv, d)
            res[name]['plain_ms'] = time_ms(plain_fn)
        # The yardstick: scaled_dot_product_attention's forward (keeping
        # what its backward needs) and its backward (dq, dk and dv in one
        # call), on the same inputs. The port never calls it.
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        res['k3']['library_ms'] = time_ms(
            lambda: F.scaled_dot_product_attention(*leaves, scale=scale),
            graph=True)
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
    with gn.backend('plain'):
        loss_p, g_p = run('plain')
    g_max = max(g.abs().max().item() for g in g_p)
    rel = max((a - b).abs().max().item() for a, b in zip(g_k, g_p)) / g_max
    print(f'LoRA step 512² batch {TRAIN_BATCH}: loss kernel {loss_k:.6f} '
          f'plain {loss_p:.6f}; factor grads max|Δg|/max|g| = {rel:.3e} '
          f'(limit {UNET_REL_TOL}); launches {moved}')
    if moved != LAUNCHES_PER_STEP['lora']:
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


def run_training(label: str, train_fn, steps: int, mode: str) -> dict:
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
    want = {k: v * steps for k, v in LAUNCHES_PER_STEP[mode].items()}
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
GROUPS = [('flash_fwd_sm90_kernel', 'flash forward (K1/K3)'),
          ('flash_fwd_kernel', 'flash forward, kept mma.sync (K1/K3)'),
          ('flash_bwd_dq', 'flash dq (K4)'),
          ('flash_bwd_dkv', 'flash dk/dv (K5)'),
          ('::gn_', 'GroupNorm (K6)'),
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
    profiler's overhead), then ``steps`` steps under ``torch.profiler``.
    Writes the device time by kernel and by operator (with input shapes)
    under ``out``."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
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
    # The operators that launched the device time, by input shapes (which
    # copy is which, say).
    ops = sorted(prof.key_averages(group_by_input_shape=True),
                 key=lambda e: e.self_device_time_total, reverse=True)
    with open(os.path.join(out, f'{label}_ops.txt'), 'w') as f:
        for e in ops[:60]:
            f.write(f'{e.self_device_time_total / 1e3 / steps:10.3f} ms/step '
                    f'{e.count / steps:7.1f} calls/step  {e.key}  '
                    f'{e.input_shapes}\n')
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
        list(pool.map(fa.build, (fa.SOURCE, fb.SOURCE), (fa.BUILD_PARTS, 1)))
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


def check_models(unet, vae, ctx, gen: torch.Generator) -> dict:
    """One 512² UNet evaluation through K1 and K6 against plain attention
    and plain GroupNorm, and one 512² VAE decode through K6 against the
    plain GroupNorm, all bf16; both decodes also against an fp32 decode of
    the same z (VAE_REL_TOL's comment); also the launches each run made."""
    lat = torch.randn((2, 64, 64, 4), generator=gen, device='cuda')
    t = torch.full((2,), 981.0, device='cuda')
    z = torch.randn((1, 64, 64, 4), generator=gen, device='cuda')
    with torch.no_grad():
        reset_counts()
        eps_k = unet(lat, t, ctx)
        unet_launches = counts()
        reset_counts()
        img_k = vae.decode(z)
        vae_launches = counts()
        with attn_mod.backend('plain'), gn.backend('plain'):
            eps_p = unet(lat, t, ctx)
            img_p = vae.decode(z)
            img_32 = copy.deepcopy(vae).float().decode(z)
    rel = lambda a, b: ((a - b).abs().max() / b.abs().max()).item()
    res = dict(unet_rel=rel(eps_k, eps_p), vae_rel=rel(img_k, img_p),
               vae_k6_vs_fp32_rel=rel(img_k, img_32),
               vae_plain_vs_fp32_rel=rel(img_p, img_32),
               unet_launches=unet_launches, vae_launches=vae_launches)
    vae_tol = 2.0 * res['vae_plain_vs_fp32_rel'] + 1e-3
    print(f'UNet 512² bf16, K1+K6 vs plain: max|Δε|/max|ε| = '
          f'{res["unet_rel"]:.3e} (limit {UNET_REL_TOL}), launches '
          f'{unet_launches}; VAE decode 512² bf16, K6 vs plain: '
          f'max|Δ|/max|ref| = {res["vae_rel"]:.3e} (limit {VAE_REL_TOL}), '
          f'launches {vae_launches}; against the fp32 decode: K6 '
          f'{res["vae_k6_vs_fp32_rel"]:.3e} (limit {vae_tol:.3e}), bf16 '
          f'plain {res["vae_plain_vs_fp32_rel"]:.3e}')
    if not (torch.isfinite(eps_k).all() and res['unet_rel'] <= UNET_REL_TOL):
        raise AssertionError('UNet through K1 and K6 disagrees with the '
                             'plain path')
    if not (torch.isfinite(img_k).all() and res['vae_rel'] <= VAE_REL_TOL
            and res['vae_k6_vs_fp32_rel'] <= vae_tol):
        raise AssertionError('VAE decode through K6 disagrees with the '
                             'plain path')
    want_unet = want_launches(k1=LAUNCHES_PER_UNET, k6=K6_PER_UNET)
    want_vae = want_launches(k6=K6_PER_DECODE)
    if unet_launches != want_unet or vae_launches != want_vae:
        raise AssertionError(f'model checks launched {unet_launches} and '
                             f'{vae_launches}')
    return res


def run_generate(label: str, call, probe: 'UNetProbe', latent_finite: list,
                 decodes, encodes: int, images: int) -> dict:
    """Drive one generate entry point with the launch counts at 0; check
    the images, finite ε and latents, and the exact launches: K1 10 and K6
    61 per UNet evaluation, K6 30 per VAE decode (``decodes`` None: one per
    evaluation, as debug mode decodes every step) and 22 per encode."""
    probe.reset()
    latent_finite.clear()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out, _ = call()
    e2e = time.perf_counter() - t0
    denoise = probe.seconds()
    got = counts()
    calls = probe.calls
    decodes = calls if decodes is None else decodes
    arrs = [np.asarray(im) for im in out]
    res = dict(label=label, unet_evaluations=calls, denoise_s=denoise,
               unet_evals_per_s=calls / denoise, e2e_s=e2e, images=len(arrs),
               launches=got)
    print(f'{label}: {json.dumps(res)}')
    if len(arrs) != images or any(a.shape != (512, 512, 3) or
                                  a.dtype != np.uint8 for a in arrs):
        raise AssertionError(f'{label}: images '
                             f'{[(a.shape, a.dtype) for a in arrs]}')
    if not all(bool(f) for f in probe.finite + latent_finite):
        raise AssertionError(f'{label}: non-finite ε or latents')
    want = want_launches(k1=LAUNCHES_PER_UNET * calls,
                    k6=K6_PER_UNET * calls + K6_PER_DECODE * decodes +
                    K6_PER_ENCODE * encodes)
    if got != want:
        raise AssertionError(f'{label}: launches {got}, expected {want} for '
                             f'{calls} UNet evaluations')
    res['image'] = out[0]
    return res


# Compose's entities: (prompt, left, top, width, height, blend), pixels.
COMPOSE_ENTITIES = [['a red fox', 64, 96, 192, 192, 0.8],
                    ['a stone castle', 288, 64, 192, 256, 1.0]]


def run_generate_phases(text, vision, unet, vae) -> list:
    """Every generate path of the port at 512² (see the module docstring,
    step 6), each through ``run_generate``."""
    tok = FakeTokenizer(CLIP_VIT_L14_TEXT.vocab_size)
    make = lambda kind, eta=0.0: _with_eta(Runner.from_models(
        text, vision, unet, vae, tok, scheduler=kind), eta)
    pndm, ddim0, ddim5, lms = (make('pndm'), make('ddim'),
                               make('ddim', 0.5), make('lms'))
    probe = UNetProbe(unet)
    latent_finite = []
    hook = vae.post_quant_conv.register_forward_pre_hook(
        lambda m, args: latent_finite.append(torch.isfinite(args[0]).all()))
    common = dict(prompt=PROMPT, guide=synthetic_image(512, SEED), steps=25,
                  guidance_scale=8, samples=1, seed=SEED, save=False)
    left = np.zeros((512, 512), np.float32)
    left[:, :256] = 1.0
    runs = []
    first = lambda: runs[0]['image']
    phases = [
        ('txt2img', lambda: pndm.gen(**common, init_size=(512, 512)),
         1, 0, 1),
        ('img2img', lambda: pndm.gen(**common, init_image=first(),
                                     strength=0.6), 1, 1, 1),
        ('ddim eta 0', lambda: ddim0.gen(**common), 1, 0, 1),
        ('ddim eta 0.5', lambda: ddim5.gen(**common), 1, 0, 1),
        ('lms', lambda: lms.gen(**common), 1, 0, 1),
        ('inpaint', lambda: pndm.gen(**common, init_image=first(),
                                     mask=left, strength=0.6), 1, 1, 1),
        ('debug', lambda: pndm.gen(**dict(common, steps=5), debug=True),
         None, 0, 6),
        ('compose', lambda: pndm.compose(
            PROMPT, COMPOSE_ENTITIES, steps=30, guidance_scale=8, batches=1,
            seed=SEED, save=False), 1, 0, 1)]
    for label, call, decodes, encodes, images in phases:
        runs.append(run_generate(label, call, probe, latent_finite, decodes,
                                 encodes, images))
    hook.remove()
    probe.remove()
    return runs


def _with_eta(runner, eta: float):
    runner.eta = eta
    return runner


def profile_generate(steps: int, out: str) -> None:
    """``--profile-gen``: where a 512² UNet evaluation's time goes (CFG
    batch 2, bf16, seeded random SD-1.4 weights), through K1 and K6, then
    through K1 with the plain GroupNorm, each by ``profile_steps``."""
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(fa.build, (fa.SOURCE, fb.SOURCE, gn.SOURCE),
                      (fa.BUILD_PARTS, 1, 1)))
    text, vision, unet, vae = build_models('cuda', torch.bfloat16, SEED)
    runner = Runner.from_models(text, vision, unet, vae,
                                FakeTokenizer(CLIP_VIT_L14_TEXT.vocab_size))
    ctx = runner.encoder.prompt(['', PROMPT])
    gen = torch.Generator('cuda').manual_seed(SEED)
    lat = torch.randn((2, 64, 64, 4), generator=gen, device='cuda')
    t = torch.full((2,), 981.0, device='cuda')

    def step():
        with torch.no_grad():
            unet(lat, t, ctx)

    profile_steps('unet_k6', step, steps, out)
    with gn.backend('plain'):
        profile_steps('unet_plain_gn', step, steps, out)


# T1–T6 in the kernels line: (name, TPU kernel, the configuration whose
# times stand for it, the (wrapper, configuration) launches it counts).
# T1 vG's G = 2 and 4 are one entry; T6 v0 is T1 v0's code (the source says
# so), so their launches are one entry's.
T_ENTRIES = [
    ('attn_opt v0 (= attn_variants v0)', 'tools/flash_opt.py:57', 'T1 v0',
     [(fv.attn_opt, 'v0'), (fv.attn_variants, 'v0')]),
    ('attn_opt vU', 'tools/flash_opt.py:57', 'T1 vU', [(fv.attn_opt, 'vU')]),
    ('attn_opt vG', 'tools/flash_opt.py:57', 'T1 vG2',
     [(fv.attn_opt, 'vG2'), (fv.attn_opt, 'vG4')]),
    ('attn_h', 'tools/flash_opt.py:120', 'T2', [(fv.attn_h, 'vH')]),
    ('pipelined_attention', 'tools/flash_pipelined.py:22', 'T3',
     [(fv.pipelined_attention, 'pipelined')]),
    ('flash_tt2', 'tools/flash_tt.py:87', 'T4', [(fv.flash_tt2, 'tt2')]),
    ('flash_ttv3 ttv3', 'tools/flash_tt3.py:41', 'T5 ttv3',
     [(fv.flash_ttv3, 'ttv3')]),
    ('flash_ttv3 ttv4', 'tools/flash_tt3.py:41', 'T5 ttv4',
     [(fv.flash_ttv3, 'ttv4')]),
    ('flash_ttv3 no-fold', 'tools/flash_tt3.py:41', 'T5 no-fold',
     [(fv.flash_ttv3, 'no-fold')]),
    ('attn_variants v1', 'tools/flash_variants.py:27', 'T6 v1',
     [(fv.attn_variants, 'v1')]),
    ('attn_variants v2', 'tools/flash_variants.py:27', 'T6 v2',
     [(fv.attn_variants, 'v2')]),
]
# Launches per UNet evaluation in the tools' A/B runs: the kernel in use
# takes the 10 eligible self-attentions, K6 the 61 GroupNorms.
AB_LAUNCHES = {'k1': dict(k1=LAUNCHES_PER_UNET, k1_sm90=LAUNCHES_PER_UNET,
                          k6=K6_PER_UNET),
               'pipelined_attention': dict(
                   pipelined_attention=LAUNCHES_PER_UNET, k6=K6_PER_UNET),
               'flash_tt2': dict(flash_tt2=LAUNCHES_PER_UNET, k6=K6_PER_UNET),
               'flash_ttv3': dict(flash_ttv3=LAUNCHES_PER_UNET,
                                  k6=K6_PER_UNET)}
# Shapes beyond MAIN_SHAPES that the tools give a configuration:
# flash_tt's check_exact and micro (T4), flash_tt3's main (T5).
T_EXTRA_SHAPES = [((8, 8, 4096, 40), ('T4', 'T5 ttv3', 'T5 ttv4',
                                       'T5 no-fold')),
                  ((2, 8, 1536, 40), ('T4',))]


def check_variants(shape, gen: torch.Generator, labels=None) -> dict:
    """The T configurations in ``labels`` (all when None) against the fp32
    reference by K1's rule, each twin supplying the plain error. With all
    of them (the main shapes) also the times of each kernel and its twin,
    of K1 and of ``scaled_dot_product_attention`` on contiguous
    ``[B,H,S,D]`` (``library_ms``) and on the transposed views of T4/T5's
    ``[B,H,D,S]`` operands (``library_views_ms``), with the bound."""
    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    scale = d**-0.5
    tq, tk, tv = (x.transpose(-1, -2).contiguous() for x in (q, k, v))
    ref = fp32_reference(q, k, v, scale)
    timed = labels is None
    res = dict(shape=list(shape), configs={})
    if timed:
        res.update(
            k1_ms=time_ms(lambda: fa.flash_attention(q, k, v, scale)),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, scale=scale)),
            library_views_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *(x.transpose(-1, -2) for x in (tq, tk, tv)), scale=scale)))
        res['bound_ms'], res['bound_by'] = attention_bound('k1', b, h, s, s,
                                                           d)
    for label in labels or fv.CONFIGS:
        kernel, twin, bhds = fv.CONFIGS[label]
        args = (tq, tk, tv) if bhds else (q, k, v)
        back = (lambda x: x.transpose(-1, -2)) if bhds else (lambda x: x)
        out = kernel(*args, scale)
        torch.cuda.synchronize()
        r = _errs(back(out), ref, back(twin(*args, scale)))
        line = (f'{label:10s} {tuple(shape)}: max|Δ| {r["max_abs_err"]:.3e} '
                f'(twin {r["plain_max_abs_err"]:.3e}, limit {r["tol"]:.3e})')
        if timed:
            r['ms'] = time_ms(lambda: kernel(*args, scale))
            r['plain_ms'] = time_ms(lambda: twin(*args, scale))
            line += (f' {r["ms"]:.4f} ms, twin {r["plain_ms"]:.3f}, K1 '
                     f'{res["k1_ms"]:.4f}, SDPA {res["library_ms"]:.4f}'
                     + (f' (on the views {res["library_views_ms"]:.4f})'
                        if bhds else '') +
                     f', bound {res["bound_ms"]:.5f} ({res["bound_by"]})')
        res['configs'][label] = r
        print(line, flush=True)
    del ref
    res['ok'] = all(r['ok'] for r in res['configs'].values())
    return res


def _ab_ok(label: str, per_eval: dict, kernel: str) -> None:
    if per_eval != AB_LAUNCHES[kernel]:
        raise AssertionError(f'{label}: launches per UNet evaluation '
                             f'{per_eval}, expected {AB_LAUNCHES[kernel]}')


def run_tools(gen: torch.Generator) -> dict:
    """The ported tools, driven as a user would (module docstring, step
    13), with the launch counts at 0 before and read after."""
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = dict(flash_variants=tool_variants.run(gen),
               flash_opt=tool_opt.run(gen),
               flash_pipelined=tool_pipelined.run(gen),
               flash_tt=tool_tt.run(gen),
               flash_tt3=tool_tt3.run(gen),
               flash_tt3_step=tool_tt3.run(gen, step=True)['step'])
    torch.cuda.synchronize()
    res['seconds'] = time.perf_counter() - t0
    res['launches'] = {name: sum(fn.launches[key] for fn, key in parts)
                       for name, _, _, parts in T_ENTRIES}
    res['launches'].update(counts())
    errs = ([r['max_abs_err'] for r in res['flash_variants']] +
            [r['max_abs_err'] for r in res['flash_opt']] +
            [res['flash_pipelined']['max_abs_err']] +
            [r['max_abs_err'] for r in res['flash_tt']['exact']] +
            [r['max_abs_err'] for r in res['flash_tt3']['main']])
    if not all(np.isfinite(e) for e in errs):
        raise AssertionError(f'a tool exactness check is not finite: {errs}')
    pipe, tt, tt3 = (res['flash_pipelined'], res['flash_tt']['step'],
                     res['flash_tt3_step'])
    for label, run, kernel in (
            ('flash_pipelined K1', pipe['base'], 'k1'),
            ('flash_pipelined T3', pipe['piped'], 'pipelined_attention'),
            ('flash_tt step base', tt['base'], 'k1'),
            ('flash_tt step tt', tt['tt'], 'flash_tt2'),
            ('flash_tt3 step_ab tt', tt3['tt'], 'k1'),
            ('flash_tt3 step_ab ttv3', tt3['ttv3'], 'flash_ttv3'),
            ('flash_tt3 step_ab ttv4', tt3['ttv4'], 'flash_ttv3')):
        _ab_ok(label, run['per_eval'], kernel)
    unused = [n for n, _, _, _ in T_ENTRIES if res['launches'][n] == 0]
    if unused:
        raise AssertionError(f'the tools launched no {unused}')
    ab = {label: r['ms'] for label, r in (
        ('pipelined: K1', pipe['base']), ('pipelined: T3', pipe['piped']),
        ('tt: K1', tt['base']), ('tt: T4', tt['tt']),
        ('tt3: K1', tt3['tt']), ('tt3: ttv3', tt3['ttv3']),
        ('tt3: ttv4', tt3['ttv4']))}
    print(f'tools: {res["seconds"]:.1f} s; UNet A/B ms per evaluation '
          f'{json.dumps(ab)}; ttv3/ttv4 max|Δε| vs K1 '
          f'{tt3["ttv3"]["max_abs_diff_vs_first"]:.3e}/'
          f'{tt3["ttv4"]["max_abs_diff_vs_first"]:.3e}; launches '
          f'{json.dumps(res["launches"])}', flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description='Smoke test of the PyTorch '
                                 'port on one CUDA card (see the module '
                                 'docstring).')
    ap.add_argument('--profile-train', type=int, default=0, metavar='STEPS',
                    help='instead of the smoke test, profile STEPS LoRA and '
                    'STEPS full fine-tuning steps')
    ap.add_argument('--profile-gen', type=int, default=0, metavar='STEPS',
                    help='instead of the smoke test, profile STEPS 512² UNet '
                    'evaluations with K6 and with the plain GroupNorm')
    ap.add_argument('--profile-out', default='outputs/profile',
                    help='where the profiling modes write their tables')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing was run', file=sys.stderr)
        return 1
    # Full fp32 where fp32 is asked for (the kernels' references); the
    # models run in bf16, which TF32 does not touch.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device_name = torch.cuda.get_device_name(0)
    print(card_line())
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; '
          f'matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}')
    if args.profile_train:
        profile_training(args.profile_train, args.profile_out)
        return 0
    if args.profile_gen:
        profile_generate(args.profile_gen, args.profile_out)
        return 0

    parts = {fa.SOURCE: fa.BUILD_PARTS, fb.SOURCE: 1, gn.SOURCE: 1,
             fv.SOURCE: fv.BUILD_PARTS}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(parts)) as pool:
        build_secs = list(pool.map(fa.build, parts, parts.values()))
    for src, secs in zip(parts, build_secs):
        print(f'build {src.name}: {secs:.1f} s ({fa.library_path(src).name})')
    print(f'build step: {time.perf_counter() - t0:.1f} s')

    gen = torch.Generator('cuda').manual_seed(SEED)
    results = [check_kernel(s, gen) for s in KERNEL_SHAPES]
    for r in results:
        print('K1', json.dumps(r))
    for r in results:
        if 'ms' in r:
            print(f'K1 {tuple(r["shape"])}: {summary(r)}')
    bad = [r['shape'] for r in results if not r['ok']]
    if bad:
        raise AssertionError(f'K1 disagrees with plain attention (or left '
                             f'the Hopper path) at {bad}')

    gn_res = [check_group_norm(*spec, gen) for spec in GN_SHAPES]
    for r in gn_res:
        print('K6', json.dumps(r))
    bad = [r['shape'] for r in gn_res if not r['ok']]
    if bad:
        raise AssertionError(f'K6 disagrees with the plain GroupNorm at '
                             f'{bad}')

    text, vision, unet, vae = build_models('cuda', torch.bfloat16, SEED)
    runner = Runner.from_models(text, vision, unet, vae,
                                FakeTokenizer(CLIP_VIT_L14_TEXT.vocab_size))
    check_models(unet, vae, runner.encoder.prompt(['', PROMPT]), gen)
    runs = run_generate_phases(text, vision, unet, vae)
    gen_launches = {k: sum(r['launches'][k] for r in runs) for k in KERNELS}

    # Training: the kernels, then the full-width step, then the loops.
    t0 = time.perf_counter()
    train_res = [check_train_kernels(s, skv, gen) for s, skv in TRAIN_SHAPES]
    for r in train_res:
        print('K3-K5', json.dumps(r))
    for r in train_res:
        if 'ms' in r['k3']:
            print(f'K3 {tuple(r["shape"])}: {summary(r["k3"])}')
    bad = [(r['shape'], r['skv']) for r in train_res if not r['ok']]
    if bad:
        raise AssertionError(f'K3/K4/K5 disagree with their twins (or K3 '
                             f'left the Hopper path or K1) at {bad}')
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
            log_every=1, on_step=on_step), LORA_STEPS, 'lora')
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
    launches = {k: gen_launches[k] + lora['launches'][k] +
                full['launches'][k] for k in KERNELS}
    del unet32, ds

    # The flash-kernel experiment tools: T1–T6 against their twins, then
    # the tools themselves.
    t0 = time.perf_counter()
    var_res = [check_variants(s, gen) for s in MAIN_SHAPES]
    var_res += [check_variants(s, gen, labels)
                for s, labels in T_EXTRA_SHAPES]
    bad = [(r['shape'], label) for r in var_res
           for label, c in r['configs'].items() if not c['ok']]
    if bad:
        raise AssertionError(f'T1–T6 disagree with their twins at {bad}')
    print(f'T1-T6 check: {time.perf_counter() - t0:.1f} s')
    tools = run_tools(gen)

    main_res = results[0]
    train_main = train_res[0]
    # K1 and K3 also carry the kept mma.sync kernel's time on the same
    # inputs and the host µs per call, and the times at every timed shape.
    timed = lambda rows: [dict(shape=shape, **{key: m[key] for key in (
        'ms', 'kept_ms', 'library_ms', 'bound_ms')})
        for shape, m in rows if 'ms' in m]
    extra = lambda m, rows: dict(
        {key: m[key] for key in ('kept_ms', 'host_us', 'kept_host_us')},
        by_shape=timed(rows))
    kernels = [dict(
        name='flash_attention', route='cuda',
        source='flexdiffuse_tpu_torch/csrc/flash_attention.cu',
        replaces='flexdiffuse_tpu/ops/flash_attention.py:126',
        launches=launches['k1'],
        max_abs_err=max(r['max_abs_err'] for r in results),
        ms=main_res['ms'], plain_ms=main_res['plain_ms'],
        bound_ms=main_res['bound_ms'], bound_by=main_res['bound_by'],
        library_ms=main_res['library_ms'],
        **extra(main_res, [(r['shape'], r) for r in results]))]
    for key, kname, src, line in (
            ('k3', 'flash_attention_lse', 'flash_attention.cu', 62),
            ('k4', 'flash_attention_dq', 'flash_backward.cu', 146),
            ('k5', 'flash_attention_dkv', 'flash_backward.cu', 174)):
        m = train_main[key]
        kernels.append(dict(
            name=kname, route='cuda',
            source=f'flexdiffuse_tpu_torch/csrc/{src}',
            replaces=f'flexdiffuse_tpu/ops/flash_backward.py:{line}',
            launches=launches[key],
            max_abs_err=max(r[key]['max_abs_err'] for r in train_res),
            ms=m['ms'], plain_ms=m['plain_ms'], bound_ms=m['bound_ms'],
            bound_by=m['bound_by'], library_ms=m['library_ms'],
            **(extra(m, [(r['shape'], r['k3']) for r in train_res])
               if key == 'k3' else {})))
    gn_main = gn_res[0]
    kernels.append(dict(
        name='fused_group_norm', route='cuda',
        source='flexdiffuse_tpu_torch/csrc/group_norm.cu',
        replaces='flexdiffuse_tpu/ops/group_norm.py:41',
        launches=launches['k6'],
        max_abs_err=max(r['max_abs_err'] for r in gn_res),
        ms=gn_main['ms'], plain_ms=gn_main['plain_ms'],
        bound_ms=gn_main['bound_ms'], bound_by=gn_main['bound_by'],
        library_ms=gn_main['library_ms']))
    var_main = var_res[0]
    for entry, replaces, label, _ in T_ENTRIES:
        c = var_main['configs'][label]
        kernels.append(dict(
            name=entry, route='cuda',
            source='flexdiffuse_tpu_torch/csrc/flash_variants.cu',
            replaces=replaces, launches=tools['launches'][entry],
            max_abs_err=max(r['configs'][label]['max_abs_err']
                            for r in var_res if label in r['configs']),
            ms=c['ms'], plain_ms=c['plain_ms'], bound_ms=var_main['bound_ms'],
            bound_by=var_main['bound_by'],
            library_ms=var_main['library_ms'],
            **({'library_views_ms': var_main['library_views_ms']}
               if fv.CONFIGS[label][2] else {})))
    print(f'LoRA check max|Δg|/max|g| {lora_rel:.3e}; train_lora '
          f'{lora["median_step_ms"]:.1f} ms/step, train_full '
          f'{full["median_step_ms"]:.1f} ms/step')
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device_name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
