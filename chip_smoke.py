#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card (an H100).

    python3 chip_smoke.py
    python3 chip_smoke.py --profile-train 3 [--profile-out DIR]
    python3 chip_smoke.py --profile-gen 5 [--family sdxl] [--profile-out DIR]

The second and third forms skip the smoke test and profile train steps
(``profile_training``) or UNet evaluations at 512² with K6 and with the
plain GroupNorm, or with ``--family sdxl`` SDXL base evaluations at 1024²
(``profile_generate``), instead. The first:

Kernels and inference (the first and third slices):

1. Prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions and the TF32 settings.
2. Builds the four kernel libraries at once, one ``nvcc`` per source or
   part: ``flexdiffuse_tpu_torch/csrc/flash_attention.cu`` (K1, and K3 as
   its lse instantiation, on both paths; ``fa.BUILD_PARTS`` parts),
   ``csrc/flash_backward.cu`` (K4, K5, on both paths; ``fb.BUILD_PARTS``
   parts), ``csrc/group_norm.cu`` (K6) and
   ``csrc/flash_variants.cu`` (T1–T6, ``flash_variants.BUILD_PARTS``
   parts), the parts of a source all started together, then linked; prints
   the seconds of each and of the step.
3. Holds K1 against the fp32 plain attention on the same bf16 inputs at
   eight shapes (the last two the serving path's UNet batch 16, drawn from
   a generator of their own), each on the Hopper path (``fa.plan``: TMA,
   wgmma, warp specialisation). A shape passes when every element's |Δ| to
   the fp32 reference is at most twice the bf16 plain version's max|Δ| to
   it, plus 1e-3·max|ref| (bf16 rounds the output and P; the slack covers
   the kernel's different summation order), or exceeds that by at most one
   bf16 ulp of its reference element (``within_rule``: an output next to a
   bf16 midpoint that the kernel rounds to the far neighbour and the twin
   to the near one; each check prints the count of such ``flipped``
   elements). Every kernel check below uses this rule. Prints both
   errors; at the two
   main-path shapes, at K2's (1,2,32768,40) and at the two batch-16 shapes
   the times, from CUDA-graph replays, of the Hopper path and of the kept
   mma.sync kernel (its own entry point, the same inputs; interleaved old,
   new, new, old), of ``scaled_dot_product_attention``, the plain
   version's, the bounds (tensor cores or bytes, and the exponential unit)
   and the host µs per call of both paths.
4. Holds K6 against the fp32 plain GroupNorm on the same inputs at
   fourteen shapes, by step 3's rule (fp32 outputs: 1e-4·max|ref|), each
   launched once on the path ``gn.plan_group_norm`` picks ('resident' or
   'stream'); at seven shapes (among them the serving path's
   (16,320,64,64), (16,1280,8,8) and the 8-image decode's
   (8,256,512,512), the last three drawn as step 3's) prints the times of
   K6 (on a resident shape also of its stream path, forced), the plain
   version, ``F.group_norm`` and ``F.group_norm`` + ``F.silu``, the bound
   and the host µs per K6 call.
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
   the Hopper path, none on the kept kernel; K6: 61 per UNet evaluation,
   all resident, 30 per VAE decode, 13 of them on the stream path, 22 per
   VAE encode, 8 on the stream path; no K3-K5); prints UNet
   evaluations/s and end-to-end seconds.

Training (the second slice):

8. Holds K3 (``o`` and ``lse``), K4 (``dq``) and K5 (``dk``, ``dv``) against
   their fp32 plain twins on the same bf16 inputs at five shapes, by step
   3's rule (``lse``: 1e-3 absolute; K3 on the Hopper path with ``o``
   bit-equal to K1's; K4 and K5 fed K3's ``lse``, their bf16 plain version
   rounding P and dS before the products, as step 3's rounds P), K4 and K5
   on the Hopper path (``fb.plan_backward``) and on the kept mma.sync
   kernels on the same inputs, each launched twice with bit-equal results;
   at the two training shapes prints the kernels' times on both paths
   (interleaved, as step 3), the twins', ``scaled_dot_product_attention``'s
   forward and backward and one forward+backward of each, with the bounds
   and the host µs per call. Then fp32 on the kept kernels
   (``check_fp32_attention``): K1, K3, K4 and K5 on fp32 tensors at
   (1,8,4096,40) against their fp32 twins by step 3's rule (the plain
   version on the inputs rounded to bf16, as the kernels take them), fp32
   q/k/v through ``attention`` with and without a gradient and an fp32
   SD-1.x self-attention (``CrossAttention``) at 4096 tokens against plain
   attention, with exactly the kept-path launches each implies; their
   times against the twins and SDPA.
9. One LoRA train step's loss and factor gradients at SD-1.4 width (512²,
   batch 4, injected timesteps and noise) through the kernels against the
   same step with plain attention: max|Δg|/max|g| ≤ 5e-2.
10. Encodes 8 synthetic 512² images (VAE encoder) and their captions (CLIP
    text) into an ``EncodedDataset`` on the card.
11. ``train_lora`` for 10 steps (rank 8, batch 4, remat 'none') on the bf16
    UNet, then ``train_full`` for 4 steps (batch 4, fp32 weights and Adam,
    bf16 autocast, remat 'full') on an fp32 copy: finite losses and exactly
    the kernel launches the path implies (``step_launches``; every K3, K4
    and K5 on the Hopper path); prints the median ms per step, images/s and
    peak device memory. (Step 12 runs between the two.)

Loading from disk (the eighth slice):

12. Writes the seeded random SD-1.4 and CLIP ViT-L/14 weights as an
    HF-layout snapshot into a temporary directory, removed after (fp16
    safetensors: ``unet/``, ``vae/``, CLIP's ``model.safetensors``; a
    character-level ``vocab.json``/``merges.txt`` padded to the 49408-row
    embedding; about 2.6 GiB, the free space checked first). Builds
    ``Runner(model_root=...)`` on its defaults (the card, bf16) and asserts
    that every loaded tensor equals the written one, that the native BPE
    is in use and that the long prompt takes three windows. Merges a rank-8
    kohya LoRA from seeded factors (``apply_lora``; one merged weight is
    checked against the stored value plus the update, rounded once), then
    runs ``gen`` at 512² (PNDM, 25 steps, CFG 8, guide image); loads a
    textual inversion and runs it again with its token; then once with
    ``long_prompt=True`` and once with ``weighted=True``: step 7's
    checks and launches for each. Then ``train_full`` for 2 steps (batch 4,
    remat 'full') on the snapshot's UNet loaded in fp32, with
    ``save_path=``, the launches ``step_launches`` implies, and the saved file
    reloaded by ``load_unet_msgpack`` equal to the trained tensors. Prints
    the seconds to write, to load and to move to the card, the host RSS
    (current and peak) and the peak device memory while loading.

The user surfaces (the ninth slice), on step 12's snapshot and Runner:

13. The CLI in-process: ``cli.main(['generate', '--models', <snapshot>,
    ...])`` at 512², 25 PNDM steps, CFG 8, a guide image, 2 samples, and
    ``compose`` with a 2-entity schema: the PNGs written and exactly step
    7's launches; then one ``python -m flexdiffuse_tpu_torch.cli generate``
    in a subprocess (rc 0, one PNG). The web UI (``interface.server.
    launch`` on port 0, in a thread): ``/api/generate`` (2 samples, a
    base64 guide image) and ``/api/compose`` (2 entities), 200 with 512²
    PNGs and exact launches. The serving API (``serving.launch``,
    ``max_batch_rows`` 8; 512², 25 steps): one request alone (seed 1234,
    no batching window), two 4-sample requests, 8 concurrent 1-row
    requests including seed 1234 fused into exactly one 8-row dispatch
    (UNet batch 16; a 5 s window they never wait out, checked through
    ``/v1/stats``), 3 concurrent requests padded to 4; then on
    ``fixed_rows`` services the request alone (padded to 8) and among 8
    concurrent ones, bit-equal. Under the default padding it prints max|Δ|
    and mean|Δ| of the request alone against batched, without a limit.
    Asserts K1 = 10 per UNet evaluation, all on the Hopper path, and
    K6 = 61 per evaluation plus 30 per decode (13 on the stream path,
    whatever the decode's batch); prints beside the card's name and power
    limit the images/min of 1-, 4- and 8-row dispatches, the p50 latency
    of each service and the peak device memory.

The flash-kernel experiment tools (the fourth slice):

14. Holds every configuration of the attention variants T1–T6
    (``csrc/flash_variants.cu``: T1 v0/vU/vG2/vG4, T2, T3, T4, T5
    ttv3/ttv4/no-fold, T6 v0/v1/v2) against its twin by step 3's rule at
    every shape the tools give it: the two main shapes, and (8,8,4096,40)
    for T4 and T5, (2,8,1536,40) for T4 (T_EXTRA_SHAPES). At the main
    shapes prints each one's, its twin's, ``scaled_dot_product_attention``'s
    (contiguous ``[B,H,S,D]``; for the ``[B,H,D,S]`` T4/T5 also on the
    transposed views, which takes its slow path) and K1's times from this
    run, and the bound.
15. Runs the ported tools (``flexdiffuse_tpu_torch/tools/``) as a user
    would: ``flash_variants``, ``flash_opt``, ``flash_pipelined`` (with its
    UNet A/B, K1 against T3), ``flash_tt`` (exactness at four shapes, K1
    against T4, the UNet A/B), ``flash_tt3`` (its main and ``step_ab``, K1
    against ttv3 and ttv4). Asserts finite exactness errors (the scripts
    print OK or FAIL by their own 0.04; step 14 holds the kernels to
    step 3's rule) and, per UNet evaluation of each A/B, exactly 10
    launches of the kernel in use, none of the other, and 61 of K6.
16. Prints one JSON line about the kernels (K1 and K3–K5 also with the kept
    kernel's time, the host µs per call, the times by shape, step 17's
    shapes included, and fp32's), then, only if every phase passed,
    ``{"ok": true, "device": {...}}`` as the last line.

The sampling features (the tenth slice), run after step 7:

17. Holds K1 at seven new shapes (STEP17_K1_SHAPES: a CFG-interval row at
    batch 1, a PAG batch of 3, ToMe's merged 2048 tokens, the hires pass's
    9216 and 2304 tokens, SD-2.1's 64-wide heads at 768², which take
    ``fa.SM90_TILES[True]``) and K6 at seven (STEP17_GN_SHAPES: the 768²
    passes' UNet levels and decode, a VAE tile's level), by step 3's rule,
    timed as step 3 times its shapes. Then drives ``Runner.gen`` at 512²,
    CFG 8, bf16, with a guide image, on step 6's models: each new scheduler
    kind for 25 steps (Euler, Euler-a, DPM++, UniPC, DDPM; Heun, 49 UNet
    evaluations; LCM for 4 steps on a guidance-embedded copy of the UNet
    with CFG off), PNDM with v-prediction and trailing spacing, Euler with
    Karras σ, DeepCache at interval 2 and 3, PAG at scale 3 on ('mid',) and
    on ('up_3',), FreeU, ToMe at ratio 0.5, ``cfg_interval`` (0, 0.6),
    ``guidance_rescale`` 0.7 and ``hires_scale`` 1.5 (a 768² second pass,
    decoded through ``enable_vae_tiling(64, 8)``); then SD-2.1 at its
    published widths (OpenCLIP-H text tower, SD-2.1 UNet and VAE, seeded
    random weights), 768², 25 DDIM v-prediction steps, txt2img. Each run:
    the UNet evaluations it must make (batch, latent size, DeepCache mode,
    PAG rows) and its VAE decodes, finite ε and latents, a finite uint8
    image, and exactly the K1 and K6 launches (by path) that a pass over
    the module tree on the meta device gives for those evaluations and
    decodes (``tree_launches``: every attention call the dispatcher sends
    to K1, every GroupNorm, each on its planned path).

The conditioning models (the eleventh slice), run after step 17:

18. Holds K1 at (3,8,1024,80) (InstructPix2Pix's 3-row batch at the
    1024-token level) and K6 at (3,320,64,64) and (3,1280,8,8), by step 3's
    rule, timed as step 3 times its shapes. Writes into a temporary
    directory, removed after, seeded random checkpoints at SD-1.x's
    published widths (fp16; the free space checked first): an SD-1.4 and
    CLIP ViT-L/14 snapshot whose UNet has 8 input channels
    (``unet/config.json``), a diffusers ControlNet made from step 6's UNet
    as ``from_unet`` makes one (its conditioning embedding and zero
    convolutions random, not zero), the base (4 tokens from the pooled
    1024-wide embedding) and Plus (Resampler: dim 768, depth 4, 12 heads of
    64, 16 queries, 1280 → 768) IP-Adapter ``.bin`` files in the official
    nesting, and an OpenCLIP ViT-H/14 image encoder; loads them back through
    ``Runner.load_controlnet``, ``Runner.load_ip_adapter(...,
    image_encoder_dir=)`` and ``Runner(model_root=...)``. Checks one 512²
    evaluation of the UNet with the ControlNet, of the IP-Adapter UNet at
    ``ip_scale`` 1 and of the 8-channel UNet at batch 3 through K1 and K6
    against the plain backends (UNET_REL_TOL), each with exactly the
    module tree's launches, and that the ControlNet and the image tokens
    move ε by more than UNET_REL_TOL (against scale 0). Then five runs at
    512², bf16, 25 PNDM steps: ``Runner.gen`` with a control image (CFG 8,
    ``controlnet_scale`` 1), the same under DeepCache 2 (the 'use' rows run
    the full control branch), IP-Adapter base and Plus from ``ip_image``,
    and ``Runner.edit`` of a 512² synthetic image (CFG 7.5, image CFG 1.5;
    UNet batch 3). Each: the UNet and ControlNet evaluations it must make,
    finite ε, latents and image, exactly the K1 and K6 launches (by path)
    of the module tree, with the control branch's (``control_launches``),
    its e2e seconds and peak device memory.

SDXL base and refiner at 1024² (the twelfth slice), run after step 18:

19. Holds K1 at SDXL's four self-attention shapes (STEP19_K1_SHAPES: the
    base's 10 and 20 heads of 64 at 4096 and 1024 tokens, the refiner's 12
    and 24; ``fa.SM90_TILES[True]``) and K6 at each of the 40 distinct
    calls (shape, SiLU, ε) of one base and one refiner CFG evaluation, one
    1024² decode and one encode, taken from the module tree
    (``sdxl_gn_specs``), by step 3's rule; K1 and six K6 shapes
    (STEP19_GN_TIMED: the base's and refiner's 128², 32² and 16² levels,
    the 960-channel level the plan streams, the 1024² decode's
    activations) timed as step 3 times its shapes. Writes into a
    temporary directory, removed after, seeded random weights at SDXL's
    published widths built on the card (bigG with its pooled projection,
    the base and refiner UNets, the VAE; step 6's CLIP ViT-L/14 towers as
    encoder 1 and the guide's vision tower) as fp16 HF-layout snapshots
    (≈ 12 GiB; the free space checked first): SDXL base (``unet/``,
    ``vae/``, ``text_encoder/``, ``text_encoder_2/``, ``tokenizer/``), the
    refiner (``unet/``) and CLIP ViT-L/14, and loads them back through
    ``SDXLRunner(model_root=, clip_root=, refiner_root=)`` (every loaded
    tensor equal to the written one; write, load and to-card seconds).
    Checks one 1024² CFG evaluation of the base and of the refiner UNet
    through K1 and K6 against the plain backends (UNET_REL_TOL), with the
    module tree's launches (K1_SDXL, K6_SDXL), and that ``added_cond``
    moves ε by more than UNET_REL_TOL (against zero ``text_embeds`` and
    ``time_ids``). Then seven runs at 1024², bf16, 25 DPM++ steps, CFG 5:
    txt2img, txt2img with a guide image (tweened into the CLIP-L half),
    img2img of a 1024² image at strength 0.6, base→refiner at
    ``refine_strength`` 0.3, DeepCache 2, txt2img after ``apply_lora`` of
    an SGM-named kohya LoRA (``lora_unet_*``, ``lora_te1_``,
    ``lora_te2_``; a UNet and an encoder-2 weight checked to be the stored
    weight plus the update rounded once), and ``cli generate
    --model-family sdxl --refiner`` in-process on the same snapshots. Each:
    the base's and the refiner's UNet evaluations it must make, its VAE
    decodes and encodes, finite ε, latents and image, exactly the K1 and K6
    launches (by path) of the module tree with ``added_cond``
    (``tree_launches``), its e2e seconds and peak device memory.
    ``--profile-gen N --family sdxl`` profiles SDXL base evaluations at
    1024² instead of the smoke test.

Textual-inversion and SDXL training (the thirteenth slice), step 20, in
two parts: the SDXL part right after step 19 (on its runner, while the
snapshots that ``SDXLRunner.apply_lora`` reads exist), the textual
inversion after step 13 (on step 12's snapshot and Runner):

20. Holds K3 (``o``, ``lse``), K4 and K5 at SDXL's training shapes
    (STEP20_TRAIN_SHAPES: the base's 10 and 20 heads of 64 at 4096 and
    1024 tokens, batch 2 for LoRA and 1 for full fine-tuning; K5 on its
    32-row q tile above DP 48) by step 8's checks, timed at the batch-2
    shapes as step 8 times its own. Encodes 4 synthetic 1024² images with
    two captions through ``encode_dataset_sdxl`` (the runner's VAE and
    ``SDXLTextEncoder``; pooled embeddings and time ids fp32), runs
    ``train_lora`` (rank 8, batch 2, remat 'full', the bf16 base, fp32
    factors, 6 steps), merges the exported LoRA with
    ``SDXLRunner.apply_lora`` and runs one txt2img (1024², 25 DPM++ steps,
    CFG 5); loads a seeded base-projection IP-Adapter (``_vit-h`` layout,
    ``ip_adapter_checkpoint``) with a seeded OpenCLIP ViT-H image encoder
    through ``load_ip_adapter(encoder='vit-h')`` and runs the same with an
    ``ip_image``; checks one 1024² CFG evaluation of the base UNet with a
    ControlNet of its geometry and ``added_cond`` against the plain
    backends (UNET_REL_TOL, the branch moving ε). Then frees the runner,
    prints the memory reckoning and runs ``train_full`` (batch 1, remat
    'full', 2 steps) on an fp32 copy of the base UNet. The textual
    inversion: ``train_textual_inversion`` on step 6's models (8 synthetic
    512² images, 2 vectors, batch 4, remat 'none', 10 steps; the saved
    file holds the returned rows), then ``cli train --textual-inversion
    --init-token a --num-vectors 2 --style-templates`` in-process on step
    12's snapshot (4 steps); its embedding loads into step 12's Runner
    (``load_textual_inversion``: the new ids hold its rows) and one 512²
    ``gen`` with the placeholder follows (25 PNDM steps, CFG 8). Every
    training run: finite losses, the median ms per step, images/s, peak
    device memory and exactly the launches of the module tree with
    autograd on (``step_launches``: per TI step 1 K1, 9 K3, 9 K4, 9 K5, 3
    K6; per SDXL LoRA step 140 K3, 70 K4, 70 K5, 14 K6; per SDXL full step
    140, 70, 70, 0), plus the VAE encodes, every K3–K5 on the Hopper path;
    each generate run step 17's checks.

The parallel modules (the fourteenth slice), step 21, after step 11's
``train_full``, on step 6's models and step 10's dataset, with NCCL
initialised at world 1 over a ``file://`` store (torn down after):

21. (a) ``parallel.sweep`` at 512², 4 seeds, PNDM, 10 steps, CFG 8, over
    a ``make_mesh()`` data mesh: each image within step 3's rule of the
    batch-1 ``FlexPipeline`` run on its seed's noise (the rule's scale: the
    kernels' against the plain backends' batch-1 run);
    ``guidance_param_sweep`` with 4 settings (the last setting's image by
    the rule against its batch-1 run) and ``compose_sweep`` with 2 seeds
    and 2 entities (each image by the rule against the composition alone
    at batch 1); K1/K6 launches exactly as the module tree gives them. (b) ``train_lora`` (rank 8, batch 4, 3 steps) with the mesh and
    without: bit-equal losses and factors, exact launches. (c)
    ``sp_pipeline`` at 1024², DDIM, 4 steps, CFG 8, against the plain
    1024² pipeline on the same noise by the rule (its scale: that pipeline
    on the plain backends); e2e seconds of both; launches exactly as a
    meta pass under ``sp_context`` gives them (``sp_tree_launches``: K3 per
    ring-eligible self-attention and round, K1 where the route sends the
    levels below the threshold, K6 none); one SP UNet evaluation (batch
    2) and one SP decode at 1024² against the plain modules without SP,
    within UNET_REL_TOL. (d) ``ring_round`` over 1 (the SP run's round), 2,
    4 and 8 K/V chunks of (2,8,16384,40) and (2,8,4096,80) in one process,
    the rotation by hand, by K1's rule and against K1 on the whole
    sequence;
    K3 timed at every round shape and at SDXL's full fine-tuning shapes
    (1,10,4096,64) and (1,20,1024,64), with SDPA's time, the plain twin's
    where its scores fit, and the bound. (e) ``cli train --data-parallel
    2`` in a subprocess exits non-zero with the missing-card message
    before anything loads. One JSON line per part, each with the card's
    name and power limit.

The real-weight parity harness (the fifteenth slice), step 22, after
step 20's textual inversion, on step 12's snapshot (seeded random SD-1.4
and CLIP ViT-L/14 weights at published widths, read back from disk):

22. Writes synthetic 512² guide and init images (``synthetic_image``, PNG
    bytes) under the file names the harness's configs read. (a) Runs
    ``flexdiffuse_tpu_torch.tools.validate_reference`` (``parse_args``,
    ``build_runner``, ``run``: the card, bf16) with the reference protocol:
    the five configs at 512², PNDM 30 steps, 4 samples, CFG 8, strength
    0.6, seed 1337; asserts that no config is skipped, that every image is
    finite and not constant, and that the K1 and K6 launches equal the
    module tree's (``eval_launches``, ``vae_launches``; every K1 on the
    Hopper path); prints the e2e seconds per config. (b) The numerics gate
    on ``t2i_base`` at 1 sample and STEP22_GATE_STEPS (5) PNDM steps: the
    card's bf16 final latents against a second Runner of the snapshot on
    the CPU in fp32, both from the same CPU noise; asserts MSE ≤ 1e-2
    (``BASELINE.json``'s gate) and prints MSE, relative MSE and max|Δ|.
    Then one pipeline call's output answers ``['sample']``, ``['images']``
    and ``.nsfw_content_detected`` as the reference's. (c) Runs
    ``tools/experiments.py`` once on the snapshot (guide and init image,
    1 sample, 4 steps) with its launches held the same way. One JSON line
    per part, each with the card's name and power limit.

Every kernel's launch count is set to 0 just before each main-path phase
(steps 6, 11, 12, 13, 15, each run of 17, 18 and 19, each training run,
encode and generate run of 20, each sweep, training and SP run of 21, and
the harness and experiments runs of 22) and read just after; launches
made to check a kernel against its plain twin do not count. Any failed
phase raises, so the script exits non-zero; without CUDA it exits
non-zero at once and prints no result.
"""
from __future__ import annotations

import argparse
import base64
import collections
import contextlib
import copy
import dataclasses
import gc
import io
import json
import logging
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image
from torch.profiler import ProfilerActivity, profile

from flexdiffuse_tpu_torch.models import (CLIP_VIT_L14_TEXT,
                                          CLIP_VIT_L14_VISION,
                                          OPENCLIP_BIGG_TEXT,
                                          OPENCLIP_H_TEXT, SD14_UNET,
                                          SD14_VAE, SD21_UNET, SD21_VAE,
                                          SDXL_REFINER_UNET, SDXL_UNET,
                                          SDXL_VAE, AutoencoderKL,
                                          CLIPTextModel, CLIPVisionModel,
                                          UNet2DCondition)
from flexdiffuse_tpu_torch.models import sdxl as sdxl_models
from flexdiffuse_tpu_torch.models.configs import OPENCLIP_H_VISION
from flexdiffuse_tpu_torch.models.controlnet import (COND_EMBED_CHANNELS,
                                                     ControlNetModel)
from flexdiffuse_tpu_torch.models.ip_adapter import (ImageProjection,
                                                     Resampler,
                                                     attn2_layer_order)
from flexdiffuse_tpu_torch.models.unet import CrossAttention
from flexdiffuse_tpu_torch import cli, schedulers, serving, training
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.interface import server as ui_server
from flexdiffuse_tpu_torch.ops import attention as attn_mod
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.ops.tiled_vae import tile_starts
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.tools import flash_opt as tool_opt
from flexdiffuse_tpu_torch.tools import flash_pipelined as tool_pipelined
from flexdiffuse_tpu_torch.tools import flash_tt as tool_tt
from flexdiffuse_tpu_torch.tools import flash_tt3 as tool_tt3
from flexdiffuse_tpu_torch.tools import flash_variants as tool_variants
from flexdiffuse_tpu_torch.tools import reference as fp32_reference
from flexdiffuse_tpu_torch.tools.perf_experiment import (
    kernel_counts as counts, reset_counts)
from flexdiffuse_tpu_torch.training import train as train_mod
from flexdiffuse_tpu_torch.weights import convert as weights_convert
from flexdiffuse_tpu_torch.weights import load as weights_load
from flexdiffuse_tpu_torch.weights import lora as weights_lora
from flexdiffuse_tpu_torch.weights import safetensors as weights_safetensors

SEED = 1337
PROMPT = 'Deer colorful, fantasy, intricate, highly detailed'
KERNEL_SHAPES = [(2, 8, 4096, 40), (4, 8, 4096, 40), (2, 8, 1024, 80),
                 (2, 8, 1536, 40), (2, 10, 4096, 64), (1, 2, 32768, 40)]
MAIN_SHAPES = [(2, 8, 4096, 40), (2, 8, 1024, 80)]
K2_SHAPE = (1, 2, 32768, 40)   # K2's regime, served by K1: timed too
# The serving path's: 8 fused rows under CFG, UNet batch 16 (step 13).
# Their inputs come from a generator of their own (SERVE_SEED), so every
# earlier check draws the inputs it drew before they were added.
SERVE_SHAPES = [(16, 8, 4096, 40), (16, 8, 1024, 80)]
SERVE_SEED = SEED + 9
TIMED_SHAPES = MAIN_SHAPES + [K2_SHAPE] + SERVE_SHAPES
# K6 launches: SD-1.4's UNet has 61 GroupNorms per evaluation (22 resnets ×
# 2, 16 transformers, conv_norm_out), the VAE decoder 30 (14 resnets × 2,
# the mid attention, conv_norm_out), the encoder 22 (10 resnets × 2, the
# mid attention, conv_norm_out).
K6_PER_UNET, K6_PER_DECODE, K6_PER_ENCODE = 61, 30, 22
# Of those, on K6's stream path as ``gn.plan_group_norm`` plans them (the
# rest resident; every UNet GroupNorm at 512² is resident): the decoder's
# at 256² and 512² (five (1,256,256,256), one (1,512,256,256), six
# (1,128,512,512), one (1,256,512,512)), the encoder's (four
# (1,128,512,512), one (1,128,256,256), three (1,256,256,256)).
K6_STREAM_PER_DECODE, K6_STREAM_PER_ENCODE = 13, 8
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


def want_launches(k1: int = 0, k3: int = 0, k4: int = 0, k5: int = 0,
                  k6: int = 0, k6_stream: int = 0) -> dict:
    """The launch counts a main-path run must show (``kernel_counts``):
    every K1, K3, K4 and K5 launch on the Hopper path ('sm90'), none on the
    kept mma.sync kernels; K6's ``k6_stream`` on the stream path, the rest
    resident."""
    return dict(k1=k1, k3=k3, k4=k4, k5=k5, k6=k6, k1_sm90=k1, k1_mma=0,
                k3_sm90=k3, k3_mma=0, k4_sm90=k4, k4_mma=0, k5_sm90=k5,
                k5_mma=0, k6_resident=k6 - k6_stream, k6_stream=k6_stream)


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
# levels at 512² (CFG batch 2, with its largest group and an 8² call, and
# compose batch 4), the VAE's mid-block and largest decoder activations
# (the stream path), fp32 in and out, a ragged one (C/G = 3, HW = 391),
# then the serving path's: the UNet's first and last levels at batch 16
# and the 8-image decode's largest stream shape.
# Groups: 32, as SD-1.4 everywhere.
GN_SHAPES = [((2, 320, 64, 64), True, 1e-5, BF16, BF16, True),
             ((2, 320, 64, 64), False, 1e-6, BF16, BF16, False),
             ((2, 960, 64, 64), True, 1e-5, BF16, BF16, True),
             ((2, 1280, 8, 8), True, 1e-5, BF16, BF16, True),
             ((2, 2560, 8, 8), True, 1e-5, BF16, BF16, False),
             ((4, 640, 64, 64), True, 1e-5, BF16, BF16, False),
             ((1, 512, 64, 64), False, 1e-6, BF16, BF16, False),
             ((1, 256, 512, 512), True, 1e-6, BF16, BF16, True),
             ((1, 128, 512, 512), True, 1e-6, BF16, BF16, False),
             ((4, 320, 64, 64), True, 1e-5, FP32, FP32, False),
             ((3, 96, 17, 23), True, 1e-5, FP32, BF16, False)]
SERVE_GN_SHAPES = [((16, 320, 64, 64), True, 1e-5, BF16, BF16, True),
                   ((16, 1280, 8, 8), True, 1e-5, BF16, BF16, True),
                   ((8, 256, 512, 512), True, 1e-6, BF16, BF16, True)]
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


def host_us(fn, calls: int = 200, reps: int = 3) -> float:
    """Host µs per call of ``fn``: ``calls`` calls enqueued back to back,
    timed on the host clock before the final synchronise; the median of
    ``reps`` such runs (the host clock spreads more than the device's)."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS) -> tuple:
    """The least time the card could take, in ms, and what bounds it."""
    by_flops, by_bytes = flops / peak, nbytes / PEAK_BYTES
    return (max(by_flops, by_bytes) * 1e3,
            'operations' if by_flops >= by_bytes else 'bytes')


def attention_bound(kind: str, b: int, h: int, sq: int, skv: int,
                    d: int, elem: int = 2) -> tuple:
    """Each input read once, each output written once (``elem``-byte
    q/k/v/o/dO and grads, fp32 lse and D); 2·Sq·Skv·d flops per product on
    the bf16 tensor cores: K1/K3 two (S, P·V), K4 three (S, dP, dQ), K5
    four (S, dP, dV, dK)."""
    bh = b * h
    qo, kv, rows = elem * bh * sq * d, elem * bh * skv * d, 4 * bh * sq
    products, nbytes = {
        'k1': (2, 2 * qo + 2 * kv),
        'k3': (2, 2 * qo + 2 * kv + rows),
        'k4': (3, 3 * qo + 2 * kv + 2 * rows),
        'k5': (4, 2 * qo + 4 * kv + 2 * rows)}[kind]
    return bound(products * 2.0 * bh * sq * skv * d, nbytes)


def exp_bound_ms(b: int, h: int, sq: int, skv: int) -> float:
    """The exponential unit's least time for one exp2 per score."""
    return b * h * sq * skv / PEAK_EX2 * 1e3


def time_paths(res: dict, call, kind: str, q, k) -> None:
    """Times of K1, K3, K4 or K5 (``call(path=None)``) on the Hopper path
    and on the kept mma.sync kernel (``path='mma'``: its own entry point,
    the same inputs), interleaved; the bounds; host µs per call of both
    paths."""
    b, h, sq, d = q.shape
    kept = lambda: call(path='mma')
    res['ms'], res['kept_ms'] = time_pair(call, kept)
    res['bound_ms'], res['bound_by'] = attention_bound(kind, b, h, sq,
                                                       k.shape[2], d)
    res['exp_bound_ms'] = exp_bound_ms(b, h, sq, k.shape[2])
    res['host_us'] = host_us(call)
    res['kept_host_us'] = host_us(kept)


def summary(res: dict) -> str:
    return (f'{res["ms"]:.4f} ms (kept mma.sync {res["kept_ms"]:.4f}, SDPA '
            f'{res["library_ms"]:.4f}, bound {res["bound_ms"]:.5f} '
            f'{res["bound_by"]}, exp2 {res["exp_bound_ms"]:.4f}); host '
            f'{res["host_us"]:.1f} µs per call (kept '
            f'{res["kept_host_us"]:.1f})')


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each element of ``x`` (8 significant bits): 2^(e−8)
    for |x| = m·2^e, m in [0.5, 1); 0 at zeros."""
    _, e = torch.frexp(x.float())
    ulp = torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)
    return torch.where(x == 0, torch.zeros_like(ulp), ulp)


def within_rule(got: torch.Tensor, ref: torch.Tensor, tol: float) -> tuple:
    """The kernels' rule, element by element: ``|got − ref| ≤ tol`` (tol =
    twice the twin's max error + 1e-3·max|ref|), except that an element
    whose only excess over ``tol`` is at most one bf16 ulp of its reference
    element passes: an output next to a bf16 midpoint that the kernel
    rounded to the far neighbour and the twin to the near one. Returns
    ``(ok, flipped)``, ``flipped`` the count of such elements."""
    excess = (got.float() - ref.float()).abs() - tol
    over = excess > 0
    if not bool(over.any()):
        return True, 0
    flip = over & (excess <= bf16_ulp(ref))
    return bool((over & ~flip).sum() == 0), int(flip.sum())


def check_kernel(shape, gen: torch.Generator,
                 timed: bool = False) -> dict:
    """K1 against fp32 plain attention on the same bf16 inputs, on the path
    ``fa.plan`` picks (every shape here is on the Hopper path), by
    :func:`within_rule`. Timed at TIMED_SHAPES or with ``timed``."""
    b, h, s, d = shape
    q, k, v = (torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    scale = d**-0.5
    out = fa.flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    # Head by head, so the [S, S] fp32 logits of K2's 32k regime fit.
    err = plain_err = max_ref = 0.0
    refs = []
    for hh in range(h):
        sl = (slice(None), slice(hh, hh + 1))
        ref = fa.plain_attention(q[sl].float(), k[sl].float(),
                                 v[sl].float(), scale)
        plain = fa.plain_attention(q[sl], k[sl], v[sl], scale)
        err = max(err, (out[sl].float() - ref).abs().max().item())
        plain_err = max(plain_err, (plain.float() - ref).abs().max().item())
        max_ref = max(max_ref, ref.abs().max().item())
        refs.append(ref)
        del plain
    tol = 2.0 * plain_err + 1e-3 * max_ref
    ok, flipped = True, 0
    for hh, ref in enumerate(refs):
        o, f = within_rule(out[:, hh:hh + 1], ref, tol)
        ok, flipped = ok and o, flipped + f
    del refs
    how = fa.plan(q, k, v, out)
    res = dict(shape=list(shape), path=how.path, block_q=how.block_q,
               block_kv=how.block_kv, max_abs_err=err,
               plain_max_abs_err=plain_err,
               max_abs_ref=max_ref, tol=tol, flipped=flipped,
               ok=ok and how.path == 'sm90')
    if timed or shape in TIMED_SHAPES:
        time_paths(res, lambda path=None: fa.flash_attention(
            q, k, v, scale, path=path), 'k1', q, k)
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
    too; exactly one launch, on the path ``gn.plan_group_norm`` picks. At
    the timed shapes, replayed from a CUDA graph: K6, on a resident shape
    also its stream path forced, the plain version, ``F.group_norm`` alone
    and with ``F.silu`` (the library call of K6's function); the bound: one
    read of x and one write of y at 3.35 TB/s against ~10 fp32 operations
    per element at 67 TFLOP/s; and the host µs per K6 call."""
    x = (1.5 * torch.randn(shape, generator=gen, device='cuda') +
         0.7).to(din).contiguous(memory_format=torch.channels_last)
    w = (1.0 + 0.5 * torch.randn(shape[1], generator=gen,
                                 device='cuda')).to(din)
    b = (0.3 * torch.randn(shape[1], generator=gen, device='cuda')).to(din)
    args = (x, 32, w, b, eps, silu, dout)
    how = gn.plan_group_norm(tuple(shape), 32, din, dout,
                             x.data_ptr() % 16 == 0)
    before = dict(gn.fused_group_norm.path_launches)
    y = gn.fused_group_norm(*args)
    torch.cuda.synchronize()
    launched = {p: n - before[p]
                for p, n in gn.fused_group_norm.path_launches.items()}
    ref = gn.plain_group_norm(x, 32, w, b, eps, silu, FP32)
    plain = gn.plain_group_norm(*args)
    err = (y.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    max_ref = ref.abs().max().item()
    if dout == FP32:
        tol = 1e-4 * max_ref
        in_rule, flipped = err <= tol, 0
    else:
        tol = 2.0 * plain_err + 1e-3 * max_ref
        in_rule, flipped = within_rule(y, ref, tol)
    res = dict(shape=list(shape), silu=silu,
               eps=eps, dtype=str(din), out_dtype=str(dout), path=how.path,
               slab=how.slab, cluster=how.cluster, pixels=how.pixels,
               smem=how.smem, blocks=how.grid[0] * how.grid[1],
               max_abs_err=err, plain_max_abs_err=plain_err,
               max_abs_ref=max_ref, tol=tol, flipped=flipped,
               ok=bool(in_rule and torch.isfinite(y).all() and
                       y.is_contiguous(memory_format=torch.channels_last) and
                       launched == {p: int(p == how.path)
                                    for p in gn.PATHS}))
    del ref, plain
    if timed:
        res['ms'] = time_ms(lambda: gn.fused_group_norm(*args), graph=True)
        if how.path == 'resident':
            res['stream_ms'] = time_ms(lambda: gn.fused_group_norm(
                *args, path='stream'), graph=True)
        res['host_us'] = host_us(lambda: gn.fused_group_norm(*args))
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


def gn_summary(r: dict) -> str:
    other = (f', stream path forced {r["stream_ms"]:.4f}'
             if 'stream_ms' in r else '')
    return (f'{r["ms"]:.4f} ms on the {r["path"]} path (cluster '
            f'{r["cluster"]}, {r["blocks"]} blocks{other}; plain '
            f'{r["plain_ms"]:.4f}, F.group_norm+F.silu {r["library_ms"]:.4f}, '
            f'bound {r["bound_ms"]:.5f} {r["bound_by"]}, '
            f'{r["bound_ms"] / r["ms"]:.1%} of it); host {r["host_us"]:.1f} '
            f'µs per call')


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
    """Forward hooks on the UNet: counts evaluations and their batch sizes,
    brackets the denoise loop with CUDA events, and keeps device-side
    finiteness flags of ε."""

    def __init__(self, unet) -> None:
        self.calls = 0
        self.first = self.last = None
        self.finite = []
        self.batches = []
        self.handles = [unet.register_forward_pre_hook(self._pre),
                        unet.register_forward_hook(self._post)]

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def reset(self) -> None:
        self.calls = 0
        self.first = self.last = None
        self.finite = []
        self.batches = []

    def _pre(self, module, args):
        self.batches.append(args[0].shape[0])
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
    """K1's rule (:func:`within_rule`) for a kernel output ``got``, its
    fp32 reference and its twin's output."""
    err = (got.float() - ref.float()).abs().max().item()
    plain_err = (plain.float() - ref.float()).abs().max().item()
    max_ref = ref.abs().max().item()
    tol = 2.0 * plain_err + 1e-3 * max_ref
    ok, flipped = within_rule(got, ref, tol)
    return dict(max_abs_err=err, plain_max_abs_err=plain_err,
                max_abs_ref=max_ref, tol=tol, flipped=flipped,
                ok=bool(ok and torch.isfinite(got).all()))


def _backward_paths(q, k, v, dout, lse, dvec, scale) -> dict:
    """K4's dq and K5's (dk, dv) on each path ('sm90': the one
    ``plan_backward`` picks here; 'mma': the kept kernels forced), each
    launched twice: {path: ((dq, dk, dv), bit-equal over the two)}."""
    args = (q, k, v, dout, lse, dvec, scale)
    out = {}
    for path in ('sm90', 'mma'):
        runs = [(fb.flash_attention_dq(*args, path=path),
                 *fb.flash_attention_dkv(*args, path=path)) for _ in range(2)]
        torch.cuda.synchronize()
        out[path] = (runs[0], all(torch.equal(a, b)
                                  for a, b in zip(*runs)))
    return out


def check_train_kernels(shape, skv: int, gen: torch.Generator,
                        timed: bool) -> dict:
    """K3, K4 and K5 against their fp32 plain twins on the same bf16 inputs,
    by K1's rule; K4 and K5 on the Hopper path (which ``plan_backward``
    must pick) and on the kept kernels, each launched twice with bit-equal
    results; times at the training shapes. The rule's 'plain' error, as
    K1's bf16 plain version rounds P before P·V: for K3 the twin on the
    bf16 inputs (fp32 math, 16-bit output); for K4 and K5 the twins' math
    with P and dS rounded to the inputs' dtype before the products, as the
    kernels' tensor cores take them (``twin_max_abs_err``: without that
    rounding). ``timed``: also time the kernels."""
    b, h, sq, d = shape
    q, dout = (torch.randn(shape, generator=gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((b, h, skv, d), generator=gen, device='cuda',
                        dtype=torch.bfloat16) for _ in range(2))
    scale = d**-0.5
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    dvec = fb.attention_delta(dout, o)
    paths = _backward_paths(q, k, v, dout, lse, dvec, scale)
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
    refs = (fb.plain_attention_dq(*f32, *rows),
            *fb.plain_attention_dkv(*f32, *rows))
    plains = (torch.matmul(ds16, f32[1]).to(q.dtype),
              torch.matmul(ds16.transpose(-1, -2), f32[0]).to(q.dtype),
              torch.matmul(p16.transpose(-1, -2), f32[3]).to(q.dtype))
    twins = (fb.plain_attention_dq(q, k, v, dout, *rows),
             *fb.plain_attention_dkv(q, k, v, dout, *rows))
    del p16, ds16
    # errs[path][i]: dq, dk, dv
    errs = {path: [_errs(g, r, pl) for g, r, pl in zip(outs, refs, plains)]
            for path, (outs, _) in paths.items()}
    for r, t, ref in zip(errs['sm90'], twins, refs):
        r['twin_max_abs_err'] = (t.float() - ref).abs().max().item()
    del twins, refs, plains
    for name, kind, parts, outs in (('k4', 'dq', slice(0, 1), (0,)),
                                    ('k5', 'dkv', slice(1, 3), (1, 2))):
        how = fb.plan_backward(kind, q, k, v, dout,
                               *(paths['sm90'][0][i] for i in outs))
        new, kept = errs['sm90'][parts], errs['mma'][parts]
        res[name] = dict(path=how.path,
                         max_abs_err=max(r['max_abs_err'] for r in new),
                         kept_max_abs_err=max(r['max_abs_err'] for r in kept),
                         deterministic=paths['sm90'][1] and paths['mma'][1],
                         grads=dict(zip(('dq',) if name == 'k4' else
                                        ('dk', 'dv'), new)),
                         kept=dict(zip(('dq',) if name == 'k4' else
                                       ('dk', 'dv'), kept)))
        res[name]['ok'] = bool(all(r['ok'] for r in new + kept) and
                               how.path == 'sm90' and
                               res[name]['deterministic'])
    if timed:
        args = (q, k, v, dout, lse, dvec, scale)
        time_paths(res['k3'], lambda path=None: fb.flash_attention_lse(
            q, k, v, scale, path=path), 'k3', q, k)
        res['k3']['plain_ms'] = time_ms(
            lambda: fb.plain_attention_lse(q, k, v, scale))
        for name, kern, plain_fn in (
                ('k4', fb.flash_attention_dq, fb.plain_attention_dq),
                ('k5', fb.flash_attention_dkv, fb.plain_attention_dkv)):
            time_paths(res[name], lambda path=None: kern(*args, path=path),
                       name, q, k)
            res[name]['plain_ms'] = time_ms(lambda: plain_fn(*args))
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


FP32_SHAPE = (1, 8, 4096, 40)   # SD-1.x's 4096-token self-attention


def _rounded(*tensors):
    """fp32 tensors as the kept kernels' products take them (bf16)."""
    return [t.to(BF16).float() for t in tensors]


def check_fp32_attention(gen: torch.Generator) -> dict:
    """fp32 attention on the card, on the kernels' kept path (the Hopper
    path takes 16 bits; the kept kernels round fp32 to bf16 as they stage
    it). At FP32_SHAPE: K1, K3, K4 and K5 on fp32 tensors against their
    fp32 twins by K1's rule, whose plain version takes the inputs rounded
    to bf16 (K3's lse: within 1e-3 of the twin's on those inputs; K3's o
    bit-equal to K1's; K4/K5 bit-equal over two launches); then
    ``attention`` on fp32 q/k/v without and with a gradient and an fp32
    SD-1.x self-attention (``CrossAttention``, 320 channels, 8 heads of 40)
    against plain attention and its autograd by the same rule (plain
    version: the same in bf16), with exactly the launches that implies,
    all on the kept path. Times each kernel against its twin,
    ``scaled_dot_product_attention`` on the fp32 tensors and the bound
    (fp32 bytes, bf16 tensor-core operations)."""
    shape = FP32_SHAPE
    q, k, v, dout, w = (torch.randn(shape, generator=gen, device='cuda')
                        for _ in range(5))
    scale = shape[-1]**-0.5
    reset_counts()
    out = fa.flash_attention(q, k, v, scale)
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    dvec = fb.attention_delta(dout, o)
    args = (q, k, v, dout, lse, dvec, scale)
    runs = [(fb.flash_attention_dq(*args), *fb.flash_attention_dkv(*args))
            for _ in range(2)]
    torch.cuda.synchronize()
    kernel_launches = {n: c for n, c in counts().items() if c}
    r16 = _rounded(q, k, v, dout)
    res = dict(shape=list(shape))
    res['k1'] = _errs(out, fb.plain_attention_lse(q, k, v, scale)[0],
                      fa.plain_attention(*(t.to(BF16) for t in (q, k, v)),
                                         scale))
    res['k3'] = dict(equals_k1=torch.equal(o, out),
                     lse_max_abs_err=(lse - fb.plain_attention_lse(
                         *r16[:3], scale)[1]).abs().max().item())
    res['k3']['ok'] = bool(res['k3']['equals_k1'] and
                           res['k3']['lse_max_abs_err'] <= 1e-3)
    rows = (lse, dvec, scale)
    p16, ds16 = (t.to(BF16).float() for t in fb._probs_and_ds(*r16, *rows))
    refs = (fb.plain_attention_dq(q, k, v, dout, *rows),
            *fb.plain_attention_dkv(q, k, v, dout, *rows))
    plains = (torch.matmul(ds16, r16[1]),
              torch.matmul(ds16.transpose(-1, -2), r16[0]),
              torch.matmul(p16.transpose(-1, -2), r16[3]))
    grads = [_errs(g, r, pl) for g, r, pl in zip(runs[0], refs, plains)]
    del p16, ds16, refs, plains
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    res['k4'] = dict(grads[0], deterministic=same)
    res['k5'] = dict(max_abs_err=max(g['max_abs_err'] for g in grads[1:]),
                     grads=dict(dk=grads[1], dv=grads[2]), deterministic=same,
                     ok=grads[1]['ok'] and grads[2]['ok'])
    res['kernel_launches'] = kernel_launches

    # The dispatcher, as a user calls it.
    reset_counts()
    with torch.no_grad():
        got = attn_mod.attention(q, k, v)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    got_grads = torch.autograd.grad((attn_mod.attention(*leaves) * w).sum(),
                                    leaves)
    layer = CrossAttention(320, 8).cuda().requires_grad_(False)
    x = torch.randn((1, 4096, 320), generator=gen, device='cuda')
    y = layer(x)
    torch.cuda.synchronize()
    res['dispatcher_launches'] = {n: c for n, c in counts().items() if c}

    def plain(dtype):
        ts = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        o_ = attn_mod.attention(*ts, backend='plain')
        return o_.detach(), torch.autograd.grad((o_.float() * w).sum(), ts)

    (ref, ref_grads), (p16, p16_grads) = plain(FP32), plain(BF16)
    with attn_mod.backend('plain'):
        ref_y = layer(x)
        p16_y = copy.deepcopy(layer).to(BF16)(x.to(BF16))
    res['attention'] = _errs(got, ref, p16)
    res['attention_grads'] = [_errs(g, r, pl) for g, r, pl in
                              zip(got_grads, ref_grads, p16_grads)]
    res['layer'] = _errs(y, ref_y, p16_y)
    want_kernels = dict(k1=1, k1_mma=1, k3=1, k3_mma=1, k4=2, k4_mma=2, k5=2,
                        k5_mma=2)
    want_dispatch = dict(k1=2, k1_mma=2, k3=1, k3_mma=1, k4=1, k4_mma=1,
                         k5=1, k5_mma=1)
    res['ok'] = bool(
        all(res[n]['ok'] for n in ('k1', 'k3', 'k4', 'k5', 'attention',
                                   'layer')) and same and
        all(g['ok'] for g in res['attention_grads']) and
        kernel_launches == want_kernels and
        res['dispatcher_launches'] == want_dispatch and
        all(t.dtype == FP32 for t in (out, o, *runs[0], got, *got_grads, y)))

    # Times: each kernel, its twin, SDPA on the same fp32 tensors, bounds.
    b, h, sq, d = shape
    for name, call, twin in (
            ('k1', lambda: fa.flash_attention(q, k, v, scale),
             lambda: fa.plain_attention(q, k, v, scale)),
            ('k3', lambda: fb.flash_attention_lse(q, k, v, scale),
             lambda: fb.plain_attention_lse(q, k, v, scale)),
            ('k4', lambda: fb.flash_attention_dq(*args),
             lambda: fb.plain_attention_dq(*args)),
            ('k5', lambda: fb.flash_attention_dkv(*args),
             lambda: fb.plain_attention_dkv(*args))):
        res[name]['ms'] = time_ms(call, graph=True)
        res[name]['plain_ms'] = time_ms(twin)
        res[name]['bound_ms'], res[name]['bound_by'] = attention_bound(
            name, b, h, sq, sq, d, elem=4)
    sdpa_leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    res['k1']['library_ms'] = res['k3']['library_ms'] = time_ms(
        lambda: F.scaled_dot_product_attention(*sdpa_leaves, scale=scale),
        graph=True)
    sdpa_out = F.scaled_dot_product_attention(*sdpa_leaves, scale=scale)
    res['k4']['library_ms'] = res['k5']['library_ms'] = time_ms(
        lambda: torch.autograd.grad(sdpa_out, sdpa_leaves, dout,
                                    retain_graph=True))
    print(f'fp32 attention on the card: {json.dumps(res)}')
    for name in ('k1', 'k3', 'k4', 'k5'):
        m = res[name]
        print(f'{name.upper()} fp32 {shape}: {m["ms"]:.4f} ms (kept path; '
              f'plain {m["plain_ms"]:.4f}, SDPA {m["library_ms"]:.4f}, bound '
              f'{m["bound_ms"]:.5f} {m["bound_by"]})')
    if not res['ok']:
        raise AssertionError('fp32 attention on the card disagrees with '
                             'plain attention, or left the kept kernels')
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
    if moved != step_launches(unet.config, 'lora', 'none', TRAIN_BATCH,
                              64):
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
        data = write_images(tmp, 'data', n, 512, SEED, captions=True)
        return training.encode_dataset(training.find_items(data), vae,
                                       runner.encoder, resolution=512,
                                       encode_batch=4)


def run_training(label: str, train_fn, steps: int, want: dict,
                 batch: int = TRAIN_BATCH, check: bool = True) -> dict:
    """Drive one training entry point with the launch counts at 0; check
    finite losses and the exact launches ``want`` (:func:`train_want`);
    time the steps (``batch`` images each)."""
    cuda = torch.cuda.is_available()
    stamps = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    stamps.append(time.perf_counter())
    _, losses = train_fn(lambda i, loss: stamps.append(time.perf_counter()))
    if cuda:
        torch.cuda.synchronize()
    got = counts()
    per_step = [b - a for a, b in zip(stamps, stamps[1:])]
    ms = statistics.median(per_step[1:]) * 1e3   # the first step warms up
    res = dict(label=label, steps=steps, batch=batch, losses=losses,
               median_step_ms=ms, images_per_s=batch / ms * 1e3,
               max_memory_gib=(torch.cuda.max_memory_allocated() / 2**30
                               if cuda else None),
               launches=got, expected=want)
    print(f'{label}: {json.dumps(res)}', flush=True)
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f'{label}: losses {losses}')
    if check and got != want:
        raise AssertionError(f'{label}: launches {got}, expected {want}')
    return res


# Kernel name fragment → group, first match wins.
GROUPS = [('flash_fwd_sm90_kernel', 'flash forward (K1/K3)'),
          ('flash_fwd_kernel', 'flash forward, kept mma.sync (K1/K3)'),
          ('flash_bwd_dq_sm90', 'flash dq (K4)'),
          ('flash_bwd_dkv_sm90', 'flash dk/dv (K5)'),
          ('flash_bwd_dq', 'flash dq, kept mma.sync (K4)'),
          ('flash_bwd_dkv', 'flash dk/dv, kept mma.sync (K5)'),
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
        list(pool.map(fa.build, (fa.SOURCE, fb.SOURCE),
                      (fa.BUILD_PARTS, fb.BUILD_PARTS)))
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
    want_vae = want_launches(k6=K6_PER_DECODE,
                             k6_stream=K6_STREAM_PER_DECODE)
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
                         K6_PER_ENCODE * encodes,
                         k6_stream=K6_STREAM_PER_DECODE * decodes +
                         K6_STREAM_PER_ENCODE * encodes)
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


def profile_generate(steps: int, out: str, family: str = 'sd1') -> None:
    """``--profile-gen``: where a 512² UNet evaluation's time goes (CFG
    batch 2, bf16, seeded random SD-1.4 weights), through K1 and K6, then
    through K1 with the plain GroupNorm, each by ``profile_steps``. With
    ``family`` 'sdxl': the SDXL base UNet at 1024² (CFG batch 2, seeded
    random weights, random context and ``added_cond``), through K1 and
    K6."""
    with ThreadPoolExecutor(3) as pool:
        list(pool.map(fa.build, (fa.SOURCE, fb.SOURCE, gn.SOURCE),
                      (fa.BUILD_PARTS, fb.BUILD_PARTS, 1)))
    if family == 'sdxl':
        torch.manual_seed(STEP19_SEED)
        with torch.device('cuda'):
            unet = UNet2DCondition(SDXL_UNET)
        unet = unet.to(BF16).eval().requires_grad_(False)
        gen = torch.Generator('cuda').manual_seed(STEP19_SEED)
        lat = torch.randn((2, 128, 128, 4), generator=gen, device='cuda')
        t = torch.full((2,), 981.0, device='cuda')
        ctx = torch.randn((2, 77, 2048), generator=gen, device='cuda')
        added = {'text_embeds': torch.randn((2, 1280), generator=gen,
                                            device='cuda'),
                 'time_ids': sdxl_models.time_ids().expand(2, -1)}

        def xl_step():
            with torch.no_grad():
                unet(lat, t, ctx, added_cond=added)

        profile_steps('sdxl_unet_k6', xl_step, steps, out)
        return
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
K6_AB = dict(k6=K6_PER_UNET, k6_resident=K6_PER_UNET)
AB_LAUNCHES = {'k1': dict(k1=LAUNCHES_PER_UNET, k1_sm90=LAUNCHES_PER_UNET,
                          **K6_AB),
               'pipelined_attention': dict(
                   pipelined_attention=LAUNCHES_PER_UNET, **K6_AB),
               'flash_tt2': dict(flash_tt2=LAUNCHES_PER_UNET, **K6_AB),
               'flash_ttv3': dict(flash_ttv3=LAUNCHES_PER_UNET, **K6_AB)}
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
                f'(twin {r["plain_max_abs_err"]:.3e}, limit {r["tol"]:.3e}, '
                f'{r["flipped"]} rounding flips)')
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


# The loading phase: a full-width HF-layout snapshot of the seeded random
# weights, written to a temporary directory and loaded through
# ``Runner(model_root=...)`` on its defaults (the card, bf16).
SNAPSHOT_DTYPE = torch.float16
BPE_CHARS = 'abcdefghijklmnopqrstuvwxyz0123456789{}!?.,-'
LORA_RANK, TI_TOKEN = 8, '<deer-style>'
LONG_PROMPT = ' '.join([PROMPT] * 4)        # ~180 tokens: three windows
WEIGHTED_PROMPT = ('(deer:1.3) colorful, [fantasy], intricate BREAK '
                   '((highly detailed))')
DISK_TRAIN_STEPS = 2


def write_bpe_files(dst: str, vocab_size: int) -> None:
    """A character-level ``vocab.json``/``merges.txt`` padded with unused
    entries to ``vocab_size`` ids, BOS and EOS last (as CLIP's are), so
    the tokenizer's id space matches the 49408-row embedding."""
    vocab = {}
    for c in BPE_CHARS:
        vocab[c] = len(vocab)
        vocab[c + '</w>'] = len(vocab)
    while len(vocab) < vocab_size - 2:
        vocab[f'<unused{len(vocab)}>'] = len(vocab)
    vocab['<|startoftext|>'] = len(vocab)
    vocab['<|endoftext|>'] = len(vocab)
    with open(os.path.join(dst, 'vocab.json'), 'w') as f:
        json.dump(vocab, f)
    with open(os.path.join(dst, 'merges.txt'), 'w') as f:
        f.write('#version: 0.2\n')


def write_snapshot(root: str, text, vision, unet, vae) -> dict:
    """The models' weights as an HF-layout snapshot under ``root`` (fp16
    safetensors: ``unet/``, ``vae/`` and CLIP's ``model.safetensors``, one
    file for both towers), after checking the free space."""
    cfg = RunConfig()
    sd_dir, clip_dir = weights_load.snapshot_dirs(root, cfg.sd_model,
                                                  cfg.clip_model)
    files = {os.path.join(sd_dir, 'unet',
                          'diffusion_pytorch_model.safetensors'):
             unet.state_dict(),
             os.path.join(sd_dir, 'vae',
                          'diffusion_pytorch_model.safetensors'):
             vae.state_dict(),
             os.path.join(clip_dir, 'model.safetensors'):
             {**text.state_dict(), **vision.state_dict()}}
    snapshot = sum(t.numel() * 2 for sd in files.values()
                   for t in sd.values())
    save = sum(p.numel() * 4 for p in unet.parameters())   # the fp32 save
    need = snapshot + save
    free = shutil.disk_usage(root).free
    print(f'snapshot: {snapshot / 2**30:.2f} GiB, then the fp32 UNet save '
          f'{save / 2**30:.2f} GiB, under {root}; {free / 2**30:.1f} GiB '
          'free')
    if free < 1.1 * need:
        raise RuntimeError(f'not enough free space under {root}: '
                           f'{free / 2**30:.1f} GiB for '
                           f'{1.1 * need / 2**30:.1f}')
    t0 = time.perf_counter()
    for path, sd in files.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        weights_safetensors.save_file(
            {k: v.to(SNAPSHOT_DTYPE) for k, v in sd.items()}, path)
    write_bpe_files(clip_dir, CLIP_VIT_L14_TEXT.vocab_size)
    return dict(sd_dir=sd_dir, clip_dir=clip_dir, bytes=snapshot,
                write_s=time.perf_counter() - t0)


def rss_gib() -> tuple:
    """(current, peak) host RSS of this process in GiB (``VmRSS``, and
    ``ru_maxrss`` in KiB)."""
    with open('/proc/self/status') as f:
        cur = next(int(line.split()[1]) for line in f
                   if line.startswith('VmRSS:'))
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return cur / 2**20, peak / 2**20


def load_runner(root: str, make=None) -> tuple:
    """``Runner(model_root=root)`` on its defaults (or ``make()``), timing
    the part spent filling the modules on the card
    (``weights.load.instantiate``)."""
    spent = []
    real = weights_load.instantiate

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = real(*args, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t0)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    weights_load.instantiate = timed
    try:
        t0 = time.perf_counter()
        runner = make() if make else Runner(model_root=root)
        total = time.perf_counter() - t0
    finally:
        weights_load.instantiate = real
    return runner, dict(load_s=total - sum(spent), to_card_s=sum(spent),
                        runner_s=total, peak_device_gib=(
                            torch.cuda.max_memory_allocated() / 2**30))


def check_loaded(runner, text, vision, unet, vae) -> None:
    """Every loaded tensor of the Runner equals the written one."""
    check_pairs(((runner.encoder.text_model, text),
                 (runner.encoder.vision_model, vision),
                 (runner.pipe.unet, unet), (runner.pipe.vae, vae)))


def check_pairs(pairs) -> None:
    """Every tensor of each loaded module equals its source's (rounded to
    the snapshot's fp16, then to the module's bf16), ``pairs`` of (loaded,
    source)."""
    for loaded, src in pairs:
        want = src.state_dict()
        got = loaded.state_dict()
        if sorted(got) != sorted(want):
            raise AssertionError(f'{type(src).__name__}: loaded keys differ')
        for k, v in got.items():
            w = want[k].to(SNAPSHOT_DTYPE).to(v.dtype)
            if v.device.type != 'cuda' or not torch.equal(v, w):
                raise AssertionError(f'{type(src).__name__}.{k}: the loaded '
                                     'tensor differs from the written one')


def write_lora(path: str, unet, text, seed: int) -> str:
    """A rank-8 kohya adapter from seeded factors on every attention
    projection of the UNet and the text encoder; returns one adapted
    module's name."""
    gen = torch.Generator().manual_seed(seed)
    out = {}
    names = [(n, m) for n, m in unet.named_modules()
             if n.endswith(('attn1.to_q', 'attn1.to_k', 'attn1.to_v',
                            'attn1.to_out.0', 'attn2.to_q', 'attn2.to_k',
                            'attn2.to_v', 'attn2.to_out.0'))]
    te = [(n, m) for n, m in text.named_modules()
          if n.endswith(('q_proj', 'k_proj', 'v_proj', 'out_proj'))]
    for prefix, mods in (('lora_unet_', names), ('lora_te_', te)):
        for n, m in mods:
            key = prefix + n.replace('.', '_')
            out[f'{key}.lora_down.weight'] = 0.02 * torch.randn(
                (LORA_RANK, m.in_features), generator=gen)
            out[f'{key}.lora_up.weight'] = 0.02 * torch.randn(
                (m.out_features, LORA_RANK), generator=gen)
            out[f'{key}.alpha'] = torch.tensor(float(LORA_RANK))
    weights_safetensors.save_file(out, path)
    return names[0][0]


def check_lora_merge(runner, path: str, name: str, stored) -> None:
    """The merged bf16 weight of ``name`` is the snapshot's stored value
    plus the update, in fp32, rounded once."""
    (down, up, a), = [v for (t, n), v in weights_lora.parse_lora(
        weights_load.load_state_dict(path))[0].items() if n == name]
    delta = torch.from_numpy((a * (up.astype(np.float64) @
                                   down.astype(np.float64))
                              ).astype(np.float32))
    got = dict(runner.pipe.unet.named_modules())[name].weight
    want = (stored.float() + delta).to(got.dtype)
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f'LoRA merge of {name} is not the stored weight '
                             'plus the update rounded once')


def run_disk_phases(text, vision, unet, vae, ds, root: str) -> dict:
    """The loading phase (module docstring, step 12): snapshot, Runner on
    its defaults, LoRA, textual inversion, long and weighted prompts, then
    full fine-tuning of the snapshot's UNet with a save and its reload.
    Returns the Runner too, for the surfaces phase."""
    snap = write_snapshot(root, text, vision, unet, vae)
    runner, timing = load_runner(root)
    cur, peak = rss_gib()
    load_res = dict(snapshot_gib=snap['bytes'] / 2**30, write_s=snap['write_s'],
                    **timing, host_rss_gib=cur, peak_host_rss_gib=peak)
    print(f'loading: {json.dumps(load_res)}')
    check_loaded(runner, text, vision, unet, vae)
    if runner.encoder.tokenizer._native is None:
        raise AssertionError('the native BPE is not in use')
    dtypes = {p.dtype for p in runner.pipe.unet.parameters()}
    if dtypes != {torch.bfloat16} or runner.pipe.device.type != 'cuda':
        raise AssertionError(f'Runner defaults: {dtypes} on '
                             f'{runner.pipe.device}')
    enc = runner.encoder
    windows = enc.prompt_chunked(LONG_PROMPT).shape[1] // 77
    if windows != 3:
        raise AssertionError(f'the long prompt takes {windows} windows')

    lora_path = os.path.join(root, 'style.safetensors')
    name = write_lora(lora_path, unet, text, SEED)
    stored = weights_convert.normalize(weights_load.load_state_dict(
        os.path.join(snap['sd_dir'], 'unet')), 'unet')[f'{name}.weight']
    runner.apply_lora(lora_path, scale=1.0)
    check_lora_merge(runner, lora_path, name, stored)
    ti_path = os.path.join(root, 'concept.safetensors')
    weights_safetensors.save_file({'emb_params': 0.01 * torch.randn(
        (2, CLIP_VIT_L14_TEXT.hidden_size),
        generator=torch.Generator().manual_seed(SEED))}, ti_path)

    probe = UNetProbe(runner.pipe.unet)
    latent_finite = []
    hook = runner.pipe.vae.post_quant_conv.register_forward_pre_hook(
        lambda m, args: latent_finite.append(torch.isfinite(args[0]).all()))
    common = dict(guide=synthetic_image(512, SEED), steps=25,
                  guidance_scale=8, samples=1, seed=SEED, save=False)
    runs = [run_generate('disk: lora', lambda: runner.gen(
        prompt=PROMPT, **common), probe, latent_finite, 1, 0, 1)]
    runner.load_textual_inversion(ti_path, token=TI_TOKEN)
    runs += [run_generate(label, call, probe, latent_finite, 1, 0, 1)
             for label, call in (
                 ('disk: textual inversion', lambda: runner.gen(
                     prompt=f'{PROMPT}, {TI_TOKEN}', **common)),
                 ('disk: long prompt', lambda: runner.gen(
                     prompt=LONG_PROMPT, long_prompt=True, **common)),
                 ('disk: weighted', lambda: runner.gen(
                     prompt=WEIGHTED_PROMPT, weighted=True, **common)))]
    hook.remove()
    probe.remove()
    del probe

    unet_sd, _ = weights_load.load_sd(snap['sd_dir'])
    unet32 = weights_load.instantiate(UNet2DCondition, SD14_UNET, unet_sd,
                                      'cuda', torch.float32)
    unet32.requires_grad_(True)
    save_path = os.path.join(root, 'unet_full.msgpack')
    trained = {}

    def train(on_step):
        params, losses = training.train_full(
            unet32, ds, training.TrainConfig(learning_rate=1e-5,
                                             remat='full'),
            steps=DISK_TRAIN_STEPS, batch_size=TRAIN_BATCH, seed=SEED,
            log_every=1, on_step=on_step, save_path=save_path)
        trained.update(params)
        return params, losses

    full = run_training('disk: train_full', train, DISK_TRAIN_STEPS,
                        train_want(SD14_UNET, 'full', 'full', TRAIN_BATCH, 64,
                                   DISK_TRAIN_STEPS))
    t0 = time.perf_counter()
    reloaded = weights_load.load_unet_msgpack(save_path, SD14_UNET)
    reload_s = time.perf_counter() - t0
    if sorted(reloaded) != sorted(unet32.state_dict()):
        raise AssertionError('the saved UNet has other keys')
    for k, v in trained.items():
        if not torch.equal(reloaded[k], v.detach().cpu()):
            raise AssertionError(f'the saved UNet differs at {k}')
    print(f'disk: train_full save {os.path.getsize(save_path) / 2**30:.2f} '
          f'GiB, reloaded and equal in {reload_s:.1f} s')
    load_res.update(reload_s=reload_s)
    launches = {k: sum(r['launches'][k] for r in runs) + full['launches'][k]
                for k in full['launches']}
    return dict(load=load_res, runs=runs, full=full, launches=launches,
                runner=runner)


# The surfaces phase (the ninth slice): the CLI, the web UI and the serving
# API, as a user starts them, on the loading phase's snapshot and Runner.
SURFACE_STEPS = 25
SURFACE_SIZE = 512        # pixels, square
SURFACE_PIXELS = (SURFACE_SIZE, SURFACE_SIZE, 3)
SERVE_ROWS = 8            # max_batch_rows: UNet batch 16 under CFG
SERVE_WAIT_MS = 5000.0    # a window the concurrent requests never wait out
FIXED_SEED = 1234


def _b64_pixels(data: str) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(
        data.split(',')[-1]))))


def _http(url: str, payload=None) -> dict:
    """GET (no payload) or POST JSON; any status but 200 raises."""
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=900) as r:
        if r.status != 200:
            raise AssertionError(f'{url}: HTTP {r.status}')
        return json.loads(r.read())


def _concurrent(url: str, payloads) -> list:
    """POST every payload at once, each from its own thread; the answers in
    order."""
    with ThreadPoolExecutor(len(payloads)) as pool:
        return list(pool.map(lambda p: _http(url, p), payloads))


class _Server:
    """A ``ThreadingHTTPServer`` serving from a thread until ``close``."""

    def __init__(self, httpd) -> None:
        self.httpd = httpd
        self.url = f'http://127.0.0.1:{httpd.server_address[1]}'
        self.thread = threading.Thread(target=httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=60)
        service = getattr(self.httpd.RequestHandlerClass, 'service', None)
        if service is not None:
            service.batcher.shutdown()


def _surface_launches(label: str, evals: int, decodes: int) -> dict:
    """The launches since the last reset against step 7's rule for
    ``evals`` UNet evaluations and ``decodes`` VAE decodes."""
    got = counts()
    want = want_launches(k1=LAUNCHES_PER_UNET * evals,
                         k6=K6_PER_UNET * evals + K6_PER_DECODE * decodes,
                         k6_stream=K6_STREAM_PER_DECODE * decodes)
    print(f'{label}: {evals} UNet evaluations, {decodes} decodes, launches '
          f'{json.dumps(got)}')
    if got != want:
        raise AssertionError(f'{label}: launches {got}, expected {want}')
    return got


def _add(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] = total.get(k, 0) + v


def _pngs(out: str) -> list:
    names = sorted(n for n in os.listdir(out) if n.endswith('.png'))
    arrs = [np.asarray(Image.open(os.path.join(out, n))) for n in names]
    if any(a.shape != SURFACE_PIXELS or a.dtype != np.uint8 for a in arrs):
        raise AssertionError(f'{out}: images '
                             f'{[(a.shape, a.dtype) for a in arrs]}')
    return arrs


def run_cli(root: str, guide_path: str) -> dict:
    """The CLI in-process (``generate``, ``compose``) with the launches of
    step 7's rule, then one ``python -m flexdiffuse_tpu_torch.cli
    generate`` in a subprocess (rc 0, one PNG)."""
    per_gen = schedulers.make('pndm', SURFACE_STEPS).length
    total = {}
    common = ['--models', root, '--steps', str(SURFACE_STEPS),
              '--guidance-scale', '8', '--seed', str(SEED), '--height',
              str(SURFACE_SIZE), '--width', str(SURFACE_SIZE)]
    out = os.path.join(root, 'cli_generate')
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    if cli.main(['generate', *common, '--prompt', PROMPT, '--guide',
                 guide_path, '--samples', '2', '--out', out]) != 0:
        raise AssertionError('cli generate failed')
    gen_s = time.perf_counter() - t0
    _add(total, _surface_launches('cli generate', 2 * per_gen, 2))
    if len(_pngs(out)) != 2:
        raise AssertionError('cli generate wrote other than 2 images')

    schema = os.path.join(root, 'schema.json')
    with open(schema, 'w') as f:
        json.dump({'background_prompt': PROMPT, 'style_start_prompt': '',
                   'style_end_prompt': '', 'style_blend': [0.0, 1.0],
                   'entities': [{'prompt': p, 'offset': [x, y],
                                 'size': [w, h], 'blend': b}
                                for p, x, y, w, h, b in COMPOSE_ENTITIES]},
                  f)
    out = os.path.join(root, 'cli_compose')
    reset_counts()
    t0 = time.perf_counter()
    if cli.main(['compose', *common, '--schema', schema, '--samples', '1',
                 '--out', out]) != 0:
        raise AssertionError('cli compose failed')
    compose_s = time.perf_counter() - t0
    _add(total, _surface_launches('cli compose', per_gen, 1))
    if len(_pngs(out)) != 1:
        raise AssertionError('cli compose wrote other than 1 image')

    out = os.path.join(root, 'cli_subprocess')
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'flexdiffuse_tpu_torch.cli', 'generate',
         *common, '--prompt', PROMPT, '--guide', guide_path, '--samples',
         '1', '--out', out], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    sub_s = time.perf_counter() - t0
    if proc.returncode != 0 or len(_pngs(out)) != 1:
        raise AssertionError(f'python -m flexdiffuse_tpu_torch.cli generate: '
                             f'rc {proc.returncode}\n{proc.stderr[-4000:]}')
    res = dict(generate_s=gen_s, compose_s=compose_s, subprocess_s=sub_s,
               launches=total)
    print(f'cli: {json.dumps(res)}')
    return res


def run_ui(runner, guide_path: str) -> dict:
    """The web UI (``interface.server.launch`` on port 0) serving the
    Runner: ``/api/generate`` (2 samples, a base64 guide image) and
    ``/api/compose`` (2 entities), 512² PNGs and exact launches."""
    per_gen = schedulers.make('pndm', SURFACE_STEPS).length
    ui_server._runner = None
    server = _Server(ui_server.launch(lambda: runner, port=0))
    total = {}
    try:
        if _http(server.url + '/api/health') != {'ok': True}:
            raise AssertionError('/api/health')
        with open(guide_path, 'rb') as f:
            guide = 'data:image/png;base64,' + base64.b64encode(
                f.read()).decode()
        reset_counts()
        t0 = time.perf_counter()
        out = _http(server.url + '/api/generate', dict(
            prompt=PROMPT, guide_image=guide, steps=SURFACE_STEPS,
            samples=2, seed=SEED, height=SURFACE_SIZE,
            width=SURFACE_SIZE))
        gen_s = time.perf_counter() - t0
        _add(total, _surface_launches('ui generate', 2 * per_gen, 2))
        images = [_b64_pixels(i) for i in out['images']]
        reset_counts()
        t0 = time.perf_counter()
        out = _http(server.url + '/api/compose', dict(
            bg_prompt=PROMPT, entities=COMPOSE_ENTITIES,
            steps=SURFACE_STEPS, samples=1, seed=SEED, height=SURFACE_SIZE,
            width=SURFACE_SIZE))
        compose_s = time.perf_counter() - t0
        _add(total, _surface_launches('ui compose', per_gen, 1))
        images += [_b64_pixels(i) for i in out['images']]
    finally:
        server.close()
        ui_server._runner = None
    if len(images) != 3 or any(a.shape != SURFACE_PIXELS for a in images):
        raise AssertionError(f'ui images {[a.shape for a in images]}')
    res = dict(generate_s=gen_s, compose_s=compose_s, launches=total)
    print(f'ui: {json.dumps(res)}')
    return res


def _serve(runner, **kw) -> _Server:
    server = _Server(serving.launch(lambda: runner, port=0,
                                    max_batch_rows=SERVE_ROWS, **kw))
    health = _http(server.url + '/v1/health')
    if health['devices'] != [serving.api.describe_device(
            runner.pipe.device)] or 'cuda' not in health['devices'][0]:
        raise AssertionError(f'/v1/health {health}')
    return server


def _timed_dispatches(server: _Server) -> list:
    """Wraps the service's batch call: each dispatch's (rows run, host
    seconds from its start to its images on the host)."""
    batcher = server.httpd.RequestHandlerClass.service.batcher
    real = batcher._run
    seen = []

    def timed(payloads, rows):
        t0 = time.perf_counter()
        out = real(payloads, rows)
        seen.append((rows, time.perf_counter() - t0))
        return out

    batcher._run = timed
    return seen


def run_serving(runner) -> dict:
    """The serving API at 512², 25 steps (module docstring, step 13):
    dispatches of 1, 4 and 8 rows, 8 concurrent requests fused into one
    dispatch (UNet batch 16), 3 padded to 4, and the same request alone and
    batched under the default padding and under ``fixed_rows``."""
    probe = UNetProbe(runner.pipe.unet)
    decodes = []
    hook = runner.pipe.vae.post_quant_conv.register_forward_pre_hook(
        lambda m, args: decodes.append(args[0].shape[0]))
    req = lambda seed, **kw: dict(prompt=f'{PROMPT}, variant {seed}',
                                  steps=SURFACE_STEPS, width=SURFACE_SIZE,
                                  height=SURFACE_SIZE, guidance_scale=8.0,
                                  seed=seed,
                                  **kw)
    eight = [req(FIXED_SEED)] + [req(SEED + i) for i in range(1, 8)]
    servers = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_phase = time.perf_counter()
    try:
        quick = _serve(runner, max_wait_ms=0.0)
        servers.append(quick)
        window = _serve(runner, max_wait_ms=SERVE_WAIT_MS)
        servers.append(window)
        quick_runs = _timed_dispatches(quick)
        alone = _http(quick.url + '/v1/generate', req(FIXED_SEED))
        four = [_http(quick.url + '/v1/generate', req(7 + i, samples=4))
                for i in range(2)]
        before = _http(window.url + '/v1/stats')
        batched = _concurrent(window.url + '/v1/generate', eight)
        after = _http(window.url + '/v1/stats')
        if [after[k] - before[k] for k in ('requests', 'batches', 'rows',
                                            'padded_rows')] != [8, 1, 8, 0] \
                or any(o['batched_with'] != 7 for o in batched):
            raise AssertionError(f'8 concurrent requests: stats {before} -> '
                                 f'{after}')
        three = _concurrent(window.url + '/v1/generate',
                            [req(SEED + 20 + i) for i in range(3)])
        last = _http(window.url + '/v1/stats')
        if [last[k] - after[k] for k in ('requests', 'batches', 'rows',
                                          'padded_rows')] != [3, 1, 3, 1]:
            raise AssertionError(f'3 concurrent requests: stats {after} -> '
                                 f'{last}')
        fixed_quick = _serve(runner, max_wait_ms=0.0, fixed_rows=True)
        servers.append(fixed_quick)
        fixed = _serve(runner, max_wait_ms=SERVE_WAIT_MS, fixed_rows=True)
        servers.append(fixed)
        fixed_runs = _timed_dispatches(fixed)
        fixed_alone = _http(fixed_quick.url + '/v1/generate',
                            req(FIXED_SEED))
        fixed_batched = _concurrent(fixed.url + '/v1/generate', eight)
        stats = {name: _http(s.url + '/v1/stats') for name, s in (
            ('quick', quick), ('window', window),
            ('fixed_quick', fixed_quick), ('fixed', fixed))}
    finally:
        for s in servers:
            s.close()
        hook.remove()
        probe.remove()
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = _surface_launches('serving', probe.calls, len(decodes))

    answers = [alone] + four + batched + three + [fixed_alone] + fixed_batched
    images = [_b64_pixels(i) for o in answers for i in o['images']]
    if len(images) != 1 + 8 + 8 + 3 + 1 + 8 or any(
            a.shape != SURFACE_PIXELS or a.dtype != np.uint8 for a in images):
        raise AssertionError(f'serving images {[a.shape for a in images]}')
    if not all(bool(f) for f in probe.finite):
        raise AssertionError('serving: non-finite ε')
    # Dispatches: quick 1, 4 and 4 rows, window 8 and 3→4, fixed 8 and 8.
    unet_batches = sorted(set(probe.batches))
    if unet_batches != [2, 8, 16] or \
            sorted(decodes) != [1, 4, 4, 4, 8, 8, 8]:
        raise AssertionError(f'serving: UNet batches {unet_batches}, '
                             f'decodes {decodes}')
    fixed_a = _b64_pixels(fixed_alone['images'][0])
    fixed_b = _b64_pixels(fixed_batched[0]['images'][0])
    if not np.array_equal(fixed_a, fixed_b):
        raise AssertionError('fixed_rows: the request alone and batched '
                             'differ')
    delta = np.abs(_b64_pixels(alone['images'][0]).astype(np.int16) -
                   _b64_pixels(batched[0]['images'][0]))
    # Images per minute of one dispatch whose rows are all real images, on
    # a batch shape the card has run before: 1 row (step 12 ran it), the
    # second 4-row request, the fixed_rows service's 8 concurrent requests.
    dispatch_s = {'1': quick_runs[0][1], '4': quick_runs[2][1],
                  '8': fixed_runs[0][1]}
    res = dict(
        card=card_line(),
        images_per_min={r: int(r) * 60.0 / t for r, t in dispatch_s.items()},
        dispatch_s=dispatch_s,
        first_dispatch_s={'4': quick_runs[1][1]},
        latency_ms_p50={k: v['latency_ms_p50'] for k, v in stats.items()},
        mean_rows_per_batch={k: v['mean_rows_per_batch']
                             for k, v in stats.items()},
        peak_device_gib=peak, phase_s=phase_s,
        unet_evaluations=probe.calls, decodes=decodes,
        default_padding_alone_vs_batched=dict(
            max_abs_levels=int(delta.max()),
            mean_abs_levels=float(delta.mean())),
        fixed_rows_bit_equal=True, launches=launches)
    print(f'serving: {json.dumps(res)}')
    return res


def run_surfaces(runner, root: str) -> dict:
    """The surfaces phase (module docstring, step 13)."""
    guide_path = os.path.join(root, 'guide.png')
    synthetic_image(SURFACE_SIZE, SEED).save(guide_path)
    res = dict(cli=run_cli(root, guide_path), ui=run_ui(runner, guide_path),
               serving=run_serving(runner))
    res['launches'] = {}
    for part in ('cli', 'ui', 'serving'):
        _add(res['launches'], res[part]['launches'])
    return res


# --- Step 17: the sampling features (the tenth slice) ----------------------

STEP17_SEED = SEED + 17
# K1 at the shapes the tenth slice's paths give it: a CFG-interval row
# outside the interval (batch 1), a PAG batch (3), ToMe's merged 2048
# tokens, the hires pass at 768² (9216 and 2304 tokens) and SD-2.1 at 768²
# (64-wide heads: fa.SM90_TILES[True], three consumers, kv tile 64).
STEP17_K1_SHAPES = [(1, 8, 4096, 40), (3, 8, 4096, 40), (2, 8, 2048, 40),
                    (2, 8, 9216, 40), (2, 8, 2304, 80), (2, 5, 9216, 64),
                    (2, 10, 2304, 64)]
# K6 at the 768² passes' shapes: the UNet's 96² and 48² levels, the 768²
# decode's (its mid block and largest activations), and one VAE tile's
# 128² level (the 512² decode of a 64-latent tile).
STEP17_GN_SHAPES = [((2, 320, 96, 96), True, 1e-5, BF16, BF16, True),
                    ((2, 640, 48, 48), True, 1e-5, BF16, BF16, False),
                    ((1, 512, 96, 96), True, 1e-6, BF16, BF16, False),
                    ((1, 512, 384, 384), True, 1e-6, BF16, BF16, False),
                    ((1, 256, 768, 768), True, 1e-6, BF16, BF16, True),
                    ((1, 128, 768, 768), True, 1e-6, BF16, BF16, True),
                    ((1, 512, 128, 128), True, 1e-6, BF16, BF16, False)]
LCM_COND_DIM = 256      # LCM-Dreamshaper's time_cond_proj_dim


class CallLog:
    """Every UNet evaluation of a run (batch, latent size, cache mode, PAG
    rows, the cache's, the IP-Adapter tokens' and SDXL's ``added_cond``
    shapes, the module's settings and config), every ControlNet evaluation
    (its config and shapes) and every VAE decode and encode (their latent
    shapes; without ``vae``, none), from hooks; device-side finiteness
    flags of ε and of the latents entering a decode."""

    def __init__(self, unet, vae=None, controlnet=None) -> None:
        self.evals, self.decodes, self.encodes, self.finite = [], [], [], []
        self.control = []
        self.handles = [
            unet.register_forward_pre_hook(self._pre, with_kwargs=True),
            unet.register_forward_hook(self._post)]
        if vae is not None:
            self.handles += [
                vae.post_quant_conv.register_forward_pre_hook(self._decode),
                vae.quant_conv.register_forward_hook(
                    lambda m, args, out: self.encodes.append(
                        tuple(out.shape)))]
        if controlnet is not None:
            self.handles.append(controlnet.register_forward_pre_hook(
                lambda m, args: self.control.append(dict(
                    batch=args[0].shape[0], hw=tuple(args[0].shape[1:3]),
                    ctx=tuple(args[2].shape[1:]),
                    cond=tuple(args[3].shape[1:]), config=m.config,
                    ramp=len(m.controlnet_cond_embedding.blocks) // 2 + 1))))

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def _pre(self, module, args, kwargs):
        lat, _, ctx = args[:3]
        cache = kwargs.get('deep_cache')
        ip = kwargs.get('ip_ctx')
        added = kwargs.get('added_cond')
        self.evals.append(dict(
            batch=lat.shape[0], hw=tuple(lat.shape[1:3]),
            channels=lat.shape[3], ctx=tuple(ctx.shape[1:]),
            mode=kwargs.get('cache_mode', 'off'),
            pag=kwargs.get('pag_mask') is not None,
            tcond=kwargs.get('timestep_cond') is not None,
            cache=None if cache is None else tuple(cache.shape),
            ip=None if ip is None else tuple(ip.shape),
            added=None if added is None else tuple(
                tuple(added[k].shape) for k in ('text_embeds', 'time_ids')),
            config=module.config,
            settings=(module.freeu, module.tome, module.pag_layers)))

    def _post(self, module, args, out):
        eps = out[0] if isinstance(out, tuple) else out
        self.finite.append(torch.isfinite(eps).all())

    def _decode(self, module, args):
        self.decodes.append(tuple(args[0].shape))
        self.finite.append(torch.isfinite(args[0]).all())


_META_MODELS: dict = {}
_META_COUNTS: dict = {}


def _meta_model(cls, config, settings=None):
    """``cls(config)`` on the meta device in bf16 (with the UNet's sampling
    settings): the module tree, no weights."""
    key = (cls, config, settings)
    if key not in _META_MODELS:
        with torch.device('meta'):
            model = cls(config).to(BF16).eval()
        if settings is not None:
            model = model.with_settings(freeu=settings[0], tome=settings[1],
                                        pag_layers=settings[2])
        _META_MODELS[key] = model
    return _META_MODELS[key]


def tree_launches(run, grad: bool = False) -> tuple:
    """The launches ``run()`` implies on the card, from a pass over the
    module tree on the meta device: every attention call the dispatcher
    sends to the kernels (``attn_mod.route`` for a CUDA tensor under
    'auto'; K1 on the path ``fa.plan`` picks, or, with ``grad`` (autograd
    on) when q, k or v needs a gradient, one K3 in the forward and one K4
    and one K5 in the backward) and every GroupNorm that needs no gradient
    (K6, on the path ``gn.plan_group_norm`` picks, aligned). Returns
    ``(launches, by_shape)``, ``by_shape`` a Counter of (kernel, shape)."""
    from flexdiffuse_tpu_torch.models import unet as unet_mod
    from flexdiffuse_tpu_torch.models import vae as vae_mod
    tally = collections.Counter()
    by_shape = collections.Counter()
    real_attn, real_gn = unet_mod.attention, unet_mod.group_norm

    def attention(q, k, v, scale=None, backend=None):
        if attn_mod.route(q.shape, k.shape, 'cuda', 'auto') == 'flash':
            name = 'k3' if torch.is_grad_enabled() and (
                q.requires_grad or k.requires_grad or v.requires_grad) \
                else 'k1'
            tally[name] += 1
            tally[f'{name}_{fa.plan(q.contiguous(), k.contiguous()).path}'] \
                += 1
            by_shape[name.upper(), tuple(q.shape)] += 1
        return real_attn(q, k, v, scale, backend)

    def group_norm(x, groups, weight, bias, eps, silu=False, dtype=None):
        if torch.is_grad_enabled() and (x.requires_grad or
                                        weight.requires_grad or
                                        bias.requires_grad):
            return real_gn(x, groups, weight, bias, eps, silu, dtype)
        tally['k6'] += 1
        how = gn.plan_group_norm(tuple(x.shape), groups, x.dtype,
                                 dtype or x.dtype, True)
        tally[f'k6_{how.path}'] += 1
        by_shape['K6', tuple(x.shape)] += 1
        return real_gn(x, groups, weight, bias, eps, silu, dtype)

    unet_mod.attention = vae_mod.attention = attention
    unet_mod.group_norm = group_norm
    try:
        with torch.set_grad_enabled(grad):
            run()
    finally:
        unet_mod.attention = vae_mod.attention = real_attn
        unet_mod.group_norm = real_gn
    return want_launches(k1=tally['k1'], k3=tally['k3'], k4=tally['k3'],
                         k5=tally['k3'], k6=tally['k6'],
                         k6_stream=tally['k6_stream']) | {
        k: tally[k] for k in ('k1_sm90', 'k1_mma', 'k3_sm90', 'k3_mma',
                              'k6_resident')}, by_shape


def step_launches(config, mode: str, remat: str, batch: int,
                  lat: int) -> dict:
    """The launches one train step implies on the card (:func:`tree_launches`
    of the UNet's forward with autograd on, for a UNet of ``config`` at
    ``batch`` × ``lat``² latents and 77 context tokens): 'lora' trains the
    LoRA targets' weights of a frozen UNet, 'full' every parameter, 'ti'
    the context of a frozen UNet (textual inversion's rows reach the UNet
    only through it). Remat 'full' and 'dots' run the forward again in the
    backward: its K1, K3 and K6 twice. K4 and K5 are counted on the Hopper
    path, as every main-path call must take it."""
    key = ('step', config, mode, remat, batch, lat)
    if key not in _META_COUNTS:
        meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
        with torch.device('meta'):
            unet = UNet2DCondition(config).to(BF16)
        unet.requires_grad_(mode == 'full')
        if mode == 'lora':
            for lin in train_mod.lora_targets(unet).values():
                lin.weight.requires_grad_(True)
        ctx = meta(batch, 77, config.cross_attention_dim).requires_grad_(
            mode == 'ti')
        kw = {}
        if config.addition_embed:
            kw['added_cond'] = {
                'text_embeds': meta(batch, config.addition_pooled_dim),
                'time_ids': meta(batch, config.num_time_ids)}
        got = tree_launches(lambda: unet(meta(batch, lat, lat, 4),
                                         meta(batch), ctx, **kw),
                            grad=True)[0]
        if remat != 'none':
            for k in got:
                if k.startswith(('k1', 'k3', 'k6')):
                    got[k] *= 2
        _META_COUNTS[key] = got
    return dict(_META_COUNTS[key])


def eval_launches(e: dict) -> dict:
    """:func:`tree_launches` of one recorded UNet evaluation: the same
    config, settings, shapes and keywords on the meta device."""
    key = tuple((k, v) for k, v in sorted(e.items()))
    if key not in _META_COUNTS:
        meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
        b = e['batch']
        kw = dict(cache_mode=e['mode'])
        if e['cache'] is not None:
            kw['deep_cache'] = meta(*e['cache'])
        if e['pag']:
            kw['pag_mask'] = meta(b)
        if e['tcond']:
            kw['timestep_cond'] = meta(b, e['config'].time_cond_proj_dim)
        if e['ip'] is not None:
            kw['ip_ctx'] = meta(*e['ip'])
        if e.get('added') is not None:
            kw['added_cond'] = dict(zip(('text_embeds', 'time_ids'),
                                        (meta(*s) for s in e['added'])))
        # ControlNet residuals are adds into the skips: no kernel launch, so
        # the pass runs without them (control_launches counts the branch).
        unet = _meta_model(UNet2DCondition, e['config'], e['settings'])
        _META_COUNTS[key] = tree_launches(lambda: unet(
            meta(b, *e['hw'], e['channels']), meta(b), meta(b, *e['ctx']),
            **kw))
    return _META_COUNTS[key]


def control_launches(c: dict) -> dict:
    """:func:`tree_launches` of one recorded ControlNet evaluation on a
    meta ControlNet of the same config, ramp and shapes."""
    key = ('controlnet',) + tuple((k, v) for k, v in sorted(c.items()))
    if key not in _META_COUNTS:
        meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
        mkey = (ControlNetModel, c['config'], c['ramp'])
        if mkey not in _META_MODELS:
            with torch.device('meta'):
                _META_MODELS[mkey] = ControlNetModel(
                    c['config'], COND_EMBED_CHANNELS[:c['ramp']]).to(
                        BF16).eval()
        net, b = _META_MODELS[mkey], c['batch']
        _META_COUNTS[key] = tree_launches(lambda: net(
            meta(b, *c['hw'], 4), meta(b), meta(b, *c['ctx']),
            meta(b, *c['cond'])))
    return _META_COUNTS[key]


def vae_launches(config, decodes, encodes) -> dict:
    """:func:`tree_launches` of the recorded decodes (post_quant_conv
    inputs ``[B, 4, h, w]``) and encodes (quant_conv outputs ``[B, 8, h,
    w]``) of a VAE of ``config``, and their (kernel, shape) Counter."""
    total, by_shape = collections.Counter(), collections.Counter()
    f = 2**(len(config.block_channels) - 1)
    for kind, shapes in (('decode', decodes), ('encode', encodes)):
        for b, c, h, w in shapes:
            key = (config, kind, b, h, w)
            if key not in _META_COUNTS:
                vae = _meta_model(AutoencoderKL, config)
                if kind == 'decode':
                    z = torch.empty((b, h, w, c), device='meta', dtype=BF16)
                    _META_COUNTS[key] = tree_launches(lambda: vae.decode(z))
                else:
                    px = torch.empty((b, h * f, w * f, 3), device='meta',
                                     dtype=BF16)
                    _META_COUNTS[key] = tree_launches(lambda: vae.encode(px))
            total.update(_META_COUNTS[key][0])
            by_shape.update(_META_COUNTS[key][1])
    return dict(total), by_shape


def _sum(dicts) -> dict:
    total = collections.Counter()
    for d in dicts:
        total.update(d)
    return {k: total[k] for k in want_launches()}


def cfg_rows(length: int, lo: float, hi: float) -> list:
    """The UNet batch per row under the CFG interval [lo, hi] (CFG 2 rows,
    cond-only 1): progress i/(length−1) compared in fp32, as the JAX
    scan."""
    span = np.float32(length - 1)
    return [2 if np.float32(lo) <= np.float32(i) / span <= np.float32(hi)
            else 1 for i in range(length)]


def step17_runs(make, lcm_unet, guide, size: int, steps: int) -> list:
    """(label, runner, gen keywords, the UNet evaluations each run must
    make as (batch, latent side, cache mode, PAG rows), the VAE decodes as
    (latent side, count), the image side): module docstring, step 17.
    ``make(kind, config=None, unet=None)`` builds a Runner on the shared
    models."""
    lat = size // 8
    rows = lambda n, b=2, hw=lat, mode='off', pag=False: [
        (b, hw, mode, pag)] * n
    plms = steps + 1
    sc = schedulers.SchedulerConfig
    common = dict(prompt=PROMPT, guide=guide, steps=steps, guidance_scale=8,
                  samples=1, seed=STEP17_SEED, save=False,
                  init_size=(size, size))

    def toggled(runner, *calls):
        for name, args in calls:
            getattr(runner, name)(*args)
        return runner

    pndm = lambda *calls: toggled(make('pndm'), *calls)
    hires_side = max(8, (int(lat * 1.5) // 8) * 8)
    init_timestep = min(int(steps * 0.55) + 1, steps)
    hires_rows = plms - max(steps - init_timestep + 1, 0)
    tiles = len(tile_starts(hires_side, 64, 56))**2
    runs = [(kind, make(kind), {}, rows(steps), [(lat, 1)])
            for kind in ('euler', 'euler_a', 'dpmpp', 'unipc', 'ddpm')]
    runs += [
        ('heun', make('heun'), {}, rows(2 * steps - 1), [(lat, 1)]),
        ('lcm', make('lcm', unet=lcm_unet), dict(steps=4), rows(4, b=1),
         [(lat, 1)]),
        ('pndm v-prediction trailing', make('pndm', sc(
            prediction_type='v_prediction', timestep_spacing='trailing')),
         {}, rows(plms), [(lat, 1)]),
        ('euler karras', make('euler', sc(use_karras_sigmas=True)), {},
         rows(steps), [(lat, 1)]),
        ('deepcache 2', pndm(('enable_deepcache', (2,))), {},
         [(2, lat, 'save' if i % 2 == 0 else 'use', False)
          for i in range(plms)], [(lat, 1)]),
        ('deepcache 3', pndm(('enable_deepcache', (3,))), {},
         [(2, lat, 'save' if i % 3 == 0 else 'use', False)
          for i in range(plms)], [(lat, 1)]),
        ('pag mid', pndm(('enable_pag', (('mid',),))), dict(pag_scale=3.0),
         rows(plms, b=3, pag=True), [(lat, 1)]),
        ('pag up_3', pndm(('enable_pag', (('up_3',),))),
         dict(pag_scale=3.0), rows(plms, b=3, pag=True), [(lat, 1)]),
        ('freeu', pndm(('enable_freeu', ())), {}, rows(plms), [(lat, 1)]),
        ('tome 0.5', pndm(('enable_tome', (0.5,))), {}, rows(plms),
         [(lat, 1)]),
        ('cfg interval (0, 0.6)', pndm(), dict(cfg_interval=(0.0, 0.6)),
         [(b, lat, 'off', False) for b in cfg_rows(plms, 0.0, 0.6)],
         [(lat, 1)]),
        ('guidance rescale 0.7', pndm(), dict(guidance_rescale=0.7),
         rows(plms), [(lat, 1)]),
        ('hires 1.5, tiled decode', pndm(('enable_vae_tiling', (64, 8))),
         dict(hires_scale=1.5), rows(plms) + rows(hires_rows,
                                                  hw=hires_side),
         [(64, tiles)] if hires_side > 64 else [(hires_side, 1)])]
    return [(label, runner, {**common, **kw}, evals, decodes,
             hires_side * 8 if 'hires_scale' in kw else size)
            for label, runner, kw, evals, decodes in runs]


def _observe(runner) -> list:
    """CallLogs on ``runner``'s pipeline (UNet, VAE, ControlNet) and, for an
    ``SDXLRunner`` with a refiner, on the refiner's UNet."""
    pipe = runner.pipe
    logs = [CallLog(pipe.unet, pipe.vae, pipe.controlnet)]
    refiner = getattr(runner, 'refiner_pipe', None)
    if refiner is not None:
        logs.append(CallLog(refiner.unet))
    return logs


def run_feature(label: str, runner, gen_kw: dict, evals: list,
                decodes: list, image_side: int, check: bool = True,
                call: str = 'gen', control: list = (),
                step: int = 17, refiner_evals: list = ()) -> dict:
    """One step-17, 18 or 19 run (``runner.<call>(**gen_kw)``) with the
    launch counts at 0, held by :func:`verify_run`."""
    pipe = runner.pipe
    logs = _observe(runner)
    cuda = pipe.device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    try:
        images, _ = getattr(runner, call)(**gen_kw)
    finally:
        for log in logs:
            log.remove()
    return verify_run(label, logs, images, time.perf_counter() - t0,
                      pipe.vae.config, evals, decodes, image_side, check,
                      control, step, refiner_evals, cuda)


def verify_run(label: str, logs: list, images, e2e: float, vae_config,
               evals: list, decodes: list, image_side: int,
               check: bool = True, control: list = (), step: int = 17,
               refiner_evals: list = (), cuda: bool = True) -> dict:
    """A run's record (``logs`` from :func:`_observe`): the UNet
    evaluations it must make (``evals``, and the refiner's
    ``refiner_evals``, as (batch, latent side, cache mode, PAG rows)),
    the ControlNet evaluations (``control`` as (batch, latent side)) and
    VAE decodes (``decodes`` as (latent side, count)), finite ε and
    latents, finite ``image_side``² uint8 images, and exactly the launches
    the module tree implies for those evaluations, decodes and encodes
    (:func:`eval_launches`, :func:`control_launches`,
    :func:`vae_launches`); the peak device memory of the run."""
    got = counts()
    log, ref_log = logs[0], (logs[1] if len(logs) > 1 else None)
    nets = [('UNet', log, evals)]
    if ref_log is not None or refiner_evals:
        nets.append(('refiner UNet', ref_log, list(refiner_evals)))
    for name, lg, want_evals in nets:
        seen = [] if lg is None else [
            (e['batch'], e['hw'][0], e['mode'], e['pag']) for e in lg.evals]
        if seen != want_evals:
            raise AssertionError(f'{label}: {name} evaluations {seen}, '
                                 f'expected {want_evals}')
    seen = [(c['batch'], c['hw'][0]) for c in log.control]
    if seen != list(control):
        raise AssertionError(f'{label}: ControlNet evaluations {seen}, '
                             f'expected {list(control)}')
    want_dec = [d for side, n in decodes for d in [(side, side)] * n]
    if [d[2:] for d in log.decodes] != want_dec:
        raise AssertionError(f'{label}: decodes {log.decodes}, expected '
                             f'{want_dec}')
    all_evals = [e for lg in logs for e in lg.evals]
    parts = [eval_launches(e) for e in all_evals] + [
        control_launches(c) for c in log.control] + [
        vae_launches(vae_config, log.decodes, log.encodes)]
    want = _sum(p[0] for p in parts)
    arrs = [np.asarray(im) for im in images]
    res = dict(label=label, unet_evaluations=len(log.evals),
               controlnet_evaluations=len(log.control),
               batches=sorted(collections.Counter(
                   e['batch'] for e in log.evals).items()),
               e2e_s=e2e, launches=got, expected=want,
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if cuda else None))
    if ref_log is not None:
        res['refiner_evaluations'] = len(ref_log.evals)
    res['encodes'] = len(log.encodes)
    print(f'step {step} {label}: {json.dumps(res)}', flush=True)
    if not all(bool(f) for lg in logs for f in lg.finite):
        raise AssertionError(f'{label}: non-finite ε or latents')
    if len(arrs) != 1 or any(
            a.shape != (image_side, image_side, 3) or a.dtype != np.uint8
            for a in arrs):
        raise AssertionError(f'{label}: images '
                             f'{[(a.shape, a.dtype) for a in arrs]}')
    if check and got != want:
        raise AssertionError(f'{label}: launches {got}, expected {want}')
    res['by_shape'] = sum((p[1] for p in parts), collections.Counter())
    return res


def lcm_unet_of(unet, cond_dim: int = LCM_COND_DIM):
    """A guidance-embedded (LCM) UNet sharing ``unet``'s weights, with a
    seeded random ``time_embedding.cond_proj``."""
    cfg = dataclasses.replace(unet.config, time_cond_proj_dim=cond_dim)
    with torch.device('meta'):
        lcm = UNet2DCondition(cfg)
    w = unet.time_embedding.linear_1.weight
    gen = torch.Generator(w.device).manual_seed(STEP17_SEED)
    proj = (0.02 * torch.randn((cfg.block_channels[0], cond_dim),
                               generator=gen, device=w.device)).to(w.dtype)
    lcm.load_state_dict({**unet.state_dict(),
                         'time_embedding.cond_proj.weight': proj},
                        strict=True, assign=True)
    return lcm.eval().requires_grad_(False)


def build_sd21(device: str, dtype: torch.dtype, seed: int):
    """SD-2.1 at its published widths with seeded random weights: the
    OpenCLIP-H text tower, the SD-2.1 UNet and VAE."""
    torch.manual_seed(seed)
    with torch.device(device):
        models = (CLIPTextModel(OPENCLIP_H_TEXT), UNet2DCondition(SD21_UNET),
                  AutoencoderKL(SD21_VAE))
    return tuple(m.to(dtype).eval().requires_grad_(False) for m in models)


def run_sampling_phase(text, vision, unet, vae, size: int = 512,
                       steps: int = 25, sd2=None, sd2_size: int = 768,
                       check: bool = True) -> dict:
    """Step 17 (module docstring): every new scheduler kind and sampling
    feature at ``size``², then SD-2.1 (``sd2``: its text tower, UNet and
    VAE) at ``sd2_size``² for ``steps`` DDIM v-prediction steps; the summed
    launches."""
    base = unet
    tok = FakeTokenizer(text.config.vocab_size)

    def make(kind, config=None, unet=None):
        return Runner.from_models(text, vision, unet or base, vae, tok,
                                  scheduler=kind, scheduler_config=config)

    lcm = lcm_unet_of(base)
    runs = step17_runs(make, lcm, synthetic_image(size, STEP17_SEED), size,
                       steps)
    results = [run_feature(*run, check=check) for run in runs]
    del runs, lcm
    if sd2 is not None:
        text2, unet2, vae2 = sd2
        runner = Runner.from_models(
            text2, vision, unet2, vae2, FakeTokenizer(text2.config.vocab_size),
            scheduler='ddim', scheduler_config=schedulers.SchedulerConfig(
                prediction_type='v_prediction'))
        lat = sd2_size // 8
        results.append(run_feature(
            f'SD-2.1 {sd2_size}² DDIM v-prediction', runner,
            dict(prompt=PROMPT, steps=steps, guidance_scale=8, samples=1,
                 seed=STEP17_SEED, save=False,
                 init_size=(sd2_size, sd2_size)),
            [(2, lat, 'off', False)] * steps, [(lat, 1)], sd2_size, check))
    by_shape = sum((r.pop('by_shape') for r in results),
                   collections.Counter())
    for kernel in ('K1', 'K6'):
        print(f'step 17 {kernel} launches by shape: ' + ', '.join(
            f'{shape} {n}' for (k, shape), n in sorted(by_shape.items())
            if k == kernel), flush=True)
    return dict(runs=results, launches=_sum(r['launches'] for r in results))


# --- Step 18: the conditioning models (the eleventh slice) ---------------

STEP18_SEED = SEED + 18
# K1 at InstructPix2Pix's 3-row UNet batch at the 1024-token level (its
# 4096-token rows are PAG's (3,8,4096,40), timed in step 17); K6 at the UNet
# batch 3's first and last levels.
STEP18_K1_SHAPES = [(3, 8, 1024, 80)]
STEP18_GN_SHAPES = [((3, 320, 64, 64), True, 1e-5, BF16, BF16, True),
                    ((3, 1280, 8, 8), True, 1e-5, BF16, BF16, True)]
# IP-Adapter Plus for SD-1.5 (h94/IP-Adapter ip-adapter-plus_sd15: the
# perceiver Resampler over OpenCLIP ViT-H's penultimate 257×1280 tokens);
# the base adapter projects the pooled 1024-wide embedding to 4 tokens.
PLUS_SD15 = dict(dim=768, depth=4, dim_head=64, heads=12, num_queries=16,
                 ff_mult=4)
IP_BASE_TOKENS = 4


def controlnet_from_unet(unet, seed: int) -> ControlNetModel:
    """A ControlNet of ``unet``'s geometry as diffusers'
    ``ControlNetModel.from_unet`` makes one: ``conv_in``, the time embedding
    and the down and mid blocks copied from the UNet; the conditioning
    embedding and the 1×1 zero convolutions seeded random (torch's default
    init: not zero, so the branch has an effect)."""
    w = next(unet.parameters())
    torch.manual_seed(seed)
    with torch.device(w.device):
        net = ControlNetModel(unet.config)
    own = net.state_dict()
    net.load_state_dict({k: v for k, v in unet.state_dict().items()
                         if k in own}, strict=False)
    return net.to(w.dtype).eval().requires_grad_(False)


def ip_adapter_checkpoint(unet, kind: str, embed_dim: int, seed: int,
                          plus: dict = PLUS_SD15) -> dict:
    """An official-layout IP-Adapter checkpoint for ``unet``: ``{'image_proj':
    head, 'ip_adapter': {'<2n+1>.to_{k,v}_ip.weight': ...}}``, fp16 on the
    host. The head (base: ``ImageProjection`` of ``embed_dim`` to 4 tokens;
    'plus': the ``Resampler``) is seeded random; each layer's projections
    start from its cross-attention's ``to_k``/``to_v``, as IP-Adapter's
    training does."""
    ctx = unet.config.cross_attention_dim
    torch.manual_seed(seed)
    if kind == 'base':
        head = ImageProjection(embed_dim, ctx, IP_BASE_TOKENS)
    else:
        head = Resampler(ctx, embed_dim=embed_dim, **plus)
        torch.nn.init.normal_(head.latents, std=plus['dim']**-0.5)
    sd = unet.state_dict()
    layers = {f'{2 * n + 1}.to_{kv}_ip.weight': sd[f'{name}.to_{kv}.weight']
              for n, name in enumerate(attn2_layer_order(unet.config))
              for kv in 'kv'}
    host = lambda d: {k: v.detach().to('cpu', SNAPSHOT_DTYPE).contiguous()
                      for k, v in d.items()}
    return {'image_proj': host(head.state_dict()), 'ip_adapter': host(layers)}


def unet_with_channels(unet, channels: int, seed: int):
    """An InstructPix2Pix-style UNet sharing ``unet``'s weights but
    ``conv_in``, widened to ``channels`` inputs (the extra ones seeded
    random)."""
    cfg = dataclasses.replace(unet.config, in_channels=channels)
    w = unet.conv_in.weight
    gen = torch.Generator(w.device).manual_seed(seed)
    extra = 0.02 * torch.randn(
        (w.shape[0], channels - w.shape[1]) + tuple(w.shape[2:]),
        generator=gen, device=w.device)
    with torch.device('meta'):
        wide = UNet2DCondition(cfg)
    wide.load_state_dict({**unet.state_dict(), 'conv_in.weight': torch.cat(
        [w, extra.to(w.dtype)], dim=1)}, strict=True, assign=True)
    return wide.eval().requires_grad_(False)


def write_conditioning(root: str, text, vision, unet, vae, encoder,
                       plus: dict = PLUS_SD15) -> dict:
    """Step 18's checkpoints under ``root``, after checking the free space:
    an SD-1.x snapshot with an 8-channel UNet (``unet/config.json``:
    ``in_channels`` 8) beside its CLIP snapshot, a diffusers ControlNet
    (fp16 safetensors), the base and Plus IP-Adapter ``.bin`` files
    (official nesting) and the image encoder (HF vision-tower names).
    Returns the paths."""
    unet8 = unet_with_channels(unet, 8, STEP18_SEED)
    controlnet = controlnet_from_unet(unet, STEP18_SEED)
    embed = {'base': encoder.config.projection_dim,
             'plus': encoder.config.hidden_size}
    ips = {kind: ip_adapter_checkpoint(unet, kind, embed[kind],
                                       STEP18_SEED + 1, plus)
           for kind in ('base', 'plus')}
    extra = {os.path.join(root, 'controlnet',
                          'diffusion_pytorch_model.safetensors'):
             controlnet.state_dict(),
             os.path.join(root, 'image_encoder', 'model.safetensors'):
             encoder.state_dict()}
    need = sum(t.numel() * 2 for sd in extra.values() for t in sd.values())
    need += sum(t.numel() * 2 for ck in ips.values()
                for part in ck.values() for t in part.values())
    free = shutil.disk_usage(root).free
    if free < 1.1 * need:
        raise RuntimeError(f'not enough free space under {root}: '
                           f'{free / 2**30:.1f} GiB for '
                           f'{1.1 * need / 2**30:.1f}')
    snap = write_snapshot(root, text, vision, unet8, vae)
    t0 = time.perf_counter()
    with open(os.path.join(snap['sd_dir'], 'unet', 'config.json'), 'w') as f:
        json.dump({'in_channels': 8}, f)
    for path, sd in extra.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        weights_safetensors.save_file(
            {k: v.to(SNAPSHOT_DTYPE) for k, v in sd.items()}, path)
    paths = dict(controlnet=os.path.dirname(next(iter(extra))),
                 encoder=os.path.join(root, 'image_encoder'))
    for kind, ck in ips.items():
        paths[kind] = os.path.join(root, f'ip-adapter-{kind}_sd15.bin')
        torch.save(ck, paths[kind])
    print(f'step 18 checkpoints: {(snap["bytes"] + need) / 2**30:.2f} GiB '
          f'under {root} ({free / 2**30:.1f} GiB free) in '
          f'{snap["write_s"] + time.perf_counter() - t0:.2f} s', flush=True)
    return paths


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).abs().max() /
            b.float().abs().max()).item()


def check_conditioning(label: str, run, meta_run, off=None,
                       step: int = 18) -> dict:
    """One 512² evaluation ``run()`` through K1 and K6 against the same with
    plain attention and GroupNorm: max|Δε|/max|ε| within UNET_REL_TOL, its
    launches exactly the module tree's (``meta_run`` on the meta device);
    with ``off`` (the same evaluation with the branch's scale at 0) the
    branch moves ε by more than UNET_REL_TOL."""
    with torch.no_grad():
        reset_counts()
        eps_k = run()
        got = counts()
        with attn_mod.backend('plain'), gn.backend('plain'):
            eps_p = run()
        eps_off = off() if off is not None else None
    want = tree_launches(meta_run)[0]
    res = dict(label=label, rel=_rel(eps_k, eps_p), launches=got,
               expected=want)
    if eps_off is not None:
        res['branch_rel'] = _rel(eps_k, eps_off)
    print(f'step {step} model check, {label}: {json.dumps(res)}',
          flush=True)
    if not (torch.isfinite(eps_k).all() and res['rel'] <= UNET_REL_TOL):
        raise AssertionError(f'{label}: K1+K6 disagrees with the plain path')
    if got != want:
        raise AssertionError(f'{label}: launches {got}, expected {want}')
    if eps_off is not None and not res['branch_rel'] > UNET_REL_TOL:
        raise AssertionError(f'{label}: the branch moved ε by only '
                             f'{res["branch_rel"]:.3e}')
    return res


def check_conditioning_models(unet, controlnet, ip_unet, ip_tokens, unet8,
                              encoder_ctx, gen: torch.Generator) -> list:
    """Step 18's model checks at 512² (module docstring): the UNet with a
    ControlNet (batch 2; against ``controlnet_scale`` 0), the IP-Adapter
    UNet at ``ip_scale`` 1 (batch 2; against ``ip_scale`` 0) and the
    8-channel UNet at batch 3."""
    meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
    lat = torch.randn((2, 64, 64, 4), generator=gen, device='cuda')
    lat8 = torch.randn((3, 64, 64, 8), generator=gen, device='cuda')
    cond = torch.rand((1, 512, 512, 3), generator=gen, device='cuda')
    t2, t3 = (torch.full((n,), 981.0, device='cuda') for n in (2, 3))
    ctx2, ctx3 = encoder_ctx(['', PROMPT]), encoder_ctx(['', '', PROMPT])
    tok = ip_tokens.expand(2, -1, -1)
    munet = _meta_model(UNet2DCondition, unet.config)
    mcn = _meta_model(ControlNetModel, controlnet.config)
    mip = _meta_model(UNet2DCondition, ip_unet.config)
    m8 = _meta_model(UNet2DCondition, unet8.config)
    with_cn = lambda scale: unet(lat, t2, ctx2, control=controlnet(
        lat, t2, ctx2, cond.expand(2, -1, -1, -1), scale))
    return [
        check_conditioning(
            'UNet + ControlNet, batch 2', lambda: with_cn(1.0),
            lambda: munet(meta(2, 64, 64, 4), meta(2), meta(2, 77, 768),
                          control=mcn(meta(2, 64, 64, 4), meta(2),
                                      meta(2, 77, 768),
                                      meta(2, 512, 512, 3))),
            off=lambda: with_cn(0.0)),
        check_conditioning(
            'IP-Adapter UNet at ip_scale 1, batch 2',
            lambda: ip_unet(lat, t2, ctx2, ip_ctx=tok, ip_scale=1.0),
            lambda: mip(meta(2, 64, 64, 4), meta(2), meta(2, 77, 768),
                        ip_ctx=meta(*tok.shape)),
            off=lambda: ip_unet(lat, t2, ctx2, ip_ctx=tok, ip_scale=0.0)),
        check_conditioning(
            '8-channel UNet, batch 3', lambda: unet8(lat8, t3, ctx3),
            lambda: m8(meta(3, 64, 64, 8), meta(3), meta(3, 77, 768)))]


def run_conditioning_phase(text, vision, unet, vae, root: str,
                           size: int = 512, steps: int = 25,
                           encoder=None, plus: dict = PLUS_SD15,
                           runner_kw=None, check: bool = True) -> dict:
    """Step 18 (module docstring): the checkpoints written under ``root``
    and loaded back through the port's loaders, the model checks (with
    ``check``), then the five runs at ``size``², ``steps`` PNDM steps:
    ControlNet, ControlNet with DeepCache 2, IP-Adapter base and Plus from
    ``ip_image``, and ``edit``. ``encoder``: the image encoder to write
    (default: OpenCLIP ViT-H, seeded); ``runner_kw``: the IP2P Runner's
    device, dtype and configs (default: the card, bf16, SD-1.4)."""
    if encoder is None:
        w = next(unet.parameters())
        torch.manual_seed(STEP18_SEED)
        with torch.device(w.device):
            encoder = CLIPVisionModel(OPENCLIP_H_VISION)
        encoder = encoder.to(w.dtype).eval().requires_grad_(False)
    written = write_conditioning(root, text, vision, unet, vae, encoder,
                                 plus)
    enc_config = encoder.config
    del encoder
    tok = FakeTokenizer(text.config.vocab_size)
    make = lambda: Runner.from_models(text, vision, unet, vae, tok)
    t0 = time.perf_counter()
    cn = make()
    cn.load_controlnet(written['controlnet'])
    ips = {}
    for kind in ('base', 'plus'):
        ips[kind] = make()
        ips[kind].load_ip_adapter(written[kind], written['encoder'],
                                  vision_config=enc_config)
    edit = Runner(model_root=root, **(runner_kw or {}))
    loaded = time.perf_counter() - t0
    if edit.pipe.unet.config.in_channels != 8:
        raise AssertionError('the IP2P snapshot did not load 8-channel')
    print(f'step 18 loaded the ControlNet, both IP-Adapters with their '
          f'encoder and the 8-channel Runner in {loaded:.2f} s', flush=True)
    image = synthetic_image(size, STEP18_SEED)
    checks = []
    if check:
        gen = torch.Generator('cuda').manual_seed(STEP18_SEED)
        base = ips['base']
        checks = check_conditioning_models(
            unet, cn.pipe.controlnet, base.pipe.unet,
            base._ip.fields(None, image, 1.0)['ip_tokens'],
            edit.pipe.unet, cn.encoder.prompt, gen)
    lat, plms = size // 8, steps + 1
    rows = lambda b=2, mode=None: [
        (b, lat, mode(i) if mode else 'off', False) for i in range(plms)]
    common = dict(prompt=PROMPT, steps=steps, guidance_scale=8, samples=1,
                  seed=STEP18_SEED, save=False, init_size=(size, size))
    control = dict(control_image=image, controlnet_scale=1.0)
    ip = dict(ip_image=image, ip_scale=1.0)
    results = [run_feature('ControlNet', cn, dict(common, **control), rows(),
                           [(lat, 1)], size, check,
                           control=[(2, lat)] * plms, step=18)]
    cn.enable_deepcache(2)
    results.append(run_feature(
        'ControlNet, DeepCache 2', cn, dict(common, **control),
        rows(mode=lambda i: 'save' if i % 2 == 0 else 'use'), [(lat, 1)],
        size, check, control=[(2, lat)] * plms, step=18))
    for kind in ('base', 'plus'):
        results.append(run_feature(
            f'IP-Adapter {kind} from ip_image', ips[kind],
            dict(common, **ip), rows(), [(lat, 1)], size, check, step=18))
    results.append(run_feature(
        f'edit {size}²', edit,
        # The image as the [-1, 1] array ``preprocess`` makes of a 512²
        # PIL image (which it would resize to 512 at any other size).
        dict(prompt='make it winter',
             image=np.asarray(image, np.float32)[None] / 127.5 - 1.0,
             steps=steps,
             guidance_scale=7.5, image_guidance_scale=1.5,
             seed=STEP18_SEED, save=False),
        rows(b=3), [(lat, 1)], size, check, call='edit', step=18))
    by_shape = sum((r.pop('by_shape') for r in results),
                   collections.Counter())
    for kernel in ('K1', 'K6'):
        print(f'step 18 {kernel} launches by shape: ' + ', '.join(
            f'{shape} {n}' for (k, shape), n in sorted(by_shape.items())
            if k == kernel), flush=True)
    return dict(runs=results, checks=checks,
                launches=_sum(r['launches'] for r in results))


# --- Step 19: SDXL base and refiner at 1024² (the twelfth slice) ---------

STEP19_SEED = SEED + 19
SDXL_SIZE, SDXL_STEPS, SDXL_CFG = 1024, 25, 5.0
SDXL_REFINE, SDXL_STRENGTH = 0.3, 0.6
# K1 at SDXL's self-attentions at 1024²: the base's 4096- and 1024-token
# levels (10 and 20 heads of 64) and the refiner's (12 and 24), all on
# fa.SM90_TILES[True].
STEP19_K1_SHAPES = [(2, 10, 4096, 64), (2, 20, 1024, 64),
                    (2, 12, 4096, 64), (2, 24, 1024, 64)]
# K6 is held at every call of the SDXL path (sdxl_gn_specs); these are
# timed: the base's first, widest-streamed and deepest 128²/32² levels, the
# refiner's 128² and 16² levels and the decode's 1024² activations, with
# SiLU.
STEP19_GN_TIMED = [(2, 320, 128, 128), (2, 960, 128, 128), (2, 2560, 32, 32),
                   (2, 384, 128, 128), (2, 3072, 16, 16),
                   (1, 128, 1024, 1024)]
# K6 calls and their stream-path share per SDXL base and refiner evaluation
# under CFG at 1024², per 1024² decode and encode, as gn.plan_group_norm
# plans them (tests/test_torch_group_norm.py -k sdxl holds these on the
# CPU); K1 per evaluation.
K6_SDXL = {'base': (46, 1), 'refiner': (56, 1), 'decode': (30, 19),
           'encode': (22, 12)}
K1_SDXL = {'base': 70, 'refiner': 40}
SDXL_DIRS = ('stable-diffusion-xl-base-1.0',
             'stable-diffusion-xl-refiner-1.0', 'clip-vit-large-patch14')


def build_sdxl(device: str, dtype: torch.dtype, seed: int):
    """SDXL's second text tower (OpenCLIP bigG with its pooled
    projection), the base and refiner UNets and the VAE at their published
    widths, seeded random, created directly on ``device``."""
    torch.manual_seed(seed)
    out = []
    for cls, cfg in ((CLIPTextModel, OPENCLIP_BIGG_TEXT),
                     (UNet2DCondition, SDXL_UNET),
                     (UNet2DCondition, SDXL_REFINER_UNET),
                     (AutoencoderKL, SDXL_VAE)):
        with torch.device(device):
            model = cls(cfg)
        out.append(model.to(dtype).eval().requires_grad_(False))
    return tuple(out)


def write_sdxl(root: str, text, vision, te2, unet, refiner, vae) -> dict:
    """The SDXL base snapshot (``unet/``, ``vae/``, ``text_encoder/`` the
    CLIP-L text tower, ``text_encoder_2/`` bigG with ``text_projection``,
    ``tokenizer/``), the refiner's (``unet/``) and the CLIP ViT-L/14
    snapshot for ``clip_root``, fp16 HF layout under ``root``, after
    checking the free space."""
    base, ref, clip = (os.path.join(root, d) for d in SDXL_DIRS)
    files = {
        os.path.join(base, 'unet', 'diffusion_pytorch_model.safetensors'):
        unet.state_dict(),
        os.path.join(base, 'vae', 'diffusion_pytorch_model.safetensors'):
        vae.state_dict(),
        os.path.join(base, 'text_encoder', 'model.safetensors'):
        text.state_dict(),
        os.path.join(base, 'text_encoder_2', 'model.safetensors'):
        te2.state_dict(),
        os.path.join(ref, 'unet', 'diffusion_pytorch_model.safetensors'):
        refiner.state_dict(),
        os.path.join(clip, 'model.safetensors'):
        {**text.state_dict(), **vision.state_dict()}}
    need = sum(t.numel() * 2 for sd in files.values() for t in sd.values())
    free = shutil.disk_usage(root).free
    if free < 1.1 * need:
        raise RuntimeError(f'not enough free space under {root}: '
                           f'{free / 2**30:.1f} GiB for '
                           f'{1.1 * need / 2**30:.1f}')
    t0 = time.perf_counter()
    for path, sd in files.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        weights_safetensors.save_file(
            {k: v.to(SNAPSHOT_DTYPE) for k, v in sd.items()}, path)
    os.makedirs(os.path.join(base, 'tokenizer'))
    for d in (os.path.join(base, 'tokenizer'), clip):
        write_bpe_files(d, text.config.vocab_size)
    write_s = time.perf_counter() - t0
    print(f'step 19 snapshots: {need / 2**30:.2f} GiB under {root} '
          f'({free / 2**30:.1f} GiB free) in {write_s:.2f} s', flush=True)
    return dict(base=base, refiner=ref, clip=clip, bytes=need,
                write_s=write_s)


def write_sgm_lora(path: str, unet, te1, te2, seed: int) -> dict:
    """A rank-8 kohya SDXL adapter from seeded factors, SGM-named: the
    self-attention projections of every transformer block of ``unet``
    (``lora_unet_input_blocks_*``, ``middle_block_1``,
    ``output_blocks_*``) and the q/v projections of both text towers
    (``lora_te1_``, ``lora_te2_``). Returns one adapted module per target
    as ``{target: name}``."""
    gen = torch.Generator().manual_seed(seed)
    named = dict(unet.named_modules())
    mods = []
    for sgm, name in weights_lora.sgm_block_map(unet.config).items():
        for d in range(len(named[name].transformer_blocks)):
            for leaf in ('to_q', 'to_k', 'to_v', 'to_out.0'):
                full = f'{name}.transformer_blocks.{d}.attn1.{leaf}'
                key = (f'lora_unet_{sgm}_transformer_blocks_{d}_attn1_'
                       f'{leaf.replace(".", "_")}')
                mods.append(('unet', key, full, named[full]))
    for target, prefix, model in (('te', 'lora_te1_', te1),
                                  ('te2', 'lora_te2_', te2)):
        for n, m in model.named_modules():
            if n.endswith(('q_proj', 'v_proj')):
                mods.append((target, prefix + n.replace('.', '_'), n, m))
    out, first = {}, {}
    for target, key, name, m in mods:
        out[f'{key}.lora_down.weight'] = 0.02 * torch.randn(
            (LORA_RANK, m.in_features), generator=gen)
        out[f'{key}.lora_up.weight'] = 0.02 * torch.randn(
            (m.out_features, LORA_RANK), generator=gen)
        out[f'{key}.alpha'] = torch.tensor(float(LORA_RANK))
        first.setdefault(target, name)
    weights_safetensors.save_file(out, path)
    return first


def check_sdxl_merge(path: str, target: str, name: str, module,
                     stored: torch.Tensor, unet_config) -> None:
    """The merged weight of ``name`` is the snapshot's stored value plus
    the update, in fp32, rounded once."""
    (down, up, a), = [v for (t, n), v in weights_lora.parse_lora(
        weights_load.load_state_dict(path), unet_config)[0].items()
        if (t, n) == (target, name)]
    delta = torch.from_numpy((a * (up.astype(np.float64) @
                                   down.astype(np.float64))
                              ).astype(np.float32))
    got = module.weight
    if not torch.equal(got.cpu(), (stored.float() + delta).to(got.dtype)):
        raise AssertionError(f'SDXL LoRA merge of {target}:{name} is not '
                             'the stored weight plus the update rounded once')


def sdxl_rows(strength=None, steps: int = SDXL_STEPS) -> int:
    """The denoise rows of a DPM++ run of ``steps`` steps (img2img from
    ``strength``)."""
    sched = schedulers.make('dpmpp', steps)
    if strength is None:
        return sched.length
    _, t_start = schedulers.init_timestep_info(sched, strength, steps)
    return sched.length - t_start * sched.rows_per_step


def sdxl_gn_specs() -> list:
    """Every distinct K6 call of the SDXL path at 1024²: ``(shape, silu,
    eps, input dtype, output dtype)`` of one base and one refiner CFG
    evaluation, one decode and one encode, from :func:`tree_launches`' pass
    over the module tree on the meta device, in the order first met."""
    from flexdiffuse_tpu_torch.models import unet as unet_mod
    meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
    specs, real = {}, unet_mod.group_norm

    def record(x, groups, weight, bias, eps, silu=False, dtype=None):
        if groups != 32:
            raise AssertionError(f'SDXL GroupNorm with {groups} groups')
        specs.setdefault((tuple(x.shape), bool(silu), float(eps), x.dtype,
                          dtype or x.dtype), None)
        return real(x, groups, weight, bias, eps, silu, dtype)

    lat = SDXL_SIZE // 8
    runs = []
    for cfg in (SDXL_UNET, SDXL_REFINER_UNET):
        added = {'text_embeds': meta(2, cfg.addition_pooled_dim),
                 'time_ids': meta(2, cfg.num_time_ids)}
        runs.append(lambda m=_meta_model(UNet2DCondition, cfg), c=cfg,
                    a=added: m(meta(2, lat, lat, 4), meta(2),
                               meta(2, 77, c.cross_attention_dim),
                               added_cond=a))
    vae = _meta_model(AutoencoderKL, SDXL_VAE)
    runs += [lambda: vae.decode(meta(1, lat, lat, 4)),
             lambda: vae.encode(meta(1, SDXL_SIZE, SDXL_SIZE, 3))]
    unet_mod.group_norm = record
    try:
        for run in runs:
            tree_launches(run)
    finally:
        unet_mod.group_norm = real
    return list(specs)


def check_sdxl_models(runner, gen: torch.Generator) -> list:
    """One 1024² CFG evaluation of the base and of the refiner UNet through
    K1 and K6 against the plain backends (UNET_REL_TOL), with the module
    tree's launches (K1_SDXL, K6_SDXL), and ``added_cond`` moving ε by
    more than UNET_REL_TOL (against zero ``text_embeds`` and
    ``time_ids``)."""
    meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
    lat = torch.randn((2, 128, 128, 4), generator=gen, device='cuda')
    t2 = torch.full((2,), 981.0, device='cuda')
    ctx, pooled = runner.text.encode(['', PROMPT])
    rctx, rpooled = runner.text.encode_refiner(['', PROMPT])
    tids = sdxl_models.time_ids((SDXL_SIZE, SDXL_SIZE), (0, 0),
                                (SDXL_SIZE, SDXL_SIZE)).expand(2, -1)
    rtids = torch.cat([sdxl_models.refiner_time_ids(aesthetic_score=s)
                       for s in (2.5, 6.0)])
    out = []
    for kind, unet, c, p, ids in (('base', runner.pipe.unet, ctx, pooled,
                                   tids),
                                  ('refiner', runner.refiner_pipe.unet, rctx,
                                   rpooled, rtids)):
        added = {'text_embeds': p, 'time_ids': ids.to('cuda')}
        zero = {k: torch.zeros_like(v) for k, v in added.items()}
        mnet = _meta_model(UNet2DCondition, unet.config)
        madded = {k: meta(*v.shape) for k, v in added.items()}
        meta_run = (lambda m=mnet, c=c, a=madded: m(
            meta(2, 128, 128, 4), meta(2), meta(2, 77, c.shape[-1]),
            added_cond=a))
        tree = tree_launches(meta_run)[0]
        if (tree['k1'], tree['k6'], tree['k6_stream']) != (
                K1_SDXL[kind], *K6_SDXL[kind]):
            raise AssertionError(f'SDXL {kind}: the module tree implies '
                                 f'{tree}, not K1_SDXL/K6_SDXL')
        out.append(check_conditioning(
            f'SDXL {kind} UNet at 1024², batch 2',
            lambda u=unet, c=c, a=added: u(lat, t2, c, added_cond=a),
            meta_run,
            off=lambda u=unet, c=c, z=zero: u(lat, t2, c, added_cond=z),
            step=19))
    return out


def run_sdxl_cli(dirs: dict, out: str, size: int, steps: int,
                 base_evals: list, refiner_evals: list, check: bool,
                 device: str = 'cuda', configs=None) -> dict:
    """``cli generate --model-family sdxl --refiner`` in-process on the
    snapshots (the SDXLRunner it builds observed by :func:`_observe`, with
    ``configs`` for snapshots of another geometry than the published one),
    held by :func:`verify_run`; e2e includes the load."""
    from flexdiffuse_tpu_torch import sdxl_runner as sr
    real, seen = sr.SDXLRunner, {}

    class Observed(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw, **(configs or {}))

        def gen(self, **kw):
            seen['logs'] = _observe(self)
            seen['vae'] = self.pipe.vae.config
            try:
                return super().gen(**kw)
            finally:
                for log in seen['logs']:
                    log.remove()

    argv = ['generate', '--model-family', 'sdxl', '--models',
            os.path.dirname(dirs['base']), '--refiner', dirs['refiner'],
            '--refine-strength', str(SDXL_REFINE), '--scheduler', 'dpmpp',
            '--prompt', PROMPT, '--steps', str(steps), '--guidance-scale',
            str(SDXL_CFG), '--height', str(size), '--width', str(size),
            '--samples', '1', '--seed', str(STEP19_SEED), '--out', out,
            '--device', device]
    cuda = device == 'cuda'
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sr.SDXLRunner = Observed
    t0 = time.perf_counter()
    try:
        if cli.main(argv) != 0:
            raise AssertionError('cli generate --model-family sdxl failed')
    finally:
        sr.SDXLRunner = real
    e2e = time.perf_counter() - t0
    images = [Image.open(os.path.join(out, n))
              for n in sorted(os.listdir(out)) if n.endswith('.png')]
    return verify_run('cli generate --model-family sdxl --refiner',
                      seen['logs'], images, e2e, seen['vae'], base_evals,
                      [(base_evals[0][1], 1)], size, check, step=19,
                      refiner_evals=refiner_evals, cuda=cuda)


def run_sdxl_phase(text, vision, root: str, size: int = SDXL_SIZE,
                   steps: int = SDXL_STEPS, models=None, runner_kw=None,
                   check: bool = True, device: str = 'cuda') -> dict:
    """Step 19 (module docstring): the SDXL snapshots written under
    ``root`` (``text``/``vision``: the CLIP ViT-L/14 towers, SDXL's
    encoder 1 and the image-guide tower; ``models``: (bigG, base UNet,
    refiner UNet, VAE), default seeded random at the published widths) and
    loaded back through ``SDXLRunner``, the model checks (with ``check``),
    then the runs at ``size``², ``steps`` DPM++ steps, CFG 5: txt2img, an
    image guide, img2img at 0.6, base→refiner at 0.3, DeepCache 2, an SGM
    LoRA and the CLI. ``runner_kw``: the SDXLRunner's device, dtype and
    configs (default: the card, bf16, the published geometry)."""
    from flexdiffuse_tpu_torch.sdxl_runner import SDXLRunner
    te2, unet, refiner, vae = models or build_sdxl('cuda', BF16,
                                                   STEP19_SEED)
    dirs = write_sdxl(root, text, vision, te2, unet, refiner, vae)
    make = lambda: SDXLRunner(dirs['base'], clip_root=dirs['clip'],
                              refiner_root=dirs['refiner'],
                              **(runner_kw or {}))
    if device == 'cuda':
        runner, timing = load_runner(None, make)
    else:
        runner, timing = make(), {}
    if device == 'cuda':
        check_pairs(((runner.text.enc1, text), (runner.text.enc2, te2),
                     (runner.pipe.unet, unet),
                     (runner.refiner_pipe.unet, refiner),
                     (runner.pipe.vae, vae), (runner.vision, vision)))
    print(f'step 19 loaded SDXLRunner(model_root=, clip_root=, '
          f'refiner_root=): {json.dumps(timing)}; every loaded tensor '
          'equals the written one', flush=True)
    del te2, unet, refiner, vae, models
    gc.collect()
    if device == 'cuda':
        torch.cuda.empty_cache()
    checks = []
    if check:
        checks = check_sdxl_models(
            runner, torch.Generator('cuda').manual_seed(STEP19_SEED))
    f = runner.pipe.vae_scale
    lat = size // f
    full = lambda n, mode=None: [
        (2, lat, mode(i) if mode else 'off', False) for i in range(n)]
    rows = sdxl_rows(steps=steps)
    image = synthetic_image(size, STEP19_SEED)
    pixels = np.asarray(image, np.float32)[None] / 127.5 - 1.0
    common = dict(prompt=PROMPT, steps=steps, guidance_scale=SDXL_CFG,
                  samples=1, seed=STEP19_SEED, save=False,
                  init_size=(size, size), refine_strength=0.0)
    one = [(lat, 1)]
    run = lambda label, kw, evals, ref=(): run_feature(
        label, runner, dict(common, **kw), evals, one, size, check,
        step=19, refiner_evals=list(ref))
    results = [
        run(f'txt2img {size}²', {}, full(rows)),
        run('txt2img, image guide', dict(guide=image), full(rows)),
        # The image as the [-1, 1] array preprocess makes of a PIL image,
        # which it would resize to 512 on the long side.
        run(f'img2img {SDXL_STRENGTH}', dict(init_image=pixels,
                                             strength=SDXL_STRENGTH),
            full(sdxl_rows(SDXL_STRENGTH, steps))),
        run(f'base→refiner {SDXL_REFINE}', dict(refine_strength=SDXL_REFINE),
            full(rows), full(sdxl_rows(SDXL_REFINE, steps)))]
    runner.enable_deepcache(2)
    results.append(run('DeepCache 2', {}, full(
        rows, lambda i: 'save' if i % 2 == 0 else 'use')))
    runner.disable_deepcache()
    lora_path = os.path.join(root, 'sdxl_lora.safetensors')
    first = write_sgm_lora(lora_path, runner.pipe.unet, runner.text.enc1,
                           runner.text.enc2, STEP19_SEED)
    t0 = time.perf_counter()
    runner.apply_lora(lora_path)
    merge_s = time.perf_counter() - t0
    stored = {t: weights_load.load_state_dict(os.path.join(
        dirs['base'], sub)) for t, sub in (('unet', 'unet'),
                                           ('te2', 'text_encoder_2'))}
    for target, model in (('unet', runner.pipe.unet),
                          ('te2', runner.text.enc2)):
        name = first[target]
        check_sdxl_merge(lora_path, target, name,
                         dict(model.named_modules())[name],
                         stored[target][f'{name}.weight'],
                         runner.pipe.unet.config)
    print(f'step 19 SGM LoRA merged in {merge_s:.2f} s ({len(runner._merged)} '
          'weights; the checked ones are the stored weight plus the update '
          'rounded once)', flush=True)
    results.append(run('txt2img after an SGM LoRA', {}, full(rows)))
    out = os.path.join(root, 'cli_out')
    configs = {k: v for k, v in (runner_kw or {}).items()
               if k.endswith('_config')}
    results.append(run_sdxl_cli(dirs, out, size, steps, full(rows),
                                full(sdxl_rows(SDXL_REFINE, steps)), check,
                                device, configs))
    by_shape = sum((r.pop('by_shape') for r in results),
                   collections.Counter())
    for kernel in ('K1', 'K6'):
        print(f'step 19 {kernel} launches by shape: ' + ', '.join(
            f'{shape} {n}' for (k, shape), n in sorted(by_shape.items())
            if k == kernel), flush=True)
    return dict(runs=results, checks=checks, loading=timing,
                write_s=dirs['write_s'], bytes=dirs['bytes'],
                launches=_sum(r['launches'] for r in results),
                runner=runner)


# --- Step 20: textual-inversion and SDXL training (the thirteenth slice) ---

STEP20_SEED = SEED + 20
# K3/K4/K5 at SDXL's self-attentions at 1024²: the base's 4096- and
# 1024-token levels (10 and 20 heads of 64; K5 on its 32-row q tile above
# DP 48), at the LoRA run's batch 2 (timed) and the full run's batch 1.
STEP20_TRAIN_SHAPES = [((2, 10, 4096, 64), 4096), ((2, 20, 1024, 64), 1024),
                       ((1, 10, 4096, 64), 4096), ((1, 20, 1024, 64), 1024)]
STEP20_TIMED = [(2, 10, 4096, 64), (2, 20, 1024, 64)]
TI_IMAGES, TI_BATCH, TI_VECTORS, TI_STEPS, TI_CLI_STEPS = 8, 4, 2, 10, 4
TI_CONCEPT, TI_CLI_CONCEPT = '<flex-concept>', '<flex-style>'
SDXL_TRAIN_IMAGES, SDXL_LORA_BATCH, SDXL_LORA_STEPS = 4, 2, 6
SDXL_FULL_BATCH, SDXL_FULL_STEPS = 1, 2


def write_images(root: str, name: str, n: int, size: int, seed: int,
                 captions: bool = False) -> str:
    """``n`` synthetic ``size``² images (with ``.txt`` captions, two
    distinct) in a new folder ``root/name``."""
    d = os.path.join(root, name)
    os.makedirs(d)
    for i in range(n):
        synthetic_image(size, seed + i).save(os.path.join(d, f'{i}.png'))
        if captions:
            with open(os.path.join(d, f'{i}.txt'), 'w') as f:
                f.write(f'{PROMPT}, view {i % 2}')
    return d


def train_want(config, mode: str, remat: str, batch: int, lat: int,
               steps: int, vae_config=None, encodes=()) -> dict:
    """The launches of ``steps`` train steps (:func:`step_launches`) and of
    the VAE encodes (quant_conv output shapes, a VAE of ``vae_config``) the
    entry point makes."""
    step = step_launches(config, mode, remat, batch, lat)
    parts = [{k: v * steps for k, v in step.items()}]
    if encodes:
        parts.append(vae_launches(vae_config, [], list(encodes))[0])
    return _sum(parts)


class StepStamps(logging.Handler):
    """The times of a training logger's 'step i/n' records, while
    attached (the logger at INFO and kept to itself meanwhile)."""

    def __init__(self, name: str) -> None:
        super().__init__(logging.INFO)
        self.times: list = []
        self.logger = logging.getLogger(name)
        self.was = self.logger.level, self.logger.propagate
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.logger.addHandler(self)

    def emit(self, record) -> None:
        if record.getMessage().startswith('step '):
            self.times.append(record.created)

    def remove(self) -> None:
        self.logger.removeHandler(self)
        self.logger.setLevel(self.was[0])
        self.logger.propagate = self.was[1]


def run_ti_phase(text, unet, vae, root: str, runner, size: int = 512,
                 steps: int = TI_STEPS, cli_steps: int = TI_CLI_STEPS,
                 gen_steps: int = 25, check: bool = True,
                 device: str = 'cuda') -> dict:
    """Step 20's textual inversion (module docstring): the library entry
    point on step 6's models, then ``cli train --textual-inversion`` on
    step 12's snapshot under ``root``, its embedding loaded into
    ``runner`` (step 12's) and one ``gen`` with the placeholder."""
    data = write_images(root, 'ti_data', TI_IMAGES, size, STEP20_SEED)
    paths = [p for p, _ in training.find_items(data, default_caption='x')]
    lat = size // 8
    encodes = [(len(paths), 8, lat, lat)]
    want = lambda n: train_want(unet.config, 'ti', 'none', TI_BATCH, lat, n,
                                vae.config, encodes)
    out = os.path.join(root, 'ti_library.safetensors')
    kept = {}

    def train(on_step):
        rows, losses = training.train_textual_inversion(
            text, FakeTokenizer(text.config.vocab_size), unet, vae, paths,
            TI_CONCEPT, num_vectors=TI_VECTORS,
            cfg=training.TrainConfig(learning_rate=5e-4, weight_decay=0.0,
                                     remat='none'),
            steps=steps, batch_size=TI_BATCH, resolution=size,
            seed=STEP20_SEED, save_path=out, log_every=1, on_step=on_step)
        kept['rows'] = rows
        return rows, losses

    lib = run_training('step 20 train_textual_inversion', train, steps,
                       want=want(steps), batch=TI_BATCH, check=check)
    saved = weights_safetensors.load_file(out)
    if list(saved) != [TI_CONCEPT] or not np.array_equal(
            saved[TI_CONCEPT].numpy(), kept['rows']):
        raise AssertionError('the saved embedding is not the returned rows')

    cli_out = os.path.join(root, 'ti_cli.safetensors')
    argv = ['train', '--models', root, '--data', data,
            '--textual-inversion', TI_CLI_CONCEPT, '--init-token', 'a',
            '--num-vectors', str(TI_VECTORS), '--style-templates',
            '--steps', str(cli_steps), '--batch-size', str(TI_BATCH),
            '--resolution', str(size), '--lr', '5e-4', '--seed',
            str(STEP20_SEED), '--out', cli_out, '--device', device]
    if device == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # The CLI logs its first and last step, each after a synchronising
    # read of the loss: their records' times give the ms per step.
    stamps = StepStamps('flexdiffuse_tpu_torch.training.textual_inversion')
    reset_counts()
    t0 = time.perf_counter()
    try:
        if cli.main(argv) != 0:
            raise AssertionError('cli train --textual-inversion failed')
    finally:
        stamps.remove()
    got, e2e = counts(), time.perf_counter() - t0
    ms = (stamps.times[-1] - stamps.times[0]) / (cli_steps - 1) * 1e3
    cli_res = dict(label='cli train --textual-inversion', steps=cli_steps,
                   e2e_s=e2e, mean_step_ms=ms, batch=TI_BATCH,
                   images_per_s=TI_BATCH / ms * 1e3, launches=got,
                   expected=want(cli_steps),
                   peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                             if device == 'cuda' else None))
    print(f'step 20 {json.dumps(cli_res)}', flush=True)
    if check and got != cli_res['expected']:
        raise AssertionError(f'cli train --textual-inversion: launches {got}'
                             f', expected {cli_res["expected"]}')
    rows = weights_safetensors.load_file(cli_out)[TI_CLI_CONCEPT]
    runner.load_textual_inversion(cli_out)
    table = runner.encoder.text_model.text_model.embeddings.token_embedding
    ids = runner.encoder.tokenizer.added_tokens[TI_CLI_CONCEPT.lower()]
    if ids != list(range(table.weight.shape[0] - TI_VECTORS,
                         table.weight.shape[0])) or not torch.equal(
            table.weight[ids].cpu(), rows.to(table.weight.dtype)):
        raise AssertionError('the CLI embedding did not load to its rows')
    plms = gen_steps + 1
    gen = run_feature(
        f'gen {size}² with the trained placeholder', runner,
        dict(prompt=f'{PROMPT}, {TI_CLI_CONCEPT}', steps=gen_steps,
             guidance_scale=8, samples=1, seed=STEP20_SEED, save=False,
             init_size=(size, size)),
        [(2, lat, 'off', False)] * plms, [(lat, 1)], size, check, step=20)
    gen.pop('by_shape')
    return dict(library=lib, cli=cli_res, gen=gen,
                launches=_sum([lib['launches'], got, gen['launches']]))


def check_sdxl_controlnet(unet, gen: torch.Generator, text,
                          size: int = SDXL_SIZE) -> dict:
    """One CFG evaluation of the SDXL base UNet with a ControlNet of its
    geometry (``controlnet_from_unet``) and ``added_cond`` through K1 and
    K6 against the plain backends (UNET_REL_TOL), with the module tree's
    launches; the branch moves ε (against ``controlnet_scale`` 0)."""
    cn = controlnet_from_unet(unet, STEP20_SEED)
    lat = size // 8
    meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
    w = next(unet.parameters())
    x = torch.randn((2, lat, lat, 4), generator=gen, device=w.device)
    t2 = torch.full((2,), 981.0, device=w.device)
    cond = torch.rand((1, size, size, 3), generator=gen, device=w.device)
    ctx, pooled = text.encode(['', PROMPT])
    added = {'text_embeds': pooled, 'time_ids': sdxl_models.time_ids(
        (size, size), (0, 0), (size, size)).expand(2, -1).to(w.device)}
    madded = {k: meta(*v.shape) for k, v in added.items()}
    munet = _meta_model(UNet2DCondition, unet.config)
    mcn = _meta_model(ControlNetModel, cn.config)
    with_cn = lambda scale: unet(x, t2, ctx, added_cond=added, control=cn(
        x, t2, ctx, cond.expand(2, -1, -1, -1), scale, added_cond=added))
    return check_conditioning(
        f'SDXL UNet + ControlNet with added_cond at {size}², batch 2',
        lambda: with_cn(1.0),
        lambda: munet(meta(2, lat, lat, 4), meta(2),
                      meta(2, 77, ctx.shape[-1]), added_cond=madded,
                      control=mcn(meta(2, lat, lat, 4), meta(2),
                                  meta(2, 77, ctx.shape[-1]),
                                  meta(2, size, size, 3),
                                  added_cond=madded)),
        off=lambda: with_cn(0.0), step=20)


def write_ip_adapter(root: str, unet, encoder) -> dict:
    """A seeded base-projection SDXL IP-Adapter checkpoint
    (``ip_adapter_checkpoint``, the ``_vit-h`` layout: ``encoder``'s
    projection width to 4 tokens) and ``encoder`` as an image-encoder
    snapshot under ``root``, after checking the free space."""
    ck = ip_adapter_checkpoint(unet, 'base', encoder.config.projection_dim,
                               STEP20_SEED)
    sd = encoder.state_dict()
    need = sum(t.numel() * 2 for t in sd.values()) + sum(
        t.numel() * 2 for part in ck.values() for t in part.values())
    free = shutil.disk_usage(root).free
    if free < 1.1 * need:
        raise RuntimeError(f'not enough free space under {root}: '
                           f'{free / 2**30:.1f} GiB for '
                           f'{1.1 * need / 2**30:.1f}')
    paths = dict(adapter=os.path.join(root, 'ip-adapter_sdxl_vit-h.bin'),
                 encoder=os.path.join(root, 'image_encoder'))
    os.makedirs(paths['encoder'])
    weights_safetensors.save_file(
        {k: v.to(SNAPSHOT_DTYPE) for k, v in sd.items()},
        os.path.join(paths['encoder'], 'model.safetensors'))
    torch.save(ck, paths['adapter'])
    return paths


def run_sdxl_training_phase(runner, root: str, size: int = SDXL_SIZE,
                            steps: int = SDXL_STEPS,
                            lora_steps: int = SDXL_LORA_STEPS,
                            full_steps: int = SDXL_FULL_STEPS,
                            encoder=None, check: bool = True,
                            device: str = 'cuda') -> dict:
    """Step 20's SDXL part (module docstring), on step 19's ``runner``
    while its snapshots under ``root`` exist: the SDXL dataset, LoRA
    training, its merge and a txt2img, an IP-Adapter (``_vit-h``) run and a
    ControlNet check, then, with the runner freed, full fine-tuning of an
    fp32 copy of the base UNet. ``encoder``: the image encoder to write
    (default: OpenCLIP ViT-H, seeded)."""
    cuda = device == 'cuda'
    data = write_images(root, 'sdxl_data', SDXL_TRAIN_IMAGES, size,
                        STEP20_SEED, captions=True)
    vae, base = runner.pipe.vae, runner.pipe.unet
    lat = size // runner.pipe.vae_scale
    encodes = [(SDXL_TRAIN_IMAGES, 8, lat, lat)]
    reset_counts()
    t0 = time.perf_counter()
    ds = training.encode_dataset_sdxl(training.find_items(data), vae,
                                      runner.text, resolution=size,
                                      encode_batch=SDXL_TRAIN_IMAGES)
    got, want = counts(), vae_launches(vae.config, [], encodes)[0]
    enc = dict(images=len(ds), seconds=time.perf_counter() - t0,
               mean=list(ds.mean.shape), context=list(ds.context.shape),
               pooled=list(ds.pooled.shape), time_ids=ds.time_ids.tolist(),
               dtypes=[str(ds.pooled.dtype), str(ds.time_ids.dtype)],
               launches=got)
    print(f'step 20 encode_dataset_sdxl: {json.dumps(enc)}', flush=True)
    if ds.pooled.dtype != torch.float32 or \
            ds.time_ids.dtype != torch.float32 or \
            ds.time_ids[0, 0].item() != size:
        raise AssertionError('the SDXL dataset\'s pooled/time ids')
    if check and got != _sum([want]):
        raise AssertionError(f'encode_dataset_sdxl: launches {got}, '
                             f'expected {want}')

    lora_path = os.path.join(root, 'sdxl_trained_lora.safetensors')
    lora = run_training(
        'step 20 SDXL train_lora', lambda on_step: training.train_lora(
            base, ds, training.TrainConfig(learning_rate=1e-4,
                                           remat='full'),
            rank=LORA_RANK, steps=lora_steps, batch_size=SDXL_LORA_BATCH,
            seed=STEP20_SEED, save_path=lora_path, log_every=1,
            on_step=on_step), lora_steps,
        want=train_want(base.config, 'lora', 'full', SDXL_LORA_BATCH, lat,
                        lora_steps),
        batch=SDXL_LORA_BATCH, check=check)
    t0 = time.perf_counter()
    runner.apply_lora(lora_path)
    merge_s = time.perf_counter() - t0
    rows = sdxl_rows(steps=steps)
    full = [(2, lat, 'off', False)] * rows
    common = dict(prompt=PROMPT, steps=steps, guidance_scale=SDXL_CFG,
                  samples=1, seed=STEP20_SEED, save=False,
                  init_size=(size, size), refine_strength=0.0)
    runs = [run_feature(f'txt2img {size}² after the trained LoRA '
                        f'(merged in {merge_s:.2f} s)', runner, common, full,
                        [(lat, 1)], size, check, step=20)]

    if encoder is None:
        torch.manual_seed(STEP20_SEED)
        with torch.device(device):
            encoder = CLIPVisionModel(OPENCLIP_H_VISION)
        encoder = encoder.to(BF16).eval().requires_grad_(False)
    ip = write_ip_adapter(root, base, encoder)
    del encoder
    runner.load_ip_adapter(ip['adapter'], ip['encoder'], encoder='vit-h')
    image = synthetic_image(size, STEP20_SEED)
    runs.append(run_feature(
        f'IP-Adapter _vit-h at {size}² from ip_image', runner,
        dict(common, ip_image=image, ip_scale=1.0), full, [(lat, 1)], size,
        check, step=20))
    checks = []
    if check:
        checks.append(check_sdxl_controlnet(
            base, torch.Generator(device).manual_seed(STEP20_SEED),
            runner.text, size))
    for r in runs:
        r.pop('by_shape')

    n = sum(p.numel() for p in base.parameters())
    print(f'step 20 SDXL train_full memory: {n} parameters; fp32 weights, '
          f'gradients and two Adam moments {16 * n / 2**30:.1f} GiB, plus '
          f'the bf16 casts of the weights {2 * n / 2**30:.1f} GiB under '
          'autocast and the activations of one batch-1 forward '
          '(remat full)', flush=True)
    with torch.device('meta'):
        unet32 = UNet2DCondition(base.config)
    unet32.load_state_dict({k: v.float() for k, v in
                            base.state_dict().items()}, assign=True)
    unet32.requires_grad_(True)
    config = base.config
    del runner, base, vae
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    full_res = run_training(
        'step 20 SDXL train_full', lambda on_step: training.train_full(
            unet32, ds, training.TrainConfig(learning_rate=1e-5,
                                             remat='full'),
            steps=full_steps, batch_size=SDXL_FULL_BATCH, seed=STEP20_SEED,
            log_every=1, on_step=on_step), full_steps,
        want=train_want(config, 'full', 'full', SDXL_FULL_BATCH, lat,
                        full_steps),
        batch=SDXL_FULL_BATCH, check=check)
    del unet32
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return dict(encode=enc, lora=lora, runs=runs, checks=checks,
                full=full_res, launches=_sum(
                    [got, lora['launches'], full_res['launches']] +
                    [r['launches'] for r in runs]))


def check_train_shapes(shapes, gen: torch.Generator, timed) -> list:
    """K3/K4/K5 at ``shapes`` ((shape, skv) pairs) against their twins
    (:func:`check_train_kernels`), timed at the shapes in ``timed``; raises
    on a disagreement, a kernel off the Hopper path, K3 not K1's output or
    K4/K5 not deterministic."""
    res = [check_train_kernels(s, skv, gen, s in timed) for s, skv in shapes]
    for r in res:
        print('K3-K5', json.dumps(r))
        if 'ms' not in r['k3']:
            continue
        for name in ('k3', 'k4', 'k5'):
            print(f'{name.upper()} {tuple(r["shape"])}: {summary(r[name])}')
        print(f'K4+K5 {tuple(r["shape"])}: {r["k4"]["ms"] + r["k5"]["ms"]:.4f}'
              f' ms (kept {r["k4"]["kept_ms"] + r["k5"]["kept_ms"]:.4f}, SDPA '
              f'backward {r["k4"]["library_ms"]:.4f}); forward+backward '
              f'{r["fwd_bwd_ms"]:.4f} (SDPA {r["library_fwd_bwd_ms"]:.4f})',
              flush=True)
    bad = [(r['shape'], r['skv']) for r in res if not r['ok']]
    if bad:
        raise AssertionError(f'K3/K4/K5 disagree with their twins (or left '
                             f'the Hopper path, K3 K1, or K4/K5 are not '
                             f'deterministic) at {bad}')
    return res


# --- Step 21: the parallel modules (the fourteenth slice) ------------------

STEP21_SEED = SEED + 21
SWEEP_SEEDS, SWEEP_STEPS, SWEEP_SIZE = 4, 10, 512
SP_SIZE, SP_STEPS = 1024, 4
# The ring rounds at the SP run's self-attention shapes (1024²: 16384 and
# 4096 tokens), cut into n K/V chunks in one process.
STEP21_RING_SHAPES = [(2, 8, 16384, 40), (2, 8, 4096, 80)]
STEP21_RING_N = (1, 2, 4, 8)
# K3 at SDXL's full fine-tuning shapes (batch 1), untimed before.
STEP21_K3_SHAPES = [(1, 10, 4096, 64), (1, 20, 1024, 64)]
# Bytes a plain ring round may take for its fp32 scores (and their exp2):
# larger rounds report no plain time.
PLAIN_SCORE_BYTES = 8 * 2**30


def step21_line(part: str, rec: dict) -> None:
    print(f'step 21 {part}: ' + json.dumps(dict(rec, card=card_line()),
                                            default=str), flush=True)


def _images_rule(got: np.ndarray, ref: np.ndarray, kp: float) -> tuple:
    """Step 3's rule on decoded [0, 1] images: ``ref`` the kernels' run
    that ``got`` must match, ``kp`` the max|Δ| between the kernels' and the
    plain backends' runs of it (the twin's error): ``(ok, max|Δ|, tol,
    flipped)``."""
    g, r = torch.from_numpy(got), torch.from_numpy(ref)
    tol = 2.0 * kp + 1e-3 * float(r.abs().max())
    ok, flipped = within_rule(g, r, tol)
    return ok, float((g - r).abs().max()), tol, flipped


def _run_plain(call):
    """``call()`` with plain attention and the plain GroupNorm."""
    with attn_mod.backend('plain'), gn.backend('plain'):
        return call()


def _log_want(log, vae_config) -> dict:
    parts = [eval_launches(e) for e in log.evals] + [
        vae_launches(vae_config, log.decodes, log.encodes)]
    return _sum(p[0] for p in parts)


def _main_run(label: str, pipe, call) -> tuple:
    """A step-21 main-path run on ``pipe`` with the counts at 0: its
    result, launches, the module tree's launches and e2e seconds."""
    log = CallLog(pipe.unet, pipe.vae)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    try:
        out = call()
        torch.cuda.synchronize()
    finally:
        log.remove()
    e2e = time.perf_counter() - t0
    got = counts()
    if not all(bool(f) for f in log.finite):
        raise AssertionError(f'step 21 {label}: non-finite ε or latents')
    return out, got, log, e2e


def run_dp_sweeps(unet, vae, gen: torch.Generator) -> dict:
    """Step 21 (a): ``sweep`` (4 seeds), ``guidance_param_sweep`` (4
    settings) and ``compose_sweep`` (2 seeds, 2 entities) at 512², PNDM,
    10 steps, CFG 8, over a data mesh at world 1; every sweep image, the
    last setting's and both composed images within the rule of a batch-1
    run on the same noise; exact K1/K6 launches."""
    from flexdiffuse_tpu_torch.config import GuidanceParams
    from flexdiffuse_tpu_torch.parallel import (compose_sweep,
                                                guidance_param_sweep,
                                                make_mesh, seed_sweep_keys,
                                                sweep)
    from flexdiffuse_tpu_torch.pipeline import FlexPipeline, SimpleGuidance
    from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                       entity_masks)
    mesh = make_mesh(model_parallel=1)
    pipe = FlexPipeline(unet, vae, scheduler='pndm')
    d = unet.config.cross_attention_dim
    emb, unc = (torch.randn((1, 77, d), generator=gen, device='cuda')
                for _ in range(2))
    seeds = seed_sweep_keys(STEP21_SEED, SWEEP_SEEDS).tolist()
    size = (SWEEP_SIZE, SWEEP_SIZE)
    kw = dict(steps=SWEEP_STEPS, init_size=size, mesh=mesh)
    launches = collections.Counter()
    out = {}
    images, got, log, e2e = _main_run('sweep', pipe, lambda: sweep(
        pipe, emb, unc, seeds, guidance_scale=8.0, **kw))
    want = _log_want(log, vae.config)
    launches.update(got)
    # The references: each seed alone at batch 1 on its noise, and that
    # run on the plain backends for the rule's scale.
    f = pipe.vae_scale
    guide = SimpleGuidance(embeddings=emb, uncond=unc, guidance_scale=8.0)

    def alone(seed, guide=guide):
        noise = torch.randn((1, SWEEP_SIZE // f, SWEEP_SIZE // f, 4),
                            device='cuda', generator=torch.Generator(
                                'cuda').manual_seed(seed))
        return lambda: pipe(guide, steps=SWEEP_STEPS, init_size=size,
                            noise=noise, output_type='np').images[0]

    def twin_err(call):
        return float(np.abs(call() - _run_plain(call)).max())
    kp = twin_err(alone(seeds[0]))
    rules = [_images_rule(images[i], alone(s)(), kp)
             for i, s in enumerate(seeds)]
    out['sweep'] = dict(images=list(images.shape), e2e_s=e2e,
                        max_abs_vs_batch1=[r[1] for r in rules],
                        tol=rules[0][2], flipped=sum(r[3] for r in rules),
                        kernels_vs_plain=kp, launches=got, expected=want)
    ok = all(r[0] for r in rules) and got == want and \
        images.shape == (SWEEP_SEEDS, SWEEP_SIZE, SWEEP_SIZE, 3)
    # Four guidance settings (one seed for every row), then composition.
    base = torch.randn((77, d), generator=gen, device='cuda')
    alt = torch.randn((257, d), generator=gen, device='cuda')
    settings = [dataclasses.replace(GuidanceParams.ui_defaults(),
                                    linear=(0.0, e))
                for e in (0.0, 0.3, 0.6, 0.9)]
    rows = guidance_param_sweep(base, alt, settings)
    pimg, got, log, e2e = _main_run('guidance_param_sweep', pipe,
                                    lambda: sweep(pipe, rows, unc,
                                                  [seeds[0]] * 4, **kw))
    want = _log_want(log, vae.config)
    launches.update(got)
    # The last setting alone at batch 1 on the same noise.
    last = alone(seeds[0], SimpleGuidance(embeddings=rows[-1:], uncond=unc,
                                          guidance_scale=8.0))
    rule = _images_rule(pimg[-1], last(), twin_err(last))
    out['guidance_param_sweep'] = dict(
        images=list(pimg.shape), e2e_s=e2e, launches=got, expected=want,
        setting_spread=float(np.abs(pimg[0] - pimg[-1]).max()),
        max_abs_vs_batch1=rule[1], tol=rule[2], flipped=rule[3])
    ok = ok and rule[0] and got == want and np.isfinite(pimg).all() and \
        out['guidance_param_sweep']['setting_spread'] > 0
    hw = SWEEP_SIZE // f
    g = CompositeGuidance(
        background=emb, entities=torch.randn((2, 77, d), generator=gen,
                                             device='cuda'),
        masks=entity_masks([((0, 0), (hw // 2, hw)),
                            ((hw // 2, 0), (hw // 2, hw))],
                           (hw, hw)).cuda(),
        blends=torch.tensor([0.8, 0.6], device='cuda'), uncond=unc,
        guidance_scale=8.0)
    cimg, got, log, e2e = _main_run('compose_sweep', pipe,
                                    lambda: compose_sweep(pipe, g, seeds[:2],
                                                          **kw))
    want = _log_want(log, vae.config)
    launches.update(got)
    # Each seed composed alone at batch 1 on its noise.
    kp = twin_err(alone(seeds[0], g))
    rules = [_images_rule(cimg[i], alone(s, g)(), kp)
             for i, s in enumerate(seeds[:2])]
    out['compose_sweep'] = dict(images=list(cimg.shape), e2e_s=e2e,
                                launches=got, expected=want,
                                unet_batches=sorted({e['batch']
                                                     for e in log.evals}),
                                max_abs_vs_batch1=[r[1] for r in rules],
                                tol=rules[0][2],
                                flipped=sum(r[3] for r in rules),
                                kernels_vs_plain=kp)
    ok = ok and all(r[0] for r in rules) and got == want and \
        np.isfinite(cimg).all()
    step21_line('(a) DP sweeps', out)
    if not ok:
        raise AssertionError('step 21 (a): a sweep, setting or composed '
                             'image left the rule of its batch-1 run or the '
                             'launches differ')
    return dict(launches)


def run_dp_training(unet, ds) -> dict:
    """Step 21 (b): ``train_lora`` (rank 8, batch 4, 3 steps) with a data
    mesh at world 1 and without: bit-equal losses and factors, exact
    K3–K5 (and K1/K6) launches."""
    from flexdiffuse_tpu_torch.parallel import make_mesh
    want = train_want(unet.config, 'lora', 'none', TRAIN_BATCH, 64, 3)
    res, trained = {}, {}
    for label, mesh in (('train_lora', None),
                        ('train_lora mesh', make_mesh(model_parallel=1))):
        def train_fn(on_step, mesh=mesh, label=label):
            factors, losses = training.train_lora(
                unet, ds, training.TrainConfig(learning_rate=1e-4,
                                               remat='none'),
                rank=8, steps=3, batch_size=TRAIN_BATCH, seed=SEED,
                mesh=mesh, log_every=1, on_step=on_step)
            trained[label] = train_mod.factor_tree(factors)
            return factors, losses
        res[label] = run_training(f'step 21 (b) {label}', train_fn, 3, want)
    a, b = (trained[k] for k in ('train_lora', 'train_lora mesh'))
    same = res['train_lora']['losses'] == res['train_lora mesh']['losses'] \
        and sorted(a) == sorted(b) and all(torch.equal(a[k], b[k])
                                           for k in a)
    step21_line('(b) DP training', dict(
        bit_equal=same, losses=res['train_lora mesh']['losses'],
        median_step_ms=res['train_lora mesh']['median_step_ms'],
        median_step_ms_no_mesh=res['train_lora']['median_step_ms'],
        launches=res['train_lora mesh']['launches']))
    if not same:
        raise AssertionError('step 21 (b): train_lora over a world-1 mesh '
                             'is not bit-equal to the run without one')
    total = collections.Counter(res['train_lora']['launches'])
    total.update(res['train_lora mesh']['launches'])
    return dict(total)


def sp_tree_launches(mesh, evals, decodes, vae_config) -> tuple:
    """The launches the SP run implies on the card, from a pass over the
    module tree on the meta device under ``sp_context`` at world 1: every
    ring round that ``attn_mod.route`` sends to the kernels for a CUDA
    tensor (K3), every other attention it sends there (K1), every
    GroupNorm that reaches ``group_norm`` (K6: none; under SP they take
    ``row_shard.group_norm``). Returns ``(launches, ring round shapes)``."""
    from flexdiffuse_tpu_torch.models import unet as unet_mod
    from flexdiffuse_tpu_torch.ops import ring_attention as ring_mod
    tally, rounds = collections.Counter(), collections.Counter()
    real_round, real_route, real_gn = (ring_mod.ring_round, attn_mod.route,
                                       unet_mod.group_norm)
    inside = []

    def ring_round(q, kb, vb, state, scale):
        if real_route(q.shape, kb.shape, 'cuda', 'auto') == 'flash':
            tally['k3'] += 1
            tally[f'k3_{fa.plan(q.contiguous(), kb.contiguous()).path}'] += 1
            rounds[tuple(q.shape), tuple(kb.shape)] += 1
        inside.append(1)
        try:
            return real_round(q, kb, vb, state, scale)
        finally:
            inside.pop()

    def route(q_shape, k_shape, device_type, backend):
        if not inside and real_route(q_shape, k_shape, 'cuda',
                                     backend) == 'flash':
            tally['k1'] += 1
            tally['k1_sm90'] += 1
        return real_route(q_shape, k_shape, device_type, backend)

    def group_norm(*args, **kw):
        tally['k6'] += 1
        return real_gn(*args, **kw)

    meta = lambda *shape: torch.empty(shape, device='meta', dtype=BF16)
    ring_mod.ring_round, attn_mod.route = ring_round, route
    unet_mod.group_norm = group_norm
    try:
        with attn_mod.sp_context(mesh, 'seq', 4096), torch.no_grad():
            for e in evals:
                unet = _meta_model(UNet2DCondition, e['config'],
                                   e['settings'])
                b = e['batch']
                unet(meta(b, *e['hw'], e['channels']), meta(b),
                     meta(b, *e['ctx']))
            vae = _meta_model(AutoencoderKL, vae_config)
            for b, c, h, w in decodes:
                vae.decode(meta(b, h, w, c))
    finally:
        ring_mod.ring_round, attn_mod.route = real_round, real_route
        unet_mod.group_norm = real_gn
    return want_launches(k1=tally['k1'], k3=tally['k3'],
                         k6=tally['k6']), rounds


def check_sp_models(unet, vae, mesh, gen: torch.Generator) -> dict:
    """Step 21 (c) model checks at 1024²: one UNet evaluation (batch 2, as
    CFG gives it) and one decode under ``sp_context`` (K3's ring round, the
    halo-row convs, the all-reduced GroupNorm) against the same modules
    without SP on the plain backends: max|Δ|/max|ref| within
    UNET_REL_TOL, as steps 18 and 19 hold their models."""
    d = unet.config.cross_attention_dim
    h = SP_SIZE // 2**(len(vae.config.block_channels) - 1)
    lat = torch.randn((2, h, h, 4), generator=gen, device='cuda')
    t = torch.tensor([500, 500], device='cuda')
    ctx = torch.randn((2, 77, d), generator=gen, device='cuda')
    z = lat[:1] / 0.18215

    def both():
        return unet(lat, t, ctx), vae.decode(z)
    with torch.no_grad():
        with attn_mod.sp_context(mesh, 'seq', 4096):
            eps_sp, img_sp = both()
        eps_p, img_p = _run_plain(both)
    res = dict(unet_rel=_rel(eps_sp, eps_p), decode_rel=_rel(img_sp, img_p),
               limit=UNET_REL_TOL)
    step21_line('(c) SP model checks', res)
    finite = bool(torch.isfinite(eps_sp).all() and
                  torch.isfinite(img_sp).all())
    if not (finite and res['unet_rel'] <= UNET_REL_TOL and
            res['decode_rel'] <= UNET_REL_TOL):
        raise AssertionError('step 21 (c): the SP UNet or decode disagrees '
                             'with the plain modules')
    return res


def run_sp(unet, vae, gen: torch.Generator) -> dict:
    """Step 21 (c): ``sp_pipeline`` at world 1 (NCCL), 1024², DDIM, 4
    steps, CFG 8, against the plain 1024² pipeline on the same noise (the
    rule's scale: that pipeline on the plain backends); exact launches:
    K3 for every ring-eligible self-attention (one round at world 1), K1
    where the route sends the levels below the threshold, no K6. Then
    :func:`check_sp_models`."""
    from flexdiffuse_tpu_torch.parallel import make_sp_mesh, sp_pipeline
    from flexdiffuse_tpu_torch.pipeline import FlexPipeline, SimpleGuidance
    mesh = make_sp_mesh()
    d = unet.config.cross_attention_dim
    emb, unc = (torch.randn((1, 77, d), generator=gen, device='cuda')
                for _ in range(2))
    guide = SimpleGuidance(embeddings=emb, uncond=unc, guidance_scale=8.0)
    f = 2**(len(vae.config.block_channels) - 1)
    noise = torch.randn((1, SP_SIZE // f, SP_SIZE // f, 4), generator=gen,
                        device='cuda')
    kw = dict(steps=SP_STEPS, init_size=(SP_SIZE, SP_SIZE), noise=noise,
              output_type='np')
    sp = sp_pipeline(unet, vae, mesh=mesh, scheduler='ddim')
    plain = FlexPipeline(unet, vae, scheduler='ddim')
    # Warm both: the 1024² shapes' first cuDNN plans stay out of the e2e.
    plain(guide, **kw)
    sp(guide, **kw)
    img, got, log, e2e = _main_run('sp', sp, lambda: sp(guide, **kw).images)
    want, rounds = sp_tree_launches(mesh, log.evals, log.decodes,
                                    vae.config)
    t0 = time.perf_counter()
    ref = plain(guide, **kw).images
    torch.cuda.synchronize()
    e2e_plain = time.perf_counter() - t0
    kp = float(np.abs(ref - _run_plain(lambda: plain(guide, **kw).images))
               .max())
    ok, err, tol, flipped = _images_rule(img, ref, kp)
    step21_line('(c) SP', dict(
        size=SP_SIZE, steps=SP_STEPS, images=list(img.shape), e2e_s=e2e,
        plain_pipeline_e2e_s=e2e_plain, max_abs_vs_plain=err, tol=tol,
        flipped=flipped, kernels_vs_plain=kp,
        unet_evaluations=len(log.evals), decodes=len(log.decodes),
        ring_rounds={f'{q}x{k}': n for (q, k), n in rounds.items()},
        launches=got, expected=want))
    if not ok or got != want or got['k6'] != 0:
        raise AssertionError('step 21 (c): the SP images left the rule of '
                             'the plain pipeline or the launches differ')
    check_sp_models(unet, vae, mesh, gen)
    return got


def _k3_row(shape, skv: int, gen: torch.Generator, label: str) -> dict:
    """K3 at q ``shape`` against k/v of ``skv`` rows: times of K3, SDPA
    and (where its scores fit) the plain twin, and the bound."""
    b, h, sq, d = shape
    q = torch.randn(shape, generator=gen, device='cuda', dtype=BF16)
    k, v = (torch.randn((b, h, skv, d), generator=gen, device='cuda',
                        dtype=BF16) for _ in range(2))
    scale = d**-0.5
    row = dict(label=label, shape=list(shape), skv=skv)
    eligible = attn_mod.route(q.shape, k.shape, 'cuda', 'auto') == 'flash'
    row['route'] = 'k3' if eligible else 'plain'
    if eligible:
        row['ms'] = time_ms(lambda: fb.flash_attention_lse(q, k, v, scale),
                            graph=True)
    row['library_ms'] = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, scale=scale), graph=True)
    if 8 * b * h * sq * skv <= PLAIN_SCORE_BYTES:
        row['plain_ms'] = time_ms(
            lambda: fb.plain_attention_lse(q, k, v, scale), iters=5)
    row['bound_ms'], row['bound_by'] = attention_bound('k3', b, h, sq, skv,
                                                       d)
    return row


def check_ring_math(gen: torch.Generator) -> list:
    """Step 21 (d): ``ring_round`` over n = 1, 2, 4, 8 K/V chunks of the
    SP run's shapes in one process (the rotation by hand: rank r's round j
    holds chunk (r − j) mod n; n = 1 is the SP run's own round), against
    the fp32 plain attention by K1's rule and against K1 on the whole
    sequence; K3 timed at every round shape, and at SDXL's full
    fine-tuning shapes."""
    from flexdiffuse_tpu_torch.ops.ring_attention import ring_round
    rows = []
    for shape in STEP21_RING_SHAPES:
        b, h, s, d = shape
        q, k, v = (torch.randn(shape, generator=gen, device='cuda',
                               dtype=BF16) for _ in range(3))
        scale = d**-0.5
        whole = fa.flash_attention(q, k, v, scale)
        refs, plain_err, max_ref = [], 0.0, 0.0
        for hh in range(h):
            sl = (slice(None), slice(hh, hh + 1))
            ref = fa.plain_attention(q[sl].float(), k[sl].float(),
                                     v[sl].float(), scale)
            plain = fa.plain_attention(q[sl], k[sl], v[sl], scale)
            plain_err = max(plain_err,
                            (plain.float() - ref).abs().max().item())
            max_ref = max(max_ref, ref.abs().max().item())
            refs.append(ref)
        tol = 2.0 * plain_err + 1e-3 * max_ref
        for n in STEP21_RING_N:
            c = s // n
            out = torch.empty_like(q)
            for r in range(n):
                state = None
                for j in range(n):
                    blk = slice((r - j) % n * c, ((r - j) % n + 1) * c)
                    state = ring_round(q[:, :, r * c:(r + 1) * c],
                                       k[:, :, blk], v[:, :, blk], state,
                                       scale)
                out[:, :, r * c:(r + 1) * c] = state[0].to(q.dtype)
            ok, flipped = True, 0
            for hh, ref in enumerate(refs):
                o, fl = within_rule(out[:, hh:hh + 1], ref, tol)
                ok, flipped = ok and o, flipped + fl
            err = max((out[:, hh:hh + 1].float() - ref).abs().max().item()
                      for hh, ref in enumerate(refs))
            row = _k3_row((b, h, c, d), c, gen, f'ring n={n}')
            row.update(ring_shape=list(shape), n=n, max_abs_err=err,
                       tol=tol, flipped=flipped, ok=ok,
                       max_abs_vs_k1=float((out.float() - whole.float())
                                           .abs().max()))
            rows.append(row)
        del refs, whole
    rows += [_k3_row(sh, sh[2], gen, 'SDXL full fine-tune')
             for sh in STEP21_K3_SHAPES]
    for r in rows:
        step21_line('(d) ring', r)
    bad = [(r['ring_shape'], r['n']) for r in rows if not r.get('ok', True)]
    if bad:
        raise AssertionError(f'step 21 (d): the ring disagrees with the '
                             f'plain attention at {bad}')
    return rows


def check_cli_refusal() -> None:
    """Step 21 (e): ``cli train --data-parallel 2`` on a one-card machine
    exits non-zero with the missing-card message before anything loads (no
    model root exists to load)."""
    proc = subprocess.run(
        [sys.executable, '-m', 'flexdiffuse_tpu_torch.cli', 'train',
         '--models', 'no-such-models', '--data', 'no-such-data',
         '--data-parallel', '2'], capture_output=True, text=True,
        timeout=300)
    msg = proc.stderr.strip().splitlines()[-1] if proc.stderr else ''
    step21_line('(e) CLI', dict(rc=proc.returncode, message=msg,
                                cards=torch.cuda.device_count()))
    if proc.returncode == 0 or 'CUDA cards' not in msg:
        raise AssertionError(f'step 21 (e): train --data-parallel 2 gave rc '
                             f'{proc.returncode}: {msg!r}')


def run_parallel_phase(unet, vae, ds) -> dict:
    """Step 21: NCCL at world 1 over a ``file://`` store, then (a)–(e); the
    group torn down after."""
    import torch.distributed as dist

    from flexdiffuse_tpu_torch.parallel import launch
    gen = torch.Generator('cuda').manual_seed(STEP21_SEED)
    store = tempfile.mkdtemp(prefix='flexdiffuse_store_')
    launch.init_rank(0, 1, os.path.join(store, 'store'), 'cuda',
                     timeout=300)
    try:
        launches = collections.Counter(run_dp_sweeps(unet, vae, gen))
        launches.update(run_dp_training(unet, ds))
        launches.update(run_sp(unet, vae, gen))
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    rows = check_ring_math(gen)
    check_cli_refusal()
    return dict(launches={k: launches[k] for k in want_launches()},
                k3_rows=rows)


# Step 22: the real-weight parity harness on step 12's snapshot.
STEP22_SEED = SEED + 22
STEP22_GATE_STEPS = 5   # the numerics gate's PNDM steps (fixed, not tuned)
STEP22_EXP_STEPS = 4    # experiments.py's run: 1 sample, 4 steps
GATE_MSE = 1e-2         # BASELINE.json's gate on the final latents


@contextlib.contextmanager
def observe_gens():
    """Every ``Runner.gen`` of the block, also of runners built inside it:
    a list of (device type, the pipeline's :class:`CallLog`, VAE config,
    images)."""
    rec = []
    real = Runner.gen

    def gen(self, *args, **kw):
        logs = _observe(self)
        try:
            images, grid = real(self, *args, **kw)
        finally:
            for log in logs:
                log.remove()
        rec.append((self.pipe.device.type, logs[0], self.pipe.vae.config,
                    images))
        return images, grid

    Runner.gen = gen
    try:
        yield rec
    finally:
        Runner.gen = real


def gens_launches(rec, label: str, image_side: int) -> dict:
    """The launches the card's runs in ``rec`` (:func:`observe_gens`)
    imply, from the module tree (:func:`eval_launches`,
    :func:`vae_launches`), after checking finite ε and latents and finite,
    non-constant ``image_side``² uint8 images in every run."""
    parts = []
    for device, log, vae_config, images in rec:
        if not all(bool(f) for f in log.finite):
            raise AssertionError(f'step 22 {label}: non-finite ε or latents')
        for im in images:
            a = np.asarray(im)
            if a.shape != (image_side, image_side, 3) or \
                    a.dtype != np.uint8 or not a.std() > 0:
                raise AssertionError(f'step 22 {label}: image {a.shape} '
                                     f'{a.dtype} std {a.std()}')
        if device == 'cuda':
            parts += [eval_launches(e)[0] for e in log.evals]
            parts.append(vae_launches(vae_config, log.decodes,
                                      log.encodes)[0])
    return _sum(parts)


def run_harness_phase(root: str, common=(), harness=(),
                      image_side: int = 512, check: bool = True) -> dict:
    """Step 22 (module docstring) on the snapshot under ``root``;
    ``common`` is added to both tools' arguments and ``harness`` to the
    harness's (a CPU rehearsal passes ``--device cpu`` and small sizes,
    with ``check=False``: no launch counts there)."""
    from flexdiffuse_tpu_torch.pipeline import SimpleGuidance
    from flexdiffuse_tpu_torch.tools import experiments as tool_exp
    from flexdiffuse_tpu_torch.tools import validate_reference as tool_vr
    assets = os.path.join(root, 'experiments')
    os.makedirs(assets, exist_ok=True)
    for i, name in enumerate(tool_vr.ASSETS):
        # PNG bytes under the reference's names (PIL reads by content).
        synthetic_image(512, STEP22_SEED + i).save(
            os.path.join(assets, name), format='PNG')
    args = tool_vr.parse_args(
        ['--models', root, '--experiments', assets, '--out',
         os.path.join(root, 'validate'), '--gate-steps',
         str(STEP22_GATE_STEPS), *common, *harness])
    runner = tool_vr.build_runner(args)
    cuda = runner.pipe.device.type == 'cuda'
    if cuda:
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with observe_gens() as rec:
        report = tool_vr.run(args, runner)
    harness_s = time.perf_counter() - t0
    got = counts()
    want = gens_launches(rec, '(a)', image_side)
    cfgs = report['configs']
    gate = cfgs['t2i_base']
    res = dict(card=card_line() if cuda else 'cpu', harness_s=harness_s,
               e2e_s={n: c.get('wall_s') for n, c in cfgs.items()},
               images={n: c.get('images') for n, c in cfgs.items()},
               gate_steps=STEP22_GATE_STEPS, **{k: gate[k] for k in (
                   'latent_mse_vs_cpu_fp32', 'latent_rel_mse',
                   'latent_max_abs', 'latent_mse_gate_1e-2')},
               launches=got, expected=want)
    print(f'step 22 (a)+(b) harness: {json.dumps(res)}', flush=True)
    skipped = {n: c['skipped'] for n, c in cfgs.items() if 'skipped' in c}
    if skipped:
        raise AssertionError(f'step 22 (a): configs skipped: {skipped}')
    if check and got != want:
        raise AssertionError(f'step 22 (a): launches {got}, expected '
                             f'{want}')
    if not gate['latent_mse_vs_cpu_fp32'] <= GATE_MSE:
        raise AssertionError(
            f'step 22 (b): final-latent MSE {gate["latent_mse_vs_cpu_fp32"]}'
            f' against CPU fp32 misses the {GATE_MSE} gate')
    # The pipeline's output answers as the reference's does.
    enc = runner.encoder
    out = runner.pipe(SimpleGuidance(embeddings=enc.prompt(PROMPT),
                                     uncond=enc.prompt(''),
                                     guidance_scale=8.0),
                      steps=2, init_size=(image_side, image_side),
                      output_type='latent')
    if not (out['sample'] is out.images and out['images'] is out.images
            and out.nsfw_content_detected == [False]):
        raise AssertionError('step 22: FlexPipelineOutput does not answer '
                             "['sample'] / ['images'] / "
                             '.nsfw_content_detected as the reference')
    del runner, out
    gc.collect()
    launches = collections.Counter(got)
    # (c) experiments.py on the same snapshot, its own Runner.
    exp_out = os.path.join(root, 'experiments_out')
    reset_counts()
    t0 = time.perf_counter()
    with observe_gens() as rec:
        rc = tool_exp.main([
            '--models', root, '--prompt', PROMPT, '--guide',
            os.path.join(assets, 'deer_mod.webp'), '--init',
            os.path.join(assets, 'deer_img2img_base.png'), '--steps',
            str(STEP22_EXP_STEPS), '--samples', '1', '--out', exp_out,
            *common])
    exp = dict(card=res['card'], e2e_s=time.perf_counter() - t0,
               launches=counts(), expected=gens_launches(rec, '(c)',
                                                         image_side),
               pngs=len([n for n in os.listdir(exp_out)
                         if n.endswith('.png')]))
    print(f'step 22 (c) experiments: {json.dumps(exp)}', flush=True)
    if rc != 0 or exp['pngs'] != 1:
        raise AssertionError(f'step 22 (c): rc {rc}, {exp["pngs"]} images')
    if check and exp['launches'] != exp['expected']:
        raise AssertionError(f'step 22 (c): launches {exp["launches"]}, '
                             f'expected {exp["expected"]}')
    launches.update(exp['launches'])
    return dict(launches={k: launches[k] for k in want_launches()},
                harness=res, experiments=exp)


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
    ap.add_argument('--family', default='sd1', choices=('sd1', 'sdxl'),
                    help='--profile-gen: SD-1.4 at 512² or the SDXL base '
                    'at 1024²')
    ap.add_argument('--profile-out', default='outputs/profile',
                    help='where the profiling modes write their tables')
    args = ap.parse_args()
    # Warnings only: the CLI phase's ``cli.main`` would otherwise set INFO
    # logging for every request of the surfaces phase.
    logging.basicConfig(level=logging.WARNING)
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
        profile_generate(args.profile_gen, args.profile_out, args.family)
        return 0

    parts = {fa.SOURCE: fa.BUILD_PARTS, fb.SOURCE: fb.BUILD_PARTS,
             gn.SOURCE: 1, fv.SOURCE: fv.BUILD_PARTS}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(parts)) as pool:
        build_secs = list(pool.map(fa.build, parts, parts.values()))
    for src, secs in zip(parts, build_secs):
        print(f'build {src.name}: {secs:.1f} s ({fa.library_path(src).name})')
    print(f'build step: {time.perf_counter() - t0:.1f} s')

    gen = torch.Generator('cuda').manual_seed(SEED)
    serve_gen = torch.Generator('cuda').manual_seed(SERVE_SEED)
    results = [check_kernel(s, gen) for s in KERNEL_SHAPES]
    results += [check_kernel(s, serve_gen) for s in SERVE_SHAPES]
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
    gn_res += [check_group_norm(*spec, serve_gen)
               for spec in SERVE_GN_SHAPES]
    for r in gn_res:
        print('K6', json.dumps(r))
    for r in gn_res:
        if 'ms' in r:
            print(f'K6 {tuple(r["shape"])}: {gn_summary(r)}')
    bad = [r['shape'] for r in gn_res if not r['ok']]
    if bad:
        raise AssertionError(f'K6 disagrees with the plain GroupNorm (or '
                             f'left its planned path) at {bad}')

    text, vision, unet, vae = build_models('cuda', torch.bfloat16, SEED)
    runner = Runner.from_models(text, vision, unet, vae,
                                FakeTokenizer(CLIP_VIT_L14_TEXT.vocab_size))
    check_models(unet, vae, runner.encoder.prompt(['', PROMPT]), gen)
    runs = run_generate_phases(text, vision, unet, vae)
    gen_launches = {k: sum(r['launches'][k] for r in runs)
                    for k in runs[0]['launches']}

    # The sampling features (step 17): K1 and K6 at their new shapes, then
    # every run.
    t0 = time.perf_counter()
    gen17 = torch.Generator('cuda').manual_seed(STEP17_SEED)
    res17 = [check_kernel(s, gen17, timed=True) for s in STEP17_K1_SHAPES]
    for r in res17:
        print('K1', json.dumps(r))
    for r in res17:
        print(f'K1 {tuple(r["shape"])}: {summary(r)}')
    wide = fa.SM90_TILES[True]
    bad = [r['shape'] for r in res17 if not r['ok'] or (
        r['shape'][3] == 64 and
        (r['block_q'] // fa.ROWS, r['block_kv']) != wide)]
    if bad:
        raise AssertionError(f'K1 disagrees with plain attention, left the '
                             f'Hopper path or its 64-wide tiling at {bad}')
    gn17 = [check_group_norm(*spec, gen17) for spec in STEP17_GN_SHAPES]
    for r in gn17:
        print('K6', json.dumps(r))
    for r in gn17:
        if 'ms' in r:
            print(f'K6 {tuple(r["shape"])}: {gn_summary(r)}')
    bad = [r['shape'] for r in gn17 if not r['ok']]
    if bad:
        raise AssertionError(f'K6 disagrees with the plain GroupNorm (or '
                             f'left its planned path) at {bad}')
    sampling = run_sampling_phase(
        text, vision, unet, vae, sd2=build_sd21('cuda', torch.bfloat16,
                                                STEP17_SEED))
    results += res17
    gn_res += gn17
    print(f'sampling phase (step 17): {time.perf_counter() - t0:.1f} s',
          flush=True)

    # The conditioning models (step 18): K1 and K6 at their new shapes,
    # then the checkpoints, the model checks and the five runs.
    t0 = time.perf_counter()
    gen18 = torch.Generator('cuda').manual_seed(STEP18_SEED)
    res18 = [check_kernel(s, gen18, timed=True) for s in STEP18_K1_SHAPES]
    gn18 = [check_group_norm(*spec, gen18) for spec in STEP18_GN_SHAPES]
    for r in res18:
        print('K1', json.dumps(r))
        print(f'K1 {tuple(r["shape"])}: {summary(r)}')
    for r in gn18:
        print('K6', json.dumps(r))
        print(f'K6 {tuple(r["shape"])}: {gn_summary(r)}')
    bad = [r['shape'] for r in res18 + gn18 if not r['ok']]
    if bad:
        raise AssertionError(f'K1 or K6 disagrees with its plain version (or '
                             f'left its planned path) at {bad}')
    root18 = tempfile.mkdtemp(prefix='flexdiffuse_conditioning_')
    try:
        conditioning = run_conditioning_phase(text, vision, unet, vae,
                                              root18)
    finally:
        shutil.rmtree(root18, ignore_errors=True)
    results += res18
    gn_res += gn18
    print(f'conditioning phase (step 18): {time.perf_counter() - t0:.1f} s',
          flush=True)

    # SDXL (step 19): K1 and K6 at SDXL's shapes, then the snapshots, the
    # model checks and the runs, after steps 17-18's runners are freed.
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gen19 = torch.Generator('cuda').manual_seed(STEP19_SEED)
    res19 = [check_kernel(s, gen19, timed=True) for s in STEP19_K1_SHAPES]
    # K6 at every call of the path; timed at STEP19_GN_TIMED with SiLU.
    gn19 = [check_group_norm(shape, silu, eps, din, dout,
                             silu and shape in STEP19_GN_TIMED, gen19)
            for shape, silu, eps, din, dout in sdxl_gn_specs()]
    for r in res19:
        print('K1', json.dumps(r))
        print(f'K1 {tuple(r["shape"])}: {summary(r)}')
    for r in gn19:
        print('K6', json.dumps(r))
        if 'ms' in r:
            print(f'K6 {tuple(r["shape"])}: {gn_summary(r)}')
    print(f'step 19 K6 held at {len(gn19)} calls of the path, '
          f'{sum("ms" in r for r in gn19)} timed; largest error '
          f'{max(r["max_abs_err"] / r["tol"] for r in gn19):.3f} of its '
          'tolerance', flush=True)
    bad = [r['shape'] for r in res19 if not r['ok'] or (
        (r['block_q'] // fa.ROWS, r['block_kv']) != wide)]
    bad += [r['shape'] for r in gn19 if not r['ok']]
    if bad:
        raise AssertionError(f'K1 or K6 disagrees with its plain version (or '
                             f'left its planned path or K1 its 64-wide '
                             f'tiling) at {bad}')
    root19 = tempfile.mkdtemp(prefix='flexdiffuse_sdxl_')
    try:
        sdxl = run_sdxl_phase(text, vision, root19)
        print(f'SDXL phase (step 19): {time.perf_counter() - t0:.1f} s',
              flush=True)
        # Step 20's SDXL part, on step 19's runner while its snapshots
        # (which SDXLRunner.apply_lora reads) exist: K3/K4/K5 at SDXL's
        # training shapes, then the runs.
        t0 = time.perf_counter()
        res20 = check_train_shapes(
            STEP20_TRAIN_SHAPES,
            torch.Generator('cuda').manual_seed(STEP20_SEED), STEP20_TIMED)
        sdxl_train = run_sdxl_training_phase(sdxl.pop('runner'), root19)
        step20_s = time.perf_counter() - t0
        print(f'SDXL training (step 20): {step20_s:.1f} s', flush=True)
    finally:
        shutil.rmtree(root19, ignore_errors=True)
    results += res19
    gn_res += gn19
    gc.collect()
    torch.cuda.empty_cache()

    # Training: the kernels, then the full-width step, then the loops.
    t0 = time.perf_counter()
    train_res = check_train_shapes(TRAIN_SHAPES, gen, TRAIN_MAIN) + res20
    fp32_res = check_fp32_attention(gen)
    print(f'K3-K5 and fp32 checks: {time.perf_counter() - t0:.1f} s')

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
            log_every=1, on_step=on_step), LORA_STEPS,
        train_want(unet.config, 'lora', 'none', TRAIN_BATCH, 64, LORA_STEPS))

    # Loading from disk: a snapshot of these weights, removed after.
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix='flexdiffuse_snapshot_')
    try:
        disk = run_disk_phases(text, vision, unet, vae, ds, root)
        print(f'loading phase: {time.perf_counter() - t0:.1f} s')
        # The surfaces: CLI, UI and serving on that snapshot and Runner.
        t0 = time.perf_counter()
        disk_runner = disk.pop('runner')
        surfaces = run_surfaces(disk_runner, root)
        print(f'surfaces phase: {time.perf_counter() - t0:.1f} s')
        # Step 20's textual inversion: on step 6's models, then the CLI on
        # this snapshot, its embedding in this Runner.
        t0 = time.perf_counter()
        ti = run_ti_phase(text, unet, vae, root, disk_runner)
        ti_s = time.perf_counter() - t0
        print(f'textual inversion (step 20): {ti_s:.1f} s; step 20 in all '
              f'{step20_s + ti_s:.1f} s', flush=True)
        # The parity harness (step 22) on this snapshot.
        t0 = time.perf_counter()
        harness = run_harness_phase(root)
        print(f'parity harness (step 22): {time.perf_counter() - t0:.1f} s',
              flush=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    del text, vision, runner, disk_runner
    torch.manual_seed(SEED)
    with torch.device('cuda'):
        unet32 = UNet2DCondition(SD14_UNET)
    full = run_training(
        'train_full', lambda on_step: training.train_full(
            unet32, ds, training.TrainConfig(learning_rate=1e-5,
                                             remat='full'),
            steps=FULL_STEPS, batch_size=TRAIN_BATCH, seed=SEED,
            log_every=1, on_step=on_step), FULL_STEPS,
        train_want(SD14_UNET, 'full', 'full', TRAIN_BATCH, 64, FULL_STEPS))
    del unet32
    gc.collect()
    torch.cuda.empty_cache()

    # The parallel modules (step 21): NCCL at world 1, the DP sweeps and
    # training, SP at 1024², the ring's rounds, the CLI's refusal.
    t0 = time.perf_counter()
    parallel = run_parallel_phase(unet, vae, ds)
    print(f'parallel phase (step 21): {time.perf_counter() - t0:.1f} s',
          flush=True)
    launches = {k: gen_launches[k] + lora['launches'][k] +
                full['launches'][k] + disk['launches'][k] +
                surfaces['launches'][k] + sampling['launches'][k] +
                conditioning['launches'][k] + sdxl['launches'][k] +
                sdxl_train['launches'][k] + ti['launches'][k] +
                parallel['launches'][k] + harness['launches'][k]
                for k in gen_launches}
    del ds

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
    # K1 and K3–K5 also carry the kept mma.sync kernel's time on the same
    # inputs and the host µs per call, and the times at every timed shape.
    timed = lambda rows: [dict(shape=shape, **{key: m[key] for key in (
        'ms', 'kept_ms', 'library_ms', 'bound_ms')})
        for shape, m in rows if 'ms' in m]
    # ... and fp32's times on the kept path at FP32_SHAPE.
    extra = lambda m, rows, name: dict(
        {key: m[key] for key in ('kept_ms', 'host_us', 'kept_host_us')},
        by_shape=timed(rows), fp32=dict(shape=fp32_res['shape'], **{
            key: fp32_res[name][key] for key in (
                'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
                'max_abs_err') if key in fp32_res[name]}))
    kernels = [dict(
        name='flash_attention', route='cuda',
        source='flexdiffuse_tpu_torch/csrc/flash_attention.cu',
        replaces='flexdiffuse_tpu/ops/flash_attention.py:126',
        launches=launches['k1'],
        max_abs_err=max(r['max_abs_err'] for r in results),
        ms=main_res['ms'], plain_ms=main_res['plain_ms'],
        bound_ms=main_res['bound_ms'], bound_by=main_res['bound_by'],
        library_ms=main_res['library_ms'],
        **extra(main_res, [(r['shape'], r) for r in results], 'k1'))]
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
            **extra(m, [(r['shape'], r[key]) for r in train_res], key),
            **({'step21': parallel['k3_rows']} if key == 'k3' else {})))
    # K6 also carries its launches by path, the host µs per call, and the
    # times at every timed shape.
    gn_main = gn_res[0]
    kernels.append(dict(
        name='fused_group_norm', route='cuda',
        source='flexdiffuse_tpu_torch/csrc/group_norm.cu',
        replaces='flexdiffuse_tpu/ops/group_norm.py:41',
        launches=launches['k6'],
        max_abs_err=max(r['max_abs_err'] for r in gn_res),
        ms=gn_main['ms'], plain_ms=gn_main['plain_ms'],
        bound_ms=gn_main['bound_ms'], bound_by=gn_main['bound_by'],
        library_ms=gn_main['library_ms'],
        path_launches={p: launches[f'k6_{p}'] for p in gn.PATHS},
        host_us=gn_main['host_us'],
        by_shape=[dict(shape=r['shape'], path=r['path'], **{
            key: r[key] for key in ('ms', 'stream_ms', 'plain_ms',
                                    'library_ms', 'bound_ms', 'host_us')
            if key in r}) for r in gn_res if 'ms' in r]))
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
