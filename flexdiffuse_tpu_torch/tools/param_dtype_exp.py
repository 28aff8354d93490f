"""The SD-1.4 UNet chain with fp32 against bf16 and ``bf16-mm`` parameters.

Port of ``tools/param_dtype_exp.py``. The JAX UNet computes in bf16 and
casts its fp32 parameters at each use; the port's counterpart is fp32
parameters under bf16 autocast (``torch.autocast``), which casts them at
each use likewise. Variants, all under bf16 autocast:

* ``fp32``: fp32 parameters (the per-use casts);
* ``bf16``: every parameter bf16, the norms' scale and bias too (the
  port's product path; not bit-identical, measured for the difference);
* ``bf16-mm``: parameters of two or more dimensions bf16, 1-D ones fp32.

The JAX script's claim is that ``bf16-mm`` is bit-identical to ``fp32``
(every cast moves out of the step; every fp32 op owns only 1-D
parameters); ``max_abs_vs_fp32`` checks it here. The chain: 25 evaluations
``l ← unet(0.1·tanh(l), 500, ctx)`` at CFG batch 2, 512², best of 3 after a
warm-up; ms per forward.

    python -m flexdiffuse_tpu_torch.tools.param_dtype_exp [--device cpu]

Prints one JSON line. On the CPU it runs the tiny UNet, 2 deep.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from flexdiffuse_tpu_torch.models import SD14_UNET, UNet2DCondition
from flexdiffuse_tpu_torch.models.configs import TINY_UNET
from flexdiffuse_tpu_torch.tools import BF16, parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (TOKENS, emit, finite,
                                                      seeded, timed)

STEPS = 25
VARIANTS = ('fp32', 'bf16', 'bf16-mm')


def variants(unet32) -> dict:
    """The three parameter layouts of one fp32 UNet's weights."""
    bf16 = copy.deepcopy(unet32).to(BF16)
    mm = copy.deepcopy(unet32)
    for p in mm.parameters():
        if p.dim() >= 2:
            p.data = p.data.to(BF16)
    return {'fp32': unet32, 'bf16': bf16, 'bf16-mm': mm}


@torch.no_grad()
def chain(unet, lat: torch.Tensor, ctx: torch.Tensor,
          steps: int = STEPS) -> torch.Tensor:
    t = torch.full((lat.shape[0],), 500.0, device=lat.device)
    with torch.autocast(lat.device.type, dtype=BF16):
        out = lat
        for _ in range(steps):
            out = unet(0.1 * torch.tanh(out), t, ctx)
    return out.float()


def measure(unet32, steps: int = STEPS, side: int = 64, reps: int = 3,
            seed: int = 0) -> dict:
    """``unet32``: an fp32 UNet (the weights of every variant)."""
    device = next(unet32.parameters()).device
    rng = np.random.default_rng(seed)
    lat = torch.from_numpy(rng.normal(size=(2, side, side, 4)).astype(
        np.float32) * 0.1).to(device)
    ctx = torch.from_numpy(rng.normal(size=(
        2, TOKENS, unet32.config.cross_attention_dim)).astype(
            np.float32)).to(device)
    rows, ref = [], None
    for label, unet in variants(unet32).items():
        times, out, _ = timed(lambda: chain(unet, lat, ctx, steps), device,
                              reps)
        if not finite(out):
            raise RuntimeError(f'param_dtype_exp {label}: non-finite')
        if ref is None:
            ref = out
        ms = min(times) / steps * 1e3
        rows.append(dict(variant=label, ms_per_forward=ms,
                         steps_per_sec=1e3 / ms,
                         max_abs_vs_fp32=float((out - ref).abs().max())))
    return {'metric': f'sd1.4 {side * 8}x{side * 8} UNet chain, CFG batch '
                      f'2, {steps} deep, bf16 autocast',
            'variants': rows,
            'bf16_mm_bit_identical': rows[2]['max_abs_vs_fp32'] == 0.0}


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    if device.type == 'cuda':
        res = measure(seeded(UNet2DCondition, SD14_UNET, device,
                             torch.float32))
    else:
        res = measure(seeded(UNet2DCondition, TINY_UNET, device,
                             torch.float32), steps=2, side=8, reps=1)
    emit(res, device)


if __name__ == '__main__':
    main()
