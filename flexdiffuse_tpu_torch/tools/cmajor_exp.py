"""A/B the channel-major transformer interior on the SD-1.4 CFG loop.

Port of ``tools/cmajor_exp.py``. The JAX script compared the two
orientations of the transformer interiors (``models/unet.py``
``channel_major``) on its product scan, where the channel-major one keeps
every interior product on XLA's standard emitter and the flash kernel's
operands in place. On the card the question is the same in other terms:
the channel-major interior makes the head split a view, so the attention
kernel (``fa.flash_attention_cm``) reads q, k and v where the projections
wrote them, at the price of its own products and LayerNorms over ``[C,
B·S]``.

The loop: :func:`~.bench_common.cfg_loop` (the JAX script's scan body:
the UNet on ``[lat, lat]``, CFG 8, PNDM) at 512², 25 steps, batch 1, zero
start latents and a seeded context, best of 4 after a warm-up, for each
orientation of one set of seeded weights (``with_settings``). Also one
UNet evaluation's max|Δε| between the orientations on the same inputs
(the single-forward agreement check), and the final latents' max|Δ|.

    python -m flexdiffuse_tpu_torch.tools.cmajor_exp [--steps N]
        [--reps R] [--device cpu]

Prints one JSON line. On the CPU it runs a tiny UNet with 1024 tokens at
its first level (so the channel-major interior engages), 4 steps, as a
check that the path runs.
"""
from __future__ import annotations

import torch

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.models import SD14_UNET, UNet2DCondition
from flexdiffuse_tpu_torch.models.configs import UNetConfig
from flexdiffuse_tpu_torch.tools import BF16, parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (TOKENS, cfg_loop, emit,
                                                      finite, seeded, timed)

STEPS = 25
# The CPU check's UNet: 32² latents, so its first level has 1024 tokens.
CPU_UNET = UNetConfig(block_channels=(8, 16), layers_per_block=1,
                      attention_levels=(True, True), num_heads=2,
                      cross_attention_dim=16, norm_groups=4)


def inputs(unet, side: int, device: torch.device) -> tuple:
    """Zero start latents ``[1, side, side, 4]`` and a seeded CFG context
    ``[2, 77, D]`` (normal·0.3), fp32, as the JAX script draws them."""
    gen = torch.Generator(device).manual_seed(2)
    ctx = torch.randn((2, TOKENS, unet.config.cross_attention_dim),
                      generator=gen, device=device) * 0.3
    return torch.zeros((1, side, side, 4), device=device), ctx


def run(unet, steps: int = STEPS, side: int = 64, reps: int = 4,
        model: str = 'sd1.4') -> dict:
    """Each orientation's steps/s (best of ``reps`` after a warm-up), the
    single-forward max|Δε| and the final latents' max|Δ|."""
    device = next(unet.parameters()).device
    lat, ctx = inputs(unet, side, device)
    schedule = schedulers.make('pndm', steps)
    rows, outs, eps = [], {}, {}
    t = torch.full((2,), 500.0, device=device)
    for cm in (False, True):
        net = unet.with_settings(channel_major=cm)
        with torch.no_grad():
            eps[cm] = net(torch.randn((2, side, side, 4), device=device,
                                      generator=torch.Generator(
                                          device).manual_seed(3)), t, ctx)
        times, outs[cm], first = timed(
            lambda: cfg_loop(net, schedule, lat, ctx, 8.0), device, reps)
        best = min(times)
        rows.append(dict(channel_major=cm, warm_s=first,
                         steps_per_sec=schedule.length / best,
                         ms_per_step=best / schedule.length * 1e3,
                         finite=finite(outs[cm])))
    return dict(
        metric=f'{model} {side * 8}x{side * 8} CFG PNDM {steps}-step loop, '
               'standard vs channel-major interiors',
        rows=rows,
        single_forward_max_abs_diff=float(
            (eps[True] - eps[False]).abs().max()),
        single_forward_scale=float(eps[False].abs().max()),
        loop_max_abs_diff=float((outs[True] - outs[False]).abs().max()),
        loop_scale=float(outs[False].abs().max()),
        steps_per_sec_change=rows[1]['steps_per_sec'] /
        rows[0]['steps_per_sec'] - 1)


def main() -> None:
    ap = parser(__doc__)
    ap.add_argument('--steps', type=int, default=STEPS)
    ap.add_argument('--reps', type=int, default=4)
    args = ap.parse_args()
    device = resolve_device(args.device)
    if device.type == 'cuda':
        unet = seeded(UNet2DCondition, SD14_UNET, device, BF16)
        res = run(unet, args.steps, reps=args.reps)
    else:
        unet = seeded(UNet2DCondition, CPU_UNET, device, torch.float32)
        res = run(unet, 4, side=32, reps=1, model='tiny')
    emit(res, device)


if __name__ == '__main__':
    main()
