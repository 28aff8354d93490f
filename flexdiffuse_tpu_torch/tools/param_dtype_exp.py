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
warm-up; ms per forward. Beside it: ``fp32_rerun_max_abs``, the ``fp32``
chain run once more against itself (is the chain deterministic?);
``first_difference``, the first module in execution order whose output
differs between ``fp32`` and ``bf16-mm`` in one evaluation (its name,
max|Δ| and output dtypes in each; null when none differs); and
``plain_group_norm``, the ``fp32`` and ``bf16-mm`` chains again with every
GroupNorm on its plain path (``ops.group_norm.backend('plain')``): on the
card the UNet's GroupNorms emit their next layer's dtype, fp32 in ``fp32``
and bf16 in ``bf16-mm``, and K6 evaluates the fused SiLU differently for
the two. ``--no-tf32`` turns TF32 off for cuBLAS and cuDNN first; the line
records both settings.

    python -m flexdiffuse_tpu_torch.tools.param_dtype_exp [--no-tf32]
        [--device cpu]

Prints one JSON line. On the CPU it runs the tiny UNet, 2 deep.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from flexdiffuse_tpu_torch.models import SD14_UNET, UNet2DCondition
from flexdiffuse_tpu_torch.models.configs import TINY_UNET
from flexdiffuse_tpu_torch.ops import group_norm as gn
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
def first_difference(a, b, lat: torch.Tensor, ctx: torch.Tensor):
    """The first leaf module, in execution order, whose output differs
    between UNets ``a`` and ``b`` (the same module tree) in one evaluation
    under bf16 autocast, both rounded to the narrower of their dtypes, as a
    dict (name, max_abs, dtype in each), and the count of leaves that
    differ; None when none does."""
    t = torch.full((lat.shape[0],), 500.0, device=lat.device)
    outs = []
    for unet in (a, b):
        seen = []
        hooks = [m.register_forward_hook(
            lambda mod, inp, out, name=name, seen=seen: seen.append(
                (name, out.detach().clone())
                if isinstance(out, torch.Tensor) else None))
            for name, m in unet.named_modules()
            if not any(True for _ in m.children())]
        try:
            with torch.autocast(lat.device.type, dtype=BF16):
                unet(0.1 * torch.tanh(lat), t, ctx)
        finally:
            for h in hooks:
                h.remove()
        outs.append([x for x in seen if x is not None])
    first, differ = None, 0
    for (name, x), (_, y) in zip(*outs):
        # An fp32 output that the next layer rounds to bf16 is compared
        # rounded: only a value that differs after it counts.
        narrow = min((x.dtype, y.dtype), key=lambda d: d.itemsize)
        if torch.equal(x.to(narrow), y.to(narrow)):
            continue
        differ += 1
        if first is None:
            first = dict(module=name, max_abs=float(
                (x.float() - y.float()).abs().max()),
                dtypes=[str(x.dtype), str(y.dtype)])
    return None if first is None else dict(first, leaves_differing=differ)


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
    layouts = variants(unet32)
    for label, unet in layouts.items():
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
    rerun = chain(layouts['fp32'], lat, ctx, steps)
    with gn.backend('plain'):
        plain = [chain(layouts[v], lat, ctx, steps) for v in ('fp32',
                                                              'bf16-mm')]
    return {'metric': f'sd1.4 {side * 8}x{side * 8} UNet chain, CFG batch '
                      f'2, {steps} deep, bf16 autocast',
            'variants': rows,
            'bf16_mm_bit_identical': rows[2]['max_abs_vs_fp32'] == 0.0,
            'fp32_rerun_max_abs': float((rerun - ref).abs().max()),
            'first_difference': first_difference(
                layouts['fp32'], layouts['bf16-mm'], lat, ctx),
            'plain_group_norm': {
                'bf16_mm_max_abs_vs_fp32': float(
                    (plain[1] - plain[0]).abs().max()),
                'bf16_mm_bit_identical': bool(torch.equal(*plain))},
            'matmul_allow_tf32': torch.backends.cuda.matmul.allow_tf32,
            'cudnn_allow_tf32': torch.backends.cudnn.allow_tf32}


def main() -> None:
    ap = parser(__doc__)
    ap.add_argument('--no-tf32', action='store_true',
                    help='TF32 off for cuBLAS and cuDNN')
    args = ap.parse_args()
    if args.no_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
