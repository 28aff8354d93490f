"""CFG-interval A/B at SD-1.4 geometry on the card.

Port of ``tools/cfg_interval_exp.py``: the 25-step 512² CFG loop exact
against ``cfg_interval=(0, 0.6)``, where rows outside the interval run the
UNet cond-only at half batch (Kynkäänniemi et al. 2024, "Applying
Guidance in a Limited Interval"), optionally with DeepCache; steps/s are
the median of 4 runs after a warm-up. Without ``--json`` it also checks
the scale-1 exactness anchor: at guidance scale 1 (+1e-9) CFG equals
cond-only, so an interval run (0.3, 1.0) must match the full-CFG run; the
JAX script's bound is 5e-3 max|Δ| on bf16 latents. ``--dtype fp32`` builds
the models in fp32 and turns TF32 off for cuBLAS and cuDNN (full fp32, the
anchor's reference precision); the line records both TF32 settings, and
the metric the dtype.

    python -m flexdiffuse_tpu_torch.tools.cfg_interval_exp
        [--deepcache N] [--json] [--dtype bf16|fp32] [--device cpu]

Prints one JSON line. On the CPU it runs the tiny models, 4 steps, as a
check that the path runs.
"""
from __future__ import annotations

import dataclasses
import statistics

import torch

from flexdiffuse_tpu_torch.tools import BF16, parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import (emit, finite, mse,
                                                      timed)
from flexdiffuse_tpu_torch.tools.deepcache_exp import (STEPS, build_parts,
                                                       models)

ANCHOR_BOUND = 5e-3


def with_interval(guide, interval):
    if interval is None:
        return guide
    return dataclasses.replace(guide, cfg_interval=True,
                               cfg_from=float(interval[0]),
                               cfg_to=float(interval[1]))


def run_variant(parts: dict, guide, interval, steps: int = STEPS,
                reps: int = 4) -> tuple:
    """(steps/s, the median of ``reps`` runs after a warm-up; the final
    latents) of the loop with ``guide`` and an optional cfg interval."""
    pipe = parts['pipe']
    g = with_interval(guide, interval)
    size = tuple(s * pipe.vae_scale for s in parts['latents'].shape[1:3])
    run = lambda: pipe(g, steps=steps, init_size=size,
                       noise=parts['latents'], output_type='latent').images
    times, lat, _ = timed(run, pipe.device, reps)
    return parts['length'] / statistics.median(times), lat


def anchor(parts: dict, steps: int = STEPS) -> float:
    """max|Δ| between the full-CFG and the (0.3, 1.0)-interval runs at
    guidance scale 1 + 1e-9."""
    g1 = dataclasses.replace(parts['guide'], guidance_scale=1.0 + 1e-9)
    _, a = run_variant(parts, g1, None, steps, reps=1)
    _, b = run_variant(parts, g1, (0.3, 1.0), steps, reps=1)
    return float((a - b).abs().max())


def measure(unet, vae, deepcache: int = 0, with_anchor: bool = True,
            steps: int = STEPS, side: int = 64, reps: int = 4,
            guide=None, latents=None) -> dict:
    parts = build_parts(unet, vae, deepcache, 1, steps, side, guide,
                        latents)
    base_sps, base_lat = run_variant(parts, parts['guide'], None, steps,
                                     reps)
    int_sps, int_lat = run_variant(parts, parts['guide'], (0.0, 0.6), steps,
                                   reps)
    dtype = str(next(unet.parameters()).dtype).removeprefix('torch.')
    out = {
        'metric': (f'sd1.4 {side * 8}x{side * 8} CFG-interval(0,0.6) '
                   f'denoise steps/sec/card ({dtype}, PLMS, {steps}-step '
                   'loop)'),
        'deepcache': deepcache,
        'exact_steps_per_sec': base_sps,
        'interval_steps_per_sec': int_sps,
        'speedup': int_sps / base_sps,
        'finite': finite(int_lat),
        'latent_mse_vs_exact': mse(int_lat, base_lat),
    }
    if with_anchor:
        err = anchor(parts, steps)
        out.update(anchor_max_abs=err, anchor_ok=err < ANCHOR_BOUND)
    return out


def main() -> None:
    ap = parser(__doc__)
    ap.add_argument('--deepcache', type=int, default=0)
    ap.add_argument('--json', action='store_true',
                    help='skip the scale-1 anchor, as the JAX script')
    ap.add_argument('--dtype', default='bf16', choices=('bf16', 'fp32'),
                    help="the models' dtype on the card; fp32 also turns "
                    'TF32 off')
    args = ap.parse_args()
    device = resolve_device(args.device)
    dtype = BF16 if args.dtype == 'bf16' else torch.float32
    if dtype == torch.float32:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    unet, vae = models(device, dtype)
    kw = {} if device.type == 'cuda' else dict(steps=4, side=8, reps=1)
    res = measure(unet, vae, args.deepcache, not args.json, **kw)
    emit(dict(res, matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
              cudnn_allow_tf32=torch.backends.cudnn.allow_tf32), device)


if __name__ == '__main__':
    main()
