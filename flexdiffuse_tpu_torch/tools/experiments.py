"""The reference README's seeded experiment protocol against real weights.

    python -m flexdiffuse_tpu_torch.tools.experiments --models ./models \\
        --prompt "Deer colorful, fantasy, intricate, highly detailed, ..." \\
        [--guide guide.png] [--init init.png] [--out outputs/experiments]

Runs the protocol the reference validates with (seed 1337, strength 0.6,
30 steps, 4 samples, CFG 8, 512², threshold 0.25/0.75, clustered 0.25,
linear 0.0–0.5, max guidance 0.35, header 0.0, best-fit mapping with
reuse; ``validate_reference.PROTOCOL``) through ``Runner(model_root=...)``
on ``--device`` (the card by default; bf16 there, fp32 on the CPU) and
writes the images and their grid under ``--out``, for a side-by-side look
at the reference's ``experiments/`` images (a distributional comparison:
the noise streams differ by construction).
``--steps``, ``--samples`` and ``--size`` override the protocol's.
"""
from __future__ import annotations

import argparse

from flexdiffuse_tpu_torch.tools.validate_reference import PROTOCOL, geometry


def main(argv=None) -> int:
    from PIL import Image

    from flexdiffuse_tpu_torch.cli import model_dtype
    from flexdiffuse_tpu_torch.config import RunConfig
    from flexdiffuse_tpu_torch.runner import Runner
    from flexdiffuse_tpu_torch.tools import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--models', default='./models')
    ap.add_argument('--prompt', required=True)
    ap.add_argument('--guide', default='')
    ap.add_argument('--init', default='')
    ap.add_argument('--out', default='outputs/experiments')
    ap.add_argument('--steps', type=int, default=0)
    ap.add_argument('--samples', type=int, default=0)
    ap.add_argument('--size', type=int, default=0,
                    help="override the protocol's 512²")
    ap.add_argument('--device', default='cuda')
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    protocol = dict(PROTOCOL)
    if args.steps:
        protocol['steps'] = args.steps
    if args.samples:
        protocol['samples'] = args.samples
    if args.size:
        protocol['init_size'] = (args.size, args.size)
    runner = Runner(model_root=args.models,
                    config=RunConfig(output_dir=args.out), device=device,
                    dtype=model_dtype(device), **geometry())
    imgs, grid = runner.gen(
        prompt=args.prompt,
        guide=Image.open(args.guide) if args.guide else None,
        init_image=Image.open(args.init) if args.init else None,
        **protocol)
    print(f'{len(imgs)} images + grid written to {args.out}')
    print('phase timing:', runner.timer.summary())
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
