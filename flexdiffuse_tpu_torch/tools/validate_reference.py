"""The real-weight parity harness: the first command to run once SD-1.4 and
CLIP ViT-L/14 checkpoints are at hand.

    python -m flexdiffuse_tpu_torch.tools.validate_reference \\
        --models /path/to/snapshots --experiments /path/to/experiments
    python -m flexdiffuse_tpu_torch.tools.validate_reference --tiny \\
        --device cpu

Runs the five configs of the repository's ``BASELINE.json`` with the
reference's seeded experiment protocol (seed 1337, strength 0.6, 30 PNDM
steps, 4 samples, CFG 8, 512², threshold 0.25 / floor 0.75, clustered
0.25, linear 0.0–0.5, max guidance 0.35, header 0.0, best-fit mapping
with reuse; the reference README's protocol section) through the port's
``Runner`` on ``--device`` (the card by default) in ``--dtype``, and
writes per config a grid named after the reference's checked-in golden
(``deer_base.png`` and so on) and one ``parity_report.json`` with the
wall seconds, the image count and the phase timings. Guide and init
images are read from ``--experiments`` (the reference's ``experiments/``
assets: ``deer_mod.webp``, ``zeus_mod.webp``, ``turtle_mod.webp``,
``deer_img2img_base.png``); a config whose asset is missing is skipped
and says so in the report.

The numerics gate (``BASELINE.json``: final latents within 1e-2 MSE):
``t2i_base`` at one sample runs again, its final latents taken before the
decode, and once more through a second ``Runner`` of the same weights on
the CPU in fp32 (the plain path); the report gives the MSE, the MSE
relative to the CPU latents' mean square, max|Δ| and the gate. Both runs
draw their noise from one CPU generator seeded with the protocol's seed,
so they start from the same latents (a CUDA and a CPU generator draw
different numbers). ``--gate-steps`` shortens that pair of runs (the CPU
fp32 run of SD-1.4 takes seconds per step). Pixel-identical goldens are
not expected: the reference draws torch noise on its own device, the
harness on the CPU.

The exactness switches are forced off before anything runs (DeepCache,
ToMe, PAG, FreeU): their drift would read as a parity failure.

``--tiny`` runs the whole harness with the port's tiny models (seeded
random weights, 64², 2 steps, 1 sample, synthetic guide and init images):
the plumbing of every config, no checkpoint needed.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
from PIL import Image

DEER_PROMPT = ('Deer colorful, fantasy, intricate, highly detailed, digital '
               'painting, hq, trending on artstation, illustration, '
               'lovecraftian dark ominous eldritch')
TURTLE_PROMPT = 'a photo of a turtle, hd 8k, dlsr photo'
CITY_PROMPT = 'an urban landscape, city, dslr photo'
FOREST_GUIDE = 'a painting of the deep woods, forest'

# The reference protocol's defaults.
PROTOCOL = dict(strength=0.6, steps=30, samples=4, guidance_scale=8.0,
                init_size=(512, 512), guide_threshold_mult=0.25,
                guide_threshold_floor=0.75, guide_clustered=0.25,
                guide_linear=(0.0, 0.5), guide_max_guidance=0.35,
                guide_header_max=0.0, guide_mode=1, guide_reuse=True,
                seed=1337)

# The assets the configs read from --experiments.
ASSETS = ('turtle_mod.webp', 'deer_mod.webp', 'deer_img2img_base.png')
DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
TINY_SEED = 0


def _configs(exp_dir: str):
    """The five BASELINE.json configs as runs: (name, reference golden
    file name, gen keywords, what the config needs)."""
    def img(name):
        path = os.path.join(exp_dir, name)
        return Image.open(path) if os.path.exists(path) else None

    return [
        # 1. txt2img, no guidance: the numerics config.
        ('t2i_base', 'deer_base.png',
         dict(prompt=DEER_PROMPT, guide=None), 'numerics'),
        # 2. linear trailing-embed style guidance (the turtle experiment).
        ('linear_style', 'turtle_modded_defaults.png',
         dict(prompt=TURTLE_PROMPT, guide=img('turtle_mod.webp'),
              guide_threshold_mult=0.0, guide_clustered=0.0), 'guide'),
        # 3. clustered + threshold with full similarity mapping (the
        #    protocol's defaults; the deer modifier).
        ('clustered_threshold', 'deer_modded_defaults.png',
         dict(prompt=DEER_PROMPT, guide=img('deer_mod.webp'),
              guide_threshold_floor=0.2), 'guide'),
        # 4. img2img latent init + image guidance (the deer img2img path).
        ('img2img_guided', 'deer_img2img_defaults.png',
         dict(prompt=DEER_PROMPT, guide=img('deer_mod.webp'),
              init_image=img('deer_img2img_base.png'),
              guide_threshold_floor=0.2), 'img2img'),
        # text2text tween (city/forest: the README's text2text tweening).
        ('text2text', 'city_photo_forest_blend.png',
         dict(prompt=CITY_PROMPT, guide=FOREST_GUIDE), None),
    ]


def tiny_models():
    """The port's tiny text and vision towers, UNet and VAE with weights
    from ``torch.manual_seed(TINY_SEED)``, fp32 on the CPU: the same on
    every call."""
    from flexdiffuse_tpu_torch import models as tm
    torch.manual_seed(TINY_SEED)
    return tuple(cls(cfg).eval().requires_grad_(False) for cls, cfg in (
        (tm.CLIPTextModel, tm.TINY_TEXT), (tm.CLIPVisionModel,
                                           tm.TINY_VISION),
        (tm.UNet2DCondition, tm.TINY_UNET), (tm.AutoencoderKL, tm.TINY_VAE)))


def build_runner(args, device=None, dtype=None):
    """The harness's Runner: ``args.device`` and ``args.dtype`` unless
    given; tiny models (:func:`tiny_models`) with ``args.tiny``, else the
    snapshots under ``args.models``; the exactness switches off."""
    from flexdiffuse_tpu_torch.config import RunConfig
    from flexdiffuse_tpu_torch.runner import Runner
    device = torch.device(device or args.device)
    dtype = dtype or args.dtype
    config = RunConfig(output_dir=args.out)
    if args.tiny:
        from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
        mods = [m.to(device, dtype) for m in tiny_models()]
        return Runner.from_models(*mods, FakeTokenizer(), config=config,
                                  scheduler=args.scheduler)
    return ensure_exact(Runner(model_root=args.models, config=config,
                               scheduler=args.scheduler, dtype=dtype,
                               device=device, **geometry()))


def geometry() -> dict:
    """The model configs a snapshot is read into: the CLI's
    (``cli.MODEL_CONFIGS``: SD-1.4 and CLIP ViT-L/14)."""
    from flexdiffuse_tpu_torch import cli
    c = cli.MODEL_CONFIGS
    return dict(text_config=c['text'], vision_config=c['vision'],
                unet_config=c['unet'], vae_config=c['vae'])


def ensure_exact(runner):
    """Parity runs take the exact path: every approximation (DeepCache,
    ToMe, PAG layers, FreeU) is forced off, whatever was set before."""
    if runner.pipe.deepcache:
        runner.disable_deepcache()
    if runner.pipe.unet.tome is not None:
        runner.disable_tome()
    if runner.pipe.unet.pag_layers is not None:
        runner.disable_pag()
    if runner.pipe.unet.freeu is not None:
        runner.disable_freeu()
    return runner


def cpu_noise(seed: int) -> Callable:
    """Unit normal draws ``[shape] -> CPU fp32`` from a CPU generator
    seeded with ``seed``: the same numbers whatever device runs."""
    gen = torch.Generator().manual_seed(int(seed))
    return lambda shape: torch.randn(tuple(shape), generator=gen)


@contextlib.contextmanager
def _noise_from(pipe, draw: Optional[Callable]):
    """The pipeline's unit-noise draws from ``draw`` (moved to its device)
    for the block; its own generator when ``draw`` is None."""
    if draw is None:
        yield
        return
    pipe._randn = lambda shape, generator: draw(shape).to(pipe.device)
    try:
        yield
    finally:
        del pipe._randn


def final_latents(runner, kwargs: dict,
                  draw: Optional[Callable] = None) -> np.ndarray:
    """Run one config and return its final latents (taken before the
    decode) as fp32 numpy; ``draw`` supplies the noise
    (:func:`cpu_noise`)."""
    captured = {}
    pipe = runner.pipe
    orig = pipe.decode_u8_device

    def spy(latents):
        captured['lat'] = latents.float().cpu().numpy()
        return orig(latents)

    pipe.decode_u8_device = spy
    try:
        with _noise_from(pipe, draw):
            runner.gen(**kwargs, save=False)
    finally:
        del pipe.decode_u8_device
    return captured['lat']


def numerics_gate(runner, args, kwargs: dict, report: dict) -> float:
    """``BASELINE.json``'s gate: ``kwargs``' final latents from ``runner``
    (``--device``, ``--dtype``) against a CPU fp32 Runner of the same
    weights, both on the protocol seed's CPU noise; writes the MSE,
    relative MSE, max|Δ| and the gate into ``report``."""
    got = final_latents(runner, kwargs, cpu_noise(kwargs['seed']))
    cpu = build_runner(args, 'cpu', torch.float32)
    want = final_latents(cpu, kwargs, cpu_noise(kwargs['seed']))
    diff = got.astype(np.float64) - want
    mse = float(np.mean(diff**2))
    report['latent_mse_vs_cpu_fp32'] = mse
    report['latent_rel_mse'] = mse / float(np.mean(want.astype(
        np.float64)**2))
    report['latent_max_abs'] = float(np.abs(diff).max())
    report['latent_mse_gate_1e-2'] = bool(mse <= 1e-2)
    return mse


def _tiny_assets(run_kw: dict, needs: Optional[str], size: int) -> None:
    """Synthetic stand-ins for the assets at the tiny geometry: a PIL guide
    image, and an init image as a preprocessed ``[1, H, W, 3]`` array in
    [-1, 1] (a PIL image would be resized to 512 by ``preprocess``)."""
    rng = np.random.default_rng(0)
    if needs == 'img2img':
        run_kw['init_image'] = rng.uniform(-1, 1, (1, size, size, 3)).astype(
            np.float32)
    if needs in ('guide', 'img2img'):
        run_kw['guide'] = Image.fromarray(rng.integers(
            0, 256, (size, size, 3), dtype=np.uint8))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--models', default='./models',
                    help='directory with the SD-1.4 and CLIP ViT-L/14 HF '
                    'snapshots')
    ap.add_argument('--out', default='outputs/validate')
    ap.add_argument('--experiments', default='experiments',
                    help="the reference's experiments/ directory (guide "
                    'and init assets)')
    ap.add_argument('--scheduler', default='pndm')
    ap.add_argument('--configs', default='',
                    help='comma-separated subset of config names')
    ap.add_argument('--tiny', action='store_true',
                    help='dry-run with tiny random models (no checkpoint)')
    ap.add_argument('--steps', type=int, default=0,
                    help='override the protocol steps (tiny: 2)')
    ap.add_argument('--samples', type=int, default=0)
    ap.add_argument('--size', type=int, default=0,
                    help='override the protocol\'s 512² (tiny: 64)')
    ap.add_argument('--gate-steps', type=int, default=0,
                    help="the numerics gate's steps (0: the protocol's)")
    ap.add_argument('--device', default='cuda',
                    help="'cuda' (the card) or 'cpu'")
    ap.add_argument('--dtype', default=None, choices=sorted(DTYPES),
                    help='the run on --device (default: bfloat16 on the '
                    'card, float32 on the CPU)')
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    from flexdiffuse_tpu_torch.cli import model_dtype
    from flexdiffuse_tpu_torch.tools import resolve_device
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    args.device = str(device)
    args.dtype = DTYPES[args.dtype] if args.dtype else model_dtype(device)
    return args


def run(args, runner) -> dict:
    """Every selected config through ``runner``: the grids and
    ``parity_report.json`` under ``args.out``; returns the report."""
    os.makedirs(args.out, exist_ok=True)
    protocol = dict(PROTOCOL)
    if args.tiny:
        protocol.update(steps=2, samples=1, init_size=(64, 64))
    if args.steps:
        protocol['steps'] = args.steps
    if args.samples:
        protocol['samples'] = args.samples
    if args.size:
        protocol['init_size'] = (args.size, args.size)
    only = {c for c in args.configs.split(',') if c}
    report = {'protocol': {k: str(v) for k, v in protocol.items()},
              'tiny': args.tiny, 'device': args.device,
              'dtype': str(args.dtype).replace('torch.', ''), 'configs': {}}
    for name, golden, kw, needs in _configs(args.experiments):
        if only and name not in only:
            continue
        cfg_report = {'reference_golden': golden}
        report['configs'][name] = cfg_report
        run_kw = {**protocol, **kw}
        if args.tiny:
            _tiny_assets(run_kw, needs, protocol['init_size'][0])
        elif needs in ('guide', 'img2img') and (
                run_kw['guide'] is None or
                (needs == 'img2img' and run_kw['init_image'] is None)):
            cfg_report['skipped'] = f'missing asset under {args.experiments}'
            continue
        t0 = time.perf_counter()
        imgs, grid = runner.gen(**run_kw, save=False)
        cfg_report['wall_s'] = round(time.perf_counter() - t0, 3)
        cfg_report['images'] = len(imgs)
        grid.save(os.path.join(args.out, golden))
        print(f'[{name}] -> {golden} ({cfg_report["wall_s"]} s, '
              f'{len(imgs)} images)', flush=True)
        if name == 't2i_base':
            single = {**run_kw, 'samples': 1}
            if args.gate_steps:
                single['steps'] = args.gate_steps
            numerics_gate(runner, args, single, cfg_report)
            print(f'[{name}] final latents on {args.device} '
                  f'{report["dtype"]} vs CPU fp32 at {single["steps"]} '
                  f'steps: MSE {cfg_report["latent_mse_vs_cpu_fp32"]:.3e} '
                  f'(gate 1e-2), relative '
                  f'{cfg_report["latent_rel_mse"]:.3e}, max|Δ| '
                  f'{cfg_report["latent_max_abs"]:.3e}', flush=True)
    report['phase_summary'] = runner.timer.summary()
    path = os.path.join(args.out, 'parity_report.json')
    with open(path, 'w') as f:
        json.dump(report, f, indent=2)
    print(f'report: {path}')
    return report


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args, build_runner(args))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
