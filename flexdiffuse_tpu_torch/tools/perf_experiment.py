"""UNet chains on the card: the baseline and the conv-only UNet.

Port of ``tools/perf_experiment.py``. :func:`scan_time` is the 12-deep
chain of UNet evaluations that every UNet A/B of the tools runs: each
evaluation is fed ``0.1·tanh`` of the previous one's output, t = 500, every
parameter filled with 1e-3, under ``torch.no_grad()``, timed by CUDA events
(best of 3 after a warm-up). It also reports the kernel launches per
evaluation, so an A/B shows which kernel served the attention.

Not carried over: the JAX script's "GN bf16" variant. The port's UNet has
no ``norm_dtype``, and its GroupNorm kernel (K6) keeps fp32 statistics
whatever the activations' dtype. Nor its conv-MFU line, which divided a
FLOP estimate by the TPU's peak.

    python -m flexdiffuse_tpu_torch.tools.perf_experiment [--device cpu]

On the CPU (``--device cpu``) the chains run on the tiny UNet, two deep and
untimed, as a check that the path runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from flexdiffuse_tpu_torch.models import SD14_UNET, UNet2DCondition
from flexdiffuse_tpu_torch.models.configs import TINY_UNET, UNetConfig
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.tools import (BF16, chain_ms, generator, parser,
                                         randn, resolve_device)

STEPS = 12
CPU_STEPS = 2


# The kernels a UNet evaluation or a train step can launch, by id; each
# counts its launches in ``.launches``. K1 and K3–K5 also count them by path
# (``.path_launches``: 'sm90', the Hopper path, and 'mma', the kept one).
KERNELS = {'k1': fa.flash_attention, 'k3': fb.flash_attention_lse,
           'k4': fb.flash_attention_dq, 'k5': fb.flash_attention_dkv,
           'k6': gn.fused_group_norm}
BY_PATH = ('k1', 'k3', 'k4', 'k5', 'k6')


def kernel_counts() -> dict:
    """Launches so far of K1, K3–K5 and K6, by id, and by path
    (``k1_sm90``, ``k1_mma``, ``k3_sm90``, ..., ``k5_mma``, ``k6_resident``,
    ``k6_stream``)."""
    counts = {name: fn.launches for name, fn in KERNELS.items()}
    for name in BY_PATH:
        for path, n in KERNELS[name].path_launches.items():
            counts[f'{name}_{path}'] = n
    return counts


def reset_counts() -> None:
    """Every kernel's launch count to 0, T1–T6's too."""
    for fn in KERNELS.values():
        fn.launches = 0
    for name in BY_PATH:
        KERNELS[name].path_launches = dict.fromkeys(
            KERNELS[name].path_launches, 0)
    fv.reset_counts()


def build_unet(config: UNetConfig, device: torch.device,
               dtype: torch.dtype = BF16) -> UNet2DCondition:
    with torch.device(device):
        unet = UNet2DCondition(config)
    return unet.to(dtype).eval().requires_grad_(False)


def unet_chain(unet: UNet2DCondition, lat: torch.Tensor, ctx: torch.Tensor,
               label: str, depth: int = STEPS) -> dict:
    """The chain ``l ← unet(0.1·tanh(l), 500, ctx)``, ``depth`` deep. On the
    card: ms per evaluation and launches per evaluation; on the CPU: one
    untimed chain. Raises on a non-finite output."""
    t = torch.full((lat.shape[0],), 500.0, device=lat.device)

    def step(l):
        return unet(0.1 * torch.tanh(l), t, ctx)

    res = dict(label=label, ms=None, per_eval=None)
    with torch.no_grad():
        if lat.device.type == 'cuda':
            before = {**kernel_counts(), **fv.launch_counts()}
            res['ms'], out = chain_ms(step, lat, depth)
            evals = 4 * depth    # the warm-up and three timed chains
            after = {**kernel_counts(), **fv.launch_counts()}
            res['per_eval'] = {k: (n - before[k]) / evals
                               for k, n in after.items() if n != before[k]}
        else:
            out = lat
            for _ in range(depth):
                out = step(out)
    if not torch.isfinite(out).all():
        raise AssertionError(f'{label}: non-finite UNet output')
    res['out'] = out
    ms = f'{res["ms"]:7.2f} ms/forward' if res['ms'] else 'untimed (CPU)'
    print(f'{label:44s}: {ms}  launches/eval {res["per_eval"]}', flush=True)
    return res


def scan_time(make_model: Callable[[], UNet2DCondition], label: str,
              batch: int = 2, hw: int = 64, *,
              generator: torch.Generator) -> dict:
    """Build the model, fill every parameter with 1e-3, and run
    :func:`unet_chain` on latents (·0.1) and context drawn from a copy of
    ``generator``'s state, so that every call with one generator (an A/B)
    sees the same inputs."""
    unet = make_model()
    with torch.no_grad():
        for p in unet.parameters():
            p.fill_(1e-3)
    lat, ctx = chain_inputs(unet, batch, hw, generator)
    depth = CPU_STEPS if generator.device.type == 'cpu' else STEPS
    return unet_chain(unet, lat, ctx, label, depth)


def chain_inputs(unet: UNet2DCondition, batch: int, hw: int,
                 generator: torch.Generator):
    """Latents ·0.1 ``[batch, hw, hw, C]`` and context ``[batch, 77, D]``,
    fp32, from a copy of ``generator``'s state."""
    gen = torch.Generator(generator.device)
    gen.set_state(generator.get_state())
    lat = randn((batch, hw, hw, unet.config.in_channels), gen,
                torch.float32, 0.1)
    ctx = randn((batch, 77, unet.config.cross_attention_dim), gen,
                torch.float32)
    return lat, ctx


def unet_maker(device: torch.device, config: UNetConfig = SD14_UNET):
    """The UNet of ``config`` (SD-1.4's by default) in bf16 on ``device``."""
    return lambda: build_unet(config, device)


def run(generator: torch.Generator, device: Optional[str] = None) -> dict:
    dev = resolve_device(device)
    cpu = dev.type == 'cpu'
    hw = 8 if cpu else 64
    config = TINY_UNET if cpu else SD14_UNET
    base = scan_time(unet_maker(dev, config), 'baseline bf16 (GN fp32)',
                     hw=hw, generator=generator)
    noattn = dataclasses.replace(config,
                                 attention_levels=(False,) *
                                 len(config.attention_levels))
    conv = scan_time(unet_maker(dev, noattn),
                     'conv-only (transformers removed)', hw=hw,
                     generator=generator)
    if base['ms']:
        share = base['ms'] - conv['ms']
        print(f'transformer share: {share:.2f} ms '
              f'({100 * share / base["ms"]:.0f}%)')
    return dict(base=base, conv=conv)


def main(argv=None) -> None:
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    run(generator(dev), args.device)


if __name__ == '__main__':
    main()
