"""The program under test, built from a configuration file: the port's
text tower, UNet and VAE at the file's sizes, on the meta device first,
then loaded with the benchmark's seeded weights (``seeded.make_weights``,
keyed by the port's ``state_dict`` names and shapes) in the served dtype.
The same names and shapes give the reference its weights in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from bench_h100 import seeded
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import text as ref_text
from bench_h100.reference import unet as ref_unet
from bench_h100.reference import vae as ref_vae

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
PARTS = ('text', 'unet', 'vae')


def port_config(cls, group: dict):
    """The port's config dataclass ``cls`` from a configuration file's
    group (keys the dataclass lacks are the reference's alone)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in group.items() if k in fields})


def vae_factor(config: dict) -> int:
    """Pixels per latent along a side: 2 per VAE level after the
    first."""
    return 2 ** (len(config['vae']['block_channels']) - 1)


def factories(config: dict) -> Dict[str, Callable]:
    from flexdiffuse_tpu_torch.models.clip import CLIPTextModel
    from flexdiffuse_tpu_torch.models.configs import (CLIPTextConfig,
                                                      UNetConfig, VAEConfig)
    from flexdiffuse_tpu_torch.models.unet import UNet2DCondition
    from flexdiffuse_tpu_torch.models.vae import AutoencoderKL
    text = port_config(CLIPTextConfig, config['text'])
    unet = port_config(UNetConfig, config['unet'])
    vae = port_config(VAEConfig, config['vae'])
    return {'text': lambda: CLIPTextModel(text),
            'unet': lambda: UNet2DCondition(unet),
            'vae': lambda: AutoencoderKL(vae)}


def port_spec(factory: Callable) -> Dict[str, Tuple[int, ...]]:
    with torch.device('meta'):
        module = factory()
    return {k: tuple(v.shape) for k, v in module.state_dict().items()}


def reference_spec(config: dict, part: str) -> Dict[str, Tuple[int, ...]]:
    """The (name, shape) pairs the reference reads for ``part``, from a
    dry run on the meta device."""
    rec = ref_ops.Recorder()
    ops = ref_ops.Ops(rec)
    meta = torch.device('meta')
    if part == 'text':
        ref_text.encode(ops, config['text'],
                        torch.zeros((1, 77), dtype=torch.long, device=meta))
    elif part == 'unet':
        u = config['unet']
        ref_unet.forward(
            ops, u, torch.empty((1, 16, 16, u['in_channels']), device=meta),
            torch.zeros((1,), device=meta),
            torch.empty((1, 77, u['cross_attention_dim']), device=meta))
    else:
        v = config['vae']
        ref_vae.decode(ops, v, torch.empty((1, 4, 4, v['latent_channels']),
                                           device=meta))
    return rec.shapes


def check_spec(port: Dict[str, tuple], ref: Dict[str, tuple],
               part: str) -> None:
    """Every weight the reference reads exists in the port with the same
    shape (the port may hold more: the VAE's encoder)."""
    bad = {n: (s, port.get(n)) for n, s in ref.items() if port.get(n) != s}
    if bad:
        raise ValueError(f'{part}: reference and port disagree on '
                         f'{len(bad)} weights, e.g. {list(bad.items())[:3]}')


def build_part(config: dict, part: str, seed: int, device,
               factory: Callable = None) -> torch.nn.Module:
    """The port's ``part`` with seeded weights in the configuration's
    dtype, frozen, in eval mode."""
    factory = factory or factories(config)[part]
    spec = port_spec(factory)
    check_spec(spec, reference_spec(config, part), part)
    weights = seeded.make_weights(spec, seed, part, device,
                                  DTYPES[config['dtype']])
    with torch.device('meta'):
        module = factory()
    module.load_state_dict(weights, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def reference_weights(config: dict, part: str, seed: int,
                      device) -> Dict[str, torch.Tensor]:
    """The same weights for the reference: drawn alike, rounded to the
    served dtype, held in fp32."""
    spec = port_spec(factories(config)[part])
    w = seeded.make_weights(spec, seed, part, device,
                            DTYPES[config['dtype']])
    return {k: v.float() for k, v in w.items()}
