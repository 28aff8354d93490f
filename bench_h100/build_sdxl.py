"""SDXL's four parts for the benchmark, as ``build.py`` makes SD's three:
the port's CLIP ViT-L/14 text tower (``text``), OpenCLIP bigG text tower
(``text2``), UNet and VAE at a configuration file's sizes, built on the
meta device and loaded with the seeded weights in the served dtype; the
same weights in fp32 for the reference (``reference/sdxl.py``), whose text
towers read them under their diffusers folder's prefix; the second
tokenizer's ids.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from bench_h100 import build, seeded
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import sdxl as ref_sdxl
from bench_h100.reference import vae as ref_vae

PARTS = ('text', 'text2', 'unet', 'vae')
# The second tokenizer pads with '!' (id 0) after the EOS.
PAD_ID_2 = 0


def factories(config: dict) -> Dict[str, Callable]:
    from flexdiffuse_tpu_torch.models.clip import CLIPTextModel
    from flexdiffuse_tpu_torch.models.configs import (CLIPTextConfig,
                                                      UNetConfig, VAEConfig)
    from flexdiffuse_tpu_torch.models.unet import UNet2DCondition
    from flexdiffuse_tpu_torch.models.vae import AutoencoderKL
    text = build.port_config(CLIPTextConfig, config['text'])
    text2 = build.port_config(CLIPTextConfig, config['text2'])
    unet = build.port_config(UNetConfig, config['unet'])
    vae = build.port_config(VAEConfig, config['vae'])
    return {'text': lambda: CLIPTextModel(text),
            'text2': lambda: CLIPTextModel(text2),
            'unet': lambda: UNet2DCondition(unet),
            'vae': lambda: AutoencoderKL(vae)}


def reference_spec(config: dict, part: str) -> Dict[str, Tuple[int, ...]]:
    """The (name, shape) pairs the reference reads for ``part`` under the
    port's names, from a dry run on the meta device."""
    rec = ref_ops.Recorder()
    ops = ref_ops.Ops(rec)
    meta = torch.device('meta')
    if part in ref_sdxl.TEXT_PREFIX:
        prefix = ref_sdxl.TEXT_PREFIX[part]
        ref_sdxl.tower(ops, config[part], prefix,
                       torch.zeros((1, 77), dtype=torch.long, device=meta),
                       pool=part == 'text2')
        return {k[len(prefix):]: v for k, v in rec.shapes.items()}
    if part == 'unet':
        u = config['unet']
        ref_sdxl.unet_forward(
            ops, u, torch.empty((1, 16, 16, u['in_channels']), device=meta),
            torch.zeros((1,), device=meta),
            torch.empty((1, 77, u['cross_attention_dim']), device=meta),
            torch.empty((1, u['addition_pooled_dim']), device=meta),
            torch.zeros((1, u['num_time_ids']), device=meta))
    else:
        v = config['vae']
        ref_vae.decode(ops, v, torch.empty((1, 4, 4, v['latent_channels']),
                                           device=meta))
    return rec.shapes


def build_part(config: dict, part: str, seed: int,
               device) -> torch.nn.Module:
    """The port's ``part`` with seeded weights in the configuration's
    dtype, frozen, in eval mode."""
    factory = factories(config)[part]
    spec = build.port_spec(factory)
    build.check_spec(spec, reference_spec(config, part), part)
    weights = seeded.make_weights(spec, seed, part, device,
                                  build.DTYPES[config['dtype']])
    with torch.device('meta'):
        module = factory()
    module.load_state_dict(weights, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def reference_ops(config: dict, seed: int, device,
                  precision: str = 'fp32') -> ref_ops.Ops:
    """The reference's weights for every part: drawn as
    :func:`build_part` draws them, rounded to the served dtype, held in
    fp32; the text towers' under their prefix."""
    weights: Dict[str, torch.Tensor] = {}
    for part in PARTS:
        spec = build.port_spec(factories(config)[part])
        w = seeded.make_weights(spec, seed, part, device,
                                build.DTYPES[config['dtype']])
        prefix = ref_sdxl.TEXT_PREFIX.get(part, '')
        weights.update({prefix + k: v.float() for k, v in w.items()})
        del w
    return ref_ops.Ops(ref_ops.Weights(weights), precision)


def token_ids_2(prompt: str, vocab_size: int) -> List[int]:
    """The second tokenizer's 77 ids: :func:`seeded.token_ids` with the
    padding after the EOS made :data:`PAD_ID_2`."""
    ids = seeded.token_ids(prompt, vocab_size)
    end = ids.index(vocab_size - 1) + 1
    return ids[:end] + [PAD_ID_2] * (len(ids) - end)
