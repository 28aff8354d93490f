"""JAX param tree → the port's ``state_dict`` (the inverse of
``flexdiffuse_tpu/weights/convert.py``).

``convert.py`` turns diffusers/HF checkpoints into the JAX package's Flax
trees; the port's modules carry those same diffusers/HF names, so this
module undoes each rule:

* Dense kernel ``[in, out]``        → Linear ``weight [out, in]``
* Conv kernel HWIO ``[kh, kw, i, o]`` → Conv2d ``weight`` OIHW
* norm ``scale``                     → ``weight``
* our ``pre_layernorm``              → HF's ``pre_layrnorm``

The inverse of each converter sits in the function of the same name
(``convert_clip_text`` :77 ↔ :func:`clip_text` (with SDXL's
``text_projection``), ``convert_clip_vision`` :103
↔ :func:`clip_vision`, ``convert_unet`` :170 ↔ :func:`unet` (with an
IP-Adapter's ``to_k_ip``/``to_v_ip`` and SDXL's ``add_embed_1/2`` where
the tree has them),
``convert_vae`` :236 ↔ :func:`vae`, ``convert_controlnet`` :275 ↔
:func:`controlnet`); the IP-Adapter heads of
``flexdiffuse_tpu/models/ip_adapter.py`` (``ImageProjection``,
``Resampler``) ↔ :func:`image_projection`, :func:`resampler`. Trees are
nested dicts of numpy arrays (an outer ``{'params': ...}`` is accepted);
no JAX is imported.
:func:`lora_factors_to_torch` renames the JAX package's LoRA factors to the
port's module names, so both packages train from the same factors.
"""
from __future__ import annotations

import re
from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

from flexdiffuse_tpu_torch.models.configs import (CLIPTextConfig,
                                                  CLIPVisionConfig,
                                                  UNetConfig, VAEConfig)

SD = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _dense(sd: SD, name: str, tree: Mapping) -> None:
    sd[f'{name}.weight'] = _t(np.asarray(tree['kernel']).T)
    if 'bias' in tree:
        sd[f'{name}.bias'] = _t(tree['bias'])


def _conv(sd: SD, name: str, tree: Mapping) -> None:
    sd[f'{name}.weight'] = _t(np.asarray(tree['kernel']).transpose(3, 2, 0,
                                                                   1))
    if 'bias' in tree:
        sd[f'{name}.bias'] = _t(tree['bias'])


def _norm(sd: SD, name: str, tree: Mapping) -> None:
    sd[f'{name}.weight'] = _t(tree['scale'])
    sd[f'{name}.bias'] = _t(tree['bias'])


def _clip_encoder(sd: SD, prefix: str, tree: Mapping,
                  num_layers: int) -> None:
    for i in range(num_layers):
        p = f'{prefix}.layers.{i}'
        layer = tree[f'layers_{i}']
        for k in ('q_proj', 'k_proj', 'v_proj', 'out_proj'):
            _dense(sd, f'{p}.self_attn.{k}', layer['self_attn'][k])
        _norm(sd, f'{p}.layer_norm1', layer['layer_norm1'])
        _norm(sd, f'{p}.layer_norm2', layer['layer_norm2'])
        _dense(sd, f'{p}.mlp.fc1', layer['mlp']['fc1'])
        _dense(sd, f'{p}.mlp.fc2', layer['mlp']['fc2'])


def clip_text(tree: Mapping, config: CLIPTextConfig) -> SD:
    sd: SD = {}
    p = 'text_model'
    sd[f'{p}.embeddings.token_embedding.weight'] = _t(
        tree['token_embedding']['embedding'])
    sd[f'{p}.embeddings.position_embedding.weight'] = _t(
        tree['position_embedding'])
    _clip_encoder(sd, f'{p}.encoder', tree['encoder'], config.num_layers)
    _norm(sd, f'{p}.final_layer_norm', tree['final_layer_norm'])
    if 'text_projection' in tree:
        _dense(sd, 'text_projection', tree['text_projection'])
    return sd


def clip_vision(tree: Mapping, config: CLIPVisionConfig) -> SD:
    sd: SD = {}
    p = 'vision_model'
    sd[f'{p}.embeddings.class_embedding'] = _t(tree['class_embedding'])
    _conv(sd, f'{p}.embeddings.patch_embedding', tree['patch_embedding'])
    sd[f'{p}.embeddings.position_embedding.weight'] = _t(
        tree['position_embedding'])
    _norm(sd, f'{p}.pre_layrnorm', tree['pre_layernorm'])  # HF's spelling
    _clip_encoder(sd, f'{p}.encoder', tree['encoder'], config.num_layers)
    _norm(sd, f'{p}.post_layernorm', tree['post_layernorm'])
    _dense(sd, 'visual_projection', tree['visual_projection'])
    return sd


def _resnet(sd: SD, p: str, tree: Mapping) -> None:
    _norm(sd, f'{p}.norm1', tree['norm1'])
    _conv(sd, f'{p}.conv1', tree['conv1'])
    _norm(sd, f'{p}.norm2', tree['norm2'])
    _conv(sd, f'{p}.conv2', tree['conv2'])
    if 'time_emb_proj' in tree:
        _dense(sd, f'{p}.time_emb_proj', tree['time_emb_proj'])
    if 'conv_shortcut' in tree:
        _conv(sd, f'{p}.conv_shortcut', tree['conv_shortcut'])


def _attn(sd: SD, p: str, tree: Mapping) -> None:
    for k in ('to_q', 'to_k', 'to_v', 'to_k_ip', 'to_v_ip'):
        if k in tree:
            _dense(sd, f'{p}.{k}', tree[k])
    _dense(sd, f'{p}.to_out.0', tree['to_out'])


def _transformer2d(sd: SD, p: str, tree: Mapping, depth: int) -> None:
    _norm(sd, f'{p}.norm', tree['norm'])
    _conv(sd, f'{p}.proj_in', tree['proj_in'])
    _conv(sd, f'{p}.proj_out', tree['proj_out'])
    for i in range(depth):
        b = f'{p}.transformer_blocks.{i}'
        blk = tree[f'blocks_{i}']
        _attn(sd, f'{b}.attn1', blk['attn1'])
        _attn(sd, f'{b}.attn2', blk['attn2'])
        for k in ('norm1', 'norm2', 'norm3'):
            _norm(sd, f'{b}.{k}', blk[k])
        _dense(sd, f'{b}.ff.net.0.proj', blk['ff']['proj_in'])
        _dense(sd, f'{b}.ff.net.2', blk['ff']['proj_out'])


def _down_mid(sd: SD, tree: Mapping, config: UNetConfig) -> None:
    """The time embedding (with SDXL's additional embedding where the
    tree has it), ``conv_in`` and the down and mid path, which the UNet and
    the ControlNet share."""
    _dense(sd, 'time_embedding.linear_1', tree['time_embed_1'])
    _dense(sd, 'time_embedding.linear_2', tree['time_embed_2'])
    if 'add_embed_1' in tree:
        _dense(sd, 'add_embedding.linear_1', tree['add_embed_1'])
        _dense(sd, 'add_embedding.linear_2', tree['add_embed_2'])
    _conv(sd, 'conv_in', tree['conv_in'])
    n = len(config.block_channels)
    for i in range(n):
        for j in range(config.layers_per_block):
            _resnet(sd, f'down_blocks.{i}.resnets.{j}',
                    tree[f'down_{i}_res_{j}'])
            if config.attention_levels[i]:
                _transformer2d(sd, f'down_blocks.{i}.attentions.{j}',
                               tree[f'down_{i}_attn_{j}'],
                               config.depth_at(i))
        if i != n - 1:
            _conv(sd, f'down_blocks.{i}.downsamplers.0.conv',
                  tree[f'down_{i}_downsample']['conv'])
    _resnet(sd, 'mid_block.resnets.0', tree['mid_res_0'])
    _resnet(sd, 'mid_block.resnets.1', tree['mid_res_1'])
    _transformer2d(sd, 'mid_block.attentions.0', tree['mid_attn'],
                   config.depth_mid())


def unet(tree: Mapping, config: UNetConfig) -> SD:
    sd: SD = {}
    _down_mid(sd, tree, config)
    if 'time_cond_proj' in tree:
        _dense(sd, 'time_embedding.cond_proj', tree['time_cond_proj'])
    _norm(sd, 'conv_norm_out', tree['norm_out'])
    _conv(sd, 'conv_out', tree['conv_out'])
    n = len(config.block_channels)
    for i in range(n):
        level = n - 1 - i
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f'up_blocks.{i}.resnets.{j}', tree[f'up_{i}_res_{j}'])
            if config.attention_levels[level]:
                _transformer2d(sd, f'up_blocks.{i}.attentions.{j}',
                               tree[f'up_{i}_attn_{j}'],
                               config.depth_at(level))
        if i != n - 1:
            _conv(sd, f'up_blocks.{i}.upsamplers.0.conv',
                  tree[f'up_{i}_upsample']['conv'])
    return sd


def controlnet(tree: Mapping, config: UNetConfig) -> SD:
    """``ControlNetModel``'s tree → the port's ``ControlNetModel``
    (diffusers' names: ``controlnet_cond_embedding``,
    ``controlnet_down_blocks.{k}``, ``controlnet_mid_block``)."""
    sd: SD = {}
    _down_mid(sd, tree, config)
    ce = tree['cond_embed']
    _conv(sd, 'controlnet_cond_embedding.conv_in', ce['conv_in'])
    _conv(sd, 'controlnet_cond_embedding.conv_out', ce['conv_out'])
    i = 0
    while f'block_{i}' in ce:
        _conv(sd, f'controlnet_cond_embedding.blocks.{i}', ce[f'block_{i}'])
        i += 1
    k = 0
    while f'zero_conv_{k}' in tree:
        _conv(sd, f'controlnet_down_blocks.{k}', tree[f'zero_conv_{k}'])
        k += 1
    _conv(sd, 'controlnet_mid_block', tree['zero_conv_mid'])
    return sd


def image_projection(tree: Mapping) -> SD:
    """The base IP-Adapter head (``ImageProjection``)."""
    sd: SD = {}
    _dense(sd, 'proj', tree['proj'])
    _norm(sd, 'norm', tree['norm'])
    return sd


def resampler(tree: Mapping) -> SD:
    """IP-Adapter Plus's perceiver ``Resampler``: ``layers_{i}_attn`` →
    ``layers.{i}.0``, ``layers_{i}_ff_norm``/``_ff_1``/``_ff_2`` →
    ``layers.{i}.1.{0,1,3}`` (the official checkpoints' names)."""
    sd: SD = {'latents': _t(tree['latents'])}
    for name in ('proj_in', 'proj_out'):
        _dense(sd, name, tree[name])
    _norm(sd, 'norm_out', tree['norm_out'])
    i = 0
    while f'layers_{i}_attn' in tree:
        a = tree[f'layers_{i}_attn']
        _norm(sd, f'layers.{i}.0.norm1', a['norm1'])
        _norm(sd, f'layers.{i}.0.norm2', a['norm2'])
        for name in ('to_q', 'to_kv', 'to_out'):
            _dense(sd, f'layers.{i}.0.{name}', a[name])
        _norm(sd, f'layers.{i}.1.0', tree[f'layers_{i}_ff_norm'])
        _dense(sd, f'layers.{i}.1.1', tree[f'layers_{i}_ff_1'])
        _dense(sd, f'layers.{i}.1.3', tree[f'layers_{i}_ff_2'])
        i += 1
    return sd


def _vae_attn(sd: SD, p: str, tree: Mapping) -> None:
    for k in ('to_q', 'to_k', 'to_v'):
        _dense(sd, f'{p}.{k}', tree[k])
    _dense(sd, f'{p}.to_out.0', tree['to_out'])
    _norm(sd, f'{p}.group_norm', tree['group_norm'])


def vae(tree: Mapping, config: VAEConfig) -> SD:
    sd: SD = {}
    n = len(config.block_channels)
    enc, dec = tree['encoder'], tree['decoder']
    _conv(sd, 'encoder.conv_in', enc['conv_in'])
    _norm(sd, 'encoder.conv_norm_out', enc['norm_out'])
    _conv(sd, 'encoder.conv_out', enc['conv_out'])
    for i in range(n):
        for j in range(config.layers_per_block):
            _resnet(sd, f'encoder.down_blocks.{i}.resnets.{j}',
                    enc[f'down_{i}_res_{j}'])
        if i != n - 1:
            _conv(sd, f'encoder.down_blocks.{i}.downsamplers.0.conv',
                  enc[f'down_{i}_downsample'])
    _resnet(sd, 'encoder.mid_block.resnets.0', enc['mid_res_0'])
    _resnet(sd, 'encoder.mid_block.resnets.1', enc['mid_res_1'])
    _vae_attn(sd, 'encoder.mid_block.attentions.0', enc['mid_attn'])

    _conv(sd, 'decoder.conv_in', dec['conv_in'])
    _norm(sd, 'decoder.conv_norm_out', dec['norm_out'])
    _conv(sd, 'decoder.conv_out', dec['conv_out'])
    for i in range(n):
        for j in range(config.layers_per_block + 1):
            _resnet(sd, f'decoder.up_blocks.{i}.resnets.{j}',
                    dec[f'up_{i}_res_{j}'])
        if i != n - 1:
            _conv(sd, f'decoder.up_blocks.{i}.upsamplers.0.conv',
                  dec[f'up_{i}_upsample'])
    _resnet(sd, 'decoder.mid_block.resnets.0', dec['mid_res_0'])
    _resnet(sd, 'decoder.mid_block.resnets.1', dec['mid_res_1'])
    _vae_attn(sd, 'decoder.mid_block.attentions.0', dec['mid_attn'])

    _conv(sd, 'quant_conv', tree['quant_conv'])
    _conv(sd, 'post_quant_conv', tree['post_quant_conv'])
    return sd


# The JAX GEGLU feed-forward's leaves → diffusers' FeedForward names.
_FF = {'proj_in': 'net.0.proj', 'proj_out': 'net.2'}


def _lora_module_name(path: str) -> str:
    """A JAX LoRA factor path (``training/train.py`` ``init_lora``) → the
    port's module name."""
    parts = path.split('/')
    head = parts[0]
    m = re.match(r'^(down|up)_(\d+)_attn_(\d+)$', head)
    if m:
        side, i, j = m.groups()
        prefix = f'{side}_blocks.{i}.attentions.{j}'
    elif head == 'mid_attn':
        prefix = 'mid_block.attentions.0'
    else:
        raise ValueError(f'no port module for LoRA path {path!r}')
    if len(parts) == 4 and parts[1].startswith('blocks_'):
        block = f'{prefix}.transformer_blocks.{parts[1][len("blocks_"):]}'
        mid, leaf = parts[2], parts[3]
        if mid in ('attn1', 'attn2') and leaf in ('to_q', 'to_k', 'to_v'):
            return f'{block}.{mid}.{leaf}'
        if mid in ('attn1', 'attn2') and leaf == 'to_out':
            return f'{block}.{mid}.to_out.0'
        if mid == 'ff' and leaf in _FF:
            return f'{block}.ff.{_FF[leaf]}'
    raise ValueError(f'no port module for LoRA path {path!r}')


def lora_factors_to_torch(factors: Mapping) -> Dict[str, SD]:
    """JAX LoRA factors ``{path: {'down': [r, in], 'up': [out, r]}}`` → the
    port's ``{module name: {'down', 'up'}}`` (fp32 tensors). The arrays are
    the same: JAX merges ``(up@down)ᵀ`` into an ``[in, out]`` kernel, the port
    ``up@down`` into an ``[out, in]`` Linear weight."""
    return {_lora_module_name(path): {k: _t(np.asarray(fac[k], np.float32))
                                      for k in ('down', 'up')}
            for path, fac in factors.items()}


# Keyed by class name: the JAX package's config dataclasses are field-for-
# field copies of the port's, and either may describe the model.
_BY_CONFIG = {CLIPTextConfig.__name__: clip_text,
              CLIPVisionConfig.__name__: clip_vision,
              UNetConfig.__name__: unet, VAEConfig.__name__: vae}


def params_to_state_dict(tree: Mapping, config=None) -> SD:
    """The JAX package's param tree for the model that ``config`` describes
    → the port's ``state_dict`` (load it with ``strict=True``). A
    ControlNet's tree (with a ``UNetConfig``) and the IP-Adapter heads'
    (no config needed) are told apart by their keys."""
    if 'params' in tree and len(tree) == 1:
        tree = tree['params']
    if 'zero_conv_mid' in tree:
        return controlnet(tree, config)
    if 'latents' in tree:
        return resampler(tree)
    if set(tree) == {'proj', 'norm'}:
        return image_projection(tree)
    fn = _BY_CONFIG.get(type(config).__name__)
    if fn is None:
        raise TypeError(f'no bridge for config {type(config).__name__}')
    return fn(tree, config)
