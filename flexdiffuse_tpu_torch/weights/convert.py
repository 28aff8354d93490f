"""diffusers/HF state dicts → the port's state dicts, and the port's state
dicts → the JAX package's param trees (port of
``flexdiffuse_tpu/weights/convert.py``).

The port's modules carry the diffusers/HF names, so loading a checkpoint is
mostly a plain ``load_state_dict``. :func:`normalize` makes up the
differences that real checkpoints show, with the leniencies of the JAX
converter:

* SD-2.x-style transformers (``use_linear_projection``) store
  ``proj_in``/``proj_out`` as Linear ``[out, in]``; the port keeps a 1×1
  conv, so they become ``[out, in, 1, 1]`` (``convert.py:36-40``), in a
  UNet and a ControlNet alike (the JAX ``convert_controlnet`` reuses the
  UNet's rules, ``convert.py:275``);
* old VAE checkpoints name the mid attention ``query``/``key``/``value``/
  ``proj_attn`` and some store it as 4-D 1×1 convs (``convert.py:218-234``);
* one HF CLIP file holds both towers (the vision tower with HF's
  ``pre_layrnorm`` spelling, which the port keeps) and keys no port module
  has (``logit_scale``, ``position_ids``, and ``text_projection`` unless
  the text tower has a ``projection_dim``, as SDXL's second encoder has):
  those are dropped with a log line.

Every other key goes through unchanged, so ``load_state_dict(strict=True)``
reports any gap.

The forward rules (:func:`convert_unet` and friends, one per JAX converter)
build the JAX package's tree from a state dict of numpy arrays or torch
tensors, so the port writes full-model saves the JAX package loads (the
inverse is ``weights/bridge.py``):

* Linear ``[out, in]``              → Dense ``kernel [in, out]``
* Conv2d ``[out, in, kh, kw]``      → Conv ``kernel [kh, kw, in, out]``
* norm ``weight``/``bias``          → ``scale``/``bias``
* HF's ``pre_layrnorm``             → ``pre_layernorm``
"""
from __future__ import annotations

import logging
import re
from typing import Dict, Union

import numpy as np
import torch

from flexdiffuse_tpu_torch.models.configs import (CLIPTextConfig,
                                                  CLIPVisionConfig,
                                                  UNetConfig, VAEConfig)

log = logging.getLogger(__name__)

Array = Union[np.ndarray, torch.Tensor]
SD = Dict[str, Array]

# Keys of an HF CLIP checkpoint that no port module holds.
CLIP_EXTRA = re.compile(r'^(logit_scale|text_projection\.weight|'
                        r'(text|vision)_model\.embeddings\.position_ids)$')
_PROJ = re.compile(r'\.(proj_in|proj_out)\.weight$')
_VAE_ATTN = re.compile(r'^((?:en|de)coder\.mid_block\.attentions\.0)\.'
                       r'(query|key|value|proj_attn|to_q|to_k|to_v|'
                       r'to_out\.0)\.(weight|bias)$')
_VAE_NEW = {'query': 'to_q', 'key': 'to_k', 'value': 'to_v',
            'proj_attn': 'to_out.0'}
KINDS = ('text', 'vision', 'unet', 'vae', 'controlnet')


def _split_clip(key: str) -> str:
    if key.startswith('text_model.'):
        return 'text'
    if key.startswith('vision_model.') or key.startswith('visual_projection.'):
        return 'vision'
    return ''


def normalize(sd: SD, kind: str,
              projection: bool = False) -> Dict[str, torch.Tensor]:
    """The state dict of the port's model of ``kind`` ('text', 'vision',
    'unet', 'vae' or 'controlnet') from a diffusers/HF checkpoint's. A CLIP
    checkpoint serves 'text' and 'vision' alike: each keeps its own tower's
    keys; 'text' keeps ``text_projection.weight`` only with ``projection``
    (a text config with ``projection_dim``). Tensors are not copied unless
    a rule reshapes them."""
    if kind not in KINDS:
        raise ValueError(f'unknown model kind {kind!r}')
    out: Dict[str, torch.Tensor] = {}
    dropped = []
    for key, w in sd.items():
        w = torch.as_tensor(w)
        if kind in ('text', 'vision'):
            if (kind == 'text' and projection
                    and key == 'text_projection.weight'):
                out[key] = w
                continue
            if CLIP_EXTRA.match(key):
                dropped.append(key)
                continue
            if _split_clip(key) != kind:
                if not _split_clip(key):
                    dropped.append(key)
                continue
        elif (kind in ('unet', 'controlnet') and _PROJ.search(key)
              and w.ndim == 2):
            w = w[:, :, None, None]
        elif kind == 'vae':
            m = _VAE_ATTN.match(key)
            if m:
                prefix, name, part = m.groups()
                key = f'{prefix}.{_VAE_NEW.get(name, name)}.{part}'
                if w.ndim == 4:   # some checkpoints store 1×1 convs
                    w = w[:, :, 0, 0]
        out[key] = w
    if dropped:
        log.info('%s: dropped %d key(s) no port module holds: %s', kind,
                 len(dropped), ', '.join(sorted(dropped)))
    return out


# ---------------------------------------------------------------------------
# Forward rules: state dict → the JAX package's tree.


def _t2(w: Array) -> Array:
    return w.T if isinstance(w, np.ndarray) else w.t()


def _hwio(w: Array) -> Array:
    return (w.transpose(2, 3, 1, 0) if isinstance(w, np.ndarray)
            else w.permute(2, 3, 1, 0))


def _dense(sd: SD, name: str, bias: bool = True) -> dict:
    out = {'kernel': _t2(sd[f'{name}.weight'])}
    if bias:
        out['bias'] = sd[f'{name}.bias']
    return out


def _conv(sd: SD, name: str) -> dict:
    w = sd[f'{name}.weight']
    # A Linear proj_in/proj_out (use_linear_projection) is the same 1×1.
    return {'kernel': _t2(w)[None, None] if w.ndim == 2 else _hwio(w),
            'bias': sd[f'{name}.bias']}


def _norm(sd: SD, name: str) -> dict:
    return {'scale': sd[f'{name}.weight'], 'bias': sd[f'{name}.bias']}


def _clip_encoder(sd: SD, prefix: str, num_layers: int) -> dict:
    enc = {}
    for i in range(num_layers):
        p = f'{prefix}.layers.{i}'
        enc[f'layers_{i}'] = {
            'self_attn': {k: _dense(sd, f'{p}.self_attn.{k}')
                          for k in ('q_proj', 'k_proj', 'v_proj',
                                    'out_proj')},
            'layer_norm1': _norm(sd, f'{p}.layer_norm1'),
            'layer_norm2': _norm(sd, f'{p}.layer_norm2'),
            'mlp': {'fc1': _dense(sd, f'{p}.mlp.fc1'),
                    'fc2': _dense(sd, f'{p}.mlp.fc2')},
        }
    return enc


def convert_clip_text(sd: SD, config: CLIPTextConfig) -> dict:
    p = 'text_model'
    out = {
        'token_embedding': {
            'embedding': sd[f'{p}.embeddings.token_embedding.weight']},
        'position_embedding': sd[f'{p}.embeddings.position_embedding.weight'],
        'encoder': _clip_encoder(sd, f'{p}.encoder', config.num_layers),
        'final_layer_norm': _norm(sd, f'{p}.final_layer_norm'),
    }
    if config.projection_dim:
        out['text_projection'] = _dense(sd, 'text_projection', bias=False)
    return out


def convert_clip_vision(sd: SD, config: CLIPVisionConfig) -> dict:
    p = 'vision_model'
    return {
        'class_embedding': sd[f'{p}.embeddings.class_embedding'],
        'patch_embedding': {
            'kernel': _hwio(sd[f'{p}.embeddings.patch_embedding.weight'])},
        'position_embedding': sd[f'{p}.embeddings.position_embedding.weight'],
        'pre_layernorm': _norm(sd, f'{p}.pre_layrnorm'),
        'encoder': _clip_encoder(sd, f'{p}.encoder', config.num_layers),
        'post_layernorm': _norm(sd, f'{p}.post_layernorm'),
        'visual_projection': {'kernel': _t2(sd['visual_projection.weight'])},
    }


def _resnet(sd: SD, p: str) -> dict:
    out = {'norm1': _norm(sd, f'{p}.norm1'), 'conv1': _conv(sd, f'{p}.conv1'),
           'norm2': _norm(sd, f'{p}.norm2'), 'conv2': _conv(sd, f'{p}.conv2')}
    if f'{p}.time_emb_proj.weight' in sd:
        out['time_emb_proj'] = _dense(sd, f'{p}.time_emb_proj')
    if f'{p}.conv_shortcut.weight' in sd:
        out['conv_shortcut'] = _conv(sd, f'{p}.conv_shortcut')
    return out


def _attn(sd: SD, p: str) -> dict:
    out = {k: _dense(sd, f'{p}.{k}', bias=False)
           for k in ('to_q', 'to_k', 'to_v')}
    out['to_out'] = _dense(sd, f'{p}.to_out.0')
    return out


def _transformer2d(sd: SD, p: str, depth: int) -> dict:
    out = {'norm': _norm(sd, f'{p}.norm'),
           'proj_in': _conv(sd, f'{p}.proj_in'),
           'proj_out': _conv(sd, f'{p}.proj_out')}
    for i in range(depth):
        b = f'{p}.transformer_blocks.{i}'
        out[f'blocks_{i}'] = {
            'attn1': _attn(sd, f'{b}.attn1'), 'attn2': _attn(sd, f'{b}.attn2'),
            'norm1': _norm(sd, f'{b}.norm1'), 'norm2': _norm(sd, f'{b}.norm2'),
            'norm3': _norm(sd, f'{b}.norm3'),
            'ff': {'proj_in': _dense(sd, f'{b}.ff.net.0.proj'),
                   'proj_out': _dense(sd, f'{b}.ff.net.2')},
        }
    return out


def convert_unet(sd: SD, config: UNetConfig) -> dict:
    out: dict = {
        'time_embed_1': _dense(sd, 'time_embedding.linear_1'),
        'time_embed_2': _dense(sd, 'time_embedding.linear_2'),
        'conv_in': _conv(sd, 'conv_in'),
        'norm_out': _norm(sd, 'conv_norm_out'),
        'conv_out': _conv(sd, 'conv_out'),
    }
    if config.time_cond_proj_dim:
        # LCM guidance-embedding projection (bias-free).
        out['time_cond_proj'] = _dense(sd, 'time_embedding.cond_proj',
                                       bias=False)
    if config.addition_embed:
        # SDXL's text-time additional embedding.
        out['add_embed_1'] = _dense(sd, 'add_embedding.linear_1')
        out['add_embed_2'] = _dense(sd, 'add_embedding.linear_2')
    n = len(config.block_channels)
    for i in range(n):
        for j in range(config.layers_per_block):
            out[f'down_{i}_res_{j}'] = _resnet(sd,
                                               f'down_blocks.{i}.resnets.{j}')
            if config.attention_levels[i]:
                out[f'down_{i}_attn_{j}'] = _transformer2d(
                    sd, f'down_blocks.{i}.attentions.{j}', config.depth_at(i))
        if i != n - 1:
            out[f'down_{i}_downsample'] = {
                'conv': _conv(sd, f'down_blocks.{i}.downsamplers.0.conv')}
    out['mid_res_0'] = _resnet(sd, 'mid_block.resnets.0')
    out['mid_res_1'] = _resnet(sd, 'mid_block.resnets.1')
    out['mid_attn'] = _transformer2d(sd, 'mid_block.attentions.0',
                                     config.depth_mid())
    for i in range(n):
        level = n - 1 - i
        for j in range(config.layers_per_block + 1):
            out[f'up_{i}_res_{j}'] = _resnet(sd, f'up_blocks.{i}.resnets.{j}')
            if config.attention_levels[level]:
                out[f'up_{i}_attn_{j}'] = _transformer2d(
                    sd, f'up_blocks.{i}.attentions.{j}',
                    config.depth_at(level))
        if i != n - 1:
            out[f'up_{i}_upsample'] = {
                'conv': _conv(sd, f'up_blocks.{i}.upsamplers.0.conv')}
    return out


def _vae_attn(sd: SD, p: str) -> dict:
    out = {k: _dense(sd, f'{p}.{k}') for k in ('to_q', 'to_k', 'to_v')}
    out['to_out'] = _dense(sd, f'{p}.to_out.0')
    out['group_norm'] = _norm(sd, f'{p}.group_norm')
    return out


def _vae_half(sd: SD, side: str, config: VAEConfig) -> dict:
    """The encoder's or decoder's tree (``side``: 'encoder' or
    'decoder')."""
    n = len(config.block_channels)
    enc = side == 'encoder'
    out: dict = {'conv_in': _conv(sd, f'{side}.conv_in'),
                 'norm_out': _norm(sd, f'{side}.conv_norm_out'),
                 'conv_out': _conv(sd, f'{side}.conv_out')}
    blocks, resample = (('down', 'downsamplers') if enc
                        else ('up', 'upsamplers'))
    for i in range(n):
        for j in range(config.layers_per_block + (0 if enc else 1)):
            out[f'{blocks}_{i}_res_{j}'] = _resnet(
                sd, f'{side}.{blocks}_blocks.{i}.resnets.{j}')
        if i != n - 1:
            out[f'{blocks}_{i}_{blocks}sample'] = _conv(
                sd, f'{side}.{blocks}_blocks.{i}.{resample}.0.conv')
    out['mid_res_0'] = _resnet(sd, f'{side}.mid_block.resnets.0')
    out['mid_res_1'] = _resnet(sd, f'{side}.mid_block.resnets.1')
    out['mid_attn'] = _vae_attn(sd, f'{side}.mid_block.attentions.0')
    return out


def convert_vae(sd: SD, config: VAEConfig) -> dict:
    return {'encoder': _vae_half(sd, 'encoder', config),
            'decoder': _vae_half(sd, 'decoder', config),
            'quant_conv': _conv(sd, 'quant_conv'),
            'post_quant_conv': _conv(sd, 'post_quant_conv')}


def state_dict_to_params(sd: SD, config) -> dict:
    """The port's ``state_dict`` for the model ``config`` describes → the
    JAX package's ``{'params': tree}`` (the inverse of
    ``bridge.params_to_state_dict``)."""
    fn: Dict[str, object] = {CLIPTextConfig.__name__: convert_clip_text,
                             CLIPVisionConfig.__name__: convert_clip_vision,
                             UNetConfig.__name__: convert_unet,
                             VAEConfig.__name__: convert_vae}
    conv = fn.get(type(config).__name__)
    if conv is None:
        raise TypeError(f'no converter for config {type(config).__name__}')
    return {'params': conv(sd, config)}

