"""Checkpoint loading: HF snapshot directories → the port's state dicts and
modules (port of ``flexdiffuse_tpu/weights/load.py``).

The JAX package converts a snapshot into its trees once and caches them as
msgpack beside it; the port's modules carry the snapshot's own names, so it
reads the files directly (safetensors through a copy-on-write ``mmap``,
``weights/safetensors.py``) and needs no cache; it writes the JAX
package's caches all the same (:func:`write_clip_cache`,
:func:`write_sd_cache`: the CLI's ``convert``). :func:`instantiate` builds
a module on the meta device and fills it from a state dict with
``strict=True``, so the weights reach the device once, in the module's
dtype.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Tuple

import torch
from torch import nn

from flexdiffuse_tpu_torch.models.configs import (CLIPTextConfig,
                                                  CLIPVisionConfig,
                                                  UNetConfig, VAEConfig)
from flexdiffuse_tpu_torch.weights import bridge, convert
from flexdiffuse_tpu_torch.weights import msgpack as _msgpack
from flexdiffuse_tpu_torch.weights import safetensors as _safetensors

SD = Dict[str, torch.Tensor]
WEIGHT_FILES = ('diffusion_pytorch_model.safetensors', 'model.safetensors',
                'pytorch_model.bin', 'diffusion_pytorch_model.bin')


def weights_file(path: str) -> str:
    """``path`` itself, or the first of :data:`WEIGHT_FILES` in the
    directory ``path``."""
    if not os.path.isdir(path):
        return path
    for name in WEIGHT_FILES:
        cand = os.path.join(path, name)
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(f'no model weights found under {path}')


def load_state_dict(path: str) -> SD:
    """A torch/safetensors state dict as CPU tensors in their stored dtypes.

    ``path`` may be a ``.safetensors`` file (mapped, not read), a torch
    ``.bin``/``.ckpt``/``.pt``, or a directory holding one of
    :data:`WEIGHT_FILES`. A1111 textual-inversion ``.pt`` files mix tensors
    with metadata: nested dicts are flattened with dotted keys and anything
    that is not a tensor is dropped."""
    path = weights_file(path)
    if path.endswith('.safetensors'):
        return _safetensors.load_file(path)
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if 'state_dict' in sd:
        sd = sd['state_dict']
    out: SD = {}

    def put(prefix: str, v) -> None:
        if torch.is_tensor(v):
            out[prefix] = v
        elif isinstance(v, dict):
            for k, sub in v.items():
                put(f'{prefix}.{k}' if prefix else str(k), sub)

    put('', sd)
    return out


def load_clip(model_dir: str) -> Tuple[SD, SD]:
    """The text and vision towers' state dicts from an
    ``openai/clip-vit-large-patch14`` snapshot directory."""
    sd = load_state_dict(model_dir)
    return convert.normalize(sd, 'text'), convert.normalize(sd, 'vision')


def load_sd(model_dir: str) -> Tuple[SD, SD]:
    """The UNet's and VAE's state dicts from a diffusers snapshot directory
    (``unet/`` and ``vae/`` subdirectories)."""
    return (convert.normalize(load_state_dict(os.path.join(model_dir,
                                                           'unet')), 'unet'),
            convert.normalize(load_state_dict(os.path.join(model_dir, 'vae')),
                              'vae'))


def load_sdxl(model_dir: str, projection: bool = True
              ) -> Tuple[SD, SD, SD, SD]:
    """The UNet's, VAE's and both text encoders' state dicts from an
    SDXL snapshot directory (``unet/``, ``vae/``, ``text_encoder/``,
    ``text_encoder_2/``); encoder 2 keeps its ``text_projection`` with
    ``projection``."""
    part = lambda sub: load_state_dict(os.path.join(model_dir, sub))
    return (convert.normalize(part('unet'), 'unet'),
            convert.normalize(part('vae'), 'vae'),
            convert.normalize(part('text_encoder'), 'text'),
            convert.normalize(part('text_encoder_2'), 'text',
                              projection=projection))


def _np_leaves(tree):
    """A restored tree with bfloat16 leaves (torch tensors) widened to
    float32 numpy arrays, exactly; ``bridge`` takes numpy."""
    if isinstance(tree, dict):
        return {k: _np_leaves(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return tree


def load_unet_msgpack(path: str, config: UNetConfig) -> SD:
    """The UNet state dict of a full fine-tune saved by either package
    (flax msgpack of ``{'params': tree}`` or of the bare tree). bfloat16
    leaves come back as float32 (exact)."""
    tree = _np_leaves(_msgpack.load(path))
    return bridge.params_to_state_dict(tree, config)


def instantiate(cls, config, state_dict: SD, device,
                dtype: torch.dtype) -> nn.Module:
    """``cls(config)`` in ``dtype`` on ``device``, its weights those of
    ``state_dict`` (checked with ``strict=True``), in eval mode and
    without gradients. The module is built on the meta device, so nothing
    is initialised, and each weight is copied to the device once and
    assigned (``Module.to_empty`` would do as well, but its first call in
    a process costs seconds on the card's host; see PERF.md)."""
    with torch.device('meta'):
        module = cls(config)
    module.load_state_dict(
        {k: v.to(device, dtype if v.is_floating_point() else None)
         for k, v in state_dict.items()}, strict=True, assign=True)
    return module.eval().requires_grad_(False)


def snapshot_dirs(model_root: str, sd_model: str,
                  clip_model: str) -> Tuple[str, str]:
    """The SD and CLIP snapshot directories under ``model_root``, named
    after the last part of each model id."""
    return (os.path.join(model_root, sd_model.split('/')[-1]),
            os.path.join(model_root, clip_model.split('/')[-1]))


def unet_overrides(sd_dir: str) -> Dict[str, int]:
    """``in_channels`` and ``time_cond_proj_dim`` from the snapshot's
    ``unet/config.json`` (an empty dict when there is none or it does not
    parse)."""
    cfg_json = os.path.join(sd_dir, 'unet', 'config.json')
    try:
        with open(cfg_json) as f:
            uj = json.load(f)
    except (OSError, ValueError):
        return {}
    return {'in_channels': int(uj.get('in_channels') or 4),
            'time_cond_proj_dim': int(uj.get('time_cond_proj_dim') or 0)}


def _config_tag(*configs) -> str:
    """Short fingerprint of the model configs a cache was converted under
    (the JAX loader's ``_config_tag``; the two packages' configs have the
    same ``repr``, so the tags agree)."""
    text = '|'.join(repr(c) for c in configs)
    return hashlib.sha1(text.encode()).hexdigest()[:10]


def _write_cache(model_dir: str, kind: str, parts: Dict[str, tuple]) -> str:
    """``parts`` (tree key → (state dict, config)) converted by
    ``convert.state_dict_to_params`` into the JAX package's cache
    ``flexdiffuse_tpu_<kind>_<tag>.msgpack`` in ``model_dir``, in flax's
    msgpack bytes; returns its path."""
    tree = {key: convert.state_dict_to_params(sd, cfg)['params']
            for key, (sd, cfg) in parts.items()}
    tag = _config_tag(*(cfg for _, cfg in parts.values()))
    path = os.path.join(model_dir, f'flexdiffuse_tpu_{kind}_{tag}.msgpack')
    _msgpack.save(tree, path)
    return path


def write_clip_cache(model_dir: str,
                     text_config: CLIPTextConfig = CLIPTextConfig(),
                     vision_config: CLIPVisionConfig = CLIPVisionConfig()
                     ) -> str:
    """The JAX loader's CLIP cache for a CLIP snapshot, beside it."""
    text, vision = load_clip(model_dir)
    return _write_cache(model_dir, 'clip', {'text': (text, text_config),
                                            'vision': (vision,
                                                       vision_config)})


def write_sd_cache(model_dir: str, unet_config: UNetConfig = UNetConfig(),
                   vae_config: VAEConfig = VAEConfig()) -> str:
    """The JAX loader's UNet+VAE cache for an SD snapshot, beside it."""
    unet, vae = load_sd(model_dir)
    return _write_cache(model_dir, 'sd', {'unet': (unet, unet_config),
                                          'vae': (vae, vae_config)})
