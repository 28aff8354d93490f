"""LoRA adapters merged into the loaded modules (port of
``flexdiffuse_tpu/weights/lora.py``).

The SD ecosystem ships fine-tunes as low-rank adapters: kohya ("a1111")
safetensors (``lora_unet_*`` / ``lora_te_*`` keys with ``lora_down.weight``
``[r, in]``, ``lora_up.weight`` ``[out, r]`` and a per-module ``alpha``) and
the diffusers/PEFT naming (dotted module paths with ``lora_A``/``lora_B``,
the format LCM-LoRA ships in, including k×k conv adapters). Each adapter is
merged into its module's weight once, ``W ← W + scale·(alpha/r)·up@down``,
so the model runs unchanged and stacked adapters cost no step time.

Module names are the port's, which are the diffusers/HF names, so a kohya
name maps by putting the dots back. Covered, as in the JAX package: the
transformer attention projections, the GEGLU feed-forward, the transformer
``proj_in``/``proj_out`` (Linear or 1×1 conv layouts), the CLIP text
encoder's attention and MLP, and, in the diffusers naming, the resnet
convs and ``time_emb_proj``, the samplers and the time embedding. Unknown
keys are reported, not silently dropped.

SDXL's kohya SGM naming (``input_blocks_{n}_1`` / ``middle_block_1`` /
``output_blocks_{n}_1``) maps through :func:`sgm_block_map`, a function of
the UNet config (``apply_lora(unet_config=)``), and ``lora_te2_`` /
``text_encoder_2.`` modules merge into SDXL's second text encoder
(``apply_lora(text2_model=)``).
"""
from __future__ import annotations

import logging
import re
from typing import Dict, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

from flexdiffuse_tpu_torch.models.configs import SDXL_UNET, UNetConfig

log = logging.getLogger(__name__)

_BLOCK = re.compile(r'^(down|up)_blocks_(\d+)_attentions_(\d+)_(.*)$')
_MID = re.compile(r'^mid_block_attentions_0_(.*)$')
_TE = re.compile(r'^text_model_encoder_layers_(\d+)_(self_attn|mlp)_(.*)$')
_SGM = re.compile(r'^((?:input|output)_blocks_\d+_\d+|middle_block_\d+)_(.*)$')
_TE_LEAVES = {'self_attn': ('q_proj', 'k_proj', 'v_proj', 'out_proj'),
              'mlp': ('fc1', 'fc2')}


def _leaf(rest: str) -> Optional[str]:
    """A kohya name inside a Transformer2D → the port's dotted name."""
    m = re.match(r'^transformer_blocks_(\d+)_(.*)$', rest)
    if m:
        d, leaf = m.groups()
        for attn in ('attn1', 'attn2'):
            if leaf == f'{attn}_to_out_0':
                return f'transformer_blocks.{d}.{attn}.to_out.0'
            if re.match(f'^{attn}_to_[qkv]$', leaf):
                return f'transformer_blocks.{d}.{attn}.{leaf[6:]}'
        ff = {'ff_net_0_proj': 'ff.net.0.proj', 'ff_net_2': 'ff.net.2'}
        return f'transformer_blocks.{d}.{ff[leaf]}' if leaf in ff else None
    return rest if rest in ('proj_in', 'proj_out') else None


def _unet_name(module: str) -> Optional[str]:
    m = _BLOCK.match(module)
    if m:
        side, i, j, rest = m.groups()
        leaf = _leaf(rest)
        return f'{side}_blocks.{i}.attentions.{j}.{leaf}' if leaf else None
    m = _MID.match(module)
    if m:
        leaf = _leaf(m.group(1))
        return f'mid_block.attentions.0.{leaf}' if leaf else None
    return None


def sgm_block_map(config: UNetConfig) -> Dict[str, str]:
    """SGM (kohya SDXL) attention block name → the port's Transformer2D
    name. Enumerates the blocks as the SGM UNet builds them: input blocks
    are [conv_in, (res[, attn]) × layers, downsample] per level, output
    blocks (layers + 1) per level innermost first; the ``_1`` suffix is the
    attention inside a block."""
    mapping = {}
    n = len(config.block_channels)
    blk = 1
    for i in range(n):
        for j in range(config.layers_per_block):
            if config.attention_levels[i]:
                mapping[f'input_blocks_{blk}_1'] = \
                    f'down_blocks.{i}.attentions.{j}'
            blk += 1
        if i != n - 1:
            blk += 1                            # downsample block
    mapping['middle_block_1'] = 'mid_block.attentions.0'
    blk = 0
    for i in range(n):
        level = n - 1 - i
        for j in range(config.layers_per_block + 1):
            if config.attention_levels[level]:
                mapping[f'output_blocks_{blk}_1'] = \
                    f'up_blocks.{i}.attentions.{j}'
            blk += 1
    return mapping


def _sgm_name(module: str, block_map: Dict[str, str]) -> Optional[str]:
    m = _SGM.match(module)
    if not m or m.group(1) not in block_map:
        return None
    leaf = _leaf(m.group(2))
    return f'{block_map[m.group(1)]}.{leaf}' if leaf else None


def _te_name(module: str) -> Optional[str]:
    m = _TE.match(module)
    if not m or m.group(3) not in _TE_LEAVES[m.group(2)]:
        return None
    return f'text_model.encoder.layers.{m.group(1)}.{m.group(2)}.' \
           f'{m.group(3)}'


# diffusers/PEFT naming: the dotted names are the port's own; these are the
# modules the JAX package maps.
_D_ATTN_LEAF = (r'(?:transformer_blocks\.\d+\.(?:attn[12]\.(?:to_[qkv]|'
                r'to_out\.0)|ff\.net\.0\.proj|ff\.net\.2)|proj_in|proj_out)')
_RES_LEAF = r'(?:conv1|conv2|conv_shortcut|time_emb_proj)'
_D_UNET = re.compile(
    rf'^(?:(?:down|up)_blocks\.\d+\.attentions\.\d+\.{_D_ATTN_LEAF}|'
    rf'(?:down|up)_blocks\.\d+\.resnets\.\d+\.{_RES_LEAF}|'
    r'(?:down|up)_blocks\.\d+\.(?:down|up)samplers\.0\.conv|'
    rf'mid_block\.attentions\.0\.{_D_ATTN_LEAF}|'
    rf'mid_block\.resnets\.\d+\.{_RES_LEAF}|'
    r'time_embedding\.linear_[12])$')
_D_TE = re.compile(r'^text_model\.encoder\.layers\.\d+\.(?:self_attn\.'
                   r'(?:q_proj|k_proj|v_proj|out_proj)|mlp\.(?:fc1|fc2))$')


def parse_spec(spec: str) -> Tuple[str, float]:
    """'path[:scale]' CLI/UI spec → (path, scale)."""
    path, _, s_part = spec.rpartition(':')
    if path:
        try:
            return path, float(s_part)
        except ValueError:
            pass
    return spec, 1.0


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().float().cpu().numpy()
    return np.asarray(v)


Modules = Dict[Tuple[str, str], Tuple[np.ndarray, np.ndarray, float]]


def parse_lora(sd: Mapping, unet_config: Optional[UNetConfig] = None
               ) -> Tuple[Modules, list]:
    """Group a LoRA state dict into ``{(target, module name): (down, up,
    alpha / rank)}``; ``target`` is 'unet', 'te' (the SD-1.x / CLIP-L text
    encoder) or 'te2' (SDXL's second encoder). ``unet_config`` drives the
    SGM block map for SDXL names (SDXL-base geometry by default). Returns
    ``(modules, unmapped module keys)``."""
    sgm_map: Optional[Dict[str, str]] = None

    def sgm(module: str) -> Optional[str]:
        nonlocal sgm_map
        if sgm_map is None:
            sgm_map = sgm_block_map(unet_config or SDXL_UNET)
        return _sgm_name(module, sgm_map)

    groups: Dict[str, dict] = {}
    for key, val in sd.items():
        base, _, part = key.rpartition('.')
        if part == 'weight':
            base, _, part = base.rpartition('.')
        # kohya: lora_down/lora_up/alpha; diffusers-PEFT: lora_A/lora_B;
        # older diffusers: <module>.lora.down / <module>.lora.up.
        if part in ('lora_A', 'lora_B'):
            part = 'lora_down' if part == 'lora_A' else 'lora_up'
        elif part in ('down', 'up') and base.endswith('.lora'):
            base = base[:-len('.lora')]
            part = f'lora_{part}'
        if part not in ('lora_down', 'lora_up', 'alpha'):
            continue
        groups.setdefault(base, {})[part] = _np(val)

    modules: Modules = {}
    unmapped = []
    for base, parts in groups.items():
        if 'lora_down' not in parts or 'lora_up' not in parts:
            unmapped.append(base)
            continue
        name, target = None, None
        if base.startswith('lora_unet_'):
            module = base[len('lora_unet_'):]
            name, target = _unet_name(module) or sgm(module), 'unet'
        elif base.startswith(('lora_te_', 'lora_te1_')):
            prefix = 'lora_te1_' if base.startswith('lora_te1_') else \
                'lora_te_'
            name, target = _te_name(base[len(prefix):]), 'te'
        elif base.startswith('lora_te2_'):
            name, target = _te_name(base[len('lora_te2_'):]), 'te2'
        elif base.startswith('unet.'):
            module = base[len('unet.'):]
            name, target = (module if _D_UNET.match(module) else None), 'unet'
        elif base.startswith(('text_encoder.', 'text_encoder_2.')):
            module = base.split('.', 1)[1]
            name = module if _D_TE.match(module) else None
            target = 'te' if base.startswith('text_encoder.') else 'te2'
        if name is None:
            unmapped.append(base)
            continue
        down, up = parts['lora_down'], parts['lora_up']
        if down.ndim == 4 and down.shape[2:] == (1, 1):   # 1×1 conv layout
            down = down[:, :, 0, 0]
        if up.ndim == 4 and up.shape[2:] == (1, 1):
            up = up[:, :, 0, 0]
        rank = down.shape[0]
        alpha = float(parts.get('alpha', rank))
        modules[(target, name)] = (down, up, alpha / rank)
    return modules, unmapped


def _delta(down: np.ndarray, up: np.ndarray, factor: float,
           shape: torch.Size, name: str) -> torch.Tensor:
    """``factor·up@down`` as an fp32 tensor of the weight's ``shape``
    (products in float64, as the JAX package)."""
    up64, down64 = up.astype(np.float64), down.astype(np.float64)
    if down.ndim == 4:
        # k×k conv adapter: ΔW[o,i,kh,kw] = Σ_r up[o,r]·down[r,i,kh,kw].
        d = np.einsum('or,rihw->oihw', up64, down64)
    else:
        d = up64 @ down64
        if len(shape) == 4 and tuple(shape[2:]) == (1, 1):
            d = d[:, :, None, None]
    if d.shape != tuple(shape):
        raise ValueError(f'LoRA shape {d.shape} does not match the weight '
                         f'{tuple(shape)} of {name}')
    return torch.from_numpy((factor * d).astype(np.float32))


def apply_lora(unet: Optional[nn.Module], text_model: Optional[nn.Module],
               lora_sd: Mapping, scale: float = 1.0,
               unet_config: Optional[UNetConfig] = None,
               base: Optional[Mapping[str, Mapping]] = None,
               merged: Set[str] = frozenset(),
               text2_model: Optional[nn.Module] = None) -> Set[str]:
    """Merge a LoRA into the UNet and text encoders in place; any may be
    None to skip its part (``text2_model``: SDXL's second encoder, the
    'te2' modules). ``unet_config`` is the UNet's geometry for SGM-named
    modules (default SDXL base). Each weight is merged in fp32 on the host
    and cast to its module's dtype once; at most one weight's fp32 copy
    exists at a time.

    ``base``: for each target ('unet', 'te', 'te2'), a state dict of the
    unmerged
    weights (the snapshot's); a weight not in ``merged`` is merged from
    there, not from the module's possibly lower-precision copy. Returns
    the ``'target:name'`` of every weight merged. Raises on a LoRA module
    the model lacks (a different base model) and when nothing applies;
    logs and skips key patterns outside the supported coverage."""
    modules, unmapped = parse_lora(lora_sd, unet_config)
    if unmapped:
        log.warning('LoRA: %d unsupported module(s) skipped (e.g. %s)',
                    len(unmapped), unmapped[0])
    if not modules:
        raise ValueError('no applicable LoRA modules found')
    models = {'unet': unet, 'te': text_model, 'te2': text2_model}
    dropped = sorted({t for (t, _) in modules if models.get(t) is None})
    if dropped:
        log.warning('LoRA: modules targeting %s skipped; no such model was '
                    'passed (partial application)', '/'.join(dropped))
    named = {t: dict(m.named_modules()) for t, m in models.items()
             if m is not None}
    done: Set[str] = set()
    for (target, name), (down, up, a) in modules.items():
        if target not in named:
            continue
        module = named[target].get(name)
        if not isinstance(module, (nn.Linear, nn.Conv2d)):
            raise KeyError(f'LoRA targets missing module {name} — adapter '
                           'does not match this base model')
        w = module.weight
        tag = f'{target}:{name}.weight'
        src = (base or {}).get(target, {}).get(f'{name}.weight')
        if src is None or tag in merged:
            src = w
        w32 = src.detach().to('cpu', torch.float32, copy=True)
        w32 += _delta(down, up, scale * a, w.shape, name)
        with torch.no_grad():
            w.copy_(w32.to(w.dtype))
        done.add(tag)
    return done
