"""Stable Diffusion XL base (Podell et al. 2023, arXiv:2307.01952;
stabilityai/stable-diffusion-xl-base-1.0's ``unet/``, ``text_encoder/``,
``text_encoder_2/`` and ``vae/`` configs, diffusers' parameter names).

- Text: two CLIP text transformers, CLIP ViT-L/14 (``text_encoder.``) and
  OpenCLIP ViT-bigG/14 (``text_encoder_2.``). The context is the two
  towers' penultimate hidden states (the output of all but the last
  layer, no final LayerNorm) concatenated, ``[B, 77, 768 + 1280]``. The
  pooled embedding is bigG's last hidden state through its final
  LayerNorm at the first EOS position, through ``text_projection`` (no
  bias). The second tokenizer pads with id 0, so its only EOS is the one
  after the prompt.
- UNet: ``reference/unet.py``'s ResNet blocks and spatial transformers with
  a transformer depth per level (``transformer_depth``, a list; the mid
  block takes the innermost level's), no attention where a level's depth
  is 0, and the ``text_time`` added embedding: each of the six
  micro-conditioning ids (original size, crop corner, target size) as 256
  sinusoidal features, concatenated after the pooled embedding (1280 + 6 ×
  256 = 2816), through ``add_embedding.linear_1`` → SiLU → ``linear_2``,
  added to the timestep embedding.
- Sampling: DPM-Solver++(2M) (``reference/dpmpp.py``) with
  classifier-free guidance on ε, then ``reference/vae.py``'s decoder at the
  configuration's latent scale (0.13025).

Departures from the published description: the linear ``proj_in`` and
``proj_out`` are read as 1×1 convolutions ``[C, C, 1, 1]`` (the same map,
as ``reference/unet.py`` reads them); the micro-conditioning ids are the
image size, no crop and the image size again, as a user asking for a
square image gets them.

Config keys: group ``text`` and ``text2`` (``reference/text.py``'s, with
``projection_dim`` for bigG), ``unet`` (``reference/unet.py``'s, with
``transformer_depth`` a list and ``addition_time_embed_dim``,
``addition_pooled_dim``, ``num_time_ids``), ``vae`` and ``scheduler``
(``reference/dpmpp.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference import dpmpp, vae
from bench_h100.reference.ops import (Ops, attention, heads, merge_heads,
                                      sinusoid)
from bench_h100.reference.unet import _heads, resnet, transformer

Tensor = torch.Tensor
TEXT_PREFIX = {'text': 'text_encoder.', 'text2': 'text_encoder_2.'}


def _embed(ops: Ops, cfg: dict, p: str, ids: Tensor) -> Tensor:
    d = cfg['hidden_size']
    tok = ops.w(p + 'embeddings.token_embedding.weight',
                (cfg['vocab_size'], d))
    pos = ops.w(p + 'embeddings.position_embedding.weight',
                (cfg['max_positions'], d))
    return F.embedding(ids, tok) + pos[:ids.shape[1]]


def _layer(ops: Ops, cfg: dict, lp: str, x: Tensor, mask: Tensor) -> Tensor:
    """One pre-LN block: causal self-attention, then the MLP."""
    d, n_heads = cfg['hidden_size'], cfg['num_heads']
    inner, act = cfg['intermediate_size'], cfg['activation']
    y = ops.layer_norm(x, lp + 'layer_norm1')
    q = heads(ops.linear(y, lp + 'self_attn.q_proj', d, d), n_heads)
    k = heads(ops.linear(y, lp + 'self_attn.k_proj', d, d), n_heads)
    v = heads(ops.linear(y, lp + 'self_attn.v_proj', d, d), n_heads)
    o = merge_heads(attention(q, k, v, (d // n_heads)**-0.5, mask),
                    x.shape[0])
    x = x + ops.linear(o, lp + 'self_attn.out_proj', d, d)
    y = ops.linear(ops.layer_norm(x, lp + 'layer_norm2'), lp + 'mlp.fc1', d,
                   inner)
    y = y * torch.sigmoid(1.702 * y) if act == 'quick_gelu' else F.gelu(y)
    return x + ops.linear(y, lp + 'mlp.fc2', inner, d)


def tower(ops: Ops, cfg: dict, prefix: str, ids: Tensor,
          pool: bool = False):
    """``(penultimate [B, T, hidden_size], pooled)``: the hidden state after
    every layer but the last (no final LN); with ``pool`` also the last
    layer's final-LN state at the first EOS (``eos_token_id``) through
    ``text_projection``, ``[B, projection_dim]`` (else None)."""
    p = prefix + 'text_model.'
    x = _embed(ops, cfg, p, ids)
    t = ids.shape[1]
    mask = torch.triu(torch.full((t, t), float('-inf'), device=x.device),
                      diagonal=1)
    n = cfg['num_layers']
    for i in range(n - 1):
        x = _layer(ops, cfg, f'{p}encoder.layers.{i}.', x, mask)
    if not pool:
        return x, None
    y = ops.layer_norm(_layer(ops, cfg, f'{p}encoder.layers.{n - 1}.', x,
                              mask), p + 'final_layer_norm')
    eos = (ids == cfg['eos_token_id']).int().argmax(dim=-1)
    y = y[torch.arange(ids.shape[0], device=ids.device), eos]
    return x, ops.linear(y, prefix + 'text_projection', cfg['hidden_size'],
                         cfg['projection_dim'], bias=False)


def encode(ops: Ops, cfg: dict, ids: Tensor, ids2: Tensor):
    """``(context [B, 77, 768 + 1280], pooled [B, 1280])`` from the first
    tokenizer's ids and the second's (padded with 0)."""
    h1, _ = tower(ops, cfg['text'], TEXT_PREFIX['text'], ids)
    h2, pooled = tower(ops, cfg['text2'], TEXT_PREFIX['text2'], ids2,
                       pool=True)
    return torch.cat([h1, h2], dim=-1), pooled


def added_embedding(ops: Ops, cfg: dict, text_embeds: Tensor,
                    time_ids: Tensor, dim: int) -> Tensor:
    """The ``text_time`` embedding ``[B, dim]``."""
    b = text_embeds.shape[0]
    ids = sinusoid(time_ids.reshape(-1), cfg['addition_time_embed_dim'])
    x = torch.cat([text_embeds.float(), ids.reshape(b, -1)], dim=-1)
    n_in = cfg['addition_pooled_dim'] + \
        cfg['num_time_ids'] * cfg['addition_time_embed_dim']
    x = ops.linear(x, 'add_embedding.linear_1', n_in, dim)
    return ops.linear(F.silu(x), 'add_embedding.linear_2', dim, dim)


def unet_forward(ops: Ops, cfg: dict, latents: Tensor, t: Tensor,
                 ctx: Tensor, text_embeds: Tensor,
                 time_ids: Tensor) -> Tensor:
    """``latents`` NHWC ``[B, H, W, in_channels]``, ``t`` ``[B]``, ``ctx``
    ``[B, T, cross_attention_dim]``, ``text_embeds`` ``[B,
    addition_pooled_dim]``, ``time_ids`` ``[B, num_time_ids]`` → ε NHWC
    fp32."""
    chans = cfg['block_channels']
    lpb, groups = cfg['layers_per_block'], cfg['norm_groups']
    depth = cfg['transformer_depth']
    n = len(chans)
    ch0 = chans[0]
    temb = ops.linear(sinusoid(t, ch0), 'time_embedding.linear_1', ch0,
                      4 * ch0)
    temb = ops.linear(F.silu(temb), 'time_embedding.linear_2', 4 * ch0,
                      4 * ch0)
    temb = temb + added_embedding(ops, cfg, text_embeds, time_ids, 4 * ch0)

    def attn(name: str, h: Tensor, level: int) -> Tensor:
        if not depth[level]:
            return h
        ch = chans[level]
        return transformer(ops, name, h, ctx, _heads(cfg, ch), groups,
                           depth[level])

    h = ops.conv(latents.permute(0, 3, 1, 2).float(), 'conv_in',
                 cfg['in_channels'], ch0, 3, padding=1)
    skips = [h]
    for i, ch in enumerate(chans):
        for j in range(lpb):
            h = resnet(ops, f'down_blocks.{i}.resnets.{j}', h, ch, groups,
                       1e-5, temb)
            h = attn(f'down_blocks.{i}.attentions.{j}', h, i)
            skips.append(h)
        if i != n - 1:
            h = ops.conv(h, f'down_blocks.{i}.downsamplers.0.conv', ch, ch,
                         3, stride=2, padding=1)
            skips.append(h)
    mid = chans[-1]
    h = resnet(ops, 'mid_block.resnets.0', h, mid, groups, 1e-5, temb)
    h = attn('mid_block.attentions.0', h, n - 1)
    h = resnet(ops, 'mid_block.resnets.1', h, mid, groups, 1e-5, temb)
    for i, ch in enumerate(reversed(chans)):
        level = n - 1 - i
        for j in range(lpb + 1):
            h = resnet(ops, f'up_blocks.{i}.resnets.{j}',
                       torch.cat([h, skips.pop()], dim=1), ch, groups, 1e-5,
                       temb)
            h = attn(f'up_blocks.{i}.attentions.{j}', h, level)
        if i != n - 1:
            h = ops.conv(F.interpolate(h, scale_factor=2.0, mode='nearest'),
                         f'up_blocks.{i}.upsamplers.0.conv', ch, ch, 3,
                         padding=1)
    h = ops.group_norm(h, 'conv_norm_out', groups, 1e-5, silu=True)
    h = ops.conv(h, 'conv_out', ch0, cfg['out_channels'], 3, padding=1)
    return h.permute(0, 2, 3, 1)


def micro_ids(size: int, rows: int, device) -> Tensor:
    """``[rows, 6]``: original size, crop corner (0, 0), target size, of a
    square ``size`` image."""
    ids = torch.tensor([size, size, 0, 0, size, size], dtype=torch.float32,
                       device=device)
    return ids.expand(rows, -1)


def generate(ops: Ops, cfg: dict, ids: Tensor, ids2: Tensor,
             uncond_ids: Tensor, uncond_ids2: Tensor, noise: Tensor,
             steps: int, scale: float, size: int) -> Tensor:
    """Images NHWC in ``[0, 1]`` for prompt rows (``ids``, ``ids2``) under
    negative rows (``uncond_ids``, ``uncond_ids2``), each ``[B, 77]``, from
    unit noise ``[B, h, w, C]`` at ``size`` pixels a side: CFG ``u +
    scale·(c − u)`` on ε at every step."""
    ctx, pool = encode(ops, cfg, torch.cat([uncond_ids, ids]),
                       torch.cat([uncond_ids2, ids2]))
    tids = micro_ids(size, ctx.shape[0], noise.device)

    def model(x: Tensor, t: int) -> Tensor:
        tt = torch.full((2 * x.shape[0],), float(t), device=x.device)
        out = unet_forward(ops, cfg['unet'], torch.cat([x, x]), tt, ctx,
                           pool, tids)
        u, c = out.chunk(2)
        return u + scale * (c - u)

    x = dpmpp.sample(model, noise.float(), steps, cfg['scheduler'])
    return vae.decode(ops, cfg['vae'], x)
