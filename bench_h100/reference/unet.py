"""The Stable Diffusion conditional UNet (Rombach et al. 2022; diffusers'
``UNet2DConditionModel`` with SD-1.x/2.x settings): a sinusoidal timestep
embedding through two linears, ``layers_per_block`` ResNet blocks per
level (with a spatial transformer after each on the attention levels),
stride-2 downsampling, a mid block (ResNet, transformer, ResNet), a
decoder with ``layers_per_block + 1`` blocks per level over the
concatenated skips, nearest 2× upsampling, GroupNorm-SiLU and the output
convolution. Transformers: GroupNorm (eps 1e-6), 1×1 ``proj_in``, blocks
of self-attention, cross-attention to the text context and a GEGLU MLP,
each pre-LayerNorm and residual, 1×1 ``proj_out``, residual. SD-2.x's
linear ``proj_in``/``proj_out`` are the same map as a 1×1 convolution
(the weights are stored ``[C, C, 1, 1]``).

Config keys (``configs/<name>.json``, group ``unet``): ``block_channels``,
``layers_per_block``, ``attention_levels``, ``transformer_depth`` (one
depth for every level), ``num_heads`` or ``head_dim``,
``cross_attention_dim``, ``norm_groups``, ``in_channels``,
``out_channels``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference.ops import (Ops, attention, heads, merge_heads,
                                      sinusoid)

Tensor = torch.Tensor


def _heads(cfg: dict, ch: int) -> int:
    return ch // cfg['head_dim'] if cfg.get('head_dim') else cfg['num_heads']


def resnet(ops: Ops, name: str, x: Tensor, c_out: int, groups: int,
           eps: float, temb: Tensor = None) -> Tensor:
    c_in = x.shape[1]
    h = ops.conv(ops.group_norm(x, f'{name}.norm1', groups, eps, silu=True),
                 f'{name}.conv1', c_in, c_out, 3, padding=1)
    if temb is not None:
        h = h + ops.linear(F.silu(temb), f'{name}.time_emb_proj',
                           temb.shape[1], c_out)[:, :, None, None]
    h = ops.conv(ops.group_norm(h, f'{name}.norm2', groups, eps, silu=True),
                 f'{name}.conv2', c_out, c_out, 3, padding=1)
    if c_in != c_out:
        x = ops.conv(x, f'{name}.conv_shortcut', c_in, c_out, 1)
    return x + h


def cross_attention(ops: Ops, name: str, x: Tensor, ctx: Tensor,
                    n_heads: int) -> Tensor:
    b, _, c = x.shape
    q = heads(ops.linear(x, f'{name}.to_q', c, c, bias=False), n_heads)
    k = heads(ops.linear(ctx, f'{name}.to_k', ctx.shape[-1], c, bias=False),
              n_heads)
    v = heads(ops.linear(ctx, f'{name}.to_v', ctx.shape[-1], c, bias=False),
              n_heads)
    o = merge_heads(attention(q, k, v, (c // n_heads)**-0.5), b)
    return ops.linear(o, f'{name}.to_out.0', c, c)


def transformer(ops: Ops, name: str, x: Tensor, ctx: Tensor, n_heads: int,
                groups: int, depth: int) -> Tensor:
    b, c, hh, ww = x.shape
    h = ops.group_norm(x, f'{name}.norm', groups, 1e-6)
    h = ops.conv(h, f'{name}.proj_in', c, c, 1)
    h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    for d in range(depth):
        bp = f'{name}.transformer_blocks.{d}'
        y = ops.layer_norm(h, f'{bp}.norm1')
        h = h + cross_attention(ops, f'{bp}.attn1', y, y, n_heads)
        h = h + cross_attention(ops, f'{bp}.attn2',
                                ops.layer_norm(h, f'{bp}.norm2'), ctx,
                                n_heads)
        y = ops.linear(ops.layer_norm(h, f'{bp}.norm3'),
                       f'{bp}.ff.net.0.proj', c, 8 * c)
        val, gate = y.chunk(2, dim=-1)
        h = h + ops.linear(val * F.gelu(gate), f'{bp}.ff.net.2', 4 * c, c)
    h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
    return ops.conv(h, f'{name}.proj_out', c, c, 1) + x


def forward(ops: Ops, cfg: dict, latents: Tensor, t: Tensor,
            ctx: Tensor) -> Tensor:
    """``latents`` NHWC ``[B, H, W, in_channels]``, ``t`` ``[B]``, ``ctx``
    ``[B, T, cross_attention_dim]`` → the prediction NHWC fp32."""
    chans = cfg['block_channels']
    lpb, groups, levels = (cfg['layers_per_block'], cfg['norm_groups'],
                           cfg['attention_levels'])
    depth = cfg['transformer_depth']
    n = len(chans)
    ch0 = chans[0]
    temb = sinusoid(t, ch0)
    temb = ops.linear(temb, 'time_embedding.linear_1', ch0, 4 * ch0)
    temb = ops.linear(F.silu(temb), 'time_embedding.linear_2', 4 * ch0,
                      4 * ch0)
    h = ops.conv(latents.permute(0, 3, 1, 2).float(), 'conv_in',
                 cfg['in_channels'], ch0, 3, padding=1)
    skips = [h]
    for i, ch in enumerate(chans):
        for j in range(lpb):
            h = resnet(ops, f'down_blocks.{i}.resnets.{j}', h, ch, groups,
                       1e-5, temb)
            if levels[i]:
                h = transformer(ops, f'down_blocks.{i}.attentions.{j}', h,
                                ctx, _heads(cfg, ch), groups, depth)
            skips.append(h)
        if i != n - 1:
            h = ops.conv(h, f'down_blocks.{i}.downsamplers.0.conv', ch, ch,
                         3, stride=2, padding=1)
            skips.append(h)
    mid = chans[-1]
    h = resnet(ops, 'mid_block.resnets.0', h, mid, groups, 1e-5, temb)
    h = transformer(ops, 'mid_block.attentions.0', h, ctx, _heads(cfg, mid),
                    groups, depth)
    h = resnet(ops, 'mid_block.resnets.1', h, mid, groups, 1e-5, temb)
    for i, ch in enumerate(reversed(chans)):
        level = n - 1 - i
        for j in range(lpb + 1):
            h = resnet(ops, f'up_blocks.{i}.resnets.{j}',
                       torch.cat([h, skips.pop()], dim=1), ch, groups, 1e-5,
                       temb)
            if levels[level]:
                h = transformer(ops, f'up_blocks.{i}.attentions.{j}', h, ctx,
                                _heads(cfg, ch), groups, depth)
        if i != n - 1:
            h = ops.conv(F.interpolate(h, scale_factor=2.0, mode='nearest'),
                         f'up_blocks.{i}.upsamplers.0.conv', ch, ch, 3,
                         padding=1)
    h = ops.group_norm(h, 'conv_norm_out', groups, 1e-5, silu=True)
    h = ops.conv(h, 'conv_out', ch0, cfg['out_channels'], 3, padding=1)
    return h.permute(0, 2, 3, 1)
