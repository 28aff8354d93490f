"""The AutoencoderKL decoder of Stable Diffusion (Rombach et al. 2022;
diffusers' names): latents divided by the latent scale, the 1×1
``post_quant_conv``, ``conv_in``, a mid block (ResNet, single-head
attention over every pixel, ResNet), ``layers_per_block + 1`` ResNet
blocks per level from the widest, nearest 2× upsampling between levels,
GroupNorm-SiLU and ``conv_out``; GroupNorm eps 1e-6. The pixels map to
``[0, 1]`` as ``clamp(x/2 + 1/2, 0, 1)``.

Config keys (group ``vae``): ``block_channels``, ``layers_per_block``,
``norm_groups``, ``latent_channels``, ``out_channels``, ``latent_scale``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference.ops import Ops, attention
from bench_h100.reference.unet import resnet

Tensor = torch.Tensor


def _mid_attention(ops: Ops, name: str, x: Tensor, groups: int) -> Tensor:
    b, c, hh, ww = x.shape
    y = ops.group_norm(x, f'{name}.group_norm', groups, 1e-6)
    y = y.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
    q = ops.linear(y, f'{name}.to_q', c, c)
    k = ops.linear(y, f'{name}.to_k', c, c)
    v = ops.linear(y, f'{name}.to_v', c, c)
    o = ops.linear(attention(q, k, v, c**-0.5), f'{name}.to_out.0', c, c)
    return x + o.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


def decode(ops: Ops, cfg: dict, latents: Tensor) -> Tensor:
    """Scaled latents NHWC ``[B, h, w, C]`` → pixels NHWC in ``[0, 1]``
    fp32."""
    chans = list(reversed(cfg['block_channels']))
    g, lc = cfg['norm_groups'], cfg['latent_channels']
    z = latents.permute(0, 3, 1, 2).float() / cfg['latent_scale']
    z = ops.conv(z, 'post_quant_conv', lc, lc, 1)
    p = 'decoder.'
    h = ops.conv(z, p + 'conv_in', lc, chans[0], 3, padding=1)
    h = resnet(ops, p + 'mid_block.resnets.0', h, chans[0], g, 1e-6)
    h = _mid_attention(ops, p + 'mid_block.attentions.0', h, g)
    h = resnet(ops, p + 'mid_block.resnets.1', h, chans[0], g, 1e-6)
    for i, ch in enumerate(chans):
        for j in range(cfg['layers_per_block'] + 1):
            h = resnet(ops, f'{p}up_blocks.{i}.resnets.{j}', h, ch, g, 1e-6)
        if i != len(chans) - 1:
            h = ops.conv(F.interpolate(h, scale_factor=2.0, mode='nearest'),
                         f'{p}up_blocks.{i}.upsamplers.0.conv', ch, ch, 3,
                         padding=1)
    h = ops.group_norm(h, p + 'conv_norm_out', g, 1e-6, silu=True)
    h = ops.conv(h, p + 'conv_out', chans[-1], cfg['out_channels'], 3,
                 padding=1)
    return torch.clamp(h / 2.0 + 0.5, 0.0, 1.0).permute(0, 2, 3, 1)
