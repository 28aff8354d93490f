"""ControlNet: spatial conditioning for the SD UNet (port of
``flexdiffuse_tpu/models/controlnet.py``).

A copy of the UNet's down and mid path (:class:`~flexdiffuse_tpu_torch.
models.unet.DownMid`: the same blocks and names, so its self-attentions
reach K1 through ``ops/attention.py`` and its GroupNorms K6 on the card)
whose 1×1 "zero" convolutions turn every skip state and the mid output into
residuals the UNet adds to its own (``UNet2DCondition.forward(control=)``).
The control image enters through :class:`ConditioningEmbedding`, a ramp of
stride-2 convolutions from pixel to latent resolution.

Parameter names are diffusers' ``ControlNetModel`` names
(``controlnet_cond_embedding.*``, ``controlnet_down_blocks.{k}``,
``controlnet_mid_block``, and an SDXL ControlNet's ``add_embedding``), so
a diffusers snapshot loads by
``load_state_dict`` after ``weights.convert.normalize(sd, 'controlnet')``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from flexdiffuse_tpu_torch.models.configs import UNetConfig
from flexdiffuse_tpu_torch.models.unet import DownMid
from flexdiffuse_tpu_torch.ops import row_shard

# Conditioning-embedding channel ramp (diffusers
# ControlNetConditioningEmbedding's default block_out_channels).
COND_EMBED_CHANNELS = (16, 32, 96, 256)


class ConditioningEmbedding(nn.Module):
    """Control image (NCHW, pixel space, [0, 1]) → latent-resolution
    features: ``conv_in``, then per step of the ramp a 3×3 conv and a
    stride-2 3×3 conv (``blocks``), each followed by SiLU, then
    ``conv_out``."""

    def __init__(self, out_channels: int,
                 channels: Tuple[int, ...] = COND_EMBED_CHANNELS) -> None:
        super().__init__()
        self.conv_in = row_shard.Conv2d(3, channels[0], 3, padding=1)
        blocks = []
        for i in range(len(channels) - 1):
            blocks.append(row_shard.Conv2d(channels[i], channels[i], 3,
                                           padding=1))
            blocks.append(row_shard.Conv2d(channels[i], channels[i + 1], 3,
                                           padding=1, stride=2))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = row_shard.Conv2d(channels[-1], out_channels, 3,
                                         padding=1)

    def forward(self, cond: torch.Tensor, plan) -> torch.Tensor:
        """Whole ``cond`` → the features laid out for ``plan``'s level 0
        (the latent grid; the ramp's k stride-2 steps run from level −k)."""
        k = len(self.blocks) // 2
        h = plan.move(cond, None, -k)
        with plan.at(-k):
            h = F.silu(self.conv_in(h))
        for j in range(k):
            depth = j - k
            with plan.at(depth):
                h = F.silu(self.blocks[2 * j](h))
            with plan.at(depth + 1):
                h = F.silu(self.blocks[2 * j + 1](
                    plan.move(h, depth, depth + 1)))
        with plan.at(0):
            return self.conv_out(h)


class ControlNetModel(DownMid):
    """``(latents [B,h,w,4], t [B], context [B,T,D], cond [B or 1,H,W,3],
    scale) -> (down_residuals, mid_residual)`` (NCHW, one residual per UNet
    skip state).

    ``config`` is the paired UNet's :class:`UNetConfig` (its IP-Adapter
    layers and LCM guidance projection are not the control branch's);
    ``latents`` are the 4 latent channels (the pipeline strips a 9- or
    8-channel UNet's extras); ``cond`` is the control image NHWC in [0, 1]
    at pixel resolution (``2^(len(cond_channels)-1)`` times the latent
    grid: 8 for SD)."""

    def __init__(self, config: UNetConfig,
                 cond_channels: Tuple[int, ...] = COND_EMBED_CHANNELS
                 ) -> None:
        super().__init__()
        self.config = cfg = dataclasses.replace(config, ip_adapter=False,
                                                time_cond_proj_dim=0)
        ch0 = cfg.block_channels[0]
        self.conv_in = row_shard.Conv2d(4, ch0, 3, padding=1)
        temb_dim = self._build_time(cfg)
        self.controlnet_cond_embedding = ConditioningEmbedding(
            ch0, tuple(cond_channels))
        self._build_down_mid(cfg, temb_dim)
        skip_ch = [ch0]
        n = len(cfg.block_channels)
        for i, ch in enumerate(cfg.block_channels):
            skip_ch += [ch] * cfg.layers_per_block
            if i != n - 1:
                skip_ch.append(ch)
        self.controlnet_down_blocks = nn.ModuleList(
            nn.Conv2d(c, c, 1) for c in skip_ch)
        mid = cfg.block_channels[-1]
        self.controlnet_mid_block = nn.Conv2d(mid, mid, 1)

    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, cond: torch.Tensor, scale=1.0,
                added_cond=None):
        """``added_cond``: SDXL's ``{'text_embeds', 'time_ids'}``, which
        the ControlNet of an ``addition_embed`` UNet requires (its
        ``add_embedding``, as the UNet's)."""
        dtype = self.conv_in.weight.dtype
        temb = self.embed_time(t, added_cond=added_cond)
        context = context.to(dtype)
        # The UNet's plan for the same latent rows: the residuals are laid
        # out level by level as its skips are.
        plan = row_shard.Plan(latents.shape[1])
        # NHWC (public layout) -> NCHW; on the card the permuted views are
        # channels-last, and so is everything the convs make of them.
        h = plan.move(latents.permute(0, 3, 1, 2).to(dtype), None, 0)
        with plan.at(0):
            h = self.conv_in(h)
        h = h + self.controlnet_cond_embedding(
            cond.permute(0, 3, 1, 2).to(h.device, dtype), plan)
        h, skips = self.run_down(h, temb, context,
                                 len(self.config.block_channels), plan=plan)
        h = self.run_mid(h, temb, context, plan=plan)
        # The scale in the weights' dtype, as the JAX module casts it.
        scale = torch.as_tensor(scale, dtype=dtype, device=h.device)
        down = tuple(conv(s) * scale
                     for conv, s in zip(self.controlnet_down_blocks, skips))
        return down, self.controlnet_mid_block(h) * scale
