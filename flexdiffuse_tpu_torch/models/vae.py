"""AutoencoderKL (SD v1.x VAE) as ``nn.Module``s (port of
``flexdiffuse_tpu/models/vae.py``).

Parameter names are diffusers' ``AutoencoderKL`` names with the current
attention naming (``to_q``/``to_k``/``to_v``/``to_out.0``) that
``flexdiffuse_tpu/weights/convert.py::convert_vae`` reads.

Public tensors keep the JAX layout: ``encode`` takes NHWC pixels and returns
NHWC ``(mean, logvar)``; ``decode`` takes NHWC latents and returns NHWC
pixels in fp32. Inside, everything runs NCHW; the transposes sit at those two
entry points and around the mid-block attention. GroupNorm eps is 1e-6 here
(the UNet's is 1e-5); every GroupNorm runs through K6 on the card, as in the
UNet. The 0.18215 latent scale lives in the pipeline. Under sequence
parallelism ``encode`` and ``decode`` take and return whole tensors, and
the encoder and decoder run each level as their
:class:`~flexdiffuse_tpu_torch.ops.row_shard.Plan` says (depth 0 the
pixel rows): on a sharded level the 3×3 convs take halo rows and the
GroupNorms reduce their statistics over the ranks, as in the UNet; the mid
attention rides the ring or gathers K/V (``ops/attention.py``); a level
that does not split runs whole.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn
import torch.nn.functional as F

from flexdiffuse_tpu_torch.models.configs import VAEConfig
from flexdiffuse_tpu_torch.models.unet import GroupNorm32, ResnetBlock
from flexdiffuse_tpu_torch.ops import row_shard
from flexdiffuse_tpu_torch.ops.attention import attention


def _resnet(in_ch: int, out_ch: int, groups: int) -> ResnetBlock:
    return ResnetBlock(in_ch, out_ch, groups, temb_dim=0, eps=1e-6)


class VAEAttention(nn.Module):
    """Single-head spatial self-attention (mid-block). NCHW in and out."""

    def __init__(self, channels: int, norm_groups: int) -> None:
        super().__init__()
        self.group_norm = GroupNorm32(norm_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        y = self.group_norm(x, self.to_q.weight.dtype)
        y = y.permute(0, 2, 3, 1).reshape(b, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        # A 512-wide head is not flash-eligible: this is plain attention.
        out = attention(q[:, None], k[:, None], v[:, None], c**-0.5)[:, 0]
        out = self.to_out[0](out)
        return x + out.reshape(b, h, w, c).permute(0, 3, 1, 2)


class _MidBlock(nn.Module):
    def __init__(self, ch: int, groups: int) -> None:
        super().__init__()
        self.resnets = nn.ModuleList([_resnet(ch, ch, groups),
                                      _resnet(ch, ch, groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, groups)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class _Resample(nn.Module):
    """Holds ``conv``: stride-2 with the torch VAE's asymmetric (0,1,0,1)
    pad (down) or nearest 2× then conv (up)."""

    def __init__(self, ch: int, down: bool) -> None:
        super().__init__()
        self.down = down
        self.conv = row_shard.Conv2d(ch, ch, 3, stride=2 if down else 1,
                                     padding=0 if down else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.down:
            # Under SP the bottom pad row is the conv's halo: the next
            # rank's first row (zeros on the last rank).
            sp = row_shard.sp_axis() is not None
            return self.conv(F.pad(x, (0, 1) if sp else (0, 1, 0, 1)))
        return self.conv(F.interpolate(x, scale_factor=2.0, mode='nearest'))


class _Block(nn.Module):
    def __init__(self, resnets, resample=None, down: bool = True) -> None:
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if resample is not None:
            name = 'downsamplers' if down else 'upsamplers'
            setattr(self, name, nn.ModuleList([resample]))


class Encoder(nn.Module):
    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        cfg = config
        g = cfg.norm_groups
        n = len(cfg.block_channels)
        self.conv_in = row_shard.Conv2d(cfg.in_channels,
                                        cfg.block_channels[0], 3, padding=1)
        blocks = []
        in_ch = cfg.block_channels[0]
        for i, ch in enumerate(cfg.block_channels):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(_resnet(in_ch, ch, g))
                in_ch = ch
            blocks.append(_Block(resnets, _Resample(ch, True)
                                 if i != n - 1 else None))
        self.down_blocks = nn.ModuleList(blocks)
        ch = cfg.block_channels[-1]
        self.mid_block = _MidBlock(ch, g)
        self.conv_norm_out = GroupNorm32(g, ch, eps=1e-6, silu=True)
        self.conv_out = row_shard.Conv2d(ch, 2 * cfg.latent_channels, 3,
                                         padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW pixels -> NCHW moments."""
        plan = row_shard.Plan(x.shape[2])
        h = plan.move(x, None, 0)
        with plan.at(0):
            h = self.conv_in(h)
        for i, blk in enumerate(self.down_blocks):
            with plan.at(i):
                for res in blk.resnets:
                    h = res(h)
            if hasattr(blk, 'downsamplers'):
                with plan.at(i + 1):
                    h = blk.downsamplers[0](plan.move(h, i, i + 1))
        deep = len(self.down_blocks) - 1
        with plan.at(deep):
            h = self.mid_block(h)
            h = self.conv_out(
                self.conv_norm_out(h, self.conv_out.weight.dtype))
        return plan.move(h, deep, None)


class Decoder(nn.Module):
    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        cfg = config
        g = cfg.norm_groups
        n = len(cfg.block_channels)
        ch = cfg.block_channels[-1]
        self.conv_in = row_shard.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _MidBlock(ch, g)
        blocks = []
        in_ch = ch
        for i, ch in enumerate(reversed(cfg.block_channels)):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(_resnet(in_ch, ch, g))
                in_ch = ch
            blocks.append(_Block(resnets, _Resample(ch, False)
                                 if i != n - 1 else None, down=False))
        self.up_blocks = nn.ModuleList(blocks)
        ch0 = cfg.block_channels[0]
        self.conv_norm_out = GroupNorm32(g, ch0, eps=1e-6, silu=True)
        self.conv_out = row_shard.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """NCHW latents -> NCHW pixels (fp32)."""
        deep = len(self.up_blocks) - 1
        plan = row_shard.Plan(z.shape[2] << deep)
        h = plan.move(z, None, deep)
        with plan.at(deep):
            h = self.mid_block(self.conv_in(h))
        for i, blk in enumerate(self.up_blocks):
            depth = deep - i
            with plan.at(depth):
                for res in blk.resnets:
                    h = res(h)
                if hasattr(blk, 'upsamplers'):
                    h = blk.upsamplers[0](h)
            if hasattr(blk, 'upsamplers'):
                h = plan.move(h, depth, depth - 1)
        with plan.at(0):
            h = self.conv_norm_out(h, self.conv_out.weight.dtype)
            h = self.conv_out(h).float()
        return plan.move(h, 0, None)


class AutoencoderKL(nn.Module):
    """``encode(pixels NHWC) -> (mean, logvar)``; ``decode(latents NHWC) ->
    pixels NHWC``. Posterior sampling is :func:`sample_latents`, with the
    noise passed in."""

    def __init__(self, config: VAEConfig) -> None:
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lc = config.latent_channels
        self.quant_conv = nn.Conv2d(2 * lc, 2 * lc, 1)
        self.post_quant_conv = nn.Conv2d(lc, lc, 1)

    def encode(self, pixels: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = self.quant_conv.weight.dtype
        x = pixels.permute(0, 3, 1, 2).to(dtype)
        moments = self.quant_conv(self.encoder(x)).float()
        mean, logvar = moments.permute(0, 2, 3, 1).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents.permute(0, 3, 1, 2).to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z)).permute(0, 2, 3, 1)


def sample_latents(mean: torch.Tensor, logvar: torch.Tensor,
                   noise: torch.Tensor) -> torch.Tensor:
    """Reparameterized posterior sample (diffusers
    ``DiagonalGaussianDistribution``) with caller-supplied unit noise."""
    return mean + torch.exp(0.5 * logvar) * noise
