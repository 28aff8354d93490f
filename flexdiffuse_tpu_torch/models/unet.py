"""SD v1.x conditional UNet as ``nn.Module``s (port of
``flexdiffuse_tpu/models/unet.py``, standard orientation only).

Parameter names are diffusers' ``UNet2DConditionModel`` names — the ones
``flexdiffuse_tpu/weights/convert.py::convert_unet`` reads — so a diffusers
checkpoint loads by a plain ``load_state_dict``.

Layouts: the public :meth:`UNet2DCondition.forward` keeps the JAX package's
NHWC latents ``[B, H, W, 4]``; inside, convolutions run NCHW (cuDNN's
layout). The transposes are at the UNet's entry and exit, and around the
transformer interiors (``Transformer2D``: NCHW -> ``[B, H·W, C]`` after
``proj_in`` and back before ``proj_out``).

Dtypes follow the JAX module: convs and matmuls in the weights' dtype (bf16
on the card), GroupNorm statistics in fp32, the timestep features in fp32,
and the returned ε in fp32. Self-attention goes through
:func:`flexdiffuse_tpu_torch.ops.attention.attention`, which sends the 4096-
and 1024-token levels to the Hopper flash kernel on CUDA. Every GroupNorm
(with the SiLU and the cast to the next layer's dtype that follow it) goes
through :func:`flexdiffuse_tpu_torch.ops.group_norm.group_norm`: the Hopper
kernel K6 on CUDA when no gradient is needed.

Left out here (later ROADMAP steps): the channel-major interiors, DeepCache,
PAG, FreeU, ToMe, IP-Adapter and ControlNet residuals, the LCM guidance
embedding and the SDXL additional embedding.
"""
from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F

from flexdiffuse_tpu_torch.models.configs import UNetConfig
from flexdiffuse_tpu_torch.ops.attention import attention
from flexdiffuse_tpu_torch.ops.group_norm import group_norm


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with fp32 statistics and affine (the JAX modules'
    ``GroupNorm(dtype=float32)``), then SiLU when built with ``silu``, the
    result cast to ``dtype`` (fp32 unless the caller names the dtype of the
    layer it feeds). Through :func:`~flexdiffuse_tpu_torch.ops.group_norm.
    group_norm`: K6 on the card when no gradient is needed, else the plain
    version."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, silu: bool = False) -> None:
        super().__init__(num_groups, num_channels, eps=eps)
        self.silu = silu

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return group_norm(x, self.num_groups, self.weight, self.bias,
                          self.eps, silu=self.silu, dtype=dtype)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep features ``[B] -> [B, dim]`` (SD: cos|sin order,
    max period 10000, no shift)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int) -> None:
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


class ResnetBlock(nn.Module):
    """GN→SiLU→conv, + time projection, GN→SiLU→conv, + (1×1) shortcut.
    NCHW in and out."""

    def __init__(self, in_channels: int, out_channels: int, norm_groups: int,
                 temb_dim: int = 0, eps: float = 1e-5) -> None:
        super().__init__()
        self.norm1 = GroupNorm32(norm_groups, in_channels, eps=eps, silu=True)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm32(norm_groups, out_channels, eps=eps,
                                 silu=True)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Conv2d(in_channels, out_channels, 1)

    def forward(self, x: torch.Tensor,
                temb: torch.Tensor = None) -> torch.Tensor:
        dtype = self.conv1.weight.dtype
        h = self.conv1(self.norm1(x, dtype))
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb).to(dtype))
            h = h + t[:, :, None, None]
        h = self.conv2(self.norm2(h, dtype))
        if hasattr(self, 'conv_shortcut'):
            x = self.conv_shortcut(x.to(dtype))
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention over ``[B, S, C]``; self-attention when
    ``context`` is None."""

    def __init__(self, query_dim: int, num_heads: int,
                 context_dim: int = 0) -> None:
        super().__init__()
        self.num_heads = num_heads
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor,
                context: torch.Tensor = None) -> torch.Tensor:
        ctx = x if context is None else context.to(x.dtype)
        q = self.to_q(x)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        b, sq, d = q.shape
        skv = k.shape[1]
        h = self.num_heads
        hd = d // h
        split = lambda t, s: t.reshape(b, s, h, hd).transpose(1, 2)
        out = attention(split(q, sq), split(k, skv), split(v, skv),
                        scale=hd**-0.5)
        out = out.transpose(1, 2).reshape(b, sq, d)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int) -> None:
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # diffusers GEGLU: first half times exact-erf gelu of the second.
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForwardGEGLU(nn.Module):
    """diffusers ``FeedForward``: ``net.0`` GEGLU, ``net.1`` dropout (none at
    inference), ``net.2`` the output projection."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        inner = dim * 4
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, context_dim: int) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, num_heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN → proj_in (1×1) → transformer blocks over ``[B, H·W, C]`` →
    proj_out (1×1) → + residual. NCHW in and out."""

    def __init__(self, channels: int, num_heads: int, depth: int,
                 norm_groups: int, context_dim: int) -> None:
        super().__init__()
        self.norm = GroupNorm32(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, num_heads, context_dim)
            for _ in range(depth))
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x, self.proj_in.weight.dtype))
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        for block in self.transformer_blocks:
            h = block(h, context)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class Downsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode='nearest'))


class _Level(nn.Module):
    """One down or up level: resnets, optional transformers, optional
    resampler (``downsamplers.0`` / ``upsamplers.0``)."""

    def __init__(self, resnets, attentions=None, downsample=None,
                 upsample=None) -> None:
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions is not None:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])


class UNet2DCondition(nn.Module):
    """``(latents [B,H,W,4], t [B], context [B,T,D]) -> eps [B,H,W,4]``."""

    def __init__(self, config: UNetConfig) -> None:
        super().__init__()
        if config.addition_embed or config.time_cond_proj_dim \
                or config.ip_adapter:
            raise NotImplementedError(
                'SDXL additional embeddings, the LCM guidance embedding and '
                'IP-Adapter layers are not ported yet (ROADMAP Queue 1 '
                'steps 9-11)')
        self.config = cfg = config
        ch0 = cfg.block_channels[0]
        temb_dim = ch0 * 4
        groups = cfg.norm_groups
        ctx = cfg.cross_attention_dim
        n = len(cfg.block_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = TimestepEmbedding(ch0, temb_dim)

        down = []
        in_ch = ch0
        for i, ch in enumerate(cfg.block_channels):
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(in_ch, ch, groups, temb_dim))
                in_ch = ch
                if cfg.attention_levels[i]:
                    attns.append(Transformer2D(ch, cfg.heads_for(ch),
                                               cfg.depth_at(i), groups, ctx))
            down.append(_Level(resnets, attns if attns else None,
                               downsample=(Downsample(ch)
                                           if i != n - 1 else None)))
        self.down_blocks = nn.ModuleList(down)

        mid = cfg.block_channels[-1]
        self.mid_block = _Level(
            [ResnetBlock(mid, mid, groups, temb_dim),
             ResnetBlock(mid, mid, groups, temb_dim)],
            [Transformer2D(mid, cfg.heads_for(mid), cfg.depth_mid(), groups,
                           ctx)])

        # Skip channels in the order run_up pops them.
        skip_ch = [ch0]
        for i, ch in enumerate(cfg.block_channels):
            skip_ch += [ch] * cfg.layers_per_block
            if i != n - 1:
                skip_ch.append(ch)
        up = []
        prev = mid
        for i, ch in enumerate(reversed(cfg.block_channels)):
            level = n - 1 - i
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(prev + skip_ch.pop(), ch, groups,
                                           temb_dim))
                prev = ch
                if cfg.attention_levels[level]:
                    attns.append(Transformer2D(ch, cfg.heads_for(ch),
                                               cfg.depth_at(level), groups,
                                               ctx))
            up.append(_Level(resnets, attns if attns else None,
                             upsample=Upsample(ch) if i != n - 1 else None))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm32(groups, ch0, eps=1e-5, silu=True)
        self.conv_out = nn.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor) -> torch.Tensor:
        dtype = self.conv_in.weight.dtype
        temb = timestep_embedding(t, self.config.block_channels[0])
        temb = self.time_embedding(temb.to(dtype))
        context = context.to(dtype)
        # NHWC (public layout) -> NCHW (conv layout).
        h = self.conv_in(latents.permute(0, 3, 1, 2).to(dtype))

        skips = [h]
        for blk in self.down_blocks:
            attns = getattr(blk, 'attentions', None)
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if attns is not None:
                    h = attns[j](h, context)
                skips.append(h)
            if hasattr(blk, 'downsamplers'):
                h = blk.downsamplers[0](h)
                skips.append(h)

        mb = self.mid_block
        h = mb.resnets[0](h, temb)
        h = mb.attentions[0](h, context)
        h = mb.resnets[1](h, temb)

        for blk in self.up_blocks:
            attns = getattr(blk, 'attentions', None)
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if attns is not None:
                    h = attns[j](h, context)
            if hasattr(blk, 'upsamplers'):
                h = blk.upsamplers[0](h)

        eps = self.conv_out(self.conv_norm_out(h, dtype)).float()
        return eps.permute(0, 2, 3, 1)                   # NCHW -> NHWC
