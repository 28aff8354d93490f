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

The sampling features of the JAX module, as call-time settings of
:class:`UNet2DCondition` (``freeu``, ``tome``, ``pag_layers``; plain
attributes, so a shallow copy of the module shares the weights and carries
its own settings) and arguments of its forward (``timestep_cond``,
``cache_mode``/``deep_cache``, ``pag_mask``): FreeU, ToMe, PAG, DeepCache
and the LCM guidance embedding. SDXL's text-time additional embedding
(``config.addition_embed``: the pooled text embedding and the
micro-conditioning time ids, ``added_cond``) joins the timestep embedding
(:meth:`DownMid.embed_time`), so every path the timestep embedding reaches
carries it. The conditioning models: IP-Adapter's
decoupled cross-attention (``config.ip_adapter``; ``ip_ctx``/``ip_scale``)
and ControlNet residuals (``control``). The down and mid path
(:class:`DownMid`) is shared with the ControlNet's control branch
(``models/controlnet.py``), blocks and names alike.

Sequence parallelism (``ops/attention.py`` ``sp_context``): the forward
takes and returns whole tensors and runs each level as its
:class:`~flexdiffuse_tpu_torch.ops.row_shard.Plan` says (the ``plan``
of :meth:`DownMid.run_down`, :meth:`DownMid.run_mid` and
:meth:`UNet2DCondition.run_up`; levels by depth, 0 the latent grid). On a
sharded level the activations are this rank's rows; the 3×3 convs are
:class:`~flexdiffuse_tpu_torch.ops.row_shard.Conv2d` (halo rows from the
neighbouring ranks) and every GroupNorm runs through
:func:`~flexdiffuse_tpu_torch.ops.row_shard.group_norm` (statistics over
the ranks, the plain path: no K6); FreeU's filter sees the whole map. A
level that does not split runs whole, as without SP; a Downsample into it
takes the gathered rows, and the Upsample out of it gives the next
level its rows.

Left out here: the channel-major interiors (ROADMAP "do not port").
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn
import torch.nn.functional as F

from flexdiffuse_tpu_torch.models.configs import UNetConfig
from flexdiffuse_tpu_torch.ops import row_shard
from flexdiffuse_tpu_torch.ops import tome as _tome
from flexdiffuse_tpu_torch.ops.attention import attention
from flexdiffuse_tpu_torch.ops.group_norm import group_norm


class GroupNorm32(nn.GroupNorm):
    """GroupNorm with fp32 statistics and affine (the JAX modules'
    ``GroupNorm(dtype=float32)``), then SiLU when built with ``silu``, the
    result cast to ``dtype`` (fp32 unless the caller names the dtype of the
    layer it feeds). Through :func:`~flexdiffuse_tpu_torch.ops.group_norm.
    group_norm`: K6 on the card when no gradient is needed, else the plain
    version; under sequence parallelism :func:`~flexdiffuse_tpu_torch.ops.
    row_shard.group_norm` (statistics over the ranks, plain)."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, silu: bool = False) -> None:
        super().__init__(num_groups, num_channels, eps=eps)
        self.silu = silu

    def forward(self, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
        norm = row_shard.group_norm if row_shard.sp_axis() is not None \
            else group_norm
        return norm(x, self.num_groups, self.weight, self.bias,
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


def guidance_scale_embedding(w: torch.Tensor, dim: int) -> torch.Tensor:
    """LCM guidance-scale embedding ``[B] -> [B, dim]`` fp32 (``w`` is the
    conditioning scale, conventionally ``guidance_scale - 1``): scaled by
    1000, log-spaced sin|cos features (diffusers'
    ``get_guidance_scale_embedding``; not the timestep's cos|sin order)."""
    w = torch.as_tensor(w, dtype=torch.float32) * 1000.0
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) *
                      torch.arange(half, dtype=torch.float32,
                                   device=w.device) / (half - 1))
    args = w.reshape(-1, 1) * freqs[None]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def fourier_filter(x: torch.Tensor, threshold: int,
                   scale: float) -> torch.Tensor:
    """FreeU's low-frequency skip attenuation on NCHW ``x``: a 2-D FFT over
    the spatial dims (2, 3), the ``threshold``-radius block around DC
    scaled by ``scale``, the inverse FFT's real part; in fp32 (cuFFT takes
    no bf16) and cast back. Under sequence parallelism the filter runs on
    the whole map, and each rank keeps its rows."""
    from flexdiffuse_tpu_torch.parallel.axis import gather, local
    dtype, sp = x.dtype, row_shard.sp_axis()
    if sp is not None:
        x = gather(x, sp, 2)
    _, _, hh, ww = x.shape
    xf = torch.fft.fftshift(torch.fft.fft2(x.float(), dim=(2, 3)),
                            dim=(2, 3))
    mask = torch.ones((1, 1, hh, ww), dtype=torch.float32)
    cr, cc = hh // 2, ww // 2
    mask[:, :, max(cr - threshold, 0):cr + threshold,
         max(cc - threshold, 0):cc + threshold] = scale
    xf = xf * mask.to(x.device)
    out = torch.fft.ifft2(torch.fft.ifftshift(xf, dim=(2, 3)),
                          dim=(2, 3)).real
    if sp is not None:
        out = local(out, sp, 2)
    return out.to(dtype)


def pag_selected(pag_layers, name: str) -> bool:
    """PAG layer selection by the JAX module's transformer names: a pattern
    matches by prefix (``'mid'`` hits ``mid_attn``, ``'down_1'`` every
    ``down_1_attn_*``, ``'up_2_attn_1'`` exactly one)."""
    return pag_layers is not None and any(
        name.startswith(p) for p in pag_layers)


class TimestepEmbedding(nn.Module):
    """``linear_2(silu(linear_1(x)))``; with ``cond_dim`` the LCM guidance
    projection ``cond_proj`` (bias-free, applied by the UNet in fp32 to the
    sinusoidal features before ``linear_1``)."""

    def __init__(self, in_dim: int, dim: int, cond_dim: int = 0) -> None:
        super().__init__()
        if cond_dim:
            self.cond_proj = nn.Linear(cond_dim, in_dim, bias=False)
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(x)))


def addition_in_dim(cfg: UNetConfig) -> int:
    """``add_embedding.linear_1``'s input width: the pooled text embedding
    and ``num_time_ids`` sinusoidal features of ``addition_time_embed_dim``
    (SDXL base 1280 + 6·256 = 2816, the refiner 1280 + 5·256 = 2560)."""
    return cfg.addition_pooled_dim + cfg.num_time_ids * \
        cfg.addition_time_embed_dim


class ResnetBlock(nn.Module):
    """GN→SiLU→conv, + time projection, GN→SiLU→conv, + (1×1) shortcut.
    NCHW in and out."""

    def __init__(self, in_channels: int, out_channels: int, norm_groups: int,
                 temb_dim: int = 0, eps: float = 1e-5) -> None:
        super().__init__()
        self.norm1 = GroupNorm32(norm_groups, in_channels, eps=eps, silu=True)
        self.conv1 = row_shard.Conv2d(in_channels, out_channels, 3,
                                      padding=1)
        if temb_dim:
            self.time_emb_proj = nn.Linear(temb_dim, out_channels)
        self.norm2 = GroupNorm32(norm_groups, out_channels, eps=eps,
                                 silu=True)
        self.conv2 = row_shard.Conv2d(out_channels, out_channels, 3,
                                      padding=1)
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
    ``context`` is None. With ``ip_adapter`` (cross-attention only) the
    IP-Adapter projections ``to_k_ip``/``to_v_ip`` attend over the image
    tokens."""

    def __init__(self, query_dim: int, num_heads: int,
                 context_dim: int = 0, ip_adapter: bool = False) -> None:
        super().__init__()
        self.num_heads = num_heads
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, query_dim, bias=False)
        self.to_k = nn.Linear(ctx, query_dim, bias=False)
        self.to_v = nn.Linear(ctx, query_dim, bias=False)
        if ip_adapter:
            self.to_k_ip = nn.Linear(ctx, query_dim, bias=False)
            self.to_v_ip = nn.Linear(ctx, query_dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(query_dim, query_dim)])

    def forward(self, x: torch.Tensor, context: torch.Tensor = None,
                pag_mask: torch.Tensor = None, ip=None) -> torch.Tensor:
        """``pag_mask`` (PAG, self-attention only): a ``[B]`` 0/1 row
        selector; the rows with 1 replace the attention map with the
        identity, whose output before ``to_out`` is the projected v, taken
        after the attention ran on every row.

        ``ip`` (IP-Adapter, cross-attention only): ``(ip_ctx [B, N, D],
        ip_scale)``; the output before ``to_out`` becomes ``out + ip_scale ·
        attention(q, k_ip, v_ip)``."""
        ctx = x if context is None else context.to(x.dtype)
        q = self.to_q(x)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        b, sq, d = q.shape
        skv = k.shape[1]
        h = self.num_heads
        hd = d // h
        split = lambda t, s: t.reshape(b, s, h, hd).transpose(1, 2)
        qh = split(q, sq)
        out = attention(qh, split(k, skv), split(v, skv), scale=hd**-0.5)
        if (ip is not None and context is not None
                and hasattr(self, 'to_k_ip')):
            ip_ctx, ip_scale = ip
            ip_ctx = ip_ctx.to(x.device, x.dtype)
            n = ip_ctx.shape[1]
            out_ip = attention(qh, split(self.to_k_ip(ip_ctx), n),
                               split(self.to_v_ip(ip_ctx), n),
                               scale=hd**-0.5)
            # The scale in the output's dtype, as the JAX module casts it.
            out = out + torch.as_tensor(ip_scale, dtype=out.dtype,
                                        device=out.device) * out_ip
        out = out.transpose(1, 2).reshape(b, sq, d)
        if pag_mask is not None and context is None:
            out = torch.where(pag_mask.to(out.device)[:, None, None] > 0, v,
                              out)
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
    def __init__(self, dim: int, num_heads: int, context_dim: int,
                 ip_adapter: bool = False) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, num_heads, context_dim, ip_adapter)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForwardGEGLU(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                tome_plan: _tome.TomePlan = None,
                pag_mask: torch.Tensor = None, ip=None) -> torch.Tensor:
        """With ``tome_plan`` the self-attention runs on the merged rows and
        its output is copied back; cross-attention and the MLP stay full
        length."""
        if tome_plan is None:
            x = x + self.attn1(self.norm1(x), pag_mask=pag_mask)
        else:
            xa = _tome.merge(self.norm1(x), tome_plan)
            x = x + _tome.unmerge(self.attn1(xa, pag_mask=pag_mask),
                                  tome_plan)
        x = x + self.attn2(self.norm2(x), context, ip=ip)
        return x + self.ff(self.norm3(x))


class Transformer2D(nn.Module):
    """GN → proj_in (1×1) → transformer blocks over ``[B, H·W, C]`` →
    proj_out (1×1) → + residual. NCHW in and out."""

    def __init__(self, channels: int, num_heads: int, depth: int,
                 norm_groups: int, context_dim: int,
                 ip_adapter: bool = False) -> None:
        super().__init__()
        self.norm = GroupNorm32(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, num_heads, context_dim,
                                  ip_adapter)
            for _ in range(depth))
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor,
                tome=None, pag_mask: torch.Tensor = None,
                ip=None) -> torch.Tensor:
        """``tome``: ``(ratio, min_seq)``; a grid of at least ``min_seq``
        tokens merges before every self-attention, one plan shared by the
        blocks (built from the hidden state after ``proj_in``)."""
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x, self.proj_in.weight.dtype))
        h = h.permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        plan = None
        if tome is not None:
            ratio, min_seq = tome
            r = _tome.resolve_r(hh, ww, float(ratio))
            if hh * ww >= max(int(min_seq), 2) and r > 0:
                plan = _tome.merge_plan(h, (hh, ww), r)
        for block in self.transformer_blocks:
            h = block(h, context, plan, pag_mask, ip)
        h = h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)
        return self.proj_out(h) + x


class Downsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = row_shard.Conv2d(channels, channels, 3, stride=2,
                                     padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int) -> None:
        super().__init__()
        self.conv = row_shard.Conv2d(channels, channels, 3, padding=1)

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


def _transformer(cfg: UNetConfig, ch: int, depth: int) -> Transformer2D:
    return Transformer2D(ch, cfg.heads_for(ch), depth, cfg.norm_groups,
                         cfg.cross_attention_dim, cfg.ip_adapter)


class DownMid(nn.Module):
    """The UNet's time embedding and down and mid path (``down_blocks``,
    ``mid_block``), shared by :class:`UNet2DCondition` and the ControlNet's
    control branch (``models/controlnet.py``), as the JAX package shares
    ``run_down_mid``: one definition, one set of names. The sampling
    settings ``tome`` and ``pag_layers`` are read by :meth:`_attn` (None
    on the control branch, which the JAX package never perturbs)."""

    tome = None
    pag_layers = None

    def _build_time(self, cfg: UNetConfig, cond_dim: int = 0) -> int:
        """``time_embedding`` (with the LCM projection when ``cond_dim``)
        and, for an ``addition_embed`` config, SDXL's ``add_embedding``;
        returns the embedding width."""
        ch0 = cfg.block_channels[0]
        temb_dim = ch0 * 4
        self.time_embedding = TimestepEmbedding(ch0, temb_dim, cond_dim)
        if cfg.addition_embed:
            self.add_embedding = TimestepEmbedding(addition_in_dim(cfg),
                                                   temb_dim)
        return temb_dim

    def _build_down_mid(self, cfg: UNetConfig, temb_dim: int) -> None:
        groups = cfg.norm_groups
        n = len(cfg.block_channels)
        down = []
        in_ch = cfg.block_channels[0]
        for i, ch in enumerate(cfg.block_channels):
            resnets, attns = [], []
            for j in range(cfg.layers_per_block):
                resnets.append(ResnetBlock(in_ch, ch, groups, temb_dim))
                in_ch = ch
                if cfg.attention_levels[i]:
                    attns.append(_transformer(cfg, ch, cfg.depth_at(i)))
            down.append(_Level(resnets, attns if attns else None,
                               downsample=(Downsample(ch)
                                           if i != n - 1 else None)))
        self.down_blocks = nn.ModuleList(down)
        mid = cfg.block_channels[-1]
        self.mid_block = _Level(
            [ResnetBlock(mid, mid, groups, temb_dim),
             ResnetBlock(mid, mid, groups, temb_dim)],
            [_transformer(cfg, mid, cfg.depth_mid())])

    def embed_time(self, t: torch.Tensor,
                   timestep_cond: torch.Tensor = None,
                   added_cond: dict = None) -> torch.Tensor:
        """The timestep embedding ``[B, 4·C0]`` in the weights' dtype (with
        the LCM guidance projection when the config has one). An
        ``addition_embed`` config requires ``added_cond`` ``{'text_embeds':
        [B, addition_pooled_dim], 'time_ids': [B, num_time_ids]}``: each id's
        sinusoidal features at ``addition_time_embed_dim``, flattened after
        the pooled embedding (fp32, as the JAX module concatenates), through
        ``add_embedding``, added to the timestep embedding."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        temb = timestep_embedding(t, cfg.block_channels[0])
        if cfg.time_cond_proj_dim:
            if timestep_cond is None:
                raise ValueError(
                    'this UNet config requires timestep_cond (the LCM '
                    'guidance embedding, guidance_scale_embedding)')
            proj = self.time_embedding.cond_proj.weight
            temb = temb + F.linear(timestep_cond.float().to(temb.device),
                                   proj.float())
        temb = self.time_embedding(temb.to(dtype))
        if not cfg.addition_embed:
            return temb
        if added_cond is None:
            raise ValueError('this UNet config requires added_cond '
                             '(text_embeds, time_ids)')
        pooled = added_cond['text_embeds'].to(temb.device, torch.float32)
        tids = added_cond['time_ids'].to(temb.device).reshape(-1)
        tid_emb = timestep_embedding(tids, cfg.addition_time_embed_dim)
        add = torch.cat([pooled, tid_emb.reshape(pooled.shape[0], -1)],
                        dim=-1)
        return temb + self.add_embedding(add.to(dtype))

    def _pm(self, name: str, pag_mask):
        return pag_mask if pag_selected(self.pag_layers, name) else None

    def _attn(self, attn, name: str, h, context, pag_mask, ip=None):
        return attn(h, context, self.tome, self._pm(name, pag_mask), ip)

    def run_down(self, h, temb, context, levels: int, pag_mask=None,
                 ip=None, *, plan):
        """The first ``levels`` encoder levels, each as ``plan`` lays it
        out; returns ``(h, skips)``. The downsample of level ``levels - 1``
        is skipped (a DeepCache shallow pass: its skip feeds a decoder
        level the cache replaces)."""
        skips = [h]
        for i in range(levels):
            blk = self.down_blocks[i]
            attns = getattr(blk, 'attentions', None)
            with plan.at(i):
                for j, res in enumerate(blk.resnets):
                    h = res(h, temb)
                    if attns is not None:
                        h = self._attn(attns[j], f'down_{i}_attn_{j}', h,
                                       context, pag_mask, ip)
                    skips.append(h)
            if hasattr(blk, 'downsamplers') and i < levels - 1:
                with plan.at(i + 1):
                    h = blk.downsamplers[0](plan.move(h, i, i + 1))
                skips.append(h)
        return h, skips

    def run_mid(self, h, temb, context, pag_mask=None, ip=None, *, plan):
        mb = self.mid_block
        with plan.at(len(self.down_blocks) - 1):
            h = mb.resnets[0](h, temb)
            h = self._attn(mb.attentions[0], 'mid_attn', h, context,
                           pag_mask, ip)
            return mb.resnets[1](h, temb)


class UNet2DCondition(DownMid):
    """``(latents [B,H,W,C], t [B], context [B,T,D]) -> eps [B,H,W,4]``.

    Sampling settings (None: off), read at every call:

    - ``freeu`` ``(b1, b2, s1, s2)``: amplify the first half of the
      backbone channels and Fourier-attenuate the skips at the two deepest
      decoder levels (SD-1.x's published 1.5/1.6/0.9/0.2);
    - ``tome`` ``(ratio, min_seq)``: token merging before every
      self-attention on a grid of at least ``min_seq`` tokens;
    - ``pag_layers``: name prefixes (:func:`pag_selected`) of the
      transformers whose self-attention turns into the identity on the
      rows that ``pag_mask`` selects.
    """

    def __init__(self, config: UNetConfig) -> None:
        super().__init__()
        self.config = cfg = config
        self.freeu = None
        self.tome = None
        self.pag_layers = None
        ch0 = cfg.block_channels[0]
        groups = cfg.norm_groups
        n = len(cfg.block_channels)
        self.conv_in = row_shard.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        temb_dim = self._build_time(cfg, cfg.time_cond_proj_dim)
        self._build_down_mid(cfg, temb_dim)

        # Skip channels in the order run_up pops them.
        skip_ch = [ch0]
        for i, ch in enumerate(cfg.block_channels):
            skip_ch += [ch] * cfg.layers_per_block
            if i != n - 1:
                skip_ch.append(ch)
        up = []
        prev = cfg.block_channels[-1]
        for i, ch in enumerate(reversed(cfg.block_channels)):
            level = n - 1 - i
            resnets, attns = [], []
            for j in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock(prev + skip_ch.pop(), ch, groups,
                                           temb_dim))
                prev = ch
                if cfg.attention_levels[level]:
                    attns.append(_transformer(cfg, ch, cfg.depth_at(level)))
            up.append(_Level(resnets, attns if attns else None,
                             upsample=Upsample(ch) if i != n - 1 else None))
        self.up_blocks = nn.ModuleList(up)

        self.conv_norm_out = GroupNorm32(groups, ch0, eps=1e-5, silu=True)
        self.conv_out = row_shard.Conv2d(ch0, cfg.out_channels, 3, padding=1)

    def with_settings(self, **settings) -> 'UNet2DCondition':
        """A shallow copy with other sampling settings (``freeu``, ``tome``,
        ``pag_layers``): it shares this module's submodules and weights."""
        unet = copy.copy(self)
        for name, value in settings.items():
            if name not in ('freeu', 'tome', 'pag_layers'):
                raise TypeError(f'unknown UNet setting {name!r}')
            setattr(unet, name, value)
        return unet

    def run_up(self, h, skips, temb, context, start_i: int = 0,
               capture_i=None, pag_mask=None, ip=None, *, plan):
        """The decoder from up level ``start_i`` (depth ``n − 1 − i``),
        each level as ``plan`` lays it out; also returns the hidden state
        entering level ``capture_i`` (the DeepCache splice point)."""
        captured = None
        n = len(self.up_blocks)
        for i in range(start_i, n):
            blk = self.up_blocks[i]
            if i == capture_i:
                captured = h
            attns = getattr(blk, 'attentions', None)
            depth = n - 1 - i
            with plan.at(depth):
                for j, res in enumerate(blk.resnets):
                    skip = skips.pop()
                    if self.freeu is not None and i < 2:
                        b, s = self.freeu[i], self.freeu[2 + i]
                        half = h.shape[1] // 2
                        h = torch.cat([h[:, :half] * b, h[:, half:]], dim=1)
                        skip = fourier_filter(skip, 1, s)
                        if self.conv_in.weight.is_cuda:
                            # The channel slice and the FFT lose the
                            # channels-last layout K6 takes.
                            h, skip = (x.contiguous(
                                memory_format=torch.channels_last)
                                for x in (h, skip))
                    h = res(torch.cat([h, skip], dim=1), temb)
                    if attns is not None:
                        h = self._attn(attns[j], f'up_{i}_attn_{j}', h,
                                       context, pag_mask, ip)
                if hasattr(blk, 'upsamplers'):
                    h = blk.upsamplers[0](h)
            if hasattr(blk, 'upsamplers'):
                h = plan.move(h, depth, depth - 1)
        return h, captured

    def forward(self, latents: torch.Tensor, t: torch.Tensor,
                context: torch.Tensor, timestep_cond: torch.Tensor = None,
                deep_cache: torch.Tensor = None, cache_mode: str = 'off',
                pag_mask: torch.Tensor = None, control=None,
                ip_ctx: torch.Tensor = None, ip_scale=1.0,
                added_cond: dict = None):
        """``timestep_cond``: the LCM guidance embedding ``[B,
        time_cond_proj_dim]`` (:func:`guidance_scale_embedding`), which a
        UNet with ``time_cond_proj_dim`` requires. ``added_cond``: SDXL's
        ``{'text_embeds', 'time_ids'}`` (:meth:`DownMid.embed_time`), which
        an ``addition_embed`` UNet requires.

        DeepCache: ``cache_mode='save'`` runs the full UNet and also returns
        the hidden state entering the shallowest ``cache_depth`` decoder
        levels, ``(eps, cache)``; ``'use'`` takes that state as
        ``deep_cache``, recomputes only the shallow encoder and decoder
        levels and splices the cache in place of the deep path. A 'use'
        call with a cache saved at the same (latents, t) is bit-identical
        to the full forward.

        ``pag_mask`` ``[B]`` selects the rows whose self-attention in the
        ``pag_layers`` transformers is the identity.

        ``control`` (ControlNet): ``(down_residuals, mid_residual)``, NCHW,
        added to the skip states and the mid output; under 'use' only the
        down residuals, zipped onto the shallow skips (the JAX zip: the
        first ones). ``ip_ctx`` ``[B, N, D]`` with ``ip_scale`` (an
        ``ip_adapter`` config): the IP-Adapter image tokens.

        Under sequence parallelism ``latents`` and the returned ε are
        whole; the DeepCache state and the ControlNet residuals are laid
        out level by level as the plan of the same latent rows lays them
        out (this rank's rows on a sharded level)."""
        cfg = self.config
        dtype = self.conv_in.weight.dtype
        n = len(cfg.block_channels)
        depth = cfg.cache_depth
        if not 1 <= depth < n:
            raise ValueError(f'cache_depth {depth} must be in [1, {n - 1}]')
        temb = self.embed_time(t, timestep_cond, added_cond)
        context = context.to(dtype)
        ip = None if ip_ctx is None else (ip_ctx, ip_scale)
        plan = row_shard.Plan(latents.shape[1])
        # NHWC (public layout) -> NCHW (conv layout).
        h = plan.move(latents.permute(0, 3, 1, 2).to(dtype), None, 0)
        with plan.at(0):
            h = self.conv_in(h)

        if cache_mode == 'use':
            if deep_cache is None:
                raise ValueError("cache_mode='use' requires deep_cache")
            _, skips = self.run_down(h, temb, context, depth, pag_mask, ip,
                                     plan=plan)
            if control is not None:
                skips = [s + r.to(s.dtype)
                         for s, r in zip(skips, control[0])]
            h, _ = self.run_up(deep_cache.to(dtype), skips, temb, context,
                               start_i=n - depth, pag_mask=pag_mask, ip=ip,
                               plan=plan)
            captured = deep_cache
        else:
            h, skips = self.run_down(h, temb, context, n, pag_mask, ip,
                                     plan=plan)
            h = self.run_mid(h, temb, context, pag_mask, ip, plan=plan)
            if control is not None:
                down_res, mid_res = control
                if len(down_res) != len(skips):
                    raise ValueError(
                        f'control provides {len(down_res)} down residuals '
                        f'but the UNet has {len(skips)} skip states — '
                        'mismatched ControlNet geometry')
                skips = [s + r.to(s.dtype) for s, r in zip(skips, down_res)]
                h = h + mid_res.to(h.dtype)
            h, captured = self.run_up(
                h, skips, temb, context,
                capture_i=n - depth if cache_mode == 'save' else None,
                pag_mask=pag_mask, ip=ip, plan=plan)

        with plan.at(0):
            eps = self.conv_out(self.conv_norm_out(h, dtype)).float()
        eps = plan.move(eps, 0, None).permute(0, 2, 3, 1)   # NCHW -> NHWC
        if cache_mode == 'off':
            return eps
        return eps, captured
