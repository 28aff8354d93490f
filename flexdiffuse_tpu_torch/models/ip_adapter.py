"""IP-Adapter: decoupled image-prompt attention (port of
``flexdiffuse_tpu/models/ip_adapter.py``).

The image-projection heads turn an image encoder's output into context
tokens: :class:`ImageProjection` (base checkpoints: the CLS-pooled
projected embedding → ``N`` tokens) and :class:`Resampler` (Plus
checkpoints: a perceiver over the encoder's penultimate hidden states). The
per-layer ``to_k_ip``/``to_v_ip`` projections live in the UNet's
cross-attention (``models/unet.py``, ``UNetConfig.ip_adapter``):

    out = attention(q, K_text, V_text) + ip_scale · attention(q, K_ip, V_ip)

The heads' parameter names are the official checkpoints' ``image_proj.*``
names without the prefix, so :func:`build_image_proj` loads them by
``load_state_dict``; :func:`convert_ip_layers` maps the checkpoint's
``ip_adapter.{i}.to_{k,v}_ip`` entries onto the UNet's module names
(:func:`attn2_layer_order`), and :func:`merge_ip_weights` adds them to a
UNet state dict. The image tokens (4 or 16) never reach a flash kernel.
"""
from __future__ import annotations

import re
from typing import Dict, List, Tuple

import torch
from torch import nn

from flexdiffuse_tpu_torch.models.configs import UNetConfig

SD = Dict[str, torch.Tensor]


class ImageProjection(nn.Module):
    """Pooled image embedding ``[B, D_img]`` → ``[B, N, D_ctx]``: ``proj``
    then a LayerNorm (``norm``) per token."""

    def __init__(self, embed_dim: int, context_dim: int,
                 num_tokens: int = 4) -> None:
        super().__init__()
        self.num_tokens = num_tokens
        self.context_dim = context_dim
        self.proj = nn.Linear(embed_dim, num_tokens * context_dim)
        self.norm = nn.LayerNorm(context_dim, eps=1e-5)

    def forward(self, embed: torch.Tensor) -> torch.Tensor:
        x = self.proj(embed.to(self.proj.weight.dtype))
        return self.norm(x.reshape(x.shape[0], self.num_tokens,
                                   self.context_dim))


class PerceiverAttention(nn.Module):
    """One Resampler cross-attention: the latents attend over
    ``concat(image tokens, latents)``, with the official block's split
    softmax scale (``1/√√d`` on both q and k) and an fp32 softmax."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 12) -> None:
        super().__init__()
        inner = dim_head * heads
        self.dim_head, self.heads = dim_head, heads
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_kv = nn.Linear(dim, inner * 2, bias=False)
        self.to_out = nn.Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x)
        lat = self.norm2(latents)
        b, n, _ = lat.shape
        q = self.to_q(lat)
        k, v = self.to_kv(torch.cat([x, lat], dim=-2)).chunk(2, dim=-1)

        def heads_first(t):
            return t.reshape(b, t.shape[1], self.heads,
                             self.dim_head).transpose(1, 2)

        q, k, v = heads_first(q), heads_first(k), heads_first(v)
        # An fp32 scale: the JAX block's product promotes to fp32.
        scale = 1.0 / torch.sqrt(torch.sqrt(torch.tensor(
            float(self.dim_head))))
        w = torch.matmul(q.float() * scale,
                         (k.float() * scale).transpose(-1, -2))
        w = torch.softmax(w, dim=-1).to(v.dtype)
        out = torch.matmul(w, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out(out)


class Resampler(nn.Module):
    """IP-Adapter Plus's image projection: ``num_queries`` learned latents
    refined over ``depth`` perceiver blocks against the image encoder's
    penultimate tokens, projected to the UNet context width.
    ``[B, 1+P, embed_dim] -> [B, num_queries, output_dim]``.

    ``layers.{i}`` is ``[PerceiverAttention, FeedForward]``, the feed-forward
    ``Sequential(LayerNorm, Linear, GELU, Linear)`` (bias-free linears,
    exact-erf GELU): the official keys ``layers.{i}.1.{0,1,3}``."""

    def __init__(self, output_dim: int, dim: int = 768, depth: int = 4,
                 dim_head: int = 64, heads: int = 12, num_queries: int = 16,
                 embed_dim: int = 1280, ff_mult: int = 4) -> None:
        super().__init__()
        self.latents = nn.Parameter(torch.zeros(1, num_queries, dim))
        self.proj_in = nn.Linear(embed_dim, dim)
        self.proj_out = nn.Linear(dim, output_dim)
        self.norm_out = nn.LayerNorm(output_dim, eps=1e-5)
        self.layers = nn.ModuleList(nn.ModuleList([
            PerceiverAttention(dim, dim_head, heads),
            nn.Sequential(nn.LayerNorm(dim, eps=1e-5),
                          nn.Linear(dim, dim * ff_mult, bias=False),
                          nn.GELU(),
                          nn.Linear(dim * ff_mult, dim, bias=False))])
            for _ in range(depth))

    def forward(self, embeds: torch.Tensor) -> torch.Tensor:
        x = self.proj_in(embeds.to(self.proj_in.weight.dtype))
        lat = self.latents.expand(x.shape[0], -1, -1)
        for attn, ff in self.layers:
            lat = lat + attn(x, lat)
            lat = lat + ff(lat)
        return self.norm_out(self.proj_out(lat))


def _jax_to_module(path: Tuple[str, ...]) -> str:
    """A JAX UNet attention path (``('down_0_attn_1', 'blocks_0',
    'attn2')``) → the port's module name."""
    head, block, leaf = path
    m = re.match(r'^(down|up)_(\d+)_attn_(\d+)$', head)
    prefix = (f'{m.group(1)}_blocks.{m.group(2)}.attentions.{m.group(3)}'
              if m else 'mid_block.attentions.0')
    return f'{prefix}.transformer_blocks.{block[len("blocks_"):]}.{leaf}'


def attn2_layer_order(config: UNetConfig) -> List[str]:
    """The UNet's cross-attention modules in diffusers' ``attn_processors``
    order, by which the official checkpoints number their layers: down →
    up → mid last (diffusers registers ``up_blocks`` before
    ``mid_block``; SD-1.x: 6 + 9 + 1)."""
    paths = []

    def block(head: str, depth: int) -> None:
        paths.extend(_jax_to_module((head, f'blocks_{d}', 'attn2'))
                     for d in range(depth))

    n = len(config.block_channels)
    for i in range(n):
        for j in range(config.layers_per_block):
            if config.attention_levels[i]:
                block(f'down_{i}_attn_{j}', config.depth_at(i))
    for i in range(n):
        level = n - 1 - i
        for j in range(config.layers_per_block + 1):
            if config.attention_levels[level]:
                block(f'up_{i}_attn_{j}', config.depth_at(level))
    block('mid_attn', config.depth_mid())
    return paths


def convert_ip_layers(sd: SD, config: UNetConfig) -> SD:
    """The checkpoint's per-layer ``to_k_ip``/``to_v_ip`` as UNet state-dict
    entries (``<attn2 module>.to_{k,v}_ip.weight``). The sorted layer
    indices map onto :func:`attn2_layer_order` (official checkpoints number
    1, 3, 5, …; some re-exports densely: the order is what counts)."""
    per_idx: Dict[int, Dict[str, torch.Tensor]] = {}
    for key, val in sd.items():
        m = re.match(r'ip_adapter\.(\d+)\.to_([kv])_ip\.weight$', key)
        if m:
            per_idx.setdefault(int(m.group(1)), {})[
                f'to_{m.group(2)}_ip'] = torch.as_tensor(val)
    order = attn2_layer_order(config)
    indices = sorted(per_idx)
    if len(indices) != len(order):
        raise ValueError(
            f'IP-Adapter has {len(indices)} attention layers but this UNet '
            f'config has {len(order)} cross-attention layers')
    return {f'{name}.{leaf}.weight': w
            for name, i in zip(order, indices)
            for leaf, w in sorted(per_idx[i].items())}


def _strip(sd: SD, prefix: str) -> SD:
    return {k[len(prefix):]: torch.as_tensor(v) for k, v in sd.items()
            if k.startswith(prefix)}


def build_image_proj(sd: SD, config: UNetConfig):
    """The image-projection head of whichever variant the checkpoint is,
    its weights loaded (fp32 module on the CPU): ``(module, num_tokens,
    input_kind)``. ``input_kind`` says what to feed it: 'pooled' (base
    checkpoints, ``image_proj.proj.*``: the encoder's CLS-pooled projected
    embedding ``[B, D]``) or 'penultimate' (Plus checkpoints,
    ``image_proj.latents`` and perceiver layers: the encoder's penultimate
    hidden states ``[B, 1+P, D]``)."""
    head = _strip(sd, 'image_proj.')
    if 'latents' in head:
        lat = head['latents']
        nq, dim = lat.shape[1], lat.shape[-1]
        out_dim = head['proj_out.weight'].shape[0]
        if out_dim != config.cross_attention_dim:
            raise ValueError(
                f'Resampler output dim {out_dim} != UNet cross-attention '
                f'dim {config.cross_attention_dim} — adapter does not match '
                'this base model')
        inner = head['layers.0.0.to_q.weight'].shape[0]
        depth = 0
        while f'layers.{depth}.0.to_q.weight' in head:
            depth += 1
        # Official checkpoints use 64-wide heads; one head for sub-64 inner
        # widths (the tiny test geometries), as the JAX loader.
        dim_head = 64 if inner % 64 == 0 and inner >= 64 else inner
        module = Resampler(
            out_dim, dim=dim, depth=depth, dim_head=dim_head,
            heads=inner // dim_head, num_queries=nq,
            embed_dim=head['proj_in.weight'].shape[1],
            ff_mult=head['layers.0.1.1.weight'].shape[0] // dim)
        tokens, kind = nq, 'penultimate'
    elif 'proj.weight' in head:
        proj_w = head['proj.weight']
        if proj_w.shape[0] % config.cross_attention_dim:
            raise ValueError(
                f'image_proj output dim {proj_w.shape[0]} is not a multiple '
                f'of the UNet cross-attention dim '
                f'{config.cross_attention_dim} — adapter does not match this '
                'base model')
        tokens = proj_w.shape[0] // config.cross_attention_dim
        module = ImageProjection(proj_w.shape[1], config.cross_attention_dim,
                                 tokens)
        kind = 'pooled'
    else:
        raise ValueError(
            'unsupported IP-Adapter variant: neither image_proj.proj.weight '
            '(base) nor image_proj.latents (Plus Resampler) present — '
            'FaceID checkpoints are not supported')
    module.load_state_dict({k: v.float() for k, v in head.items()},
                           strict=True)
    return module.eval().requires_grad_(False), tokens, kind


def convert_ip_adapter(sd: SD, config: UNetConfig) -> Tuple[SD, SD]:
    """Base checkpoints only: ``(image_proj state dict, UNet IP layers)``;
    :func:`build_image_proj` and :func:`convert_ip_layers` also take Plus
    checkpoints."""
    module, _, kind = build_image_proj(sd, config)
    if kind != 'pooled':
        raise ValueError('convert_ip_adapter handles base checkpoints only;'
                         ' use build_image_proj for Plus (Resampler) ones')
    return module.state_dict(), convert_ip_layers(sd, config)


def merge_ip_weights(unet_sd: SD, layers: SD) -> SD:
    """A UNet state dict with the IP layers added (a new dict; the base
    tensors are shared), for a UNet built with ``ip_adapter=True``. Every
    layer must land on a cross-attention of the base."""
    merged = dict(unet_sd)
    for key, w in layers.items():
        module = key.rsplit('.', 2)[0]
        if f'{module}.to_k.weight' not in unet_sd:
            raise KeyError(f'UNet lacks {module} — mismatched IP-Adapter / '
                           'UNet geometry')
        merged[key] = w
    return merged
