"""CLIP text and vision towers as ``nn.Module``s (port of
``flexdiffuse_tpu/models/clip.py``).

Parameter names are the HF ``transformers`` CLIP names that
``flexdiffuse_tpu/weights/convert.py`` reads (``text_model.*``,
``vision_model.*`` with HF's ``pre_layrnorm`` spelling,
``visual_projection``), so an HF checkpoint loads by a plain
``load_state_dict``.

* The text tower returns the final-LN last hidden state ``[B, 77, D]``, the
  penultimate one through the final LN (``clip_skip``), or SDXL's outputs:
  the penultimate hidden state un-normalised, alone or with the pooled
  projection (the final-LN state at the first EOS position through
  ``text_projection``, which a config with ``projection_dim`` holds).
* The vision tower takes NHWC pixels like the JAX tower and returns all
  ``1 + P`` tokens after ``post_layernorm`` and ``visual_projection`` (the
  reference's all-patch path, ``clip.py:174``), the CLS token's pooled
  projection (a base IP-Adapter's input), or the penultimate hidden states
  (an IP-Adapter Plus's input).

Attention here is plain einsum math (77 and 257 tokens; nothing to stream).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F

from flexdiffuse_tpu_torch.models.configs import (CLIPTextConfig,
                                                  CLIPVisionConfig)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(hidden_size, hidden_size)
        self.k_proj = nn.Linear(hidden_size, hidden_size)
        self.v_proj = nn.Linear(hidden_size, hidden_size)
        self.out_proj = nn.Linear(hidden_size, hidden_size)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, d = x.shape
        h = self.num_heads
        hd = d // h
        split = lambda t: t.reshape(b, s, h, hd).transpose(1, 2)
        q = split(self.q_proj(x) * (hd**-0.5))
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(x.dtype)
        out = torch.matmul(probs, v).transpose(1, 2).reshape(b, s, d)
        return self.out_proj(out)


class CLIPMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int,
                 activation: str = 'quick_gelu') -> None:
        super().__init__()
        self.activation = activation
        self.fc1 = nn.Linear(hidden_size, intermediate_size)
        self.fc2 = nn.Linear(intermediate_size, hidden_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.fc1(x)
        x = quick_gelu(x) if self.activation == 'quick_gelu' else F.gelu(x)
        return self.fc2(x)


class CLIPEncoderLayer(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int,
                 intermediate_size: int,
                 activation: str = 'quick_gelu') -> None:
        super().__init__()
        self.self_attn = CLIPAttention(hidden_size, num_heads)
        self.layer_norm1 = nn.LayerNorm(hidden_size, eps=1e-5)
        self.mlp = CLIPMLP(hidden_size, intermediate_size, activation)
        self.layer_norm2 = nn.LayerNorm(hidden_size, eps=1e-5)

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, hidden_size: int, num_layers: int, num_heads: int,
                 intermediate_size: int,
                 activation: str = 'quick_gelu') -> None:
        super().__init__()
        self.layers = nn.ModuleList(
            CLIPEncoderLayer(hidden_size, num_heads, intermediate_size,
                             activation) for _ in range(num_layers))

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor],
                skip: int = 0) -> torch.Tensor:
        """All layers, or all but the last ``skip``."""
        for layer in self.layers[:len(self.layers) - skip]:
            x = layer(x, mask)
        return x


class _TextEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig) -> None:
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions,
                                               cfg.hidden_size)


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig) -> None:
        super().__init__()
        self.embeddings = _TextEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.num_layers,
                                   cfg.num_heads, cfg.intermediate_size,
                                   cfg.activation)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPTextModel(nn.Module):
    """Text tower: ``input_ids [B, T] -> [B, T, D]``."""

    def __init__(self, config: CLIPTextConfig) -> None:
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)
        if config.projection_dim:
            self.text_projection = nn.Linear(config.hidden_size,
                                             config.projection_dim,
                                             bias=False)

    OUTPUTS = ('final', 'penultimate', 'penultimate_norm',
               'penultimate_and_pooled')

    def forward(self, input_ids: torch.Tensor, output: str = 'final'):
        """``output``: 'final' → the final-LN last hidden state (the SD-1.x
        path, reference encode/clip.py:64-65); 'penultimate_norm' → the
        hidden state one layer before the end through ``final_layer_norm``
        (the diffusers/A1111 ``clip_skip`` convention; the last layer is not
        run); 'penultimate' → that hidden state un-normalised (SDXL's
        conditioning); 'penultimate_and_pooled' → ``(penultimate, pooled)``,
        pooled ``[B, projection_dim]`` the final-LN state at the first
        position whose id is ``eos_token_id`` (not ``ids.argmax()``, which
        textual-inversion tokens above the EOS id would break) through
        ``text_projection``."""
        if output not in self.OUTPUTS:
            raise ValueError(f'unknown output {output!r}')
        if output == 'penultimate_and_pooled' and \
                not self.config.projection_dim:
            raise ValueError("output='penultimate_and_pooled' needs a text "
                             'config with projection_dim (text_projection)')
        tm = self.text_model
        b, t = input_ids.shape
        emb = tm.embeddings
        x = emb.token_embedding(input_ids) + emb.position_embedding.weight[:t]
        causal = torch.triu(
            torch.full((t, t), torch.finfo(torch.float32).min,
                       device=x.device), diagonal=1)
        if output == 'final':
            return tm.final_layer_norm(tm.encoder(x, causal))
        penult = tm.encoder(x, causal, skip=1)
        if output == 'penultimate':
            return penult
        if output == 'penultimate_norm':
            return tm.final_layer_norm(penult)
        final = tm.final_layer_norm(tm.encoder.layers[-1](penult, causal))
        eos = (input_ids == self.config.eos_token_id).int().argmax(dim=-1)
        pooled = final[torch.arange(b, device=final.device), eos]
        return penult, self.text_projection(pooled)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig) -> None:
        super().__init__()
        self.class_embedding = nn.Parameter(torch.randn(cfg.hidden_size))
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size,
                                         kernel_size=cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.position_embedding = nn.Embedding(cfg.num_positions,
                                               cfg.hidden_size)


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig) -> None:
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)  # HF's
        self.encoder = CLIPEncoder(cfg.hidden_size, cfg.num_layers,
                                   cfg.num_heads, cfg.intermediate_size)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=1e-5)


class CLIPVisionModel(nn.Module):
    """Vision tower: ``pixels [B, H, W, 3] (NHWC)`` → the output that
    :meth:`forward`'s ``output`` names."""

    OUTPUTS = ('patches', 'pooled', 'penultimate')

    def __init__(self, config: CLIPVisionConfig) -> None:
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)
        self.visual_projection = nn.Linear(config.hidden_size,
                                           config.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor,
                output: str = 'patches') -> torch.Tensor:
        """``output``: 'patches' → every token after post-LN and the
        projection, ``[B, 1 + P, projection_dim]``; 'pooled' → the CLS
        token's, ``[B, projection_dim]``; 'penultimate' → the hidden states
        one layer before the end, ``[B, 1 + P, hidden]``, no post-LN and no
        projection (the last layer is not run)."""
        if output not in self.OUTPUTS:
            raise ValueError(f'unknown output {output!r}')
        vm = self.vision_model
        emb = vm.embeddings
        w = emb.patch_embedding.weight
        # NHWC in (the JAX package's layout) -> NCHW for the conv.
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2).to(w.dtype))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                   # [B, P, D]
        cls = emb.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight
        x = vm.pre_layrnorm(x)
        if output == 'penultimate':
            return vm.encoder(x, None, skip=1)
        x = vm.encoder(x, None)
        # Reference quirk (encode/clip.py:96-100): 'patches' takes post-LN +
        # projection over ALL tokens, not just the pooled class token.
        x = vm.post_layernorm(x if output == 'patches' else x[:, 0])
        return self.visual_projection(x)
