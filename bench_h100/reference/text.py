"""The CLIP text transformer (Radford et al. 2021; OpenCLIP's ViT-H/14
tower as shipped with SD-2.x has 23 of its 24 layers and GELU MLPs):
token and position embeddings, pre-LN blocks under a causal mask, the
final LayerNorm. Returns the last hidden state ``[B, 77, D]``, the
context SD's UNet attends to."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench_h100.reference.ops import Ops, attention, heads, merge_heads

Tensor = torch.Tensor


def encode(ops: Ops, cfg: dict, ids: Tensor) -> Tensor:
    """``ids`` ``[B, T]`` (int64) → ``[B, T, hidden_size]`` fp32."""
    d, n_heads = cfg['hidden_size'], cfg['num_heads']
    inner, act = cfg['intermediate_size'], cfg['activation']
    b, t = ids.shape
    p = 'text_model.'
    tok = ops.w(p + 'embeddings.token_embedding.weight',
                (cfg['vocab_size'], d))
    pos = ops.w(p + 'embeddings.position_embedding.weight',
                (cfg['max_positions'], d))
    x = F.embedding(ids, tok) + pos[:t]
    mask = torch.triu(torch.full((t, t), float('-inf'), device=x.device),
                      diagonal=1)
    hd = d // n_heads
    for i in range(cfg['num_layers']):
        lp = f'{p}encoder.layers.{i}.'
        y = ops.layer_norm(x, lp + 'layer_norm1')
        q = heads(ops.linear(y, lp + 'self_attn.q_proj', d, d), n_heads)
        k = heads(ops.linear(y, lp + 'self_attn.k_proj', d, d), n_heads)
        v = heads(ops.linear(y, lp + 'self_attn.v_proj', d, d), n_heads)
        o = merge_heads(attention(q, k, v, hd**-0.5, mask), b)
        x = x + ops.linear(o, lp + 'self_attn.out_proj', d, d)
        y = ops.linear(ops.layer_norm(x, lp + 'layer_norm2'), lp + 'mlp.fc1',
                       d, inner)
        y = y * torch.sigmoid(1.702 * y) if act == 'quick_gelu' else \
            F.gelu(y)
        x = x + ops.linear(y, lp + 'mlp.fc2', inner, d)
    return ops.layer_norm(x, p + 'final_layer_norm')
