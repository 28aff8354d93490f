"""The work of SDXL's calls, as ``work.py`` counts SD's: K1's calls with a
transformer depth per level (``work.unet_flash_calls`` takes one depth for
every level), and the model FLOPs of the UNet with its added embedding
and of the two text towers, counted once on ``reference/sdxl.py`` on the
meta device. Bounds, K6's GroupNorms and the decode's FLOPs are
``work.py``'s.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from bench_h100 import work


def unet_flash_calls(u: dict, b: int, hh: int, ww: int
                     ) -> List[Tuple[int, int, int, int]]:
    """``(B, H, S, D)`` of every self-attention of one UNet evaluation at
    batch ``b`` on an ``hh × ww`` latent that the dispatcher sends to K1:
    ``layers_per_block`` transformers a level on the way down, one in the
    mid block (the innermost level's depth), ``layers_per_block + 1`` on
    the way up, each ``transformer_depth[level]`` blocks deep."""
    chans, levels = u['block_channels'], u['attention_levels']
    lpb, depth = u['layers_per_block'], u['transformer_depth']
    n = len(chans)
    per_level = [2 * lpb + 1 + (i == n - 1) for i in range(n)]
    out = []
    for i, ch in enumerate(chans):
        if not levels[i]:
            continue
        s = (hh >> i) * (ww >> i)
        h = work._heads(u, ch)
        d = ch // h
        if s >= work.FLASH_MIN_SEQ and s % 128 == 0 and d <= 128:
            out += [(b, h, s, d)] * (per_level[i] * depth[i])
    return out


def unet_flops(u: dict, hh: int, ww: int) -> float:
    """One UNet row (an evaluation at batch 1)."""
    from bench_h100.reference import ops, sdxl
    meta = torch.device('meta')
    o = ops.Ops(ops.Recorder())
    return work.count_flops(lambda: sdxl.unet_forward(
        o, u, torch.empty((1, hh, ww, u['in_channels']), device=meta),
        torch.zeros((1,), device=meta),
        torch.empty((1, 77, u['cross_attention_dim']), device=meta),
        torch.empty((1, u['addition_pooled_dim']), device=meta),
        torch.zeros((1, u['num_time_ids']), device=meta)))


def text_flops(config: dict) -> float:
    """One prompt's encode: CLIP-L to its penultimate state, bigG through
    its last layer and the pooled projection."""
    from bench_h100.reference import ops, sdxl
    o = ops.Ops(ops.Recorder())
    ids = torch.zeros((1, 77), dtype=torch.long, device='meta')
    return work.count_flops(lambda: sdxl.encode(o, config, ids, ids))
