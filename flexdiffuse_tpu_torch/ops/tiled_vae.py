"""Tiled VAE encode/decode (port of ``flexdiffuse_tpu/ops/tiled_vae.py``).

The spatial plane splits into overlapping tiles, the conv tower runs tile
by tile (peak activation memory: one tile's), and the overlaps cross-fade
linearly: each tile's output is weighted by a separable ramp mask and
accumulated, then the canvas is divided by the accumulated weight, which
makes a region covered by one tile exact. NHWC in and out, as the JAX
package.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch


def tile_starts(total: int, tile: int, stride: int) -> List[int]:
    """Tile origins covering ``[0, total)``; the last tile is flush with the
    end."""
    if total <= tile:
        return [0]
    starts = list(range(0, total - tile + 1, stride))
    if starts[-1] != total - tile:
        starts.append(total - tile)
    return starts


def _ramp(length: int, overlap: int) -> np.ndarray:
    """Linear ramp over ``overlap`` samples at both ends, positive at the
    edge."""
    r = np.ones(length, np.float32)
    o = min(overlap, length // 2)
    if o > 0:
        up = np.arange(1, o + 1, dtype=np.float32) / (o + 1)
        r[:o] = up
        r[length - o:] = up[::-1]
    return r


def blend_mask(th: int, tw: int, oy: int, ox: int) -> np.ndarray:
    """``[1, th, tw, 1]`` separable ramp mask for a ``th×tw`` output tile."""
    return np.outer(_ramp(th, oy), _ramp(tw, ox))[None, :, :, None]


def tiled_apply(fn: Callable, x: torch.Tensor, tile: int, overlap: int,
                out_num: int = 1, out_den: int = 1):
    """Apply ``fn`` tile by tile over the spatial dims of NHWC ``x`` and
    cross-fade. ``fn`` maps ``[B, tile, tile, C]`` to ``[B,
    tile·out_num/out_den, ·, C']`` or a tuple of such tensors (the
    encoder's moments); ``(f, 1)`` is the decoder's scale, ``(1, f)`` the
    encoder's. Accumulates in fp32."""
    b, hh, ww, _ = x.shape
    if hh <= tile and ww <= tile:
        return fn(x)
    stride = tile - overlap
    if stride <= 0:
        raise ValueError(f'overlap {overlap} must be < tile {tile}')
    th, tw = min(tile, hh), min(tile, ww)
    ys = tile_starts(hh, th, stride)
    xs = tile_starts(ww, tw, stride)

    def _o(v: int) -> int:
        return v * out_num // out_den

    mask = torch.from_numpy(blend_mask(_o(th), _o(tw), _o(overlap),
                                       _o(overlap))).to(x.device)
    acc = None
    wsum = torch.zeros((1, _o(hh), _o(ww), 1), dtype=torch.float32,
                       device=x.device)
    for y0 in ys:
        for x0 in xs:
            # A dense tile: the NHWC → NCHW permute inside the VAE then
            # gives the channels-last layout K6 takes on the card.
            out = fn(x[:, y0:y0 + th, x0:x0 + tw, :].contiguous())
            outs = out if isinstance(out, tuple) else (out,)
            oy, ox = _o(y0), _o(x0)
            if acc is None:
                acc = [torch.zeros((b, _o(hh), _o(ww), t.shape[-1]),
                                   dtype=torch.float32, device=x.device)
                       for t in outs]
            for a, t in zip(acc, outs):
                a[:, oy:oy + t.shape[1], ox:ox + t.shape[2]] += \
                    t.float() * mask
            wsum[:, oy:oy + _o(th), ox:ox + _o(tw)] += mask
    res = tuple(a / wsum for a in acc)
    return res if isinstance(out, tuple) else res[0]
