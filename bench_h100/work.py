"""The work the benchmark counts: operations and bytes of the hand-written
kernels' calls (from the configuration's shapes), their bounds at the
card's published peaks, and the model FLOPs of a step (counted once on the
reference on the meta device with ``torch.utils.flop_counter``, so the
count is the same whatever implements the work).

Bounds follow one rule: the least time the card could take, the larger
of the operations at the peak rate and the bytes at the bandwidth, every
input byte read once and every output byte written once.
"""
from __future__ import annotations

import math
from typing import List, Tuple

import torch

from bench_h100.harness import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_FP32_FLOPS

# The dispatcher's rule for the flash kernels (``ops/attention.py``
# ``_eligible``): both sequences at least 1024 tokens and multiples of
# 128, head width at most 128.
FLASH_MIN_SEQ = 1024
# Operations per element of a GroupNorm(+SiLU): moments, normalise, affine,
# SiLU, in fp32 outside the tensor cores.
GN_OPS_PER_ELEMENT = 10


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS
          ) -> float:
    """Seconds: the larger of ``flops`` at ``peak`` and ``nbytes`` at the
    bandwidth."""
    return max(flops / peak, nbytes / PEAK_BYTES)


def k1_work(b: int, h: int, s: int, d: int, elt: int = 2) -> Tuple[float,
                                                                   float]:
    """Attention forward: S = QKᵀ and O = PV, 4·B·H·S²·D operations; q, k,
    v read and o written once."""
    return 4.0 * b * h * s * s * d, 4.0 * b * h * s * d * elt


def k3_work(b, h, s, d, elt=2):
    """Forward with the log-sum-exp (fp32 per row) written too."""
    f, n = k1_work(b, h, s, d, elt)
    return f, n + 4.0 * b * h * s


def k4_work(b, h, s, d, elt=2):
    """dQ: S = QKᵀ, dP = dO·Vᵀ, dQ = dS·K, 6·B·H·S²·D; q, k, v, do and
    the fp32 lse and δ read, dq written."""
    return 6.0 * b * h * s * s * d, (5 * elt * d + 8) * b * h * s


def k5_work(b, h, s, d, elt=2):
    """dK, dV: S, dP, dV = Pᵀ·dO, dK = dSᵀ·Q, 8·B·H·S²·D; q, k, v, do,
    lse, δ read, dk and dv written."""
    return 8.0 * b * h * s * s * d, (6 * elt * d + 8) * b * h * s


def gn_work(b: int, c: int, hh: int, ww: int, in_elt: int = 2,
            out_elt: int = 2) -> Tuple[float, float]:
    n = float(b * c * hh * ww)
    return GN_OPS_PER_ELEMENT * n, n * (in_elt + out_elt)


def gn_bound(b, c, hh, ww, in_elt=2, out_elt=2) -> float:
    f, n = gn_work(b, c, hh, ww, in_elt, out_elt)
    return bound(f, n, PEAK_FP32_FLOPS)


def _heads(u: dict, ch: int) -> int:
    return ch // u['head_dim'] if u.get('head_dim') else u['num_heads']


def unet_flash_calls(u: dict, b: int, hh: int, ww: int
                     ) -> List[Tuple[int, int, int, int]]:
    """``(B, H, S, D)`` of every self-attention in one UNet evaluation at
    batch ``b`` on an ``hh × ww`` latent that the flash kernels take
    (cross-attention over 77 tokens never is)."""
    out = []
    chans, levels = u['block_channels'], u['attention_levels']
    n = len(chans)
    per_level = []
    for i, ch in enumerate(chans):
        s = (hh >> i) * (ww >> i)
        per_level.append((ch, s))
    calls = []
    for i in range(n):
        if levels[i]:
            calls += [per_level[i]] * u['layers_per_block']
    calls += [per_level[-1]]                                 # mid block
    for i in range(n):
        level = n - 1 - i
        if levels[level]:
            calls += [per_level[level]] * (u['layers_per_block'] + 1)
    depth = u['transformer_depth']
    for ch, s in calls:
        h = _heads(u, ch)
        d = ch // h
        if s >= FLASH_MIN_SEQ and s % 128 == 0 and d <= 128:
            out += [(b, h, s, d)] * depth
    return out


def unet_group_norms(u: dict, b: int, hh: int, ww: int
                     ) -> List[Tuple[int, int, int, int]]:
    """``(B, C, H, W)`` of every GroupNorm of one UNet evaluation."""
    chans, levels, lpb = (u['block_channels'], u['attention_levels'],
                          u['layers_per_block'])
    n = len(chans)
    side = lambda i: (hh >> i, ww >> i)
    out = []
    in_ch = chans[0]
    for i, ch in enumerate(chans):
        for _ in range(lpb):
            out += [(b, in_ch, *side(i)), (b, ch, *side(i))]
            in_ch = ch
            if levels[i]:
                out.append((b, ch, *side(i)))
    mid = chans[-1]
    out += [(b, mid, *side(n - 1))] * 2 + [(b, mid, *side(n - 1))] + \
        [(b, mid, *side(n - 1))] * 2
    skip = [chans[0]]
    for i, ch in enumerate(chans):
        skip += [ch] * lpb
        if i != n - 1:
            skip.append(ch)
    prev = chans[-1]
    for i, ch in enumerate(reversed(chans)):
        level = n - 1 - i
        for _ in range(lpb + 1):
            out += [(b, prev + skip.pop(), *side(level)),
                    (b, ch, *side(level))]
            prev = ch
            if levels[level]:
                out.append((b, ch, *side(level)))
    out.append((b, chans[0], hh, ww))
    return out


def vae_decode_group_norms(v: dict, b: int, hh: int, ww: int
                           ) -> List[Tuple[int, int, int, int]]:
    """``(B, C, H, W)`` of every GroupNorm of one decode of ``hh × ww``
    latents."""
    chans = list(reversed(v['block_channels']))
    n = len(chans)
    out = [(b, chans[0], hh, ww)] * 5          # mid: 2 resnets + attention
    in_ch, h, w = chans[0], hh, ww
    for i, ch in enumerate(chans):
        for _ in range(v['layers_per_block'] + 1):
            out += [(b, in_ch, h, w), (b, ch, h, w)]
            in_ch = ch
        if i != n - 1:
            h, w = 2 * h, 2 * w
    out.append((b, chans[-1], h, w))
    return out


# ---------------------------------------------------------------------------
# Model FLOPs on the reference, on the meta device


def count_flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn()
    return float(counter.get_total_flops())


def unet_flops(u: dict, hh: int, ww: int, b: int = 1) -> float:
    """One UNet evaluation at batch ``b``."""
    from bench_h100.reference import ops, unet
    meta = torch.device('meta')
    o = ops.Ops(ops.Recorder())
    return count_flops(lambda: unet.forward(
        o, u, torch.empty((b, hh, ww, u['in_channels']), device=meta),
        torch.zeros((b,), device=meta),
        torch.empty((b, 77, u['cross_attention_dim']), device=meta)))


def vae_flops(v: dict, hh: int, ww: int, b: int = 1) -> float:
    from bench_h100.reference import ops, vae
    o = ops.Ops(ops.Recorder())
    return count_flops(lambda: vae.decode(o, v, torch.empty(
        (b, hh, ww, v['latent_channels']), device='meta')))


def text_flops(t: dict, b: int = 1) -> float:
    from bench_h100.reference import ops, text
    o = ops.Ops(ops.Recorder())
    return count_flops(lambda: text.encode(o, t, torch.zeros(
        (b, 77), dtype=torch.long, device='meta')))


def mfu(flops: float, seconds: float) -> float:
    """Percent of the bf16 peak."""
    return 100.0 * flops / seconds / PEAK_BF16_FLOPS if seconds > 0 else \
        math.nan

