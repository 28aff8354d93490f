"""Token merging (ToMe, Bolya & Hoffman 2023) for the UNet's self-attention;
port of ``flexdiffuse_tpu/ops/tome.py``: the ``[B, S, C]`` row layout
(:func:`merge`, :func:`unmerge`) and the channel-major ``[C, B·S]`` one
(:func:`merge_cm`, :func:`unmerge_cm`, :func:`metric_from_cm`: token
gathers become column gathers; the plan is the same).

Before a self-attention, ``r`` of the spatial tokens merge into their most
similar neighbours (bipartite soft matching), attention runs on the reduced
set, and the outputs are copied back to the full set. As in the JAX
package:

- dst tokens are the top-left of each 2×2 window (no random jitter), src
  the rest;
- cosine scores are one batched matmul; every src goes to its best dst and
  the ``r`` most similar srcs merge (mean into their dst);
- ``r`` is fixed from the ratio and rounded so the merged length stays a
  multiple of 128, so the 4096-token level keeps K1's alignment (ratio
  0.5: 2048 tokens).

An approximation: there is no bit-parity target against the full
attention.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class TomePlan(NamedTuple):
    """Merge plan for one (B, S) grid: ``dst_idx``/``src_idx`` the fixed
    split (token ids), ``merged_pos``/``kept_pos`` positions into
    ``src_idx`` per batch row, ``assign`` each merged src's dst slot. The
    merged sequence is ``[dst..., kept src...]``."""
    dst_idx: torch.Tensor      # [Sd] int64
    src_idx: torch.Tensor      # [Ss] int64
    merged_pos: torch.Tensor   # [B, r]
    kept_pos: torch.Tensor     # [B, Sk]
    assign: torch.Tensor       # [B, r]
    grid_hw: Tuple[int, int]

    @property
    def merged_len(self) -> int:
        return self.dst_idx.shape[0] + self.kept_pos.shape[-1]


def bipartite_split(hh: int, ww: int, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token ids of the dst (top-left of each 2×2 window) and src (the
    rest) sets of an ``hh×ww`` row-major grid; odd edges fall to src. Built
    on the host (the split depends on the grid only), then moved."""
    ids = torch.arange(hh * ww).reshape(hh, ww)
    dst = ids[0::2, 0::2].reshape(-1)
    mask = torch.zeros((hh, ww), dtype=torch.bool)
    mask[0::2, 0::2] = True
    src = ids.reshape(-1)[~mask.reshape(-1)]
    return dst.to(device), src.to(device)


def resolve_r(hh: int, ww: int, ratio: float, multiple: int = 128) -> int:
    """Merge count: ``ratio`` of all tokens, capped at the src count, with
    the REDUCED length rounded up to a multiple of ``multiple``."""
    s = hh * ww
    sd = ((hh + 1) // 2) * ((ww + 1) // 2)
    r = min(int(s * ratio), s - sd)
    rem = (s - r) % multiple
    if rem:
        r = max(r - (multiple - rem), 0)
    return r


def merge_plan(metric: torch.Tensor, grid_hw: Tuple[int, int],
               r: int) -> TomePlan:
    """The plan from a ``[B, S, C]`` similarity metric (the hidden states
    before the self-attention; cosine similarity, in fp32)."""
    hh, ww = grid_hw
    b, s, _ = metric.shape
    assert s == hh * ww, (s, grid_hw)
    dst_idx, src_idx = bipartite_split(hh, ww, metric.device)
    m = metric.float()
    m = m * torch.rsqrt((m * m).sum(-1, keepdim=True) + 1e-12)
    scores = torch.matmul(m[:, src_idx], m[:, dst_idx].transpose(1, 2))
    best, assign_all = scores.max(dim=-1)                # [B, Ss]
    order = torch.argsort(-best, dim=-1, stable=True)   # most similar first
    merged_pos = order[:, :r]
    kept_pos = order[:, r:]
    assign = torch.gather(assign_all, 1, merged_pos)
    return TomePlan(dst_idx, src_idx, merged_pos, kept_pos, assign, grid_hw)


def _rows(x: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
    """x [B, S, C], token ids [S'] or [B, S'] → [B, S', C]."""
    if token_ids.ndim == 1:
        return x[:, token_ids]
    return torch.gather(x, 1, token_ids[..., None].expand(
        -1, -1, x.shape[-1]))


def merge(x: torch.Tensor, plan: TomePlan) -> torch.Tensor:
    """``[B, S, C] → [B, Sd+Sk, C]``: each dst slot averages in its merged
    srcs (mean mode); kept srcs pass through."""
    b = x.shape[0]
    src = plan.src_idx[None].expand(b, -1)
    x_dst = _rows(x, plan.dst_idx)
    x_merged = _rows(x, torch.gather(src, 1, plan.merged_pos))
    x_kept = _rows(x, torch.gather(src, 1, plan.kept_pos))
    idx = plan.assign[..., None].expand(-1, -1, x.shape[-1])
    acc = torch.zeros_like(x_dst).scatter_add_(1, idx, x_merged)
    cnt = torch.zeros(x_dst.shape[:2], dtype=x.dtype,
                      device=x.device).scatter_add_(
        1, plan.assign, torch.ones(plan.assign.shape, dtype=x.dtype,
                                   device=x.device))
    x_dst = (x_dst + acc) / (1.0 + cnt)[..., None]
    return torch.cat([x_dst, x_kept], dim=1)


def unmerge(y: torch.Tensor, plan: TomePlan) -> torch.Tensor:
    """``[B, Sd+Sk, C] → [B, S, C]``: dst and kept tokens take their own
    outputs, merged srcs their dst's."""
    b, _, c = y.shape
    sd = plan.dst_idx.shape[0]
    y_dst, y_kept = y[:, :sd], y[:, sd:]
    s = plan.grid_hw[0] * plan.grid_hw[1]
    out = torch.zeros((b, s, c), dtype=y.dtype, device=y.device)
    src = plan.src_idx[None].expand(b, -1)
    out[:, plan.dst_idx] = y_dst
    out.scatter_(1, torch.gather(src, 1, plan.kept_pos)[..., None].expand(
        -1, -1, c), y_kept)
    y_for_merged = torch.gather(y_dst, 1, plan.assign[..., None].expand(
        -1, -1, c))
    out.scatter_(1, torch.gather(src, 1, plan.merged_pos)[..., None].expand(
        -1, -1, c), y_for_merged)
    return out


# Channel-major ([C, B·S], b-major columns) variants.

def _flat_cols(token_ids: torch.Tensor, b: int, s: int) -> torch.Tensor:
    """Token ids ``[B, S']`` (or ``[S']``, every row's) → flat column ids
    into the ``B·S`` axis."""
    if token_ids.ndim == 1:
        token_ids = token_ids[None].expand(b, -1)
    off = torch.arange(b, device=token_ids.device)[:, None] * s
    return (token_ids + off).reshape(-1)


def merge_cm(x: torch.Tensor, plan: TomePlan, b: int) -> torch.Tensor:
    """``[C, B·S] → [C, B·(Sd+Sk)]``: :func:`merge` over columns, each row's
    merged tokens ``[dst..., kept...]`` contiguous."""
    s = plan.grid_hw[0] * plan.grid_hw[1]
    src = plan.src_idx[None].expand(b, -1)
    kept = torch.gather(src, 1, plan.kept_pos)
    x_dst = x[:, _flat_cols(plan.dst_idx, b, s)]
    x_merged = x[:, _flat_cols(torch.gather(src, 1, plan.merged_pos), b, s)]
    x_kept = x[:, _flat_cols(kept, b, s)]
    sd = plan.dst_idx.shape[0]
    dst_cols = _flat_cols(plan.assign, b, sd)
    acc = torch.zeros_like(x_dst).index_add_(1, dst_cols, x_merged)
    cnt = torch.zeros(x_dst.shape[1], dtype=x.dtype,
                      device=x.device).index_add_(
        0, dst_cols, torch.ones(dst_cols.shape, dtype=x.dtype,
                                device=x.device))
    x_dst = (x_dst + acc) / (1.0 + cnt)[None]
    c, sk = x.shape[0], kept.shape[1]
    return torch.cat([x_dst.reshape(c, b, sd), x_kept.reshape(c, b, sk)],
                     dim=2).reshape(c, b * (sd + sk))


def unmerge_cm(y: torch.Tensor, plan: TomePlan, b: int) -> torch.Tensor:
    """``[C, B·(Sd+Sk)] → [C, B·S]``: :func:`unmerge` over columns."""
    c = y.shape[0]
    sd = plan.dst_idx.shape[0]
    sk = plan.kept_pos.shape[1]
    s = plan.grid_hw[0] * plan.grid_hw[1]
    y3 = y.reshape(c, b, sd + sk)
    y_dst = y3[:, :, :sd].reshape(c, b * sd)
    src = plan.src_idx[None].expand(b, -1)
    out = torch.zeros((c, b * s), dtype=y.dtype, device=y.device)
    out[:, _flat_cols(plan.dst_idx, b, s)] = y_dst
    out[:, _flat_cols(torch.gather(src, 1, plan.kept_pos), b, s)] = \
        y3[:, :, sd:].reshape(c, b * sk)
    out[:, _flat_cols(torch.gather(src, 1, plan.merged_pos), b, s)] = \
        y_dst[:, _flat_cols(plan.assign, b, sd)]
    return out


def metric_from_cm(x: torch.Tensor, b: int) -> torch.Tensor:
    """``[C, B·S] → [B, S, C]`` fp32, the metric :func:`merge_plan` takes
    (a copy of the metric only; the activations stay channel-major)."""
    c, bs = x.shape
    return x.reshape(c, b, bs // b).permute(1, 2, 0).float()
