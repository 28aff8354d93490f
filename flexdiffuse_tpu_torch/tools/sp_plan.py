"""The sequence-parallel row plan of SD-1.4 at a size and rank count.

    python -m flexdiffuse_tpu_torch.tools.sp_plan --size 1088 --ranks 4

Runs one UNet evaluation (CFG batch 2), one VAE encode and one decode of
SD-1.4's geometry on the meta device (no weights, no card, no process
group: every level runs whole), and through
:func:`~flexdiffuse_tpu_torch.ops.row_shard.observe` records, for every
level the models enter, its depth, whether the plan would shard it on
``--ranks`` ranks (:func:`~flexdiffuse_tpu_torch.ops.row_shard.splits`)
and the FLOPs it runs (``torch.utils.flop_counter``, whole-map counts).
Prints per model the sharded and the whole levels and the share of its
FLOPs that every rank repeats: the whole levels' and the work outside any
level (the time embedding, the VAE's 1×1 quant convs).
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import json
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from flexdiffuse_tpu_torch.models import SD14_UNET, SD14_VAE
from flexdiffuse_tpu_torch.models import AutoencoderKL, UNet2DCondition
from flexdiffuse_tpu_torch.ops import row_shard

MODELS = ('unet', 'encoder', 'decoder')


class _Tracer:
    """Attributes the FLOPs counted so far to the level being run
    (None: outside every level) at each level's entry and exit, the level
    named by its depth and whether it splits over ``ranks``."""

    def __init__(self, counter: FlopCounterMode, ranks: int) -> None:
        self.counter, self.ranks = counter, ranks
        self.stack = [None]
        self.flops: Dict = collections.Counter()
        self.seen = 0

    def settle(self) -> None:
        total = self.counter.get_total_flops()
        self.flops[self.stack[-1]] += total - self.seen
        self.seen = total

    @contextlib.contextmanager
    def level(self, rows: int, depth: int):
        self.settle()
        self.stack.append((depth, row_shard.splits(rows, self.ranks, depth)))
        try:
            yield
        finally:
            self.settle()
            self.stack.pop()


def trace(model: str, size: int, ranks: int) -> dict:
    """The plan of SD-1.4's ``model`` ('unet', 'encoder' or 'decoder') at
    ``size``² pixels on ``ranks`` ranks: ``{'sharded': [depths], 'whole':
    [depths], 'replicated_share': float, 'flops': int}``."""
    counter = FlopCounterMode(display=False)
    tracer = _Tracer(counter, ranks)
    f = 2**(len(SD14_VAE.block_channels) - 1)
    meta = lambda *shape: torch.empty(shape, device='meta')
    with torch.device('meta'):
        net = UNet2DCondition(SD14_UNET) if model == 'unet' else \
            AutoencoderKL(SD14_VAE)
    with row_shard.observe(tracer.level), counter, torch.no_grad():
        if model == 'unet':
            net(meta(2, size // f, size // f, 4), meta(2),
                meta(2, 77, SD14_UNET.cross_attention_dim))
        elif model == 'encoder':
            net.encode(meta(1, size, size, 3))
        elif model == 'decoder':
            net.decode(meta(1, size // f, size // f, 4))
        else:
            raise ValueError(f'unknown model {model!r} {MODELS}')
        tracer.settle()
    levels = {k for k in tracer.flops if k is not None}
    total = sum(tracer.flops.values())
    repeated = sum(v for k, v in tracer.flops.items()
                   if k is None or not k[1])
    return dict(sharded=sorted(d for d, s in levels if s),
                whole=sorted(d for d, s in levels if not s),
                replicated_share=repeated / total, flops=int(total))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--size', type=int, default=1088,
                    help='square image side in pixels')
    ap.add_argument('--ranks', type=int, default=4)
    args = ap.parse_args(argv)
    for model in MODELS:
        print(json.dumps(dict(model=model, size=args.size,
                              ranks=args.ranks,
                              **trace(model, args.size, args.ranks))))
    return 0


if __name__ == '__main__':
    raise SystemExit(main())
