"""The comparison that decides ``correct`` for the SDXL cells, as
``check.py`` decides it for SD's: the images the timed path returned for a
sample of its calls, against ``reference/sdxl.py`` in fp32 run once over
the same prompts, negative prompts and noise, after the window has closed
and the program is freed. The number compared is ``check.py``'s
``image_rms``; the control is the reference with fp8 operands.
"""
from __future__ import annotations

import sys
from typing import List, Sequence

import numpy as np
import torch

from bench_h100 import build_sdxl, check, seeded
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import sdxl as ref_sdxl


def reference_images(ops: ref_ops.Ops, config: dict, rows: Sequence[dict],
                     steps: int, scale: float, size: int, device,
                     batch: int) -> List[np.ndarray]:
    """Images ``[size, size, 3]`` fp32 in [0, 1] for ``rows`` (each
    ``prompt``, ``negative``, ``noise`` ``[h, w, C]``), ``batch`` rows a
    call."""
    vocab = config['text']['vocab_size']

    def ids(prompts, fn):
        return torch.tensor([fn(p, vocab) for p in prompts],
                            dtype=torch.long, device=device)
    out = []
    with torch.no_grad(), ref_ops.exact_fp32():
        for i in range(0, len(rows), batch):
            part = rows[i:i + batch]
            pos = [r['prompt'] for r in part]
            neg = [r['negative'] for r in part]
            img = ref_sdxl.generate(
                ops, config, ids(pos, seeded.token_ids),
                ids(pos, build_sdxl.token_ids_2),
                ids(neg, seeded.token_ids), ids(neg, build_sdxl.token_ids_2),
                torch.stack([r['noise'].to(device) for r in part]), steps,
                scale, size)
            out += list(img.float().cpu().numpy())
    return out


def compare_images(config: dict, seed: int, device, rows: Sequence[dict],
                   served: Sequence[np.ndarray], steps: int, scale: float,
                   size: int, batch: int, limit: float,
                   control: bool = False):
    """``image_rms`` of the served images against the fp32 reference; with
    ``control`` also ``control_image_rms``: the reference with fp8 operands
    (``ops.fp8``), rounded to 8 bits, against the same fp32 images."""
    from bench_h100.harness import Check
    ops = build_sdxl.reference_ops(config, seed, device)
    ref = reference_images(ops, config, rows, steps, scale, size, device,
                           batch)
    gaps = check.image_gaps(served, ref)
    print(f'check gaps: {gaps}', file=sys.stderr)
    out = [Check('image_rms', gaps['image_rms'], limit)]
    if control:
        ops.low = True
        low = reference_images(ops, config, rows, steps, scale, size, device,
                               batch)
        cgaps = check.image_gaps(check.quantize(low), ref)
        print(f'control gaps: {cgaps}', file=sys.stderr)
        out.append(Check('control_image_rms', cgaps['image_rms'], limit))
    del ops
    check.free_card()
    return out
