"""The comparison that decides ``correct`` for the generation cells: the
images the timed path returned for a sample of its requests, against the
plain fp32 reference run once over the same prompts and noise, after the
window has closed and the program is freed.

The number compared is ``image_rms``: per image the root mean square of
the difference in ``[0, 1]`` pixel units (the program's 8-bit image over
255 against the reference's fp32 image), the largest over the sample.
"""
from __future__ import annotations

import gc
import io
import math
import sys
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_h100 import build, seeded
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import samplers


def free_card() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def png_to_array(b64: str) -> np.ndarray:
    import base64
    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))).convert(
        'RGB'))


def reference_ops(config: dict, seed: int, device,
                  precision: str = 'fp32') -> ref_ops.Ops:
    weights: Dict[str, torch.Tensor] = {}
    for part in build.PARTS:
        weights.update(build.reference_weights(config, part, seed, device))
    return ref_ops.Ops(ref_ops.Weights(weights), precision)


def reference_images(ops: ref_ops.Ops, config: dict, rows: Sequence[dict],
                     steps: int, scale: float, device,
                     batch: int) -> List[np.ndarray]:
    """Images ``[H, W, 3]`` fp32 in [0, 1] for ``rows`` (each ``prompt``,
    ``negative``, ``noise`` ``[h, w, C]``), ``batch`` rows a call."""
    vocab = config['text']['vocab_size']
    ids = lambda ps: torch.tensor([seeded.token_ids(p, vocab) for p in ps],
                                  dtype=torch.long, device=device)
    out = []
    with torch.no_grad(), ref_ops.exact_fp32():
        for i in range(0, len(rows), batch):
            part = rows[i:i + batch]
            img = samplers.generate(
                ops, config, ids([r['prompt'] for r in part]),
                ids([r['negative'] for r in part]),
                torch.stack([r['noise'].to(device) for r in part]), steps,
                scale)
            out += list(img.float().cpu().numpy())
    return out


def image_gaps(program: Sequence[np.ndarray],
               reference: Sequence[np.ndarray]) -> Dict[str, float]:
    """The largest per-image RMS gap, and beside it the largest absolute
    gap and the mean absolute gap (diagnostics, not compared)."""
    rms, mx, mean = [math.inf], [math.inf], [math.inf]
    if program:
        rms, mx, mean = [], [], []
    for p, r in zip(program, reference):
        d = p.astype(np.float64) / 255.0 - r.astype(np.float64)
        rms.append(math.sqrt(float(np.mean(d * d))))
        mx.append(float(np.abs(d).max()))
        mean.append(float(np.abs(d).mean()))
    return {'image_rms': max(rms), 'max_abs': max(mx),
            'mean_abs': max(mean), 'n_images': len(rms)}


def pick(n: int, longest: int, k: int, r: np.random.Generator) -> List[int]:
    """``k`` of ``n`` indices drawn by ``r``, always with ``longest``."""
    rest = [i for i in r.permutation(n).tolist() if i != longest]
    return sorted([longest] + rest[:max(0, k - 1)])


def quantize(images: Sequence[np.ndarray]) -> List[np.ndarray]:
    """fp32 images in [0, 1] to 8 bits as the program rounds them (×255,
    half up)."""
    return [np.floor(np.asarray(im, np.float64) * 255.0 + 0.5).astype(
        np.uint8) for im in images]


def compare_images(config: dict, seed: int, device, rows: Sequence[dict],
                   served: Sequence[np.ndarray], steps: int, scale: float,
                   batch: int, limit: float, control: bool = False):
    """``image_rms`` of the served images against the fp32 reference;
    with ``control`` also ``control_image_rms``: the reference computed
    with fp8 operands (``ops.fp8``), rounded to 8 bits, against the same
    fp32 images."""
    from bench_h100.harness import Check
    ops = reference_ops(config, seed, device)
    ref = reference_images(ops, config, rows, steps, scale, device, batch)
    gaps = image_gaps(served, ref)
    print(f'check gaps: {gaps}', file=sys.stderr)
    out = [Check('image_rms', gaps['image_rms'], limit)]
    if control:
        ops.low = True
        low = reference_images(ops, config, rows, steps, scale, device,
                               batch)
        cgaps = image_gaps(quantize(low), ref)
        print(f'control gaps: {cgaps}', file=sys.stderr)
        out.append(Check('control_image_rms', cgaps['image_rms'], limit))
    del ops
    free_card()
    return out
