"""What the benchmark makes from ``--seed``: weights, prompts and token ids,
and frozen copies of the program's own draws, so that the reference can
work the same noise out again.

- :func:`make_weights`: for a list of (name, shape), fp32 normal draws on
  the device from a ``torch.Generator`` of their own, a few large calls,
  scaled by 1/√fan-in (fan-in: the product of every dimension but the
  first); 1-D tensors are 0 (biases) or 1 (norm scales); rounded to the
  dtype the program serves in. The reference gets the same rounded values
  in fp32.
- :func:`row_noise` is ``serving/api.py``'s per-row noise, and
  :func:`generator_noise` the pipeline's draw from a seeded generator.
- :func:`token_ids` is the test tokenizer's arithmetic (a CRC-32 per
  lower-cased word), with BOS first, EOS after the content and EOS padding
  to 77.
"""
from __future__ import annotations

import math
import zlib
from typing import Dict, Iterable, List, Sequence

import numpy as np
import torch

Tensor = torch.Tensor
M64 = 2**64 - 1
MAX_LENGTH = 77
# Draw at most this many fp32 values in one call.
DRAW_CHUNK = 1 << 28

# Prompts are built from these words: plain lower-case ASCII, so that the
# tokenizer's whitespace and HTML clean-up leaves them as they are.
WORDS = tuple('''a an the of in on at with under over near beside old
young small large bright dark quiet loud red blue green golden silver
white black painting photo portrait sketch render city forest river
mountain harbour garden street castle desert ocean island village bridge
tower market sky cloud storm sunset morning night winter summer spring
autumn cat dog horse bird fox owl dragon robot astronaut sailor dancer
child woman man lantern window door boat train car bicycle flower tree
stone glass wood metal fabric light shadow mist rain snow fire smoke
highly detailed sharp focus soft cinematic dramatic lighting wide angle
close up oil watercolor digital art by style of trending'''.split())


def mix64(x: int) -> int:
    """splitmix64's finaliser."""
    x = (x + 0x9E3779B97F4A7C15) & M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & M64
    return x ^ (x >> 31)


def derive(seed: int, tag: str) -> int:
    """A 63-bit seed for the stream ``tag`` of run ``seed``."""
    return mix64((int(seed) & M64) ^ zlib.crc32(tag.encode()) << 32) >> 1


def rng(seed: int, tag: str) -> np.random.Generator:
    return np.random.default_rng(derive(seed, tag))


def make_weights(spec: Dict[str, Sequence[int]], seed: int, tag: str,
                 device, dtype: torch.dtype) -> Dict[str, Tensor]:
    """Seeded weights for ``spec`` (name → shape) in ``dtype`` on
    ``device``; names are drawn in sorted order."""
    gen = torch.Generator(device).manual_seed(derive(seed, tag))
    names = sorted(spec)
    out: Dict[str, Tensor] = {}
    group: List[str] = []

    def flush() -> None:
        sizes = [math.prod(spec[n]) for n in group]
        flat = torch.randn(sum(sizes), generator=gen, device=device,
                           dtype=torch.float32)
        for n, part in zip(group, flat.split(sizes)):
            shape = tuple(spec[n])
            out[n] = (part.view(shape) *
                      math.prod(shape[1:])**-0.5).to(dtype)
        group.clear()

    count = 0
    for n in names:
        shape = tuple(spec[n])
        if len(shape) == 1:
            fill = 0.0 if n.endswith('bias') else 1.0
            out[n] = torch.full(shape, fill, device=device, dtype=dtype)
            continue
        if group and count + math.prod(shape) > DRAW_CHUNK:
            flush()
            count = 0
        group.append(n)
        count += math.prod(shape)
    if group:
        flush()
    return out


def row_noise(seed: int, sample: int, shape: Sequence[int],
              device) -> Tensor:
    """Unit fp32 noise of a served request's row ``sample``: a generator
    on ``device`` seeded by the splitmix64 hash of (seed mod 2**32,
    sample)."""
    gen = torch.Generator(device).manual_seed(mix64(
        ((int(seed) & 0xFFFFFFFF) << 32) | (int(sample) & 0xFFFFFFFF)))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


def generator_noise(seed: int, shape: Sequence[int], device) -> Tensor:
    """Unit fp32 noise drawn first from a generator on ``device`` seeded
    with ``seed``."""
    gen = torch.Generator(device).manual_seed(int(seed))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


def token_ids(prompt: str, vocab_size: int) -> List[int]:
    """77 ids: BOS (vocab−2), ``2 + crc32(word) mod (vocab−4)`` per word,
    EOS (vocab−1), EOS padding; truncated to keep the final EOS."""
    bos, eos = vocab_size - 2, vocab_size - 1
    content = [2 + zlib.crc32(w.encode()) % (vocab_size - 4)
               for w in prompt.lower().split()]
    ids = ([bos] + content)[:MAX_LENGTH - 1] + [eos]
    return ids + [eos] * (MAX_LENGTH - len(ids))


def prompt(r: np.random.Generator, n_words: int) -> str:
    return ' '.join(WORDS[i] for i in r.integers(0, len(WORDS), n_words))


def spread(values: Iterable[float], r: np.random.Generator) -> list:
    """``values`` in an order drawn from ``r``: every seed gets the same
    multiset, so the work is the same and only its order changes."""
    values = list(values)
    return [values[i] for i in r.permutation(len(values))]


def exp_quantiles(n: int, mean: float) -> np.ndarray:
    """``n`` evenly spaced quantiles of an exponential of ``mean``: the
    gaps of a Poisson process, the same set for every seed."""
    q = (np.arange(n) + 0.5) / n
    return -np.log1p(-q) * mean


def uniform_ints(n: int, lo: int, hi: int) -> List[int]:
    """``n`` integers spread evenly over ``[lo, hi]``."""
    return [int(round(v)) for v in np.linspace(lo, hi, n)]
