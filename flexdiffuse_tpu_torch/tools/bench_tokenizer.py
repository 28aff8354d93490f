"""The native C++ BPE merge loop against the Python one (host only).

Port of ``tools/bench_tokenizer.py``, on the port's tokenizer
(``text/tokenizer.py``, ``native/csrc/clip_bpe.cpp``). Builds a full
byte-level vocab with a few thousand synthetic merges (the real CLIP
vocab is not at hand offline; the merge loop's cost depends on the merge
count and the word length, both matched), then times ``encode`` over a
prompt corpus with a fresh tokenizer (cold word cache: serving sees mostly
new words) and over the same corpus again (warm cache). Tokens per second
of the host; nothing runs on the card.

    python -m flexdiffuse_tpu_torch.tools.bench_tokenizer

Prints one JSON line.
"""
from __future__ import annotations

import json
import os
import random
import tempfile
import time

from flexdiffuse_tpu_torch.text.tokenizer import (CLIPTokenizer,
                                                  bytes_to_unicode)


def build_vocab(tmp: str, n_merges: int = 4000) -> tuple:
    rng = random.Random(0)
    vocab = {}
    for ch in bytes_to_unicode().values():
        vocab[ch] = len(vocab)
        vocab[ch + '</w>'] = len(vocab)
    letters = 'abcdefghijklmnopqrstuvwxyz'
    merges = ['#version: 0.2']
    seen = set()
    pieces = [c for c in letters] + [c + '</w>' for c in letters]
    for _ in range(n_merges):
        a = rng.choice([p for p in pieces if not p.endswith('</w>')])
        b = rng.choice(pieces)
        if (a, b) in seen:
            continue
        seen.add((a, b))
        merges.append(f'{a} {b}')
        merged = a + b
        if merged not in vocab:
            vocab[merged] = len(vocab)
        if not merged.endswith('</w>'):
            pieces.append(merged)
    vocab['<|startoftext|>'] = len(vocab)
    vocab['<|endoftext|>'] = len(vocab)
    vp, mp = os.path.join(tmp, 'vocab.json'), os.path.join(tmp, 'merges.txt')
    with open(vp, 'w') as f:
        json.dump(vocab, f)
    with open(mp, 'w') as f:
        f.write('\n'.join(merges))
    return vp, mp


def corpus(n: int = 2000) -> list:
    rng = random.Random(1)
    letters = 'abcdefghijklmnopqrstuvwxyz'
    words = [''.join(rng.choice(letters)
                     for _ in range(rng.randrange(2, 12)))
             for _ in range(400)]
    return [' '.join(rng.choice(words) for _ in range(rng.randrange(5, 60)))
            for _ in range(n)]


def _tokenizer(vp: str, mp: str, native: bool) -> CLIPTokenizer:
    tok = CLIPTokenizer(vp, mp)
    if not native:
        tok._native = None
    return tok


def _rate(tok: CLIPTokenizer, prompts) -> float:
    t0 = time.perf_counter()
    total = sum(len(tok.encode(p)) for p in prompts)
    return total / (time.perf_counter() - t0)


def measure(n_merges: int = 4000, n_prompts: int = 2000) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        vp, mp = build_vocab(tmp, n_merges)
        prompts = corpus(n_prompts)
        results = {}
        for label, native in (('python', False), ('native', True)):
            # cold: a fresh tokenizer (empty word cache)
            results[label + '_cold_tok_per_s'] = _rate(
                _tokenizer(vp, mp, native), prompts)
            # warm: a second pass over the same corpus (cache hits)
            tok = _tokenizer(vp, mp, native)
            for p in prompts:
                tok.encode(p)
            results[label + '_warm_tok_per_s'] = _rate(tok, prompts)
        results['native_available'] = \
            CLIPTokenizer(vp, mp)._native is not None
    for kind in ('cold', 'warm'):
        results[f'speedup_{kind}'] = (results[f'native_{kind}_tok_per_s'] /
                                      results[f'python_{kind}_tok_per_s'])
    return results


def main() -> None:
    print(json.dumps(dict(measure(), device='host')), flush=True)


if __name__ == '__main__':
    main()
