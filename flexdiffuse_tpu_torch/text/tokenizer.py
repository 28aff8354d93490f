"""CLIP BPE tokenizer — loads HF ``vocab.json``/``merges.txt``; the merge
loop runs in native code when it builds (``native/``), else in Python.

Drop-in for the transformers ``CLIPTokenizer`` the reference uses
(encode/clip.py:57-63): lowercasing, whitespace cleanup, byte-level BPE with
the ``</w>`` end-of-word convention, ``<|startoftext|>``/``<|endoftext|>``
specials, padding to ``model_max_length`` (77) with truncation. Implemented
from the published algorithm so the framework has no transformers dependency
at runtime; when no vocab files are available (zero-egress test
environments), :class:`FakeTokenizer` provides a deterministic stand-in.
"""
from __future__ import annotations

import functools
import gzip
import html
import json
import logging
import os
import re
import zlib
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np

from flexdiffuse_tpu_torch import native as _native_pkg

MODEL_MAX_LENGTH = 77

# CLIP's pre-tokenization pattern with true unicode letter/number classes
# (the stdlib `re` lacks \p{...}; the `regex` module provides it so accented
# CJK/emoji prompts tokenize identically to the HF CLIPTokenizer).
try:
    import regex as _re
    _PAT = _re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+", _re.IGNORECASE)
except ImportError:  # ASCII-only degradation — WARN: ids will differ
    logging.getLogger(__name__).warning(
        'the `regex` package is unavailable; falling back to ASCII-only '
        'pre-tokenization — non-ASCII prompts will tokenize differently '
        'from the HF CLIPTokenizer')
    _PAT = re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
        r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+", re.IGNORECASE)


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 byte↔unicode table (reversible byte-level encoding)."""
    bs = (list(range(ord('!'), ord('~') + 1)) +
          list(range(ord('¡'), ord('¬') + 1)) +
          list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _whitespace_clean(text: str) -> str:
    return re.sub(r'\s+', ' ', html.unescape(html.unescape(text))).strip()


class CLIPTokenizer:
    """Byte-level BPE with CLIP's end-of-word merges."""

    def __init__(self, vocab_path: str, merges_path: str) -> None:
        with open(vocab_path, encoding='utf-8') as f:
            self.encoder: Dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        opener = gzip.open if merges_path.endswith('.gz') else open
        with opener(merges_path, 'rt', encoding='utf-8') as f:
            merges = f.read().split('\n')
        # First line is the version header; drop empties.
        merges = [m for m in merges[1:] if m and not m.startswith('#')]
        self.bpe_ranks = {
            tuple(m.split()): i for i, m in enumerate(merges)
        }
        self.byte_encoder = bytes_to_unicode()
        self.bos_token_id = self.encoder['<|startoftext|>']
        self.eos_token_id = self.encoder['<|endoftext|>']
        self.model_max_length = MODEL_MAX_LENGTH
        self._cache: Dict[str, List[str]] = {}
        # Added tokens (textual inversion): literal name → id list (multi-
        # vector concepts expand to several consecutive embedding rows).
        self.added_tokens: Dict[str, List[int]] = {}
        self._added_pattern = None
        self._added_count = 0
        # Native merge loop (native/bpe.py): C++ behind ctypes; on any
        # build or load failure the Python loop below serves.
        self._native = None
        if not _native_pkg.disabled():
            try:
                from flexdiffuse_tpu_torch.native.bpe import NativeBPE
                self._native = NativeBPE(self.encoder, self.bpe_ranks)
            except Exception as e:  # no compiler / build error — degrade
                logging.getLogger(__name__).info(
                    'native BPE unavailable (%s); using pure Python', e)

    def add_tokens(self, name: str, num_vectors: int = 1) -> List[int]:
        """Register a literal placeholder token mapping to ``num_vectors``
        fresh ids just past the current vocabulary (textual inversion;
        matched before BPE, case-insensitively)."""
        name = name.lower()
        if name in self.added_tokens:
            raise ValueError(f'token {name!r} already added')
        base = len(self.encoder) + self._added_count
        ids = list(range(base, base + num_vectors))
        self.added_tokens[name] = ids
        self._added_count += num_vectors
        self._added_pattern = re.compile('(' + '|'.join(
            re.escape(t)
            for t in sorted(self.added_tokens, key=len, reverse=True)) + ')')
        return ids

    @classmethod
    def from_dir(cls, model_dir: str) -> 'CLIPTokenizer':
        """Load from an HF snapshot dir (``tokenizer/`` subdir or flat)."""
        for sub in ('tokenizer', '.'):
            v = os.path.join(model_dir, sub, 'vocab.json')
            m = os.path.join(model_dir, sub, 'merges.txt')
            if os.path.exists(v) and os.path.exists(m):
                return cls(v, m)
        raise FileNotFoundError(f'no vocab.json/merges.txt under {model_dir}')

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        if not pairs:
            return [token + '</w>']
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float('inf')))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
        out = list(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Text → BPE ids (no specials). Added tokens match literally
        before BPE."""
        text = _whitespace_clean(text).lower()
        parts = (self._added_pattern.split(text)
                 if self.added_tokens else [text])
        ids: List[int] = []
        for part in parts:
            if part in self.added_tokens:
                ids.extend(self.added_tokens[part])
                continue
            words = _PAT.findall(part)
            if self._native is not None:
                try:
                    ids.extend(self._native.encode_words(words))
                    continue
                except KeyError:
                    pass  # out-of-vocab symbol: the Python path raises
            for tok in words:
                tok = ''.join(self.byte_encoder[b]
                              for b in tok.encode('utf-8'))
                ids.extend(self.encoder[t] for t in self._bpe(tok))
        return ids

    def __call__(self, prompts: Union[str, Sequence[str]],
                 max_length: int | None = None,
                 pad_id: int | None = None) -> np.ndarray:
        """Tokenize to ``[B, max_length]`` int32 with BOS/EOS + padding and
        truncation (matching HF CLIPTokenizer padding='max_length'). Default
        padding is EOS; SDXL's second tokenizer pads with id 0 (``pad_id``).
        """
        if isinstance(prompts, str):
            prompts = [prompts]
        max_length = max_length or self.model_max_length
        fill = self.eos_token_id if pad_id is None else pad_id
        out = np.full((len(prompts), max_length), fill, np.int32)
        for r, p in enumerate(prompts):
            ids = [self.bos_token_id] + self.encode(p)
            ids = ids[:max_length - 1] + [self.eos_token_id]
            out[r, :len(ids)] = ids
        return out


class FakeTokenizer:
    """Deterministic hash tokenizer for weightless test environments."""

    def __init__(self, vocab_size: int = 1000) -> None:
        self.vocab_size = vocab_size
        self.model_max_length = MODEL_MAX_LENGTH
        # Mirror real CLIP: BOS/EOS are the two highest ids, so the
        # argmax-of-ids EOS pooling convention holds.
        self.bos_token_id = vocab_size - 2
        self.eos_token_id = vocab_size - 1
        self.added_tokens: dict = {}
        self._added_count = 0

    def add_tokens(self, name: str, num_vectors: int = 1):
        """Mirror CLIPTokenizer.add_tokens: fresh ids past the vocab."""
        name = name.lower()
        if name in self.added_tokens:
            raise ValueError(f'token {name!r} already added')
        base = self.vocab_size + self._added_count
        ids = list(range(base, base + num_vectors))
        self.added_tokens[name] = ids
        self._added_count += num_vectors
        return ids

    def encode(self, text: str):
        """Content ids without specials (mirrors CLIPTokenizer.encode).
        crc32, not hash(): Python's hash is salted per process and would
        break cross-process determinism."""
        words = _whitespace_clean(text).lower().split()
        out = []
        for w in words:
            if w in self.added_tokens:
                out.extend(self.added_tokens[w])
            else:
                out.append(2 + (zlib.crc32(w.encode()) %
                                (self.vocab_size - 4)))
        return out

    def __call__(self, prompts: Union[str, Sequence[str]],
                 max_length: int | None = None,
                 pad_id: int | None = None) -> np.ndarray:
        if isinstance(prompts, str):
            prompts = [prompts]
        max_length = max_length or self.model_max_length
        fill = self.eos_token_id if pad_id is None else pad_id
        out = np.full((len(prompts), max_length), fill, np.int32)
        for r, p in enumerate(prompts):
            ids = [self.bos_token_id] + self.encode(p)
            ids = ids[:max_length - 1] + [self.eos_token_id]
            out[r, :len(ids)] = ids
        return out
