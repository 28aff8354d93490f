"""ctypes binding for the native CLIP BPE encoder (csrc/clip_bpe.cpp; port
of ``flexdiffuse_tpu/native/bpe.py``).

Splits the tokenizer with :mod:`flexdiffuse_tpu_torch.text.tokenizer`:
Python owns unicode normalization + the HF-exact pre-tokenization regex;
C++ owns the byte→unicode mapping and the BPE merge loop. ``NativeBPE.encode_words``
takes the regex's raw pre-tokens and returns vocab ids.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Tuple

from . import load

_UNKNOWN = -1
_OVERFLOW = -2


class NativeBPE:
    """One native handle per tokenizer instance (owns its word cache)."""

    def __init__(self, encoder: Dict[str, int],
                 bpe_ranks: Dict[Tuple[str, str], int]) -> None:
        self._lib = load('clip_bpe')
        self._lib.clip_bpe_create.restype = ctypes.c_void_p
        self._lib.clip_bpe_create.argtypes = [ctypes.c_char_p,
                                              ctypes.c_char_p]
        self._lib.clip_bpe_destroy.argtypes = [ctypes.c_void_p]
        self._lib.clip_bpe_encode_words.restype = ctypes.c_long
        self._lib.clip_bpe_encode_words.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_long]
        vocab_tsv = '\n'.join(
            f'{i}\t{tok}' for tok, i in encoder.items()
            if '\n' not in tok and '\t' not in tok)
        merges = '\n'.join(
            f'{a} {b}' for (a, b), _ in
            sorted(bpe_ranks.items(), key=lambda kv: kv[1]))
        self._handle = self._lib.clip_bpe_create(
            vocab_tsv.encode('utf-8'), merges.encode('utf-8'))
        if not self._handle:
            raise RuntimeError('clip_bpe_create returned NULL')

    def __del__(self) -> None:
        handle = getattr(self, '_handle', None)
        if handle:
            self._lib.clip_bpe_destroy(handle)
            self._handle = None

    def encode_words(self, words: Sequence[str]) -> List[int]:
        """Raw pre-tokens (no whitespace) → flat vocab-id list.

        Raises ``KeyError`` on out-of-vocab symbols — the caller falls back
        to the Python path, which raises the same way the HF tokenizer does.
        """
        if not words:
            return []
        payload = '\n'.join(words).encode('utf-8')
        cap = 4 * len(payload) + 16
        while True:
            buf = (ctypes.c_int32 * cap)()
            n = self._lib.clip_bpe_encode_words(
                self._handle, payload, buf, cap)
            if n == _OVERFLOW:
                cap *= 2
                continue
            if n == _UNKNOWN:
                raise KeyError(f'out-of-vocab symbol in {words!r}')
            return list(buf[:n])
