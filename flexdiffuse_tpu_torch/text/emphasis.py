"""Prompt-emphasis parsing and weighted tokenization, A1111 syntax (port of
``flexdiffuse_tpu/text/emphasis.py``, pure Python).

Beyond the reference, which tokenizes prompts verbatim
(``encode/clip.py:47-65``): the de-facto community syntax for per-token
attention emphasis —

* ``(text)``        ×1.1 weight (nesting multiplies: ``((x))`` = 1.21)
* ``[text]``        ×1/1.1
* ``(text:1.3)``    explicit weight
* ``\\(`` ``\\)`` ``\\[`` ``\\]`` ``\\\\``  literal characters
* ``BREAK``         hard chunk boundary (long-prompt windows)

The grammar is implemented from its published description (stack of open
groups; closing applies the group multiplier to every fragment opened since).
Application follows the same convention downstream UIs use: scale each
token's embedding by its weight, then rescale the whole context so its mean
matches the unweighted encoding's mean (keeps overall conditioning magnitude
stable so CFG strength isn't silently changed).
"""
from __future__ import annotations

import re
from typing import List, Tuple

_TOKEN = re.compile(r"""
    \\[\\()\[\]] |      # escaped literal
    \(            |     # open  ()
    \[            |     # open  []
    :\s*([+-]?[\d.]+)\s*\) |  # explicit-weight close
    \)            |     # plain close ()
    \]            |     # close []
    \bBREAK\b     |     # hard chunk break
    (?:(?!\bBREAK\b)[^\\()\[\]:])+ |  # run of plain text (stops at BREAK)
    :                   # bare colon (literal)
""", re.X)

ATTENTION_MULT = 1.1

# Sentinel weight marking a hard chunk boundary in parse output.
BREAK = None


def parse(text: str) -> List[Tuple[str, float]]:
    """Parse emphasis syntax → ``[(fragment, weight)]`` in prompt order.

    A ``BREAK`` keyword yields a ``('BREAK', None)`` marker. Unbalanced
    closers are treated as literals; unclosed openers apply to the prompt
    tail (both matching the lenient behavior users expect).
    """
    out: List[Tuple[str, float]] = []
    # Stack of indices into `out` where currently-open groups began.
    round_stack: List[int] = []
    square_stack: List[int] = []

    def _scale(start: int, mult: float) -> None:
        for i in range(start, len(out)):
            if out[i][1] is not BREAK:
                out[i] = (out[i][0], out[i][1] * mult)

    for m in _TOKEN.finditer(text):
        tok = m.group(0)
        if tok.startswith('\\'):
            out.append((tok[1], 1.0))
        elif tok == '(':
            round_stack.append(len(out))
        elif tok == '[':
            square_stack.append(len(out))
        elif m.group(1) is not None:        # ":1.3)"
            if round_stack:
                try:
                    w = float(m.group(1))
                except ValueError:
                    w = ATTENTION_MULT
                _scale(round_stack.pop(), w)
            else:
                out.append((tok, 1.0))      # stray ":1.3)" — literal
        elif tok == ')':
            if round_stack:
                _scale(round_stack.pop(), ATTENTION_MULT)
            else:
                out.append((tok, 1.0))
        elif tok == ']':
            if square_stack:
                _scale(square_stack.pop(), 1.0 / ATTENTION_MULT)
            else:
                out.append((tok, 1.0))
        elif tok == 'BREAK':
            out.append(('BREAK', BREAK))
        else:
            out.append((tok, 1.0))
    # Unclosed groups emphasize through to the end.
    for start in round_stack:
        _scale(start, ATTENTION_MULT)
    for start in square_stack:
        _scale(start, 1.0 / ATTENTION_MULT)
    # Merge adjacent fragments with identical weight (fewer tokenizer calls
    # and no splits inside words at group boundaries like "a (b)c").
    merged: List[Tuple[str, float]] = []
    for frag, w in out:
        if w is BREAK:
            merged.append((frag, w))
        elif merged and merged[-1][1] == w and merged[-1][1] is not BREAK:
            merged[-1] = (merged[-1][0] + frag, w)
        else:
            merged.append((frag, w))
    return [(f, w) for f, w in merged if w is BREAK or f != '']


def tokenize_weighted(tokenizer, text: str):
    """Tokenize with per-token weights → ``(ids, weights, breaks)``.

    ``ids``/``weights`` are parallel lists over *content* tokens (no
    BOS/EOS); ``breaks`` is a set of id-list indices at which a hard chunk
    boundary was requested (index = position of the first token AFTER the
    BREAK).
    """
    ids: List[int] = []
    weights: List[float] = []
    breaks = set()
    for frag, w in parse(text):
        if w is BREAK:
            breaks.add(len(ids))
            continue
        frag_ids = tokenizer.encode(frag)
        ids.extend(frag_ids)
        weights.extend([w] * len(frag_ids))
    return ids, weights, breaks
