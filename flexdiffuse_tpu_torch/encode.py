"""CLIPEncoder — text and image embedding facade (port of
``flexdiffuse_tpu/encode.py``).

* ``prompt(str | list[str]) -> [B, 77, D]`` — tokenize (pad/truncate to 77)
  and run the text tower's post-LN last hidden state (``clip_skip=1``: the
  penultimate one through the final LN);
* ``prompt_chunked`` / ``prompt_weighted`` — long prompts in 75-token
  windows (A1111), the latter with emphasis weights, ``-> [1, 77·k, D]``;
* ``image(PIL) -> [1, 1 + P, D]`` — SD-preprocess →
  center-crop → bicubic to the tower's ``image_size`` → normalize (from the
  [-1, 1] range, a reference quirk) → the vision tower's all-patch path.

The towers own their weights; inputs go to the towers' device. Outputs are
in the towers' dtype, as in the JAX package.
"""
from __future__ import annotations

import logging
from typing import List, Union

import numpy as np
import torch

from flexdiffuse_tpu_torch.text.emphasis import tokenize_weighted
from flexdiffuse_tpu_torch.utils.image import clip_preprocess
from flexdiffuse_tpu_torch.utils.profiling import spanned

log = logging.getLogger(__name__)


class CLIPEncoder:
    def __init__(self, text_model, vision_model, tokenizer,
                 clip_skip: int = 0) -> None:
        """``clip_skip=1`` conditions on the penultimate hidden state run
        through ``final_layer_norm``, the diffusers/A1111 convention many
        fine-tuned SD-1.x checkpoints are trained against; 0 is the
        reference's behaviour."""
        if clip_skip not in (0, 1):
            raise ValueError('clip_skip must be 0 or 1')
        self.tokenizer = tokenizer
        self.text_model = text_model
        self.vision_model = vision_model
        self._output = 'penultimate_norm' if clip_skip else 'final'

    def replace_text(self, text_model) -> None:
        """Swap the text tower (after a textual-inversion vocabulary
        extension)."""
        self.text_model = text_model

    @torch.no_grad()
    def _encode(self, ids: np.ndarray) -> torch.Tensor:
        dev = next(self.text_model.parameters()).device
        ids = torch.from_numpy(ids.astype(np.int64)).to(dev)
        return self.text_model(ids, output=self._output)

    @spanned('fd.encode')
    def prompt(self, prompt: Union[str, List[str]]) -> torch.Tensor:
        return self._encode(self.tokenizer(prompt))

    def _rows(self, chunks: List[List[int]]) -> np.ndarray:
        """BOS + chunk + EOS, EOS-padded to 77, one row per chunk."""
        tk = self.tokenizer
        rows = np.full((len(chunks), tk.model_max_length), tk.eos_token_id,
                       np.int64)
        for r, ch in enumerate(chunks):
            rows[r, 0] = tk.bos_token_id
            rows[r, 1:1 + len(ch)] = ch
        return rows

    @spanned('fd.encode')
    def prompt_chunked(self, prompt: str, max_chunks: int = 8
                       ) -> torch.Tensor:
        """Long-prompt encoding (A1111): content tokens beyond the
        75-token window split into BOS…EOS chunks, each encoded on its own,
        contexts concatenated → ``[1, 77·k, D]`` (k at most ``max_chunks``;
        cross-attention takes any context length). A short prompt gives the
        plain 77-token encoding."""
        content = self.tokenizer.encode(prompt)
        window = self.tokenizer.model_max_length - 2     # 75 content tokens
        if len(content) <= window:
            return self.prompt(prompt)
        chunks = [content[i:i + window]
                  for i in range(0, len(content), window)]
        if len(chunks) > max_chunks:
            log.warning('prompt needs %d chunks; truncating to max_chunks=%d '
                        '(%d tokens dropped)', len(chunks), max_chunks,
                        len(content) - max_chunks * window)
            chunks = chunks[:max_chunks]
        enc = self._encode(self._rows(chunks))            # [k, 77, D]
        return enc.reshape(1, -1, enc.shape[-1])

    @spanned('fd.encode')
    def prompt_weighted(self, prompt: str, max_chunks: int = 8
                        ) -> torch.Tensor:
        """Emphasis-weighted encoding (A1111 ``(word:1.3)`` syntax,
        ``text/emphasis.py``): 75-token windows as :meth:`prompt_chunked`
        (``BREAK`` forces a window boundary), each token's embedding scaled
        by its weight, then each window's mean restored so the overall
        conditioning magnitude (and so the effective CFG strength) stays.
        Returns ``[1, 77·k, D]`` (``k=1`` for short prompts) in the tower's
        dtype."""
        tk = self.tokenizer
        ids, weights, breaks = tokenize_weighted(tk, prompt)
        window = tk.model_max_length - 2
        chunks: list = []
        cur_i: list = []
        cur_w: list = []
        for idx, (i, w) in enumerate(zip(ids, weights)):
            if (idx in breaks and cur_i) or len(cur_i) == window:
                chunks.append((cur_i, cur_w))
                cur_i, cur_w = [], []
            cur_i.append(i)
            cur_w.append(w)
        if cur_i or not chunks:
            chunks.append((cur_i, cur_w))
        if len(chunks) > max_chunks:
            log.warning('weighted prompt needs %d chunks; truncating to '
                        'max_chunks=%d', len(chunks), max_chunks)
            chunks = chunks[:max_chunks]
        wrows = np.ones((len(chunks), tk.model_max_length), np.float32)
        for r, (_, cw) in enumerate(chunks):
            wrows[r, 1:1 + len(cw)] = cw
        enc = self._encode(self._rows([ci for ci, _ in chunks]))
        if np.allclose(wrows, 1.0):
            return enc.reshape(1, -1, enc.shape[-1])
        w = torch.from_numpy(wrows).to(enc.device)[..., None]
        mean_before = enc.mean(dim=(1, 2), keepdim=True)
        z = enc * w
        mean_after = z.mean(dim=(1, 2), keepdim=True)
        # Multiplicative mean restoration (the community convention); where
        # the mean is near zero (random test towers) the ratio would be
        # arbitrary, so an additive shift restores it instead.
        safe = mean_after.abs() > 1e-6 * z.abs().mean()
        ratio = torch.where(safe, mean_before / torch.where(
            safe, mean_after, torch.ones_like(mean_after)),
            torch.ones_like(mean_after))
        shift = torch.where(safe, torch.zeros_like(mean_after),
                            mean_before - mean_after)
        out = z * ratio + shift
        return out.to(enc.dtype).reshape(1, -1, z.shape[-1])

    @torch.no_grad()
    def image(self, image) -> torch.Tensor:
        pixels = clip_preprocess(image, self.vision_model.config.image_size)
        dev = next(self.vision_model.parameters()).device
        return self.vision_model(torch.from_numpy(pixels).to(dev))
