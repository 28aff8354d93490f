"""Textual-inversion embeddings — learned concept tokens (port of
``flexdiffuse_tpu/weights/textual_inversion.py``).

An embedding file carries ``[n, d]`` learned vectors for a placeholder
token. Loading it registers the literal token with the tokenizer
(multi-vector concepts expand to n consecutive ids) and appends the vectors
as new rows of the text encoder's ``token_embedding``: a new
``nn.Embedding`` on the old one's device and in its dtype, the old rows
kept, ``config.vocab_size`` updated. The CLIP text tower's 77 tokens never
reach a flash kernel, so no kernel launch changes.

File layouts: A1111 ``.pt`` (``{'string_to_param': {'*': T}}``),
safetensors with ``emb_params``, and single-tensor dicts keyed by the token
name (the diffusers convention).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn


def extract_embedding(sd: Mapping, token: Optional[str] = None
                      ) -> Tuple[Optional[str], np.ndarray]:
    """State dict → (token name or None, ``[n, d]`` fp32 vector table)."""
    if 'string_to_param' in sd:                       # A1111 .pt (nested)
        table = sd['string_to_param']
        if isinstance(table, Mapping):
            table = next(iter(table.values()))
    elif any(k.startswith('string_to_param.') for k in sd):
        table = sd[next(k for k in sd if k.startswith('string_to_param.'))]
    elif 'emb_params' in sd:
        table = sd['emb_params']
    else:
        tensors = {k: v for k, v in sd.items()
                   if hasattr(v, 'ndim') and v.ndim in (1, 2)}
        if len(tensors) != 1:
            raise ValueError(
                f'cannot locate the embedding tensor (keys: {list(sd)})')
        key, table = next(iter(tensors.items()))
        token = token or key
    if isinstance(table, torch.Tensor):
        table = table.detach().float().cpu().numpy()
    table = np.asarray(table, np.float32)
    if table.ndim == 1:
        table = table[None]
    if table.ndim != 2:
        raise ValueError(f'embedding table has rank {table.ndim}, expected 2')
    return token, table


def add_textual_inversion(tokenizer, text_model: nn.Module, name: str,
                          table: np.ndarray) -> nn.Module:
    """Register ``name`` with the tokenizer and append ``table``'s rows to
    ``text_model``'s token embedding, in place; returns ``text_model``."""
    emb = text_model.text_model.embeddings.token_embedding
    rows, width = emb.weight.shape
    if table.shape[1] != width:
        raise ValueError(
            f'embedding width {table.shape[1]} does not match the text '
            f'encoder ({width}) — wrong base model for this inversion')
    ids = tokenizer.add_tokens(name, num_vectors=table.shape[0])
    if ids[0] != rows:
        raise ValueError(
            f'tokenizer id space ({ids[0]}) out of sync with the embedding '
            f'table ({rows} rows)')
    w = emb.weight
    grown = nn.Embedding(rows + table.shape[0], width, device=w.device,
                         dtype=w.dtype)
    grown.requires_grad_(w.requires_grad)
    with torch.no_grad():
        grown.weight[:rows] = w
        grown.weight[rows:] = torch.from_numpy(table).to(w.device, w.dtype)
    text_model.text_model.embeddings.token_embedding = grown
    text_model.config = dataclasses.replace(text_model.config,
                                            vocab_size=rows + table.shape[0])
    return text_model
