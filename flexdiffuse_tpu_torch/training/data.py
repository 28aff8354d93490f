"""Training data: folder-of-images datasets and precomputed encodings on the
device (port of ``flexdiffuse_tpu/training/data.py``).

All encoding happens up front: images are VAE-encoded (the posterior mean
and log-variance kept, a fresh sample drawn per batch) and captions
CLIP-encoded once, and the training loop gathers shuffled rows out of
tensors resident on the VAE's device. An SDXL dataset
(:func:`encode_dataset_sdxl`) also carries each row's pooled text
embedding and the micro-conditioning time ids, and its batches carry the
SDXL UNet's ``added_cond``.

Dataset layout (kohya/diffusers folder conventions):

* ``<dir>/*.png|jpg|jpeg|webp|bmp`` with a same-stem ``.txt`` caption
  sidecar, OR
* ``<dir>/metadata.jsonl`` lines ``{"file_name": ..., "text": ...}``, OR
* no captions at all → every image uses ``default_caption`` (DreamBooth
  single-concept style).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from PIL import Image

from flexdiffuse_tpu_torch.config import LATENT_SCALE

Tensor = torch.Tensor
log = logging.getLogger(__name__)

IMAGE_EXTS = ('.png', '.jpg', '.jpeg', '.webp', '.bmp')


def find_items(data_dir: str,
               default_caption: str = '') -> List[Tuple[str, str]]:
    """``[(image_path, caption)]`` for a dataset folder (see module doc)."""
    if not os.path.isdir(data_dir):
        raise ValueError(f'not a dataset directory: {data_dir!r}')
    meta = {}
    meta_path = os.path.join(data_dir, 'metadata.jsonl')
    if os.path.exists(meta_path):
        with open(meta_path, encoding='utf-8') as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                row = json.loads(line)
                meta[row['file_name']] = row.get('text', default_caption)
    items: List[Tuple[str, str]] = []
    for name in sorted(os.listdir(data_dir)):
        stem, ext = os.path.splitext(name)
        if ext.lower() not in IMAGE_EXTS:
            continue
        path = os.path.join(data_dir, name)
        txt = os.path.join(data_dir, stem + '.txt')
        if name in meta:
            caption = meta[name]
        elif os.path.exists(txt):
            with open(txt, encoding='utf-8') as f:
                caption = f.read().strip()
        else:
            caption = default_caption
        items.append((path, caption))
    if not items:
        raise ValueError(f'no images found under {data_dir!r} '
                         f'(looked for {", ".join(IMAGE_EXTS)})')
    return items


def load_pixels(path: str, resolution: int) -> np.ndarray:
    """Image file → ``[H, W, 3]`` float32 in [-1, 1], center-cropped to a
    square and resized to ``resolution`` (the standard SD training crop)."""
    img = Image.open(path).convert('RGB')
    w, h = img.size
    side = min(w, h)
    img = img.crop(((w - side) // 2, (h - side) // 2,
                    (w - side) // 2 + side, (h - side) // 2 + side))
    img = img.resize((resolution, resolution), Image.LANCZOS)
    return np.asarray(img, np.float32) / 127.5 - 1.0


class EncodedDataset:
    """Precomputed VAE posteriors and text contexts on one device.

    ``mean``/``logvar``: ``[N, h, w, 4]`` fp32 (pre-scale); ``context``:
    ``[N, 77·k, D]``. :meth:`batches` draws shuffled rows and samples the
    posterior fresh each time, pre-scaled by ``LATENT_SCALE`` — ready for
    :func:`flexdiffuse_tpu_torch.training.diffusion_loss`.

    SDXL: ``pooled`` ``[N, D]`` (the second encoder's pooled embedding per
    row) and ``time_ids`` ``[1, 6]`` (the dataset-constant
    micro-conditioning, ``models/sdxl.py`` ``time_ids``), both kept fp32 on
    the dataset's device; then every sample carries a third element, the
    ``added_cond`` the SDXL UNet takes.
    """

    def __init__(self, mean: Tensor, logvar: Tensor, context: Tensor,
                 captions: Sequence[str], pooled: Optional[Tensor] = None,
                 time_ids: Optional[Tensor] = None):
        if not (mean.shape[0] == logvar.shape[0] == context.shape[0]):
            raise ValueError('row-count mismatch between latents and context')
        if pooled is not None and pooled.shape[0] != mean.shape[0]:
            raise ValueError('row-count mismatch on pooled embeds')
        self.mean = mean
        self.logvar = logvar.to(mean.device)
        self.context = context.to(mean.device)
        self.captions = list(captions)
        self.pooled = (None if pooled is None else
                       pooled.to(mean.device, torch.float32))
        self.time_ids = (None if time_ids is None else
                         time_ids.to(mean.device, torch.float32))

    def __len__(self) -> int:
        return int(self.mean.shape[0])

    @property
    def device(self) -> torch.device:
        return self.mean.device

    def sample(self, idx: Tensor, noise: Tensor) -> Tuple[Tensor, ...]:
        """Rows ``idx``: posterior samples ``(mean + exp(logvar/2)·noise)·
        LATENT_SCALE`` with the unit ``noise`` given, and their contexts;
        for an SDXL dataset also ``{'text_embeds': [B, D], 'time_ids': [B,
        6]}``, the time ids broadcast from the dataset's ``[1, 6]``."""
        idx = idx.to(self.device)
        lat = (self.mean[idx] + torch.exp(0.5 * self.logvar[idx]) *
               noise.to(self.device)) * LATENT_SCALE
        if self.pooled is None:
            return lat, self.context[idx]
        added = {'text_embeds': self.pooled[idx],
                 'time_ids': self.time_ids.expand(
                     idx.shape[0], self.time_ids.shape[-1])}
        return lat, self.context[idx], added

    def batches(self, batch_size: int, generator: torch.Generator,
                skip: int = 0) -> Iterator[Tuple[Tensor, ...]]:
        """Infinite shuffled ``(latents, context[, added_cond])`` batches
        (drop-last; datasets smaller than ``batch_size`` sample with
        replacement); the third element as :meth:`sample` gives it.

        Each epoch draws a permutation from ``generator`` (on the dataset's
        device), then each batch its posterior noise. ``skip`` fast-forwards
        past the first ``skip`` batches by making the same draws without
        sampling (checkpoint resume), so ``batches(bs, g, skip=s)`` from a
        generator in the same state yields exactly what the ``s``-th
        ``next()`` of ``batches(bs, g)`` would.
        """
        n = len(self)
        dev = self.device
        shape = (batch_size,) + tuple(self.mean.shape[1:])
        while True:
            if n < batch_size:
                order = torch.randint(0, n, (batch_size,), device=dev,
                                      generator=generator)
            else:
                order = torch.randperm(n, device=dev, generator=generator)
            for i in range(0, max(len(order) - batch_size + 1, 1),
                           batch_size):
                noise = torch.randn(shape, device=dev, generator=generator)
                if skip > 0:
                    skip -= 1
                    continue
                yield self.sample(order[i:i + batch_size], noise)


@torch.no_grad()
def encode_images(paths: Sequence[str], vae, resolution: int = 512,
                  encode_batch: int = 8) -> Tuple[Tensor, Tensor]:
    """Image files → the VAE posterior ``(mean, logvar)`` ``[N, h, w, 4]``
    fp32 on the VAE's device, encoded ``encode_batch`` images at a time."""
    dev = next(vae.parameters()).device
    means, logvars = [], []
    for i in range(0, len(paths), encode_batch):
        px = np.stack([load_pixels(p, resolution)
                       for p in paths[i:i + encode_batch]])
        m, lv = vae.encode(torch.from_numpy(px).to(dev))
        means.append(m)
        logvars.append(lv)
    return torch.cat(means), torch.cat(logvars)


def encode_dataset(items: Sequence[Tuple[str, str]], vae, encoder,
                   resolution: int = 512,
                   encode_batch: int = 8) -> EncodedDataset:
    """Encode a dataset folder once: images through the VAE encoder and
    captions through the CLIP text tower (``encoder.prompt``), one pass over
    the unique captions gathered back per row."""
    mean, logvar = encode_images([p for p, _ in items], vae, resolution,
                                 encode_batch)
    captions = [c for _, c in items]
    uniq = sorted(set(captions))
    ctx_u = torch.as_tensor(encoder.prompt(uniq)).to(mean.device)
    by_cap = {c: i for i, c in enumerate(uniq)}
    rows = torch.tensor([by_cap[c] for c in captions], device=mean.device)
    ds = EncodedDataset(mean, logvar, ctx_u[rows], captions)
    log.info('encoded %d images (%d unique captions) at %dx%d -> latents %s',
             len(items), len(uniq), resolution, resolution,
             tuple(ds.mean.shape))
    return ds


def encode_dataset_sdxl(items: Sequence[Tuple[str, str]], vae, encoder,
                        resolution: int = 1024,
                        encode_batch: int = 4) -> EncodedDataset:
    """SDXL variant: ``encoder`` is a :class:`~flexdiffuse_tpu_torch.models.
    sdxl.SDXLTextEncoder`; captions encode once (deduplicated) to the
    dual-tower context and the pooled embedding, and the dataset carries the
    micro-conditioning ids for its resolution (original = target = the
    training resolution, no crop: the standard fine-tuning
    conditioning)."""
    from flexdiffuse_tpu_torch.models.sdxl import time_ids as _time_ids
    mean, logvar = encode_images([p for p, _ in items], vae, resolution,
                                 encode_batch)
    captions = [c for _, c in items]
    uniq = sorted(set(captions))
    ctx_u, pooled_u = encoder.encode(uniq)
    by_cap = {c: i for i, c in enumerate(uniq)}
    rows = torch.tensor([by_cap[c] for c in captions], device=mean.device)
    ds = EncodedDataset(
        mean, logvar, torch.as_tensor(ctx_u).to(mean.device)[rows], captions,
        pooled=torch.as_tensor(pooled_u).to(mean.device)[rows],
        time_ids=_time_ids(original_size=(resolution, resolution),
                           target_size=(resolution, resolution)))
    log.info('encoded %d SDXL images (%d unique captions) at %dx%d',
             len(items), len(uniq), resolution, resolution)
    return ds
