"""Training data: folder-of-images datasets and precomputed encodings on the
device (port of ``flexdiffuse_tpu/training/data.py``, SD-1.x only).

All encoding happens up front: images are VAE-encoded (the posterior mean
and log-variance kept, a fresh sample drawn per batch) and captions
CLIP-encoded once, and the training loop gathers shuffled rows out of
tensors resident on the VAE's device.

Dataset layout (kohya/diffusers folder conventions):

* ``<dir>/*.png|jpg|jpeg|webp|bmp`` with a same-stem ``.txt`` caption
  sidecar, OR
* ``<dir>/metadata.jsonl`` lines ``{"file_name": ..., "text": ...}``, OR
* no captions at all → every image uses ``default_caption`` (DreamBooth
  single-concept style).

``encode_dataset_sdxl`` waits for SDXL training (ROADMAP Queue 1 step 12).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Iterator, List, Sequence, Tuple

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
    ``[N, 77, D]``. :meth:`batches` draws shuffled rows and samples the
    posterior fresh each time, pre-scaled by ``LATENT_SCALE`` — ready for
    :func:`flexdiffuse_tpu_torch.training.diffusion_loss`.
    """

    def __init__(self, mean: Tensor, logvar: Tensor, context: Tensor,
                 captions: Sequence[str]):
        if not (mean.shape[0] == logvar.shape[0] == context.shape[0]):
            raise ValueError('row-count mismatch between latents and context')
        self.mean = mean
        self.logvar = logvar.to(mean.device)
        self.context = context.to(mean.device)
        self.captions = list(captions)

    def __len__(self) -> int:
        return int(self.mean.shape[0])

    @property
    def device(self) -> torch.device:
        return self.mean.device

    def sample(self, idx: Tensor, noise: Tensor) -> Tuple[Tensor, Tensor]:
        """Rows ``idx``: posterior samples ``(mean + exp(logvar/2)·noise)·
        LATENT_SCALE`` with the unit ``noise`` given, and their contexts."""
        idx = idx.to(self.device)
        lat = (self.mean[idx] + torch.exp(0.5 * self.logvar[idx]) *
               noise.to(self.device)) * LATENT_SCALE
        return lat, self.context[idx]

    def batches(self, batch_size: int, generator: torch.Generator,
                skip: int = 0) -> Iterator[Tuple[Tensor, Tensor]]:
        """Infinite shuffled ``(latents, context)`` batches (drop-last;
        datasets smaller than ``batch_size`` sample with replacement).

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
