"""Textual-inversion training: learn new concept tokens from images (port
of ``flexdiffuse_tpu/training/textual_inversion.py``).

Only ``n`` new rows of the text encoder's token-embedding table train; the
UNet, the VAE, the text tower and every existing embedding row are frozen.

* The trainable state is the fp32 ``[n, d]`` rows. Each step builds a fresh
  table from the frozen rows (detached) and the live rows (cast to the
  table's dtype) at ``row_start`` — the JAX step's ``dynamic_update_slice``
  into a ``stop_gradient`` copy — and runs the text tower on it through
  ``torch.func.functional_call``, so no ``nn.Embedding`` weight ever takes
  a gradient. The loss differentiates through the text tower into the
  UNet's denoising loss.
* Prompts come from the published TI template set ("a photo of a {}", …)
  with the placeholder expanded to its ``n`` consecutive ids; the token ids
  are computed once per template, so the loop samples ``(latents, ids)``
  rows with no host work per step.
* Trained rows export in the diffusers single-tensor convention
  (``{placeholder: [n, d]}`` fp32 safetensors), which
  ``Runner.load_textual_inversion`` reads back
  (``weights/textual_inversion.py``).

On the card the first self-attention of the UNet needs no gradient (the
trainable context enters later, at its cross-attention), so it runs on K1;
the others train through K3/K4/K5 (``ops/attention.py``).

Published formulation: Gal et al. 2022, "An Image is Worth One Word".
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from flexdiffuse_tpu_torch.config import LATENT_SCALE
from flexdiffuse_tpu_torch.training import train as _train
from flexdiffuse_tpu_torch.training.data import encode_images
from flexdiffuse_tpu_torch.training.loop import generators
from flexdiffuse_tpu_torch.weights.safetensors import save_safetensors

Tensor = torch.Tensor
log = logging.getLogger(__name__)

TABLE = 'text_model.embeddings.token_embedding.weight'

# The "imagenet_templates_small" set the TI paper trains object concepts
# with (style concepts conventionally swap "photo" → "painting in the
# style"; pass templates= to override).
OBJECT_TEMPLATES = (
    'a photo of a {}',
    'a rendering of a {}',
    'a cropped photo of the {}',
    'the photo of a {}',
    'a photo of a clean {}',
    'a photo of a dirty {}',
    'a dark photo of the {}',
    'a photo of my {}',
    'a photo of the cool {}',
    'a close-up photo of a {}',
    'a bright photo of the {}',
    'a cropped photo of a {}',
    'a photo of the {}',
    'a good photo of the {}',
    'a photo of one {}',
    'a close-up photo of the {}',
    'a rendition of the {}',
    'a photo of the clean {}',
    'a rendition of a {}',
    'a photo of a nice {}',
    'a good photo of a {}',
    'a photo of the nice {}',
    'a photo of the small {}',
    'a photo of the weird {}',
    'a photo of the large {}',
    'a photo of a cool {}',
    'a photo of a small {}',
)

STYLE_TEMPLATES = (
    'a painting in the style of {}',
    'a rendering in the style of {}',
    'a cropped painting in the style of {}',
    'the painting in the style of {}',
    'a clean painting in the style of {}',
    'a picture in the style of {}',
    'a cool painting in the style of {}',
    'a close-up painting in the style of {}',
    'a bright painting in the style of {}',
    'a good painting in the style of {}',
    'a rendition in the style of {}',
    'a nice painting in the style of {}',
    'a small painting in the style of {}',
    'a weird painting in the style of {}',
    'a large painting in the style of {}',
)


def _table(text_model: nn.Module) -> Tensor:
    return text_model.text_model.embeddings.token_embedding.weight


def init_rows(text_model: nn.Module, tokenizer,
              initializer_token: Optional[str], num_vectors: int,
              generator: Optional[torch.Generator] = None) -> Tensor:
    """Initial fp32 ``[n, d]`` rows on the text tower's device: copies of
    the initializer token's embedding (the paper's coarse-prior init) or
    0.01·N(0,1) drawn from ``generator`` without one."""
    table = _table(text_model).detach()
    if initializer_token:
        ids = tokenizer.encode(initializer_token)
        if len(ids) != 1:
            raise ValueError(
                f'initializer_token {initializer_token!r} must be a single '
                f'token (got {len(ids)})')
        return table[ids[0]].float().expand(num_vectors, -1).clone()
    gdev = generator.device if generator is not None else 'cpu'
    return 0.01 * torch.randn((num_vectors, table.shape[1]),
                              generator=generator, device=gdev).to(
                                  table.device)


def template_ids(tokenizer, placeholder: str,
                 templates: Sequence[str]) -> np.ndarray:
    """``[T, 77]`` token-id rows, one per template with the placeholder
    (already registered via ``tokenizer.add_tokens``) filled in."""
    return np.asarray(tokenizer([t.format(placeholder) for t in templates]))


class TIStep:
    """One textual-inversion update: ``step(rows, ids, latents, *, t=None,
    noise=None, generator=None) -> loss``. ``rows`` (fp32 ``[n, d]``, the
    trainable vectors at table rows ``row_start:row_start + n``) is updated
    in place by a :class:`~flexdiffuse_tpu_torch.training.train.ClippedAdamW`
    made on the first call (``optimizer``); every later call must pass the
    same tensor. ``t`` and ``noise`` as in ``diffusion_loss``."""

    def __init__(self, text_model: nn.Module, unet: nn.Module,
                 cfg: _train.TrainConfig, row_start: int) -> None:
        text_model.requires_grad_(False)
        unet.requires_grad_(False)
        self.text_model = text_model
        self.cfg = cfg
        self.row_start = row_start
        self.frozen = _table(text_model).detach()
        self.device = self.frozen.device
        self.acp = _train.schedule_tables(cfg, self.device)
        self.unet_apply = _train._remat_apply(unet, cfg)
        self.optimizer: Optional[_train.ClippedAdamW] = None
        self._rows: Optional[Tensor] = None

    def table(self, rows: Tensor) -> Tensor:
        """A fresh table: the frozen rows with ``rows`` (cast to the
        table's dtype) at ``row_start``."""
        f, a = self.frozen, self.row_start
        return torch.cat([f[:a], rows.to(f.dtype), f[a + rows.shape[0]:]])

    def __call__(self, rows: Tensor, ids: Tensor, latents: Tensor, *,
                 t=None, noise=None, generator=None) -> Tensor:
        if self.optimizer is None:
            rows.requires_grad_(True)
            self.optimizer = _train.make_optimizer([rows], self.cfg)
            self._rows = rows
        elif rows is not self._rows:
            raise ValueError('a TIStep updates the rows tensor of its first '
                             'call; make a new step for other rows')
        ids = torch.as_tensor(ids, device=self.device).long()
        with _train.compute_context(self.device):
            ctx = torch.func.functional_call(
                self.text_model, {TABLE: self.table(rows)}, (ids,))
            loss = _train.diffusion_loss(
                self.unet_apply, latents, ctx, self.acp, self.cfg, t=t,
                noise=noise, generator=generator)
        loss.backward()
        self.optimizer.step()
        return loss.detach()


def make_ti_train_step(text_model: nn.Module, unet: nn.Module,
                       cfg: _train.TrainConfig, row_start: int) -> TIStep:
    """The textual-inversion step (:class:`TIStep`) over ``text_model``,
    whose table already holds ``row_start + n`` rows, and ``unet``; both
    are frozen (``requires_grad_(False)``)."""
    return TIStep(text_model, unet, cfg, row_start)


def grow_text_model(text_model: nn.Module, rows: Tensor) -> nn.Module:
    """A text tower at ``vocab_size + n`` sharing ``text_model``'s weights,
    its table grown by ``rows`` (cast to the table's dtype) so the new ids
    resolve; ``text_model`` itself is left as it is."""
    sd = text_model.state_dict()
    sd[TABLE] = torch.cat([sd[TABLE], rows.detach().to(sd[TABLE].dtype)])
    with torch.device('meta'):
        grown = type(text_model)(dataclasses.replace(
            text_model.config, vocab_size=sd[TABLE].shape[0]))
    grown.load_state_dict(sd, strict=True, assign=True)
    return grown.eval().requires_grad_(False)


def train_textual_inversion(
        text_model: nn.Module, tokenizer, unet: nn.Module, vae,
        image_paths: Sequence[str], placeholder: str,
        initializer_token: Optional[str] = None, num_vectors: int = 1,
        templates: Sequence[str] = OBJECT_TEMPLATES,
        cfg: Optional[_train.TrainConfig] = None, steps: int = 1000,
        batch_size: int = 4, resolution: int = 512, seed: int = 0,
        save_path: Optional[str] = None, log_every: int = 25,
        on_step: Optional[Callable[[int, float], None]] = None,
) -> Tuple[np.ndarray, List[float]]:
    """End-to-end TI run: registers ``placeholder`` with ``tokenizer`` (it
    is mutated), encodes the images once, trains the rows, optionally saves
    the embedding. Returns ``(rows [n, d] fp32, loss_history)``.

    Randomness comes from generators on the UNet's device seeded ``seed``
    (the random row init), ``seed + 1`` (the image, template and posterior
    draws) and ``seed + 2`` (the steps' timesteps and noise). ``text_model``
    and ``unet`` are frozen; the text tower the step runs is a copy at the
    grown vocabulary sharing their weights, so using the result at
    inference means loading it (``Runner.load_textual_inversion``)."""
    cfg = cfg or _train.TrainConfig(learning_rate=5e-4, weight_decay=0.0)
    dev = next(unet.parameters()).device
    init_gen, data_gen, step_gen = generators(seed, dev, 3)
    row_start = int(_table(text_model).shape[0])
    ids_new = tokenizer.add_tokens(placeholder, num_vectors=num_vectors)
    if ids_new[0] != row_start:
        raise ValueError(f'tokenizer id space ({ids_new[0]}) out of sync '
                         f'with the embedding table ({row_start} rows)')
    rows = init_rows(text_model, tokenizer, initializer_token, num_vectors,
                     init_gen).to(dev)
    # Grow the FROZEN table by the initial rows so the new ids resolve;
    # the step overwrites those rows with the live ones each call.
    grown = grow_text_model(text_model, rows)

    mean, logvar = encode_images(image_paths, vae, resolution)
    mean, logvar = mean.to(dev), logvar.to(dev)
    tmpl = torch.as_tensor(template_ids(tokenizer, placeholder, templates),
                           dtype=torch.long, device=dev)
    step = make_ti_train_step(grown, unet, cfg, row_start)

    n_img, n_tmpl = mean.shape[0], tmpl.shape[0]
    shape = (batch_size,) + tuple(mean.shape[1:])
    losses: List[float] = []
    t0 = time.monotonic()
    log.info('textual inversion %r: %d vector(s), %d images, %d steps',
             placeholder, num_vectors, n_img, steps)
    for i in range(steps):
        ii = torch.randint(0, n_img, (batch_size,), device=dev,
                           generator=data_gen)
        ti = torch.randint(0, n_tmpl, (batch_size,), device=dev,
                           generator=data_gen)
        noise = torch.randn(shape, device=dev, generator=data_gen)
        latents = (mean[ii] + torch.exp(0.5 * logvar[ii]) * noise) * \
            LATENT_SCALE
        loss = step(rows, tmpl[ti], latents, generator=step_gen)
        if log_every and (i % log_every == 0 or i == steps - 1):
            val = float(loss)   # synchronises with the device
            losses.append(val)
            log.info('step %d/%d  loss %.5f  (%.2f steps/s)', i + 1, steps,
                     val, (i + 1) / max(time.monotonic() - t0, 1e-6))
            if on_step is not None:
                on_step(i, val)
    rows_np = rows.detach().float().cpu().numpy()
    if save_path:
        # Single-tensor diffusers convention keyed by the placeholder —
        # weights/textual_inversion.extract_embedding recovers both.
        save_safetensors({placeholder: rows_np}, save_path)
        log.info('wrote %d-vector embedding %r to %s', num_vectors,
                 placeholder, save_path)
    return rows_np, losses
