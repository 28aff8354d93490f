"""LoRA fine-tuning of the SD UNet as published (Hu et al. 2021 over
Rombach et al. 2022's noise-prediction objective), in fp32:

- LoRA: a frozen weight ``W`` of each adapted linear (the attention
  projections ``to_q``, ``to_k``, ``to_v``, ``to_out.0`` and the GEGLU
  MLP's ``ff.net.0.proj`` and ``ff.net.2``) becomes ``W + up·down``;
- the loss: ``x_t = √ᾱ_t·x₀ + √(1−ᾱ_t)·ε`` at integer timesteps ``t``,
  the mean squared error of the UNet's prediction of ε (or of v), mean
  over the batch;
- the update: the gradients scaled to a global norm of at most
  ``max_grad_norm`` (scaled only when the norm reaches it), then AdamW
  (decoupled decay on the weights before the step, bias-corrected moments,
  ε outside the root).

A batch is computed in blocks of rows, each block's loss weighted by its
share of the batch, so the sum is the batch's mean and its gradient.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from bench_h100.reference import unet
from bench_h100.reference.ops import Ops
from bench_h100.reference.samplers import alphas_cumprod

Tensor = torch.Tensor
TARGETS = ('to_q', 'to_k', 'to_v', 'to_out.0', 'ff.net.0.proj', 'ff.net.2')


def lora_targets(spec: Dict[str, Sequence[int]]) -> Dict[str, tuple]:
    """Adapted module name → ``(out, in)`` from a UNet's weight shapes."""
    out = {}
    for name, shape in spec.items():
        if name.endswith('.weight') and len(shape) == 2:
            module = name[:-len('.weight')]
            if any(module.endswith('.' + t) for t in TARGETS):
                out[module] = tuple(shape)
    return out


class LoraOps(Ops):
    """:class:`Ops` whose adapted weights are ``W + up·down``."""

    def __init__(self, weights, factors: Dict[str, Dict[str, Tensor]],
                 precision: str = 'fp32') -> None:
        super().__init__(weights, precision)
        self.factors = factors

    def w(self, name: str, shape) -> Tensor:
        base = super().w(name, shape)
        f = self.factors.get(name[:-len('.weight')]) \
            if name.endswith('.weight') else None
        return base if f is None else base + f['up'] @ f['down']


def loss(ops: Ops, cfg: dict, latents: Tensor, ctx: Tensor, t: Tensor,
         noise: Tensor, block: int) -> List[Tensor]:
    """The batch's mean loss, accumulated block by block with each block's
    backward run at once (so only one block's activations live); returns
    the blocks' weighted losses (detached)."""
    acp = torch.tensor(alphas_cumprod(cfg['scheduler']), dtype=torch.float32,
                       device=latents.device)
    b = latents.shape[0]
    parts = []
    for i in range(0, b, block):
        sl = slice(i, i + block)
        ap = acp[t[sl]][:, None, None, None]
        x0, n = latents[sl].float(), noise[sl].float()
        noisy = torch.sqrt(ap) * x0 + torch.sqrt(1.0 - ap) * n
        pred = unet.forward(ops, cfg['unet'], noisy, t[sl].float(), ctx[sl])
        if cfg['scheduler']['prediction_type'] == 'v_prediction':
            target = torch.sqrt(ap) * n - torch.sqrt(1.0 - ap) * x0
        else:
            target = n
        part = torch.mean(torch.square(pred - target)) * (x0.shape[0] / b)
        if part.requires_grad:
            part.backward()
        parts.append(part.detach())
    return parts


class AdamW:
    """Global-norm clipping then AdamW over a list of fp32 leaves."""

    def __init__(self, leaves: List[Tensor], lr: float, b1: float, b2: float,
                 eps: float, weight_decay: float, max_norm: float) -> None:
        self.leaves = leaves
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.max_norm = weight_decay, max_norm
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.count = 0

    @torch.no_grad()
    def step(self) -> List[Tensor]:
        """Apply the leaves' ``.grad``; returns the clipped gradients."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.leaves]
        norm = math.sqrt(sum(float(g.double().square().sum())
                             for g in grads))
        if norm >= self.max_norm:
            grads = [g * (self.max_norm / norm) for g in grads]
        self.count += 1
        c1 = 1.0 - self.b1**self.count
        c2 = 1.0 - self.b2**self.count
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            p.mul_(1.0 - self.lr * self.wd)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))
            p.grad = None
        return grads


def draw_t_noise(gen: torch.Generator, b: int, shape: Sequence[int],
                 num_train_timesteps: int, device):
    """The step's draws from its generator: ``t`` first, then the noise."""
    t = torch.randint(0, num_train_timesteps, (b,), device=device,
                      generator=gen)
    noise = torch.randn(tuple(shape), device=device, dtype=torch.float32,
                        generator=gen)
    return t, noise


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             floor: float = 1e-3) -> float:
    """The worst leaf's ``|‖p‖ − ‖r‖| / max(‖r‖, median ‖r‖)``, over the
    leaves whose reference norm is at least ``floor`` times the median
    (a leaf the reference leaves at rounding noise is left out)."""
    med = float(np.median(list(reference.values())))
    gaps = [abs(program[k] - r) / max(r, med)
            for k, r in reference.items() if r >= floor * med]
    return max(gaps) if gaps else math.inf
