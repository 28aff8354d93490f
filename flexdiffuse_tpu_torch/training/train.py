"""Diffusion training: the noise-prediction loss, the optimizer and the
full-model and LoRA train steps (port of
``flexdiffuse_tpu/training/train.py``).

* The loss is the published SD objective: ε- (or v-) prediction MSE at
  uniformly drawn timesteps, optional min-SNR-γ weighting, optional
  per-row weights (DreamBooth prior preservation).
* The optimizer is optax's ``chain(clip_by_global_norm, adamw)``, wrapped
  in ``MultiSteps`` when ``grad_accum > 1``: :class:`ClippedAdamW`.
* LoRA differentiates through the merge: the effective weights
  ``base.detach() + scale·(up@down)`` are rebuilt each step and applied with
  ``torch.func.functional_call``, so the UNet needs no adapter branches.
* Attention at the UNet's 4096- and 1024-token levels trains through the
  Hopper kernels K3 (forward with lse) and K4/K5 (backward),
  ``ops/flash_backward.py``.

Dtypes: on CUDA the forward and backward run under
``torch.autocast('cuda', torch.bfloat16)``: fp32 master weights (full
fine-tuning) or fp32 LoRA factors over a bf16 base compute in bf16, and the
attention inputs reach the kernels as bf16. The LoRA merge runs with
autocast off, in fp32, cast to the base dtype. On the CPU nothing is cast
(the parity tests run fp32).

State lives in the modules and the optimizer, not in returned trees: a step
updates the UNet's parameters (or the LoRA factors) in place and returns the
loss. A step's optional ``extra`` is SDXL's ``added_cond``
(``{'text_embeds', 'time_ids'}``, fp32), which reaches the UNet as
``added_cond=``; the UNet computes the time ids' sinusoidal features in
fp32 under autocast too (``models/unet.py`` ``embed_time``).

In a ``torch.profiler`` trace a step is the span ``fd.train_step`` holding
``fd.lora_merge`` (LoRA), ``fd.forward`` (the loss), ``fd.backward`` and
``fd.optimizer`` (the gradient sync, clipping and AdamW), in that order
(``utils/profiling.span``); a LoRA step replayed from a CUDA graph holds
``fd.train_replay`` instead.

A LoRA step on one card without accumulation replays from a CUDA graph of
its whole body once it has run eager once (``training/step_graph.py``);
``step.graph_stats`` counts its captures, replays and eager calls by
reason. Full fine-tuning (:func:`make_train_step`) runs eager.

``mesh`` (a ``(data, model)`` mesh of ``parallel/mesh.py``; every rank
calls the step with the same arguments): each rank draws the *global*
batch's ``t`` and ``noise`` from the same generator, keeps its rows
(``shard_batch``, the per-row ``sample_weights`` too), computes the loss
on them and averages the gradients over the data group before the update:
the global-mean-loss update that GSPMD makes in JAX, so the run equals
world size 1 up to summation order. The returned loss is the mean over the
data group. Under tensor parallelism (``parallel.shard_params`` applied to
the UNet first) the sharded weights take their gradient through the
output all-gather's backward, LoRA factors sum theirs over the model group
(each rank's factors meet only its slice of the weights), and the clipping
norm counts every shard once.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils import checkpoint as _ckpt

from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.ops import attention as _attn
from flexdiffuse_tpu_torch.training import step_graph as _step_graph
from flexdiffuse_tpu_torch.utils.profiling import span, spanned
from flexdiffuse_tpu_torch.weights.safetensors import save_safetensors

Tensor = torch.Tensor
Factors = Dict[str, Dict[str, Tensor]]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    max_grad_norm: float = 1.0
    # 'epsilon' (SD1.x) or 'v_prediction' (SD2.x 768-v).
    prediction_type: str = 'epsilon'
    # min-SNR-γ loss weighting (Hang et al. 2023); 0 → uniform.
    snr_gamma: float = 0.0
    num_train_timesteps: int = 1000
    # AdamW betas (diffusers defaults).
    b1: float = 0.9
    b2: float = 0.999
    # Rematerialization through torch.utils.checkpoint (non-reentrant):
    # 'none' keeps every activation; 'full' keeps only the step inputs and
    # recomputes the forward in the backward; 'dots' keeps the outputs of
    # matmuls without batch dims and of convolutions (aten mm, addmm,
    # convolution) and recomputes the rest.
    remat: str = 'none'
    # Gradient accumulation: the optimizer applies the mean of every k
    # micro-steps' gradients on the k-th (optax.MultiSteps).
    grad_accum: int = 1
    # EMA of the trained tensors (0 → off), applied by the loop driver.
    ema_decay: float = 0.0
    # Kept for the JAX package's signature; PyTorch has no buffer donation
    # and ignores it (the optimizer updates in place).
    donate: bool = True
    # Attention backend for the training forward and backward: 'auto'
    # trains the flash-eligible attentions through K3/K4/K5 on CUDA;
    # 'plain' forces plain attention (the JAX package's 'xla').
    attention_backend: str = 'auto'


class ClippedAdamW:
    """optax ``chain(clip_by_global_norm(max_grad_norm), adamw(...))``, as
    ``MultiSteps(every_k=grad_accum)`` when ``grad_accum > 1``.

    :meth:`step` reads each parameter's ``.grad`` and clears it. Clipping
    follows optax: the gradients are scaled by ``max_norm / ‖g‖`` only when
    ``‖g‖ ≥ max_norm`` (no +1e-6 as in ``clip_grad_norm_``). Accumulation
    keeps optax's running mean ``acc += (g − acc) / (n + 1)`` and applies it
    on the k-th call. ``torch.optim.AdamW`` computes optax's ``adamw``
    update: decoupled decay on the pre-update weights, eps outside the root.
    ``capturable``: AdamW keeps its step count on the card and computes
    the bias correction there, with no host sync, so that a CUDA graph may
    hold the update (``training/step_graph.py``); every LoRA step on CUDA
    takes it. :meth:`load_state_dict` keeps it, whatever optimizer wrote
    the state.
    """

    def __init__(self, params: Iterable[Tensor], cfg: TrainConfig,
                 tp_group=None, capturable: bool = False) -> None:
        self.params = list(params)
        # Tensor parallelism: the squares of the sharded parameters'
        # gradients are summed over the model group for the clipping norm.
        self.tp_group = tp_group
        self.max_norm = float(cfg.max_grad_norm)
        self.every = int(cfg.grad_accum)
        self.capturable = bool(capturable)
        self.adamw = torch.optim.AdamW(
            self.params, lr=cfg.learning_rate, betas=(cfg.b1, cfg.b2),
            eps=1e-8, weight_decay=cfg.weight_decay, capturable=capturable)
        self.mini_step = 0
        self.acc: Optional[List[Tensor]] = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> bool:
        """Apply (or accumulate) the held gradients; True when the
        parameters changed."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        if self.every > 1:
            if self.acc is None:
                self.acc = [torch.zeros_like(g) for g in grads]
            n = self.mini_step
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (n + 1))
            self.mini_step += 1
            if self.mini_step < self.every:
                self.zero_grad()
                return False
            grads = [a.clone() for a in self.acc]
            for a in self.acc:
                a.zero_()
            self.mini_step = 0
        norm = torch.sqrt(self._norm_sq(grads))
        keep = norm < self.max_norm
        for i, p in enumerate(self.params):
            # Each unclipped gradient is released as its clipped one is
            # made: at SDXL's width a second set is 10 GB of fp32.
            g, grads[i] = grads[i], None
            p.grad = torch.where(keep, g, g / norm * self.max_norm).to(
                p.dtype)
        self.adamw.step()
        self.zero_grad()
        return True

    def _norm_sq(self, grads: List[Tensor]) -> Tensor:
        """The squared global norm of ``grads``: with ``tp_group``, the
        sharded parameters' part summed over the model group."""
        sq = [g.float().square().sum() for g in grads]
        if self.tp_group is None:
            return sum(sq)
        sharded = [getattr(p, 'tp_sharded', False) for p in self.params]
        part = sum((s for s, sh in zip(sq, sharded) if sh),
                   torch.zeros((), device=sq[0].device))
        dist.all_reduce(part, group=self.tp_group)
        return sum((s for s, sh in zip(sq, sharded) if not sh), part)

    def state_dict(self) -> dict:
        return {'adamw': self.adamw.state_dict(),
                'every': self.every, 'max_norm': self.max_norm,
                'mini_step': self.mini_step,
                'acc': [] if self.acc is None else list(self.acc)}

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state['adamw'])
        # The state's groups carry the flags of the optimizer that wrote
        # it (on the CPU or the card); this one keeps its own, and its step
        # counts where it reads them: on the card when capturable.
        for group in self.adamw.param_groups:
            group['capturable'] = self.capturable
        for p, st in self.adamw.state.items():
            if 'step' in st:
                st['step'] = st['step'].to(
                    p.device if self.capturable else 'cpu')
        self.mini_step = int(state['mini_step'])
        self.acc = [a.to(p.device) for a, p in zip(state['acc'],
                                                   self.params)] or None


def make_optimizer(params: Iterable[Tensor], cfg: TrainConfig,
                   tp_group=None, capturable: bool = False) -> ClippedAdamW:
    return ClippedAdamW(params, cfg, tp_group, capturable)


# Matmuls without batch dims and convolutions: what remat='dots' keeps
# (the JAX package's dots_with_no_batch_dims_saveable policy, plus convs).
_SAVED_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
              torch.ops.aten.convolution.default)


def _dots_policy(ctx, op, *args, **kwargs):
    del ctx, args, kwargs
    if op in _SAVED_OPS:
        return _ckpt.CheckpointPolicy.MUST_SAVE
    return _ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return _ckpt.create_selective_checkpoint_contexts(_dots_policy)


def compute_context(device: torch.device, cache: bool = True):
    """bf16 autocast on CUDA; nothing on the CPU. ``cache=False`` keeps no
    casts of grad-requiring leaves across ops, as a CUDA graph capture
    asks."""
    if device.type == 'cuda':
        return torch.autocast('cuda', dtype=torch.bfloat16,
                              cache_enabled=cache)
    return contextlib.nullcontext()


def _remat_apply(apply_fn: Callable, cfg: TrainConfig,
                 preserve_rng_state: bool = True) -> Callable:
    """Training-path apply: the attention backend scope plus the configured
    rematerialization. Under 'full' and 'dots' the backward recomputes the
    forward, so K3 runs twice per flash attention and step.
    ``preserve_rng_state=False``: the recompute does not restore the RNG
    states of the forward, which a CUDA graph capture cannot read; exact
    where the region draws nothing."""

    def scoped_apply(*args, **kwargs):
        with _attn.backend(cfg.attention_backend):
            return apply_fn(*args, **kwargs)

    if cfg.remat == 'none':
        return scoped_apply
    if cfg.remat == 'full':
        return lambda *args, **kwargs: _ckpt.checkpoint(
            scoped_apply, *args, use_reentrant=False,
            preserve_rng_state=preserve_rng_state, **kwargs)
    if cfg.remat == 'dots':
        return lambda *args, **kwargs: _ckpt.checkpoint(
            scoped_apply, *args, use_reentrant=False,
            preserve_rng_state=preserve_rng_state,
            context_fn=_dots_context, **kwargs)
    raise ValueError(f'unknown remat mode {cfg.remat!r}')


@torch.no_grad()
def ema_update(ema_params: Dict[str, Tensor], params: Dict[str, Tensor],
               decay: float) -> Dict[str, Tensor]:
    """One EMA step ``ema ← decay·ema + (1−decay)·params`` (fp32 math, cast
    back to each EMA tensor's dtype), in place on ``ema_params`` to spare a
    second copy of the model; returns it."""
    for name, e in ema_params.items():
        e.copy_(decay * e.float() + (1.0 - decay) * params[name].float())
    return ema_params


def schedule_tables(cfg: TrainConfig, device=None) -> Tensor:
    """``alphas_cumprod`` of the training schedule, fp32."""
    sc = schedulers.SchedulerConfig(
        num_train_timesteps=cfg.num_train_timesteps)
    return torch.as_tensor(schedulers.alphas_cumprod(sc).astype(np.float32),
                           device=device)


def draw_t_noise(latents: Tensor, cfg: TrainConfig, t: Optional[Tensor],
                 noise: Optional[Tensor],
                 generator: Optional[torch.Generator]):
    """``(t [B], noise like latents)``: each that is None drawn from
    ``generator``, ``t`` first."""
    b = latents.shape[0]
    dev = latents.device
    if t is None:
        t = torch.randint(0, cfg.num_train_timesteps, (b,), device=dev,
                          generator=generator)
    if noise is None:
        noise = torch.randn(latents.shape, device=dev, dtype=torch.float32,
                            generator=generator)
    return t, noise


@spanned('fd.forward')
def diffusion_loss(apply_fn: Callable, latents: Tensor, context: Tensor,
                   acp: Tensor, cfg: TrainConfig, *,
                   t: Optional[Tensor] = None, noise: Optional[Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   sample_weights: Optional[Tensor] = None,
                   **apply_kwargs) -> Tensor:
    """Mean denoising loss over a batch of clean (pre-scaled) latents.

    ``apply_fn(noisy, t, context, **apply_kwargs) -> prediction``. ``t``
    ``[B]`` (int) and ``noise`` (like ``latents``) may be passed in;
    whichever is missing is drawn from ``generator``, ``t`` first.
    ``sample_weights`` ``[B]`` scales per-sample losses."""
    dev = latents.device
    t, noise = draw_t_noise(latents, cfg, t, noise, generator)
    t = t.to(dev)
    noise = noise.to(dev, torch.float32)
    ap = acp.to(dev)[t][:, None, None, None]
    lat32 = latents.float()
    noisy = torch.sqrt(ap) * lat32 + torch.sqrt(1.0 - ap) * noise
    pred = apply_fn(noisy.to(latents.dtype), t.float(), context,
                    **apply_kwargs).float()
    if cfg.prediction_type == 'v_prediction':
        target = torch.sqrt(ap) * noise - torch.sqrt(1.0 - ap) * lat32
    elif cfg.prediction_type == 'epsilon':
        target = noise
    else:
        raise ValueError(f'unknown prediction_type {cfg.prediction_type!r}')
    per = torch.mean(torch.square(pred - target), dim=(1, 2, 3))
    if cfg.snr_gamma > 0:
        a = ap[:, 0, 0, 0]
        snr = a / (1.0 - a)
        if cfg.prediction_type == 'v_prediction':
            w = torch.clamp(snr, max=cfg.snr_gamma) / (snr + 1.0)
        else:
            w = torch.clamp(snr, max=cfg.snr_gamma) / torch.clamp(snr,
                                                                  min=1e-8)
        per = per * w
    if sample_weights is not None:
        per = per * sample_weights.to(dev, torch.float32)
    return torch.mean(per)


def _weights(sample_weights, device) -> Optional[Tensor]:
    if sample_weights is None:
        return None
    return torch.as_tensor(np.asarray(sample_weights, np.float32),
                           device=device)


def _device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class _Parallel:
    """A step's data and model axes (None without a mesh): row sharding of
    the batch, the gradient all-reduces and the reported loss."""

    def __init__(self, mesh) -> None:
        self.mesh = mesh
        self.data = self.model = None
        if mesh is not None:
            from flexdiffuse_tpu_torch.parallel.axis import MeshAxis
            from flexdiffuse_tpu_torch.parallel import mesh as _mesh
            self.data = _mesh.batch_sharding(mesh)
            self.model = MeshAxis.of(mesh, _mesh.MODEL_AXIS)

    @property
    def tp_group(self):
        return self.model.group if self.model is not None and \
            self.model.size > 1 else None

    def rows(self, cfg, latents, context, extra, t, noise, generator, sw):
        """This rank's rows of the step's inputs, ``t`` and ``noise`` drawn
        for the global batch first."""
        if self.mesh is None:
            return latents, context, extra, t, noise, sw
        from flexdiffuse_tpu_torch.parallel.mesh import shard_batch
        t, noise = draw_t_noise(latents, cfg, t, noise, generator)
        return shard_batch((latents, context, extra, t, noise, sw),
                           self.mesh)

    def sync(self, leaves: List[Tensor], model_sum: bool = False) -> None:
        """Average the gradients of ``leaves`` over the data group (summed
        over the model group first when ``model_sum``)."""
        if self.mesh is None:
            return
        for p in leaves:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if model_sum and self.tp_group is not None:
                dist.all_reduce(p.grad, group=self.tp_group)
            dist.all_reduce(p.grad, group=self.data.group)
            p.grad /= self.data.size

    def loss(self, loss: Tensor) -> Tensor:
        loss = loss.detach()
        if self.mesh is None:
            return loss
        loss = loss.clone()
        dist.all_reduce(loss, group=self.data.group)
        return loss / self.data.size


# ---------------------------------------------------------------------------
# Full-model training


def make_train_step(unet: nn.Module, cfg: TrainConfig, mesh=None,
                    sample_weights=None):
    """``(step, optimizer)``: ``step(latents, context, extra=None, *,
    t=None, noise=None, generator=None) -> loss`` runs forward, backward
    and one optimizer update of every UNet parameter that requires grad, in
    place. ``extra``: SDXL's ``added_cond``. ``sample_weights`` ``[B]``
    fixes per-row loss weights (DreamBooth). ``mesh``: see the module
    doc."""
    dev = _device(unet)
    par = _Parallel(mesh)
    leaves = [p for p in unet.parameters() if p.requires_grad]
    opt = make_optimizer(leaves, cfg, par.tp_group)
    acp = schedule_tables(cfg, dev)
    apply_fn = _remat_apply(unet, cfg)
    sw = _weights(sample_weights, dev)

    @spanned('fd.train_step')
    def step(latents: Tensor, context: Tensor, extra=None, *, t=None,
             noise=None, generator=None) -> Tensor:
        latents, context, extra, t, noise, w = par.rows(
            cfg, latents, context, extra, t, noise, generator, sw)
        with compute_context(dev):
            loss = diffusion_loss(apply_fn, latents, context, acp, cfg, t=t,
                                  noise=noise, generator=generator,
                                  sample_weights=w, added_cond=extra)
        with span('fd.backward'):
            loss.backward()
        with span('fd.optimizer'):
            par.sync(leaves)
            opt.step()
        return par.loss(loss)

    return step, opt


# ---------------------------------------------------------------------------
# LoRA training

LORA_ATTN_TARGETS = ('to_q', 'to_k', 'to_v', 'to_out.0')
LORA_FF_TARGETS = ('ff.net.0.proj', 'ff.net.2')


def lora_targets(unet: nn.Module,
                 include_ff: bool = True) -> Dict[str, nn.Linear]:
    """The Linear layers LoRA adapts, by module name: the attention
    projections and, with ``include_ff``, the GEGLU feed-forward's two."""
    ends = LORA_ATTN_TARGETS + (LORA_FF_TARGETS if include_ff else ())
    return {name: m for name, m in unet.named_modules()
            if isinstance(m, nn.Linear) and
            any(name.endswith('.' + e) for e in ends)}


def init_lora(unet: nn.Module, rank: int = 8,
              generator: Optional[torch.Generator] = None,
              include_ff: bool = True) -> Factors:
    """LoRA factors ``{module name: {'down': [r, in], 'up': [out, r]}}``
    (fp32, on the UNet's device, requiring grad). ``down`` is normal / r
    drawn from ``generator`` in module order; ``up`` is zero, so the merge is
    an exact no-op at step 0."""
    targets = lora_targets(unet, include_ff)
    if not targets:
        raise ValueError('no LoRA targets found in the module')
    dev = _device(unet)
    gdev = generator.device if generator is not None else 'cpu'
    factors: Factors = {}
    for name, lin in targets.items():
        down = torch.randn((rank, lin.in_features), generator=generator,
                           device=gdev) / rank
        factors[name] = {
            'down': down.to(dev).requires_grad_(),
            'up': torch.zeros((lin.out_features, rank), device=dev,
                              requires_grad=True),
        }
    return factors


@spanned('fd.lora_merge')
def merge_lora_params(unet: nn.Module, factors: Factors,
                      scale: float = 1.0) -> Dict[str, Tensor]:
    """Effective weights ``{'<module>.weight': base.detach() +
    scale·(up@down)}`` for ``functional_call``, differentiable in the
    factors. torch Linear weights are ``[out, in]``, so there is no
    transpose; the merge runs in fp32 and is cast to the base dtype. A
    tensor-parallel layer (``parallel.shard_params``) merges its rows of
    ``up``."""
    from flexdiffuse_tpu_torch.parallel.mesh import tp_slice
    mods = dict(unet.named_modules())
    out = {}
    with torch.autocast(_device(unet).type, enabled=False):
        for name, fac in factors.items():
            base = mods[name].weight.detach()
            rows = tp_slice(mods[name])
            up = fac['up'] if rows is None else fac['up'][rows]
            delta = (up.float() @ fac['down'].float()) * scale
            out[f'{name}.weight'] = (base.float() + delta).to(base.dtype)
    return out


def make_lora_train_step(unet: nn.Module, factors: Factors,
                         cfg: TrainConfig, scale: float = 1.0, mesh=None,
                         sample_weights=None):
    """``(step, optimizer)`` updating only the LoRA ``factors`` (in place);
    the UNet's own parameters are frozen (``requires_grad_(False)``).
    ``step`` has :func:`make_train_step`'s signature. On one card without
    accumulation its calls replay from CUDA graphs of the whole step
    (``training/step_graph.py``); ``step.graph_stats`` counts them."""
    par = _Parallel(mesh)
    unet.requires_grad_(False)
    dev = _device(unet)
    leaves = [f[k] for f in factors.values() for k in ('down', 'up')]
    for leaf in leaves:
        leaf.requires_grad_(True)
    # Every step is built as a graphed one is (capturable AdamW on CUDA, no
    # autocast cache, no RNG state across remat's recompute): one
    # arithmetic, so a world-1 mesh or a step kept eager equals a replayed
    # one bit for bit.
    opt = make_optimizer(leaves, cfg, capturable=dev.type == 'cuda')
    acp = schedule_tables(cfg, dev)
    sw = _weights(sample_weights, dev)
    graphs = _step_graph.StepGraph(unet, factors, opt, mesh=mesh,
                                   grad_accum=cfg.grad_accum,
                                   sample_weights=sw)

    def body(latents: Tensor, context: Tensor, extra, t, noise, w,
             generator) -> Tensor:
        eff = merge_lora_params(unet, factors, scale)
        apply_fn = _remat_apply(
            lambda *args, **kwargs: torch.func.functional_call(
                unet, eff, args, kwargs), cfg, preserve_rng_state=False)
        with compute_context(dev, cache=False):
            loss = diffusion_loss(apply_fn, latents, context, acp, cfg, t=t,
                                  noise=noise, generator=generator,
                                  sample_weights=w, added_cond=extra)
        with span('fd.backward'):
            loss.backward()
        with span('fd.optimizer'):
            par.sync(leaves, model_sum=True)
            opt.step()
        return par.loss(loss)

    @spanned('fd.train_step')
    def step(latents: Tensor, context: Tensor, extra=None, *, t=None,
             noise=None, generator=None) -> Tensor:
        latents, context, extra, t, noise, w = par.rows(
            cfg, latents, context, extra, t, noise, generator, sw)
        # The step's tensors by name, SDXL's added_cond as 'extra.<key>'.
        inputs = {'latents': latents, 'context': context, 't': t,
                  'noise': noise, **{f'extra.{k}': v
                                     for k, v in (extra or {}).items()}}
        inputs = {k: v for k, v in inputs.items() if v is not None}
        why = graphs.reason(inputs)
        if why is not None:
            graphs.eager(why)
            return body(latents, context, extra, t, noise, w, generator)

        def graphed_body(**xs: Tensor) -> Tensor:
            added = None if extra is None else {
                k: xs.get(f'extra.{k}') for k in extra}
            return body(xs['latents'], xs['context'], added, xs.get('t'),
                        xs.get('noise'), w, generator)
        return graphs.run(graphed_body, inputs, generator)

    step.graph_stats = graphs.stats
    return step, opt


# ---------------------------------------------------------------------------
# Export: trained factors → kohya safetensors


def kohya_module_name(name: str) -> str:
    """Port module name → kohya ``lora_unet_*`` name."""
    return 'lora_unet_' + name.replace('.', '_')


def export_lora_safetensors(factors: Factors, path: str,
                            alpha: Optional[float] = None) -> int:
    """Write trained factors as a kohya safetensors adapter; returns the
    module count. The names and arrays are those the JAX package's
    ``export_lora_safetensors`` writes for the same factors."""
    out = {}
    for name, fac in factors.items():
        mod = kohya_module_name(name)
        down = fac['down'].detach().float().cpu().numpy()
        up = fac['up'].detach().float().cpu().numpy()
        out[f'{mod}.lora_down.weight'] = down
        out[f'{mod}.lora_up.weight'] = up
        out[f'{mod}.alpha'] = np.asarray(
            alpha if alpha is not None else down.shape[0], np.float32)
    save_safetensors(out, path)
    return len(factors)


def trainable_tree(unet: nn.Module) -> Dict[str, Tensor]:
    """The UNet's parameters that require grad, by name."""
    return {n: p for n, p in unet.named_parameters() if p.requires_grad}


def factor_tree(factors: Factors) -> Dict[str, Tensor]:
    """LoRA factors flattened to ``{'<module>/down': ..., ...}``."""
    return {f'{n}/{k}': f[k] for n, f in factors.items()
            for k in ('down', 'up')}


def unflatten_factors(tree: Dict[str, Tensor]) -> Factors:
    """The inverse of :func:`factor_tree`."""
    factors: Factors = {}
    for key, t in tree.items():
        name, part = key.rsplit('/', 1)
        factors.setdefault(name, {})[part] = t
    return factors
