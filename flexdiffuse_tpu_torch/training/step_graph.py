"""CUDA graphs of the LoRA train step (:class:`StepGraph`).

A LoRA step of the SD-1.x UNet at batch 32 is thousands of launches behind
autograd, remat 'dots''s Python dispatch mode (every aten op of the forward
and of its recompute passes through its policy), a 160-module merge and a
320-leaf clip. The card runs them faster than the host issues them, so it
waits on the host. A CUDA graph of the whole step enqueues them all from
one host call; the kernels, and their order, are the eager step's:

1. ``merge_lora_params``;
2. ``diffusion_loss``: the draws of ``t`` and noise, the functional UNet
   forward under remat, the loss;
3. ``loss.backward()``: the recompute, K3–K5;
4. ``ClippedAdamW.step()``: the global-norm clip and AdamW.

``make_lora_train_step``'s step asks :meth:`StepGraph.reason` whether a
call may be replayed, from what it can observe. A call runs the eager body,
counted in ``stats['eager']`` under the first reason that holds: the step
has a mesh (``mesh``: the gradient sync and the loss run collectives), the
optimizer accumulates (``grad_accum``: its branch differs from call to
call), the UNet or an input is not on CUDA or the step was built off the
card (``device``), a stream is capturing already (``capturing``), or a
forward hook or pre-hook is set on the UNet, a submodule or globally
(``hooks``: a replay would not call it).

An eligible call goes to :meth:`StepGraph.run`, keyed by its signature: the
shapes, dtypes and strides of the step's tensors (the latents, the
context, SDXL's ``added_cond`` tensors and any ``t`` and ``noise`` passed,
with their presence), the generator object, the fixed per-row weights, the
UNet's dispatcher state (``models/unet_graph.py`` ``dispatch_state``: the
attention and GroupNorm backends, the TF32 flags and the rest) and AdamW's
hyperparameters.

- The first sighting runs eager (``eager['first']``): the warm-up, in which
  AdamW makes its state, cuDNN picks its algorithms and K3–K5 are built.
- The second is the call's step, run on the capture stream; then the same
  body is captured there into static input buffers, in the span
  ``fd.train_capture``. The capture runs nothing on the card, so the call
  applies exactly one update. The caching allocator's free blocks go back
  to the card before the warm-up and before the capture: the eager step's
  blocks, the capture stream's and the graph's pool would not fit on one
  card together at the benchmark's batch.
- Later sightings copy the inputs into the static buffers and replay, in
  the span ``fd.train_replay``, and return a clone of the static loss.

A graph draws ``t`` and noise from the step's generator, registered with
it, so that each replay draws at the generator's offset and advances it as
the eager step would. At most :data:`MAX_GRAPHS` signatures are kept, the
least recently used dropped first; every graph of a step shares one memory
pool.

A graph reads by address the frozen UNet's parameters and buffers, the
LoRA factors and AdamW's ``exp_avg``, ``exp_avg_sq`` and ``step`` tensors.
Every call reads their data pointers (and the UNet's submodules, as
``models/unet_graph.py``'s ``_Weights`` does); a ``.to()``, a swapped factor
or ``load_state_dict`` (a resumed checkpoint, ``training/checkpoint.py``)
drops every graph, and the call runs eager (``eager['weights']``).
In-place updates, such as AdamW's own or a checkpoint's ``copy_`` into the
factors, need nothing.

Every LoRA step is built the one way, graphed or not, so that a step kept
eager by a mesh, accumulation or a hook runs the replays' arithmetic (a
world-1 mesh equals no mesh bit for bit): on CUDA its AdamW is
``capturable`` (optax's update with the bias correction on the card, no
host sync), its autocast keeps no cast cache, and its remat keeps no RNG
state across the recompute. The training forward draws nothing inside the
checkpointed region (``t`` and noise are drawn before it, the UNet has no
dropout), so the last is exact.

The sighting order, the entries, the pool and the launch credit (a capture
takes back the K1, K3–K5 and K6 launches it counted, each replay credits
them) are ``models/unet_graph.py``'s ``GraphSet``.
"""
from __future__ import annotations

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch import nn

from flexdiffuse_tpu_torch.models import unet_graph as ug
from flexdiffuse_tpu_torch.models.unet_graph import cuda_capture

# Signatures a step keeps: each graph's pool holds a whole step's
# activations.
MAX_GRAPHS = 2

Tensor = torch.Tensor


def _on_card(unet: nn.Module, opt, inputs: Dict[str, Tensor]) -> bool:
    """The UNet on CUDA, every input a tensor on its device, and the
    step built there (AdamW ``capturable``)."""
    dev = next(unet.parameters()).device
    return dev.type == 'cuda' and all(
        g['capturable'] for g in opt.adamw.param_groups) and all(
        torch.is_tensor(x) and x.device == dev for x in inputs.values())


class StepGraph(ug.GraphSet):
    """The CUDA graphs of one LoRA step (see the module doc). ``opt``: the
    step's :class:`~flexdiffuse_tpu_torch.training.train.ClippedAdamW`;
    ``sample_weights``: its fixed per-row weights."""

    def __init__(self, unet: nn.Module, factors: Dict[str, Dict[str, Tensor]],
                 opt, *, mesh=None, grad_accum: int = 1,
                 sample_weights: Optional[Tensor] = None) -> None:
        super().__init__(cuda_capture, MAX_GRAPHS,
                         ('fd.train_capture', 'fd.train_replay'),
                         release=True)
        self._unet, self._factors, self._opt = unet, factors, opt
        self._mesh, self._accum = mesh, int(grad_accum)
        self._sw = None if sample_weights is None else (
            tuple(sample_weights.shape), sample_weights.dtype)
        self._weights = ug._Weights(unet)
        self._state = None

    def reason(self, inputs: Dict[str, Tensor]) -> Optional[str]:
        """Why the call with ``inputs`` (the step's tensors by name) must
        run eager, or None."""
        if self._mesh is not None:
            return 'mesh'
        if self._accum > 1:
            return 'grad_accum'
        if not _on_card(self._unet, self._opt, inputs):
            return 'device'
        if torch.cuda.is_current_stream_capturing():
            return 'capturing'
        if self._hooked():
            return 'hooks'
        return None

    def _hooked(self) -> bool:
        """A forward hook or pre-hook on the UNet, a submodule (as
        ``_Weights`` lists them; a new submodule's show once the weights
        check has read the tree anew), or global."""
        glob, unet = torch.nn.modules.module, self._unet
        return bool(glob._global_forward_hooks or
                    glob._global_forward_pre_hooks or unet._forward_hooks or
                    unet._forward_pre_hooks) or self._weights.hooked()

    def _key(self, inputs: Dict[str, Tensor], generator) -> tuple:
        return (tuple((n, x.shape, x.dtype, x.stride())
                      for n, x in inputs.items()),
                next(iter(inputs.values())).device, generator, self._sw,
                ug.dispatch_state(self._unet),
                tuple(tuple(sorted((k, v) for k, v in g.items()
                                   if k != 'params'))
                      for g in self._opt.adamw.param_groups))

    def _read(self) -> tuple:
        """The data pointers the graphs read: the UNet's (and its
        submodules' ids), the factors', AdamW's state tensors'."""
        state = self._opt.adamw.state
        opt = []
        for p in self._opt.params:
            st = state.get(p, {})
            opt += [(k, v.data_ptr()) for k, v in sorted(st.items())
                    if torch.is_tensor(v)]
        return (self._weights.read(),
                [f[k].data_ptr() for f in self._factors.values()
                 for k in ('down', 'up')], opt)

    def run(self, body: Callable[..., Tensor], inputs: Dict[str, Tensor],
            generator: Optional[torch.Generator]) -> Tensor:
        """An eligible call (:meth:`reason` None): ``body(**inputs)``, the
        whole step returning its detached loss, eager, captured or
        replayed. ``generator``: the one the body draws from (None: the
        default CUDA generator)."""
        names = tuple(inputs)
        args = tuple(inputs.values())
        positional = lambda *xs: body(**dict(zip(names, xs)))
        key = self._key(inputs, generator)
        if self._read() == self._state:
            return self.graphed(key, positional, args,
                                () if generator is None else (generator,))
        moved = self._state is not None
        self._weights = ug._Weights(self._unet)
        out = self.drop(key, 'weights' if moved else 'first', positional,
                        args)
        # The first step makes AdamW's state: read it as the graphs will.
        self._state = self._read()
        return out
