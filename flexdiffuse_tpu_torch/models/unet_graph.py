"""CUDA graphs of the UNet's no-grad forward (:class:`GraphCache`).

A UNet call on the card is about 1,500 launches (K1, K6, cuDNN
convolutions, cuBLAS GEMMs, LayerNorms, copies, adds). At 768² and batch 4
the host takes longer to enqueue them than the card takes to run them, so
the card waits on the host. A CUDA graph of the call enqueues them all from
one host call; the kernels, and their order, are the eager body's.

:meth:`UNet2DCondition.forward` asks :meth:`GraphCache.reason` whether a
call may be replayed, from what the call carries: a CUDA call with no
gradient, no autocast, no stream capturing already, no sequence-parallel
axis or process group, every optional argument at its default but SDXL's
``added_cond`` (its two tensors become two more inputs) and no ToMe or
FreeU. Any other call runs the eager body and is counted under its reason
in ``stats['eager']``.

An eligible call goes to :meth:`GraphCache.run`, keyed by its signature:
the inputs' shapes, dtypes and strides, the device, and the dispatcher
state the body reads (:func:`dispatch_state`: the attention and GroupNorm
backends, the kernel bound for K1, the ``channel_major`` and
``approx_gelu`` settings, ``CM_MIN_SEQ``, the TF32 flags, inference
mode).

- The first sighting runs eager (``eager['first']``): the warm-up, in which
  libraries load, cuDNN picks its algorithms and K1/K6 are built, so a
  one-off shape never pays a capture.
- The second runs the body on the capture stream (the call's result) and
  then captures it there into static input buffers, in the span
  ``fd.unet_capture``. Every graph of a cache shares one memory pool, so
  the bytes held are those of the largest capture, not their sum.
- Later sightings copy the inputs into the static buffers and replay, in
  the span ``fd.unet_replay``, and return a clone of the static output: a
  scheduler may keep the ε it was given (PLMS), which the next replay
  would otherwise overwrite.

At most :data:`MAX_GRAPHS` signatures are kept, the least recently used
dropped first.

Weights: a graph reads the storages the module's parameters and buffers
had at its capture. Each eligible call reads every one's data pointer
through its module's dicts, and every submodule through its parent's, so a
storage or module swapped by ``.to()``, a dtype change,
``load_state_dict(assign=True)``, ``torch.func.functional_call`` or a
replaced submodule shows; it drops every graph, and the call counts as a
first sighting (``eager['weights']``). In-place updates, such as
``apply_lora``'s merge, need nothing: the graph reads the same storages. A
forward hook on a submodule keeps the call eager (``eager['hooks']``): a
replay would not call it.

Counters: the kernel wrappers (K1, K3–K5, K6 and the attention variants)
count their launches on the host. A capture records how far it moved them
and takes that back (nothing ran on the card); each replay adds it, so the
counters still count launches on the card.

:class:`GraphSet` holds the sighting order, the entries, the pool and the
counter credit; :class:`GraphCache` and the LoRA train step's
``training/step_graph.py`` ``StepGraph`` add their eligibility, key and
weights check to it.
"""
from __future__ import annotations

import collections
import dataclasses
import operator
import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from flexdiffuse_tpu_torch.ops import attention as attention_ops
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.utils.profiling import span

# Signatures a cache keeps (serving's row counts and hires sizes could
# otherwise grow it without bound).
MAX_GRAPHS = 8

# The kernel wrappers whose launch counters a replay credits: K1's, K3–K5's,
# K6's, and the attention variants' that the tools swap in for K1.
COUNTED = (fa.flash_attention, fa.flash_attention_tt, fa.flash_attention_cm,
           fb.flash_attention_lse, fb.flash_attention_dq,
           fb.flash_attention_dkv, gn.fused_group_norm, *fv.WRAPPERS)
# A wrapper's counters: an int or a dict of ints (by path, configuration).
COUNTERS = ('launches', 'path_launches', 'config_path_launches')

# (wrapper, counter, key) → launches; the key is None for an int counter.
Launches = Dict[tuple, int]


def launch_counts() -> Launches:
    """Every counter of every wrapper in :data:`COUNTED`."""
    out = {}
    for fn in COUNTED:
        for name in COUNTERS:
            c = getattr(fn, name, None)
            if isinstance(c, int):
                out[fn, name, None] = c
            elif c is not None:
                out.update(((fn, name, k), n) for k, n in c.items())
    return out


def launch_delta(before: Launches, after: Launches) -> Launches:
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


def add_launches(delta: Launches, sign: int = 1) -> None:
    for (fn, name, k), n in delta.items():
        if k is None:
            setattr(fn, name, getattr(fn, name) + sign * n)
        else:
            getattr(fn, name)[k] += sign * n


def dispatch_state(module: nn.Module) -> tuple:
    """What a UNet body reads besides its inputs and weights: the attention
    backend and the kernel ``ops/attention.py`` has bound for K1 (the
    tools swap one in), the GroupNorm backend, the module's
    ``channel_major`` and ``approx_gelu``, ``CM_MIN_SEQ``, inference mode
    and the TF32 flags."""
    return (attention_ops._BACKEND.get(), attention_ops.flash_attention,
            gn._BACKEND.get(), module.channel_major, module.approx_gelu,
            os.environ.get('CM_MIN_SEQ'), torch.is_inference_mode_enabled(),
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


class _Weights:
    """The module tree's parameter, buffer and submodule slots (each a
    dict and a key), and its submodules' forward-hook dicts."""

    def __init__(self, module: nn.Module) -> None:
        slots, kids, self.hooks = [], [], []
        for m in module.modules():
            for d in (m._parameters, m._buffers):
                slots += [(d, k) for k, v in d.items() if v is not None]
            kids += [(m._modules, k) for k, v in m._modules.items()
                     if v is not None]
            if m is not module:
                self.hooks += [m._forward_hooks, m._forward_pre_hooks]
        self.dicts, self.keys = (list(x) for x in zip(*slots)) \
            if slots else ([], [])
        self.kid_dicts, self.kid_keys = (list(x) for x in zip(*kids)) \
            if kids else ([], [])
        self.state = self.read()

    def read(self) -> Optional[tuple]:
        """Every slot's data pointer and every submodule's id; None when a
        slot is gone."""
        try:
            ptrs = list(map(torch.Tensor.data_ptr,
                            map(operator.getitem, self.dicts, self.keys)))
            kids = list(map(id, map(operator.getitem, self.kid_dicts,
                                    self.kid_keys)))
        except (KeyError, TypeError):
            return None
        return ptrs, kids

    def hooked(self) -> bool:
        return any(map(len, self.hooks))


@dataclasses.dataclass
class _Entry:
    """One signature: sighted once, or captured (its static inputs, graph,
    static output and the launches a replay credits)."""
    static: tuple = ()
    graph: object = None
    out: Optional[torch.Tensor] = None
    launches: Launches = dataclasses.field(default_factory=dict)


def cuda_capture(body: Callable, inputs: tuple, static: tuple, pool,
                 generators: tuple = ()):
    """``(this call's output, graph, static output)``: ``body`` run on
    ``inputs`` on the capture stream (the warm-up of that stream's library
    handles and workspaces), then captured there on ``static`` into a
    ``torch.cuda.CUDAGraph`` in ``pool``. The capture stream is the one
    ``torch.cuda.graph`` shares across the process: each stream that runs
    a GEMM holds a cuBLAS workspace of its own (32 MiB on Hopper).

    ``generators``: CUDA generators besides the default one that ``body``
    draws from, registered with the graph so that each replay draws at,
    and advances, their offsets as the eager body would."""
    device = inputs[0].device
    graph = torch.cuda.CUDAGraph()
    for g in generators:
        graph.register_generator_state(g)
    # 'thread_local': another thread's copies (serving's PNG encoding) may
    # run while this one captures.
    capture = torch.cuda.graph(graph, pool=pool,
                               capture_error_mode='thread_local')
    if capture.capture_stream.device != device:
        capture = torch.cuda.graph(graph, pool=pool,
                                   stream=torch.cuda.Stream(device),
                                   capture_error_mode='thread_local')
    caller = torch.cuda.current_stream(device)
    side = capture.capture_stream
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        out = body(*inputs)
    with capture:
        static_out = body(*static)
    caller.wait_stream(side)
    out.record_stream(caller)
    return out, graph, static_out


class GraphSet:
    """Keyed CUDA graphs of one body, in the order the module doc gives:
    a key's first sighting runs eager, its second runs the body and
    captures it, later ones replay; at most ``max_graphs`` keys, the least
    recently used dropped first (None: :data:`MAX_GRAPHS`), every graph
    in one memory pool. ``stats``:
    ``captures``, ``replays`` and ``eager`` (a ``Counter`` by reason).
    ``capture``: :func:`cuda_capture`, or a stand-in with its signature
    whose graph has ``replay()``; ``spans``: the capture's and the
    replay's span names; ``release``: hand the caching allocator's free
    blocks back to the card before a capture call, where the body's
    activations fit once at a time."""

    def __init__(self, capture: Callable = cuda_capture,
                 max_graphs: Optional[int] = None,
                 spans: Tuple[str, str] = ('fd.unet_capture',
                                           'fd.unet_replay'),
                 release: bool = False) -> None:
        self.stats = {'captures': 0, 'replays': 0,
                      'eager': collections.Counter()}
        self._capture = capture
        self._max, self._spans, self._release = max_graphs, spans, release
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._pool = None

    def eager(self, why: str) -> None:
        self.stats['eager'][why] += 1

    def drop(self, key: tuple, why: str, body: Callable,
             inputs: tuple) -> torch.Tensor:
        """Every graph dropped (the weights they read moved); this call
        runs eager, counted under ``why``, as ``key``'s first sighting."""
        self._entries.clear()
        self._entries[key] = _Entry()
        self.eager(why)
        return body(*inputs)

    def graphed(self, key: tuple, body: Callable, inputs: tuple,
                generators: tuple = ()) -> torch.Tensor:
        """``body(*inputs)`` eager, captured or replayed, by how often
        ``key`` was sighted; ``generators``: as :func:`cuda_capture`
        takes them."""
        entry = self._entries.get(key)
        if entry is None:
            self._entries[key] = _Entry()
            if len(self._entries) > (self._max or MAX_GRAPHS):
                self._entries.popitem(last=False)
            self.eager('first')
            return body(*inputs)
        self._entries.move_to_end(key)
        if entry.graph is None:
            return self._capture_call(entry, body, inputs, generators)
        with span(self._spans[1]):
            for s, x in zip(entry.static, inputs):
                s.copy_(x)
            entry.graph.replay()
            add_launches(entry.launches)
            self.stats['replays'] += 1
            return entry.out.clone()

    def _capture_call(self, entry: _Entry, body: Callable, inputs: tuple,
                      generators: tuple) -> torch.Tensor:
        with span(self._spans[0]):
            static = tuple(torch.empty_like(x) for x in inputs)
            for s, x in zip(static, inputs):
                s.copy_(x)
            if inputs[0].is_cuda:
                if self._release:
                    # The caller's stream, the capture stream and the
                    # graph's pool cache blocks apart: the caller's go
                    # back before the warm-up, as torch.cuda.graph hands
                    # the capture stream's back before the capture.
                    torch.cuda.synchronize(inputs[0].device)
                    torch.cuda.empty_cache()
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
            marks = []

            def counted(*args):
                # The counters after the warm-up, whose launches ran on the
                # card, and after the capture, whose did not: those are
                # what a replay credits.
                out = body(*args)
                marks.append(launch_counts())
                return out
            out, entry.graph, entry.out = self._capture(
                counted, inputs, static, self._pool, generators)
            entry.launches = launch_delta(*marks)
            add_launches(entry.launches, -1)
            entry.static = static
            self.stats['captures'] += 1
            return out


class GraphCache(GraphSet):
    """The CUDA graphs of one UNet's eligible calls (see the module doc)."""

    def __init__(self, capture: Callable = cuda_capture) -> None:
        super().__init__(capture)
        self._weights: Optional[_Weights] = None

    def __deepcopy__(self, memo) -> 'GraphCache':
        return GraphCache(self._capture)

    def __reduce__(self):
        return GraphCache, ()

    def reason(self, module: nn.Module, latents: torch.Tensor,
               t: torch.Tensor, context: torch.Tensor,
               argument: Optional[str] = None) -> Optional[str]:
        """Why the call must run eager (``argument``: the first optional
        argument not at its default), or None."""
        if torch.is_grad_enabled():
            return 'grad'
        if argument is not None:
            return argument
        if module.tome is not None:
            return 'tome'
        if module.freeu is not None:
            return 'freeu'
        if attention_ops.sp_axis() is not None or (
                dist.is_available() and dist.is_initialized()):
            return 'sp'
        dev = module.conv_in.weight.device
        if dev.type != 'cuda' or any(x.device != dev
                                     for x in (latents, t, context)):
            return 'device'
        if torch.is_autocast_enabled('cuda'):
            return 'autocast'
        if torch.cuda.is_current_stream_capturing():
            return 'capturing'
        return None

    @staticmethod
    def _key(module: nn.Module, inputs: tuple) -> tuple:
        return (tuple((x.shape, x.dtype, x.stride()) for x in inputs),
                inputs[0].device, dispatch_state(module))

    def _weights_changed(self, module: nn.Module) -> bool:
        """Whether the module's weights moved since the graphs were made;
        if so, drop them and read the module anew."""
        w = self._weights
        if w is not None and w.read() == w.state:
            return False
        self._entries.clear()
        self._weights = _Weights(module)
        return w is not None

    def run(self, module: nn.Module, body: Callable,
            *inputs: torch.Tensor) -> torch.Tensor:
        """An eligible call (:meth:`reason` None): ``body(*inputs)`` eager,
        captured or replayed (``inputs``: the latents, ``t``, the context
        and, for SDXL, the pooled embedding and the time ids)."""
        key = self._key(module, inputs)
        if self._weights_changed(module):
            return self.drop(key, 'weights', body, inputs)
        if self._weights.hooked() or \
                torch.nn.modules.module._global_forward_hooks or \
                torch.nn.modules.module._global_forward_pre_hooks:
            self.eager('hooks')
            return body(*inputs)
        return self.graphed(key, body, inputs)
