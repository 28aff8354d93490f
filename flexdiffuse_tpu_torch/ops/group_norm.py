"""Fused GroupNorm (+affine, optional SiLU): K6, its plan, its plain twin
and the dispatcher (port of ``flexdiffuse_tpu/ops/group_norm.py``).

* K6, :func:`fused_group_norm`: the Hopper kernel ``csrc/group_norm.cu``
  (replaces the Pallas ``_gn_kernel`` :41). Over ``[B, C, H, W]`` in bf16,
  fp16 or fp32, channels-last in memory, it computes fp32 statistics per
  (batch, group), the affine, an optional SiLU, and writes the result in
  the dtype asked for (bf16, fp16 or fp32), channels-last too. The port's
  UNet and VAE activations are channels-last on the card (the models'
  NHWC → NCHW permute at entry propagates through cuDNN), so that is the
  one layout K6 takes. Unlike the JAX package's 8 MiB gate it takes any
  size: the VAE's activations too. Built and loaded with
  ``ops/flash_attention.build``/``load`` at first use.
* :func:`plan_group_norm` decides before the launch, from the shape, the
  dtypes and the alignment alone, how K6 runs: on the 'resident' path (one
  launch; a cluster of up to 16 blocks holds a slab of whole groups in
  shared memory, so x is read once) or the 'stream' path (two launches:
  per-block moments, then the apply), and with which slab, cluster, pixels
  per block, shared memory and grid. The kernel's entry point only checks
  the plan.
* :func:`plain_group_norm`: the same function in plain PyTorch (``x.float()``
  → ``F.group_norm`` → SiLU → cast), the CPU path and the test oracle.
* :func:`group_norm`: the dispatcher the models call. A call that needs a
  gradient (grad mode on and any of x, weight, bias requiring grad) runs the
  plain version: the JAX package has no backward kernel for K6, so the port
  has none. Any other call on a CUDA tensor goes to K6 under the 'auto'
  backend; CPU tensors take the plain version.

On a CUDA tensor :func:`fused_group_norm` launches its planned path or
raises; there is no fallback, and a launch the CUDA runtime refuses
raises too.
``fused_group_norm.launches`` counts its calls,
``fused_group_norm.path_launches`` them by path.
"""
from __future__ import annotations

import contextlib
import contextvars
import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.utils.profiling import span

SOURCE = fa.SOURCE.parent / 'group_norm.cu'
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


class Shape(ctypes.Structure):
    """A call's shape and plan as the entry point takes them (csrc
    ``Shape``): built once per plan, passed by pointer."""
    _fields_ = [(name, ctypes.c_int) for name in (
        'batch', 'channels', 'groups', 'hw', 'path', 'vec', 'slab',
        'cluster', 'pixels', 'smem', 'grid_x', 'stats_pixels')]


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    # (x, gamma, beta, y, work, shape, eps, silu, in_dtype, out_dtype,
    #  w_dtype, stream)
    'group_norm_fwd': (_P, _P, _P, _P, _P, ctypes.POINTER(Shape), _F, _I,
                       _I, _I, _I, _P),
}

PATHS = ('resident', 'stream')
THREADS = 256            # per block, both paths (csrc kThreads)
MAX_CLUSTER = 16         # Hopper's largest (non-portable) cluster
MAX_CHANNELS = 6144      # csrc kMaxChannels
TILE_BYTES = 96 * 1024   # the largest resident tile (two blocks per SM)
BLOCK_BYTES = 64 * 1024  # x per resident block to aim at
MIN_BLOCKS = 64          # resident blocks at least
MIN_SEGMENT = 32         # bytes of a pixel's slab: one whole sector at least
STATS_BLOCKS = 2 * 132   # stream stats blocks per call (partials to merge)
STREAM_BLOCKS = 4 * 132  # stream apply blocks per call


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one K6 call runs. ``path`` 'resident' or 'stream'; ``vec`` 1 for
    16-byte loads and stores; ``slab`` whole groups per cluster (stream:
    all of them); ``cluster`` blocks per cluster (stream: 1); ``pixels``
    per block (stream: per apply block); ``smem`` dynamic shared-memory
    bytes of the resident block (stream: 0); ``grid`` (blocks per batch
    row, batch; stream: of the apply pass); ``stats_pixels`` pixels per
    stream stats block (resident: 0); ``workspace`` fp32 floats of the
    stream path's partial moments (a mean and an M2 per stats block and
    group)."""
    path: str
    vec: int
    slab: int
    cluster: int
    pixels: int
    smem: int
    grid: Tuple[int, int]
    stats_pixels: int
    workspace: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def resident_smem(pixels: int, slab_channels: int, elem: int, slab: int,
                  cluster: int) -> int:
    """The resident block's shared memory in bytes, as the kernel lays it
    out: the tile ``[pixels][slab_channels]`` in x's dtype, the lanes'
    per-channel fp32 (mean, M2), the block's (mean, M2) per group of the
    slab, and every rank's."""
    units = slab_channels // (16 // elem)
    lanes = THREADS // units
    return pixels * slab_channels * elem + 8 * lanes * slab_channels + \
        8 * slab + 8 * cluster * slab


def _resident(b: int, groups: int, cpg: int, hw: int,
              elem: int) -> Optional[Tuple[int, int]]:
    """(slab, cluster) of the resident path, or None where it does not go.
    The call is spread over ``T = max(MIN_BLOCKS, 2^⌈log2(x bytes /
    BLOCK_BYTES)⌉)`` blocks: the widest slab of whole groups (16-byte
    vectors, at most ``THREADS`` of them) whose cluster for T blocks is at
    most 8, or at most 16 where that gives a wider pixel segment than 64
    bytes would; none if its tile exceeds ``TILE_BYTES`` or a pixel's slab
    is narrower than ``MIN_SEGMENT`` bytes. Measured on the H100
    (``tools/gn_compare.py --sweep``): 64 blocks of wide slabs in clusters
    of 4–8 are fastest below 64², where latency sets the time; the tile
    stays small enough for two blocks per SM; past that the stream path
    is faster."""
    ve = 16 // elem
    slabs = [s for s in range(1, groups + 1) if groups % s == 0 and
             s * cpg % ve == 0 and s * cpg // ve <= THREADS]
    if not slabs:
        return None
    target = max(MIN_BLOCKS, _pow2_at_least(
        _cdiv(b * groups * cpg * hw * elem, BLOCK_BYTES)))
    cluster_for = lambda s: _pow2_at_least(_cdiv(target, b * (groups // s)))
    within = lambda most: [s for s in slabs if cluster_for(s) <= most]
    slab = max(within(8), default=None)
    if slab is None or slab * cpg * elem < 64:
        slab = max(within(16), default=slab or slabs[0])
    cluster = min(cluster_for(slab), MAX_CLUSTER, 1 << (hw.bit_length() - 1))
    pixels = _cdiv(hw, cluster)
    if pixels * slab * cpg * elem > TILE_BYTES or \
            slab * cpg * elem < MIN_SEGMENT:
        return None
    return slab, cluster


@functools.lru_cache(maxsize=None)
def plan_group_norm(shape: Tuple[int, ...], groups: int, dtype: torch.dtype,
                    out_dtype: torch.dtype, aligned: bool,
                    path: Optional[str] = None) -> Plan:
    """K6's plan for x of ``shape`` ``[B, C, H, W]`` (channels-last) in
    ``dtype``, y in ``out_dtype``, ``groups`` groups; ``aligned``: x and y
    16-byte aligned. 'resident' when 16-byte vectors fit (aligned, C a
    multiple of the vector) and :func:`_resident` finds a slab and cluster.
    Else 'stream', over about ``STATS_BLOCKS`` stats and ``STREAM_BLOCKS``
    apply blocks, with 16-byte vectors where C and the alignment allow,
    scalars otherwise. ``path`` forces one ('resident' raises where it
    cannot go). Cached: the same arguments give the same plan object."""
    if path not in (None, *PATHS):
        raise ValueError(f'fused_group_norm: path {path!r} not in {PATHS}')
    b, c = shape[0], shape[1]
    hw = 1
    for n in shape[2:]:
        hw *= n
    cpg = c // groups
    elem = torch.finfo(dtype).bits // 8
    vec = int(aligned and c % (16 // elem) == 0)
    fit = _resident(b, groups, cpg, hw, elem) if vec else None
    if fit is not None and path != 'stream':
        slab, cluster = fit
        sc = slab * cpg
        pixels = _cdiv(hw, cluster)
        return Plan('resident', 1, slab, cluster, pixels,
                    resident_smem(pixels, sc, elem, slab, cluster),
                    (cluster * (groups // slab), b), 0, 0)
    if path == 'resident':
        raise ValueError(f'fused_group_norm: the resident path does not take '
                         f'{tuple(shape)} {dtype} with {groups} groups '
                         f'(aligned={aligned})')
    pixels = _cdiv(hw, min(hw, _cdiv(STREAM_BLOCKS, b)))
    stats_pixels = _cdiv(hw, min(hw, _cdiv(STATS_BLOCKS, b)))
    return Plan('stream', vec, groups, 1, pixels, 0, (_cdiv(hw, pixels), b),
                stats_pixels, 2 * b * groups * _cdiv(hw, stats_pixels))


# Context-local: 'auto' (K6 for CUDA tensors) | 'plain'.
_BACKEND: contextvars.ContextVar = contextvars.ContextVar(
    'group_norm_backend', default='auto')


@contextlib.contextmanager
def backend(name: str):
    """Scoped GroupNorm-backend override: ``with backend('plain'): ...``."""
    if name not in ('auto', 'plain'):
        raise ValueError(f'unknown group-norm backend {name!r}')
    token = _BACKEND.set(name)
    try:
        yield
    finally:
        _BACKEND.reset(token)


def plain_group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, silu: bool = False,
                     dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm over ``[B, C, ...]`` with fp32 statistics and affine, then
    SiLU if asked, cast to ``dtype`` (x's dtype by default). Mirrors
    ``_gn_reference`` (flexdiffuse_tpu/ops/group_norm.py:72) in NCHW.

    A CPU tensor is made NCHW-contiguous first: PyTorch's CPU kernel for
    channels-last maps (what the models' NHWC → NCHW permutes give) loses
    precision in its statistics, 2.6e-5 max|Δ| at (1, 8, 8, 8) and 2.5e-3
    at (1, 8, 1024, 1024) for unit-scale maps of mean 3, against ≤ 1e-6
    contiguous."""
    xf = x.float()
    if not x.is_cuda:
        xf = xf.contiguous()
    y = F.group_norm(xf, num_groups, weight.float(), bias.float(), eps)
    if silu:
        y = F.silu(y)
    return y.to(x.dtype if dtype is None else dtype)


def _check(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
           bias: torch.Tensor, dtype: torch.dtype) -> None:
    if not x.is_cuda:
        raise ValueError('fused_group_norm: x must be a CUDA tensor (or a '
                         'CPU tensor)')
    if x.dtype not in DTYPES or dtype not in DTYPES:
        raise ValueError(f'fused_group_norm takes and gives bf16, fp16 or '
                         f'fp32, got {x.dtype} -> {dtype}')
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f'fused_group_norm takes a non-empty [B, C, H, W] '
                         f'tensor, got {tuple(x.shape)}')
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError('fused_group_norm takes a channels-last x, got '
                         f'strides {x.stride()} for {tuple(x.shape)}')
    b, c = x.shape[:2]
    if num_groups < 1 or c % num_groups:
        raise ValueError(f'fused_group_norm: {c} channels do not split into '
                         f'{num_groups} groups')
    if b > 65535 or c > MAX_CHANNELS:
        raise ValueError(f'fused_group_norm takes at most 65535 batch rows '
                         f'and {MAX_CHANNELS} channels, got {tuple(x.shape)}')
    if x.numel() // b >= 2**31:
        raise ValueError('fused_group_norm: more than 2^31 elements per batch '
                         'row')
    for name, t in (('weight', weight), ('bias', bias)):
        if t.shape != (c,) or t.device != x.device or \
                t.dtype not in DTYPES or t.dtype != weight.dtype or \
                not t.is_contiguous():
            raise ValueError(f'fused_group_norm takes a contiguous {name} '
                             f'[{c}] on {x.device} in the dtype of weight, '
                             f'got {t.dtype} {tuple(t.shape)} on {t.device}')


@functools.lru_cache(maxsize=None)
def _shape(how: Plan, batch: int, channels: int, groups: int,
           hw: int) -> Shape:
    return Shape(batch, channels, groups, hw, PATHS.index(how.path), how.vec,
                 how.slab, how.cluster, how.pixels, how.smem, how.grid[0],
                 how.stats_pixels)


def launch(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
           bias: torch.Tensor, y: torch.Tensor, eps: float, silu: bool,
           how: Plan) -> None:
    """Launch K6 on the current stream as ``how`` says: one ctypes call
    (the stream's raw handle read as Triton and Inductor read it, without
    building a stream object); raises if the entry point finds the plan
    inconsistent with the shape or the CUDA runtime refuses the launch (too
    large a cluster, too much shared memory). Never retries another
    way."""
    lib = fa.load(SOURCE, SIGNATURES)
    b, c, h, w = x.shape
    work = torch.empty(how.workspace, dtype=torch.float32,
                       device=x.device) if how.workspace else None
    device = x.get_device()
    switch = device != torch.cuda.current_device()
    with torch.cuda.device(device) if switch else contextlib.nullcontext():
        rc = lib.group_norm_fwd(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            None if work is None else work.data_ptr(),
            _shape(how, b, c, num_groups, h * w), eps, silu, DTYPES[x.dtype],
            DTYPES[y.dtype], DTYPES[weight.dtype],
            torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f'fused_group_norm kernel launch failed: CUDA '
                           f'error {rc} at x {tuple(x.shape)} {x.dtype}, '
                           f'{how}')


def fused_group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
                     bias: torch.Tensor, eps: float, silu: bool = False,
                     dtype: Optional[torch.dtype] = None,
                     path: Optional[str] = None) -> torch.Tensor:
    """K6: :func:`plain_group_norm`'s function through the Hopper kernel,
    launched on the current stream on the path :func:`plan_group_norm`
    picks (``path``: forced, for comparisons); the result is
    channels-last, as x must be. CPU tensors take :func:`plain_group_norm`;
    CUDA tensors the kernel does not take raise. A launch's host work is
    the profiler span ``fd.k6``."""
    dtype = x.dtype if dtype is None else dtype
    if x.device.type == 'cpu':
        return plain_group_norm(x, num_groups, weight, bias, eps, silu, dtype)
    with span('fd.k6'):
        _check(x, num_groups, weight, bias, dtype)
        y = torch.empty_like(x, dtype=dtype)
        how = plan_group_norm(x.shape, num_groups, x.dtype, dtype,
                              (x.data_ptr() | y.data_ptr()) % 16 == 0, path)
        launch(x, num_groups, weight, bias, y, eps, silu, how)
        fa.count_launch(fused_group_norm, how.path)
    return y


fused_group_norm.launches = 0
fused_group_norm.path_launches = dict.fromkeys(PATHS, 0)


def group_norm(x: torch.Tensor, num_groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float, silu: bool = False,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """GroupNorm (+SiLU) cast to ``dtype``, routed to K6 or the plain
    version: under the 'auto' backend (the default; see :func:`backend`)
    CUDA tensors take K6, CPU tensors the plain version; under 'plain'
    every call takes the plain version. A call that needs a gradient always
    runs the plain version."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or bias.requires_grad)
    if needs_grad or _BACKEND.get() == 'plain' or not x.is_cuda:
        return plain_group_norm(x, num_groups, weight, bias, eps, silu, dtype)
    return fused_group_norm(x, num_groups, weight, bias, eps, silu, dtype)
