"""PyTorch port: the GroupNorm dispatcher and the plain twin of the Hopper
kernel K6, held against the JAX package on the CPU.

The JAX side is ``flexdiffuse_tpu/ops/group_norm.py``: its Pallas kernel in
interpret mode (as the JAX package's own tests run it) and its XLA
reference, on NHWC inputs; the port takes NCHW, so the inputs and outputs
are transposed. K6's plan (``plan_group_norm``), which decides in Python
before the launch how the kernel runs, is tested here over every GroupNorm
shape of the SD-1.4 UNet and VAE at 512². The Hopper kernel itself needs
the card; its tests are in ``tests/test_torch_kernels_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from flexdiffuse_tpu.ops.group_norm import _gn_reference
from flexdiffuse_tpu.ops.group_norm import group_norm as jax_group_norm
from flexdiffuse_tpu_torch.models.unet import GroupNorm32
from flexdiffuse_tpu_torch.ops import group_norm as gn
from tests.test_torch_attention import one_torch_thread  # noqa: F401


def _inputs(shape, seed):
    """NCHW x (not centred, so the statistics matter), gamma, beta."""
    rng = np.random.default_rng(seed)
    x = (1.5 * rng.standard_normal(shape) + 0.7).astype(np.float32)
    c = shape[1]
    gamma = (1.0 + 0.5 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.3 * rng.standard_normal(c)).astype(np.float32)
    return x, gamma, beta


def _bf16_ulp(ref: np.ndarray) -> np.ndarray:
    """The spacing of bf16 numbers (8 significant bits) at |ref|."""
    mag = np.maximum(np.abs(ref), np.finfo(np.float32).tiny)
    return 2.0**(np.floor(np.log2(mag)) - 7)


CASES = [(groups, silu, dtype) for groups in (8, 16, 32)
         for silu in (False, True) for dtype in ('float32', 'bfloat16')]


@pytest.mark.parametrize('groups,silu,dtype', CASES)
def test_plain_group_norm_matches_jax(groups, silu, dtype):
    """plain_group_norm vs the Pallas K6 (interpret mode) and
    ``_gn_reference``, output in x's dtype as in JAX. fp32: within 1e-5
    (observed ≤ 1.5e-6: the JAX kernel's E[x²]−E[x]² against F.group_norm's
    moments). bf16: within one bf16 ulp of the JAX output (both round the
    same fp32 value, which may sit on either side of a rounding edge)."""
    shape = (2, 64, 8, 6)
    x, gamma, beta = _inputs(shape, seed=groups + 2 * silu)
    eps = 1e-5 if silu else 1e-6
    jx = jnp.asarray(np.transpose(x, (0, 2, 3, 1))).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = gn.plain_group_norm(tx, groups, torch.from_numpy(gamma),
                              torch.from_numpy(beta), eps, silu)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got = np.transpose(got.float().numpy(), (0, 2, 3, 1))
    kernel = jax_group_norm(jx, jnp.asarray(gamma), jnp.asarray(beta),
                            groups, eps, silu, interpret=True)
    b, h, w, c = jx.shape
    ref = _gn_reference(jx.reshape(b, h * w, c), jnp.asarray(gamma),
                        jnp.asarray(beta), groups, eps, silu).reshape(jx.shape)
    for want in (kernel, ref):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == 'float32':
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert np.all(np.abs(got - want) <= _bf16_ulp(want))


@pytest.mark.parametrize('silu', [False, True])
def test_plain_group_norm_is_the_models_old_math(silu):
    """The plain version is bit for bit the expression the UNet and VAE ran
    before K6 (fp32 F.group_norm, F.silu, cast to the next layer's dtype),
    so the port's CPU path is unchanged."""
    x, gamma, beta = _inputs((2, 32, 5, 7), seed=5)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for out_dtype in (torch.float32, torch.bfloat16):
        old = F.group_norm(tx.float(), 8, torch.from_numpy(gamma),
                           torch.from_numpy(beta), 1e-5)
        old = (F.silu(old) if silu else old).to(out_dtype)
        new = gn.plain_group_norm(tx, 8, torch.from_numpy(gamma),
                                  torch.from_numpy(beta), 1e-5, silu,
                                  out_dtype)
        assert new.dtype == out_dtype
        assert torch.equal(new, old)


def test_cpu_wrapper_and_dispatcher_take_plain_path():
    """On CPU tensors K6's wrapper and every backend of the dispatcher give
    the plain result, and the launch counter does not move."""
    x, gamma, beta = (torch.from_numpy(a) for a in _inputs((1, 32, 9, 9), 6))
    before = gn.fused_group_norm.launches
    ref = gn.plain_group_norm(x, 16, gamma, beta, 1e-6, True, torch.float16)
    got = gn.fused_group_norm(x, 16, gamma, beta, 1e-6, True, torch.float16)
    assert torch.equal(got, ref)
    assert torch.equal(gn.group_norm(x, 16, gamma, beta, 1e-6, True,
                                     torch.float16), ref)
    for name in ('auto', 'plain'):
        with gn.backend(name):
            assert torch.equal(gn.group_norm(x, 16, gamma, beta, 1e-6, True,
                                             torch.float16), ref)
    assert gn.fused_group_norm.launches == before
    assert gn._BACKEND.get() == 'auto'
    for name in ('kernel', 'xla'):
        with pytest.raises(ValueError), gn.backend(name):
            pass


def test_group_norm32_routes_to_autograd_under_requires_grad():
    """A GroupNorm32 call that needs a gradient runs the plain version, so
    autograd reaches x and the affine (K6 has no backward, in JAX or
    here); the gradients equal F.group_norm's."""
    x, _, _ = _inputs((2, 32, 4, 4), seed=7)
    norm = GroupNorm32(8, 32, eps=1e-5, silu=True)
    with torch.no_grad():
        norm.weight.normal_()
        norm.bias.normal_()
    xt = torch.from_numpy(x).requires_grad_()
    out = norm(xt)
    assert out.grad_fn is not None and out.dtype == torch.float32
    grads = torch.autograd.grad(out.square().sum(),
                                [xt, norm.weight, norm.bias])
    xr = xt.detach().clone().requires_grad_()
    w = norm.weight.detach().clone().requires_grad_()
    b = norm.bias.detach().clone().requires_grad_()
    ref = F.silu(F.group_norm(xr, 8, w, b, 1e-5))
    want = torch.autograd.grad(ref.square().sum(), [xr, w, b])
    for g, r in zip(grads, want):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    with torch.no_grad():
        assert norm(xt, torch.bfloat16).dtype == torch.bfloat16


# K6's plan (chosen in Python before the launch, so it is tested here).
H100_SMEM = 232448   # shared memory one block can use (227 KB)


def _hooked_shapes(model, run):
    """The input shape of every GroupNorm32 call ``run`` makes, in order."""
    got = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: got.append(tuple(args[0].shape)))
        for m in model.modules() if isinstance(m, GroupNorm32)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    return got


@functools.lru_cache(maxsize=None)
def _sd14_shapes(kind: str, batch: int):
    """Every GroupNorm shape of one SD-1.4 UNet evaluation at 512² (UNet
    batch ``batch``), VAE decode or encode at 512², from the port's models
    on the meta device (no weights, no arithmetic)."""
    from flexdiffuse_tpu_torch.models import (SD14_UNET, SD14_VAE,
                                              AutoencoderKL, UNet2DCondition)
    meta = lambda *shape: torch.empty(shape, device='meta')
    with torch.device('meta'):
        model = (UNet2DCondition(SD14_UNET) if kind == 'unet' else
                 AutoencoderKL(SD14_VAE))
    run = {'unet': lambda: model(meta(batch, 64, 64, 4), meta(batch),
                                 meta(batch, 77, 768)),
           'decode': lambda: model.decode(meta(batch, 64, 64, 4)),
           'encode': lambda: model.encode(meta(batch, 512, 512, 3))}[kind]
    return tuple(_hooked_shapes(model, run))


def _check_plan(shape, groups, dtype, out_dtype=None, aligned=True):
    """The plan's invariants: whole groups per slab, at most 227 KB of
    shared memory per block and 16 blocks per cluster, every (batch,
    group) and pixel covered exactly once, whole 16-byte vectors and at
    least one whole 32-byte sector per pixel of a resident slab."""
    out_dtype = dtype if out_dtype is None else out_dtype
    how = gn.plan_group_norm(shape, groups, dtype, out_dtype, aligned)
    b, c, h, w = shape
    hw, cpg = h * w, c // groups
    elem = torch.finfo(dtype).bits // 8
    blocks, batch = how.grid
    assert batch == b and groups % how.slab == 0
    if how.path == 'resident':
        sc = how.slab * cpg
        assert how.vec == 1 and aligned and sc % (16 // elem) == 0
        assert sc // (16 // elem) <= gn.THREADS
        assert sc * elem >= gn.MIN_SEGMENT
        assert how.pixels * sc * elem <= gn.TILE_BYTES
        assert 1 <= how.cluster <= 16
        assert how.cluster & (how.cluster - 1) == 0
        assert how.smem == gn.resident_smem(how.pixels, sc, elem, how.slab,
                                            how.cluster)
        assert how.smem <= H100_SMEM
        assert how.workspace == how.stats_pixels == 0
        assert how.pixels == -(-hw // how.cluster)
        # Cluster k owns groups [k·slab, (k+1)·slab) of every batch row.
        assert blocks % how.cluster == 0
        owned = [g for k in range(blocks // how.cluster)
                 for g in range(k * how.slab, (k + 1) * how.slab)]
        assert owned == list(range(groups))
    else:
        assert how.cluster == 1 and how.smem == 0 and how.slab == groups
        assert (blocks - 1) * how.pixels < hw <= blocks * how.pixels
        parts = -(-hw // how.stats_pixels)
        assert (parts - 1) * how.stats_pixels < hw
        assert how.workspace == 2 * b * groups * parts
        assert how.vec == int(aligned and c % (16 // elem) == 0)
    return how


@pytest.mark.parametrize('batch', [2, 4])
def test_plan_puts_every_unet_group_norm_resident(batch):
    """All 61 GroupNorms of a 512² UNet evaluation, at CFG batch 2 and at
    compose batch 4, plan 'resident' (one launch, x read once), in bf16
    and in fp32."""
    shapes = _sd14_shapes('unet', batch)
    assert len(shapes) == 61
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            assert _check_plan(shape, 32, dtype).path == 'resident', shape


@pytest.mark.parametrize('kind,calls,stream', [('decode', 30, 13),
                                               ('encode', 22, 8)])
def test_plan_splits_the_vae_between_the_paths(kind, calls, stream):
    """The VAE at 512²: only the activations at 256² and 512², whose
    slabs no cluster holds in two blocks per SM, take the stream path; the
    numbers are the ones chip_smoke.py asserts on the card."""
    import chip_smoke
    shapes = _sd14_shapes(kind, 1)
    assert len(shapes) == calls
    paths = [_check_plan(s, 32, torch.bfloat16).path for s in shapes]
    streamed = [s for s, p in zip(shapes, paths) if p == 'stream']
    assert len(streamed) == stream
    assert all(s[2] >= 256 for s in streamed)
    assert all(s[2] <= 128 for s, p in zip(shapes, paths) if p == 'resident')
    assert stream == {'decode': chip_smoke.K6_STREAM_PER_DECODE,
                      'encode': chip_smoke.K6_STREAM_PER_ENCODE}[kind]


@pytest.mark.parametrize('kind,batch', [('unet', 8), ('unet', 16),
                                        ('decode', 4), ('decode', 8)])
def test_plan_at_serving_batches(kind, batch):
    """The serving path's batches (up to 8 fused rows: UNet batch 16, a
    decode of 8 images) plan as batch 1 and 2 do: every UNet GroupNorm
    resident, 13 of a decode's 30 on the stream path, the counts
    ``chip_smoke.py`` step 13 asserts."""
    import chip_smoke
    shapes = _sd14_shapes(kind, batch)
    paths = [_check_plan(s, 32, torch.bfloat16).path for s in shapes]
    if kind == 'unet':
        assert len(shapes) == chip_smoke.K6_PER_UNET
        assert set(paths) == {'resident'}
    else:
        assert len(shapes) == chip_smoke.K6_PER_DECODE
        assert paths.count('stream') == chip_smoke.K6_STREAM_PER_DECODE
        assert paths == [_check_plan((1,) + tuple(s[1:]), 32,
                                     torch.bfloat16).path for s in shapes]


@functools.lru_cache(maxsize=None)
def _sdxl_shapes(kind: str):
    """Every GroupNorm shape of one SDXL base or refiner UNet evaluation at
    1024² under CFG (batch 2, with ``added_cond``), or of a 1024² decode or
    encode, from the port's models on the meta device."""
    from flexdiffuse_tpu_torch.models import (SDXL_REFINER_UNET, SDXL_UNET,
                                              SDXL_VAE, AutoencoderKL,
                                              UNet2DCondition)
    meta = lambda *shape: torch.empty(shape, device='meta')
    cfg = {'base': SDXL_UNET, 'refiner': SDXL_REFINER_UNET}.get(kind)
    with torch.device('meta'):
        model = (UNet2DCondition(cfg) if cfg is not None else
                 AutoencoderKL(SDXL_VAE))
    if cfg is not None:
        added = {'text_embeds': meta(2, cfg.addition_pooled_dim),
                 'time_ids': meta(2, cfg.num_time_ids)}
        run = lambda: model(meta(2, 128, 128, 4), meta(2),
                            meta(2, 77, cfg.cross_attention_dim),
                            added_cond=added)
    else:
        run = {'decode': lambda: model.decode(meta(1, 128, 128, 4)),
               'encode': lambda: model.encode(meta(1, 1024, 1024, 3))}[kind]
    return tuple(_hooked_shapes(model, run))


@pytest.mark.parametrize('kind', ['base', 'refiner', 'decode', 'encode'])
def test_plan_at_sdxl_1024(kind):
    """SDXL at 1024²: every GroupNorm of a base and a refiner evaluation
    (one of each streams: the 960- and 1152-channel 128² levels, whose
    vector-aligned slabs of 4 groups no cluster of 16 holds) and of the
    decode and encode; the calls and stream counts are the ones
    ``chip_smoke.py`` step 19 holds its module-tree counts to."""
    import chip_smoke
    shapes = _sdxl_shapes(kind)
    paths = [_check_plan(s, 32, torch.bfloat16).path for s in shapes]
    assert (len(shapes), paths.count('stream')) == chip_smoke.K6_SDXL[kind]
    if kind in ('base', 'refiner'):
        assert all(s[2] == 128 and s[1] in (960, 1152)
                   for s, p in zip(shapes, paths) if p == 'stream')


def test_step19_holds_k6_at_every_sdxl_call():
    """``chip_smoke.py`` step 19 holds K6 at every distinct GroupNorm call
    of the SDXL path: its specs cover every shape of the base and refiner
    evaluations, the decode and the encode, with both plans' paths, and
    its timed shapes are SiLU calls of that path."""
    import chip_smoke
    specs = chip_smoke.sdxl_gn_specs()
    shapes = {s[0] for s in specs}
    assert len(specs) == len(set(specs))
    assert shapes == {tuple(s) for kind in ('base', 'refiner', 'decode',
                                            'encode')
                      for s in _sdxl_shapes(kind)}
    assert {_check_plan(s, 32, torch.bfloat16).path for s in shapes} == {
        'resident', 'stream'}
    silu = {s[0] for s in specs if s[1]}
    assert set(chip_smoke.STEP19_GN_TIMED) <= silu


PLAN_CASES = [
    ((2, 320, 64, 64), 32, torch.bfloat16, torch.float32, True),
    ((4, 320, 64, 64), 32, torch.float32, torch.float32, True),
    ((3, 96, 17, 23), 32, torch.float32, torch.bfloat16, True),
    ((1, 512, 192, 256), 32, torch.bfloat16, None, True),
    ((1, 512, 193, 256), 32, torch.bfloat16, None, True),
    ((1, 128, 512, 512), 32, torch.float16, None, True),
    ((2, 60, 9, 11), 1, torch.bfloat16, None, True),
    ((2, 60, 9, 11), 12, torch.bfloat16, None, True),
    ((2, 60, 9, 11), 60, torch.bfloat16, None, True),
    ((2, 64, 9, 11), 4, torch.bfloat16, None, False),
    ((1, 6144, 2, 3), 1, torch.float32, None, True),
    ((1, 32, 1, 1), 32, torch.bfloat16, None, True),
]


@pytest.mark.parametrize('shape,groups,dtype,out_dtype,aligned', PLAN_CASES)
def test_plan_invariants(shape, groups, dtype, out_dtype, aligned):
    """fp32, mixed output dtypes, the resident/stream boundary, C % 8 != 0,
    a misaligned x, a slab wider than a block's threads, one pixel."""
    _check_plan(shape, groups, dtype, out_dtype, aligned)


def test_plan_paths_where_expected():
    """Which path each kind of call takes: 16 blocks of 96 KB hold 49,152
    pixels of a 32-byte slab; scalar loads (C % 8 != 0, misaligned),
    slabs wider than 256 vectors and pixels of less than a sector
    stream."""
    path = lambda *a: gn.plan_group_norm(*a).path
    bf16 = torch.bfloat16
    assert path((1, 512, 192, 256), 32, bf16, bf16, True) == 'resident'
    assert path((1, 512, 193, 256), 32, bf16, bf16, True) == 'stream'
    assert path((1, 128, 256, 256), 32, bf16, bf16, True) == 'stream'
    assert path((2, 60, 9, 11), 12, bf16, bf16, True) == 'stream'
    assert path((2, 64, 9, 11), 4, bf16, bf16, False) == 'stream'
    assert gn.plan_group_norm((2, 60, 9, 11), 12, bf16, bf16, True).vec == 0
    assert path((1, 4096, 2, 2), 1, bf16, bf16, True) == 'stream'
    assert path((3, 96, 17, 23), 32, torch.float32, bf16, True) == \
        'resident'


def test_plan_is_the_same_on_every_call():
    """Cached per (shape, groups, dtypes, alignment): the same object
    every call, and a forced path is planned on its own."""
    args = ((2, 320, 64, 64), 32, torch.bfloat16, torch.bfloat16, True)
    first = gn.plan_group_norm(*args)
    assert gn.plan_group_norm(*args) is first
    assert gn.plan_group_norm(*args, 'resident') == first
    forced = gn.plan_group_norm(*args, 'stream')
    assert forced.path == 'stream'
    assert gn.plan_group_norm(*args, 'stream') is forced
    with pytest.raises(ValueError):
        gn.plan_group_norm((2, 60, 9, 11), 12, torch.bfloat16,
                           torch.bfloat16, True, 'resident')
    with pytest.raises(ValueError):
        gn.plan_group_norm(*args, 'plain')
