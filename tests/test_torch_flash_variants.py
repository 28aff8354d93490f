"""PyTorch port: the attention variants T1–T6 and the ported experiment
tools, held against the JAX package's tool kernels on the CPU, and the
path choosers of T1–T6.

The JAX tools (``tools/flash_*.py``) call ``pl.pallas_call`` without
``interpret=``; here ``jax.experimental.pallas.pallas_call`` is patched to
interpret mode for each test (the tools look it up at call time). The
Hopper kernels themselves need the card: ``tests/test_torch_kernels_cuda.py``.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.tools import flash_opt as port_flash_opt
from flexdiffuse_tpu_torch.tools import flash_pipelined as port_pipelined
from flexdiffuse_tpu_torch.tools import flash_tt as port_flash_tt
from flexdiffuse_tpu_torch.tools import flash_tt3 as port_flash_tt3
from flexdiffuse_tpu_torch.tools import flash_variants as port_variants
from flexdiffuse_tpu_torch.tools import perf_experiment as port_perf
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tools import flash_opt, flash_pipelined, flash_tt, flash_tt3
from tools import flash_variants

_T = lambda x: x.transpose(0, 1, 3, 2)

# Each configuration's JAX tool kernel on [B, H, S, D] arrays (the tools'
# default blocks; vG with g = 4 takes 256-row q blocks so that Sq = 1024
# divides).
JAX_CALLS = {
    'T1 v0': lambda q, k, v, s: flash_opt.attn('v0', q, k, v, s),
    'T1 vU': lambda q, k, v, s: flash_opt.attn('vU', q, k, v, s),
    'T1 vG2': lambda q, k, v, s: flash_opt.attn('vG', q, k, v, s, 512, 512,
                                                2),
    'T1 vG4': lambda q, k, v, s: flash_opt.attn('vG', q, k, v, s, 256, 512,
                                                4),
    'T2': lambda q, k, v, s: flash_opt.attn_h(q, k, v, s),
    'T3': lambda q, k, v, s: flash_pipelined.pipelined_attention(q, k, v, s),
    'T4': lambda q, k, v, s: _T(flash_tt.flash_tt2(_T(q), _T(k), _T(v), s)),
    'T5 ttv3': lambda q, k, v, s: _T(flash_tt3.flash_ttv3(
        _T(q), _T(k), _T(v), s)),
    'T5 ttv4': lambda q, k, v, s: _T(flash_tt3.flash_ttv3(
        _T(q), _T(k), _T(v), s, bf16_p=True)),
    'T5 no-fold': lambda q, k, v, s: _T(flash_tt3.flash_ttv3(
        _T(q), _T(k), _T(v), s, sum_fold=False)),
    'T6 v0': lambda q, k, v, s: flash_variants.attn(0, q, k, v, s),
    'T6 v1': lambda q, k, v, s: flash_variants.attn(1, q, k, v, s),
    'T6 v2': lambda q, k, v, s: flash_variants.attn(2, q, k, v, s),
}
DTYPES = {'fp32': (jnp.float32, torch.float32),
          'bf16': (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret(monkeypatch):
    """The JAX tools' Pallas kernels in interpret mode."""
    monkeypatch.setattr(pl, 'pallas_call',
                        functools.partial(pl.pallas_call, interpret=True))


def _tolerance(label: str, dtype: str) -> float:
    """Relative to max|ref|. fp32: 1e-5, the twins' one-pass fp32 order
    against the kernels' online rescaling (observed 5.0e-7 to 9.2e-7).
    bf16: 2⁻⁷, one bf16 ulp: the twins round P relative to the row's
    final max, the kernels relative to the running one, and the output's
    last bit may flip (observed 3.0e-3 to 6.7e-3). T5 ttv4 in either
    dtype: 2⁻⁶: its exp2 argument is rounded to bf16 relative to the
    running max, so the result depends on the block schedule, and the JAX
    package's interpret path evaluates the bf16 exp2 as exp(bf16(ln 2)·x)
    in bf16, one more rounding than the twin's (and the Hopper kernel's)
    exp2 of the bf16 argument (observed 5.6e-3 to 6.4e-3 in fp32, 1.2e-2
    to 1.3e-2 in bf16)."""
    if label == 'T5 ttv4':
        return 2.0**-6
    return 1e-5 if dtype == 'fp32' else 2.0**-7


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('shape', [(1, 2, 1024, 40), (1, 2, 1024, 80)])
@pytest.mark.parametrize('label', list(fv.CONFIGS))
def test_twin_matches_jax_tool_kernel(label, shape, dtype, interpret):
    """Each configuration's twin (what the wrapper runs on CPU tensors)
    against its JAX tool kernel in interpret mode, on the same inputs."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(shape[-1])
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    scale = shape[-1]**-0.5
    ref = np.asarray(JAX_CALLS[label](
        *(jnp.asarray(a).astype(jdt) for a in arrs), scale).astype(
            jnp.float32))
    _, twin, bhds = fv.CONFIGS[label]
    t = (lambda x: x.transpose(-1, -2)) if bhds else (lambda x: x)
    got = t(twin(*(t(torch.from_numpy(a).to(tdt)) for a in arrs), scale))
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _tolerance(label, dtype) * np.abs(ref).max(), err


@pytest.mark.parametrize('label', list(fv.CONFIGS))
def test_wrapper_on_cpu_returns_its_twin(label):
    """On CPU tensors each wrapper returns its twin's result exactly and
    launches nothing."""
    kernel, twin, bhds = fv.CONFIGS[label]
    shape = (1, 2, 40, 256) if bhds else (1, 2, 256, 40)
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    before = fv.launch_counts()
    torch.testing.assert_close(kernel(q, k, v, 0.15), twin(q, k, v, 0.15),
                               rtol=0, atol=0)
    assert fv.launch_counts() == before


def test_wrappers_reject_shapes_outside_the_domain():
    """The kernels' domain holds on the CPU too: S a multiple of 64 (of
    64·G for vG), D a multiple of 8, the fold's D ≤ 120, known variants."""
    x = torch.zeros((1, 1, 256, 40))
    bad = [
        lambda: fv.attn_opt('v0', x[:, :, :100], x[:, :, :100],
                            x[:, :, :100], 0.1),
        lambda: fv.attn_opt('vG', x[:, :, :192], x, x, 0.1, g=2),
        lambda: fv.attn_opt('vX', x, x, x, 0.1),
        lambda: fv.attn_h(x[..., :36], x[..., :36], x[..., :36], 0.1),
        lambda: fv.flash_ttv3(*(torch.zeros((1, 1, 128, 64)),) * 3, 0.1),
        lambda: fv.flash_ttv3(x, x, x, 0.1, bf16_p=True, sum_fold=False),
        lambda: fv.attn_variants(5, x, x, x, 0.1),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


@pytest.mark.parametrize('path', [None, fv.MMA])
@pytest.mark.parametrize('tool', [port_variants, port_flash_opt])
def test_tools_take_a_path_on_cpu(tool, path):
    """flash_variants' and flash_opt's ``path`` (and ``--path``): each
    row runs through its twin on the CPU, labelled so, within the JAX
    scripts' 0.04, with the tile its plan on that path gives."""
    rows = tool.run(torch.Generator().manual_seed(0), device='cpu',
                    path=path)
    assert rows and all(r['max_abs_err'] < 0.04 and r['path'] == 'twin'
                        for r in rows)
    tool.main(['--device', 'cpu'] + (['--path', path] if path else []))


@pytest.mark.parametrize('tool', [port_variants, port_flash_opt,
                                  port_pipelined])
def test_tool_exactness_on_cpu(tool):
    """Each attention tool's CPU run: its exactness part at a small shape,
    through the twins, within the JAX scripts' 0.04 of fp32 attention."""
    res = tool.run(torch.Generator().manual_seed(0), device='cpu')
    rows = res if isinstance(res, list) else [res]
    assert rows and all(r['max_abs_err'] < 0.04 for r in rows)


def test_flash_tt_tools_exactness_on_cpu():
    """flash_tt's check_exact (K1, K1's transposed entry and T4) and
    flash_tt3's main (K1, ttv3, ttv4, no-fold) at their CPU shapes."""
    gen = torch.Generator().manual_seed(0)
    rows = port_flash_tt.run(gen, device='cpu')['exact']
    rows += port_flash_tt3.run(gen, device='cpu')['main']
    assert len(rows) == 6 + 8
    assert all(r['max_abs_err'] < 0.04 for r in rows)


@pytest.mark.parametrize('path', [None, fv.MMA])
def test_tt_tools_take_a_path_on_cpu(path):
    """flash_tt's and flash_tt3's ``path`` (and ``--path``): on the CPU
    each T4/T5 row runs through its twin whatever the path, within the JAX
    scripts' 0.04."""
    gen = torch.Generator().manual_seed(0)
    rows = port_flash_tt.run(gen, device='cpu', path=path)['exact']
    rows += port_flash_tt3.run(gen, device='cpu', path=path)['main']
    assert len(rows) == 6 + 8
    assert all(r['max_abs_err'] < 0.04 for r in rows)
    more = ['--path', path] if path else []
    port_flash_tt.main(['exact', '--device', 'cpu'] + more)
    port_flash_tt3.main(['--device', 'cpu'] + more)


def test_perf_experiment_chain_on_cpu():
    """perf_experiment's chains on the tiny UNet (CPU: untimed, finite)."""
    res = port_perf.run(torch.Generator().manual_seed(0), device='cpu')
    assert res['base']['ms'] is None
    assert res['base']['out'].shape == res['conv']['out'].shape == (
        2, 8, 8, 4)


def test_tools_raise_without_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        port_flash_opt.run(torch.Generator().manual_seed(0))


def test_kernel_swap_restores_the_dispatcher_kernel():
    """The A/B swap puts K1 back, also when the block raises."""
    from flexdiffuse_tpu_torch.ops import attention as attn_mod
    orig = attn_mod.flash_attention
    with pytest.raises(KeyError):
        with port_pipelined.kernel_swapped(fv.pipelined_attention):
            assert attn_mod.flash_attention is fv.pipelined_attention
            raise KeyError
    assert attn_mod.flash_attention is orig


def test_build_in_parts_compiles_each_part_then_links(tmp_path, monkeypatch):
    """``build(source, parts)`` runs one compile per part, each with
    ``-DBUILD_PART=p -DBUILD_PARTS=parts``, then one link of the objects
    into the library (a stand-in nvcc records its arguments)."""
    log, nvcc = tmp_path / 'calls', tmp_path / 'nvcc'
    nvcc.write_text('#!/bin/sh\n'
                    f'echo "$@" >> {log}\n'
                    'while [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(fa, '_nvcc', lambda: str(nvcc))
    monkeypatch.setattr(fa, 'BUILD_DIR', tmp_path / 'build')
    assert fa.build(fv.SOURCE, 3) > 0
    calls = log.read_text().splitlines()
    compiles = sorted(c for c in calls if ' -c ' in c)
    assert len(calls) == 4 and len(compiles) == 3
    for p, call in enumerate(compiles):
        assert f'-DBUILD_PART={p} -DBUILD_PARTS=3' in call
        assert '-shared' not in call.split()
    (link,) = [c for c in calls if ' -c ' not in c]
    assert '-shared' in link.split() and link.count('.o') == 3
    assert fa.library_path(fv.SOURCE).read_text() == 'built\n'
    assert fa.build(fv.SOURCE, 3) == 0.0   # built already


# The path choosers of T1–T6: every head width of the domain, both dtypes,
# the main shapes, a serving batch, the tools' CPU shape and Sq != Skv
# (T1's and T6's plans take those whose Sq is a multiple of 64·G; T4's and
# T5's the same shapes over [B, H, D, S], their chains following Sq).
PLAN_SHAPES = [((2, 8, 4096), 4096), ((2, 8, 1024), 1024),
               ((1, 2, 1024), 1024), ((16, 8, 4096), 4096),
               ((1, 2, 256), 256), ((1, 1, 64), 192), ((3, 5, 128), 640),
               ((1, 3, 512), 320)]
PLANS = {'attn_h': fv.plan_attn_h, 'pipelined_attention': fv.plan_pipelined}
# T1's and T6's plans: name → (plan, the kernel's configuration, q chains
# G, the kept kernel's stages).
CHAIN_PLANS = {
    'attn_opt v0': (fv.PATH_CONFIGS['T1 v0'][1], 'v0', 1, 1),
    'attn_opt vU': (fv.PATH_CONFIGS['T1 vU'][1], 'vU', 1, 2),
    'attn_opt vG2': (fv.PATH_CONFIGS['T1 vG2'][1], 'vG2', 2, 1),
    'attn_opt vG4': (fv.PATH_CONFIGS['T1 vG4'][1], 'vG4', 4, 1),
    'attn_variants v0': (lambda q, k, path=None: fv.plan_attn_variants(
        q, k, 0, path=path), 'v0', 1, 1),
    'attn_variants v1': (fv.PATH_CONFIGS['T6 v1'][1], 'v0', 1, 1),
    'attn_variants v2': (fv.PATH_CONFIGS['T6 v2'][1], 'v2', 1, 1),
}
# T4's and T5's plans, over [B, H, D, S]: name → (configuration, the fold).
TT_PLANS = {'flash_tt2': ('T4', False), 'flash_ttv3 ttv3': ('T5 ttv3', True),
            'flash_ttv3 ttv4': ('T5 ttv4', True),
            'flash_ttv3 no-fold': ('T5 no-fold', False)}


def _meta(shape, skv, d, dtype, bhds=False):
    if bhds:
        return (torch.empty((*shape[:2], d, shape[2]), dtype=dtype,
                            device='meta'),
                torch.empty((*shape[:2], d, skv), dtype=dtype, device='meta'))
    return (torch.empty((*shape, d), dtype=dtype, device='meta'),
            torch.empty((*shape[:2], skv, d), dtype=dtype, device='meta'))


def _tt_plan_holds(name, d):
    """T4's or T5's plan at width d, every PLAN_SHAPES shape: 'sm90' with
    tt_chains' chains of 64 q rows over 64-column kv tiles, the chains'
    stages, the kv split for T4 alone; 'mma' only when forced, one 4-warp
    block per 64 q rows; the plan's layout [B, H, D, S]."""
    label, fold = TT_PLANS[name]
    plan = fv.PATH_CONFIGS[label][1]
    if d > (fv.MAX_FOLD_HEAD_DIM if fold else fv.MAX_HEAD_DIM):
        return
    dp = -(-(d + fold) // 16) * 16
    for dtype in fa.DTYPES16:
        for shape, skv in PLAN_SHAPES:
            q, k = _meta(shape, skv, d, dtype, bhds=True)
            b, h, sq = shape
            for path in (None, fv.SM90):
                how = plan(q, k, path=path)
                chains = fv.tt_chains(sq, dp)
                assert chains == (4 if sq % 256 == 0 and dp <= 96 else
                                  2 if sq % 128 == 0 else 1)
                config = fv.TT_CONFIGS[chains]
                assert how.path == fv.SM90 and how.bhds
                assert how.head_pad == dp and how.block_q == 64 * chains
                assert how.block_kv == fv.TILE
                assert how.grid == (sq // (64 * chains), b * h)
                assert how.threads == 128 * chains
                assert how.stages == fv.chains_tiling(config, dp, True)[1]
                assert how.parts == (fv.chains_parts(
                    config, how.grid[0] * how.grid[1], skv // 64, dp, True)
                    if label == 'T4' else 1)
            kept = plan(q, k, path=fv.MMA)
            assert kept.path == fv.MMA and kept.bhds
            assert (kept.block_q, kept.threads, kept.stages, kept.parts) == (
                64, 128, 1, 1)
            assert kept.grid == (sq // 64, b * h)


@pytest.mark.parametrize('d', range(8, fv.MAX_HEAD_DIM + 1, 8))
@pytest.mark.parametrize('name', list(PLANS) + list(CHAIN_PLANS) +
                         list(TT_PLANS))
def test_plan_takes_the_hopper_path_at_every_width(name, d):
    """Every shape of the domain plans 'sm90', with the source's tiles
    (PIPELINED_TILES, HEADS_TILES, CHAINS_TILES: G chains of 64 q rows,
    vG4's kv tile 32 above DP 96, 64-row kv tiles elsewhere, T1's and T6
    v0's kv split where their blocks number at most the card's SMs; T4 at
    d 8–128 and T5 at d 8–120, no-fold to 128, as :func:`_tt_plan_holds`);
    'mma' only when the caller forces it, as the first port's grid."""
    if name in TT_PLANS:
        _tt_plan_holds(name, d)
        return
    if name in CHAIN_PLANS:
        plan, config, g, kept_stages = CHAIN_PLANS[name]
    else:
        plan, g = PLANS[name], 1
        kept_stages = 1 if name == 'attn_h' else 2
    dp = -(-d // 16) * 16
    for dtype in fa.DTYPES16:
        for shape, skv in PLAN_SHAPES:
            q, k = _meta(shape, skv, d, dtype)
            b, h, sq = shape
            if sq % (64 * g):
                continue
            for path in (None, fv.SM90):
                how = plan(q, k, path=path)
                assert how.path == fv.SM90 and how.head_pad == dp
                if name in CHAIN_PLANS:
                    chains, stages, kv, _ = fv.chains_tiling(config, dp)
                    assert chains == g and how.block_q == 64 * g
                    assert how.block_kv == kv == (
                        32 if g == 4 and dp > 96 else fv.TILE)
                    assert how.grid == (sq // (64 * g), b * h)
                    assert how.threads == 128 * g
                    assert how.stages == stages
                    split = name.startswith('attn_opt') or name.endswith(
                        'v0')
                    assert how.parts == (fv.chains_parts(
                        config, sq // (64 * g) * b * h, skv // kv, dp)
                        if split else 1)
                    continue
                assert how.block_kv == fv.TILE
                if name == 'attn_h':
                    consumers, stages = fv.HEADS_TILES[dp <= 64]
                    parts = fv.heads_parts(b * sq // 64, skv // 64, dp)
                    assert how.grid == (sq // 64, b)
                    assert how.parts == parts and how.block_q == 64
                else:
                    consumers, stages = fv.PIPELINED_TILES
                    assert how.block_q == 64 * consumers and how.parts == 1
                    assert how.grid == (-(-sq // how.block_q), b * h)
                assert how.threads == 128 * (consumers + 1)
                assert how.stages == stages
            kept = plan(q, k, path=fv.MMA)
            assert kept.path == fv.MMA and kept.threads == 128 * g
            assert kept.block_q == 64 * g and kept.stages == kept_stages
            assert kept.grid == (sq // (64 * g),
                                 b if name == 'attn_h' else b * h)
            assert kept.parts == 1


# ChainsTiling's shared memory and blocks an SM, as the source computes
# them (the source's comment states v0's 57 KB and 3 blocks up to DP 64,
# 2 above; vU's 3, then 2 at DP 80 and 96, then 1).
@pytest.mark.parametrize('config,dp,nbytes,blocks,split', [
    ('v0', 48, 58424, 3, True), ('v0', 64, 58424, 3, True),
    ('v2', 64, 58424, 3, True), ('v0', 80, 52264, 2, True),
    ('v0', 128, 82984, 2, True),
    ('vU', 64, 74824, 3, True), ('vU', 80, 93256, 2, True),
    ('vU', 96, 111688, 2, True), ('vU', 112, 130120, 1, True),
    ('vU', 128, 148552, 1, True),
    ('vG2', 48, 66616, 2, True), ('vG2', 80, 83000, 1, True),
    ('vG2', 128, 132152, 1, True),
    ('vG4', 48, 83000, 1, True), ('vG4', 80, 103480, 1, True),
    ('vG4', 96, 123960, 1, True), ('vG4', 112, 101432, 1, False),
    ('vG4', 128, 115768, 1, False),
])
def test_chains_blocks_an_sm(config, dp, nbytes, blocks, split):
    """ChainsTiling's shared memory, blocks an SM and whether the split's
    merge buffers fit where Q and the ring were."""
    assert fv.chains_bytes(config, dp) == nbytes
    assert fv.chains_blocks(config, dp) == blocks
    assert fv.chains_split_fits(config, dp) == split
    assert nbytes <= 232448   # a block's most


# T4/T5's tiles over [D, S]: a tile is DP rows of 128 bytes, the kv tile
# 64 columns at every chain count.
@pytest.mark.parametrize('config,dp,nbytes,blocks,split', [
    ('vG4', 48, 62520, 1, True), ('vG4', 96, 123960, 1, True),
    ('vG2', 48, 50232, 2, True), ('vG2', 128, 132152, 1, True),
    ('v0', 48, 44088, 3, True), ('v0', 128, 82984, 2, True),
])
def test_tt_chains_blocks_an_sm(config, dp, nbytes, blocks, split):
    """ChainsTiling's shared memory, blocks an SM and merge room for the
    [D, S] forms."""
    assert fv.chains_tiling(config, dp, bhds=True)[2] == fv.TILE
    assert fv.chains_bytes(config, dp, bhds=True) == nbytes
    assert fv.chains_blocks(config, dp, bhds=True) == blocks
    assert fv.chains_split_fits(config, dp, bhds=True) == split


@pytest.mark.parametrize('sq,dp,want', [
    (4096, 48, 4), (1536, 48, 4), (1024, 96, 4),   # 256-row multiples
    (1024, 112, 2), (1024, 128, 2),   # vG4 stops at DP 96
    (640, 48, 2), (128, 80, 2),       # 128-row multiples
    (192, 48, 1), (64, 128, 1), (320, 96, 1),      # 64-row multiples
])
def test_tt_chains_follow_sq(sq, dp, want):
    """T4's and T5's q chains a block: 4 where Sq is a multiple of 256 and
    DP <= 96, else 2 where it is a multiple of 128, else 1."""
    assert fv.tt_chains(sq, dp) == want
    assert fv.TT_CONFIGS[want] == {4: 'vG4', 2: 'vG2', 1: 'v0'}[want]


@pytest.mark.parametrize('shape,want', [
    ((2, 8, 80, 1024), 2),    # 64 blocks of four chains
    ((2, 8, 40, 4096), 1),    # 256 blocks: more than the SMs
    ((1, 2, 40, 1024), 2),
    ((2, 8, 40, 1536), 2),    # 96 blocks
    ((8, 8, 40, 4096), 1),
    ((1, 1, 40, 64), 1),      # one kv tile cannot be split
])
def test_tt2_split_only_where_the_card_has_room(shape, want):
    """T4's kv split follows T1's rule (chains_parts over its blocks); T5
    is never split."""
    q = torch.empty(shape, dtype=torch.bfloat16, device='meta')
    assert fv.plan_tt2(q, q).parts == want
    for label in ('T5 ttv3', 'T5 ttv4', 'T5 no-fold'):
        assert fv.PATH_CONFIGS[label][1](q, q).parts == 1


@pytest.mark.parametrize('config,blocks,tiles,dp,want', [
    ('vG4', 64, 16, 80, 2),     # (2,8,1024,80): 64 blocks
    ('vG2', 128, 16, 80, 2),    # the same shape's vG2
    ('v0', 256, 16, 80, 1),     # and v0: more blocks than SMs
    ('vG4', 256, 64, 48, 1),    # (2,8,4096,40)
    ('v0', 32, 16, 48, 2),      # (1,2,1024,40)
    ('vG2', 132, 64, 48, 2),    # one block an SM
    ('vG2', 133, 64, 48, 1),
    ('vG4', 8, 32, 128, 1),     # no room for the merge buffers
    ('v0', 8, 1, 48, 1),        # one kv tile cannot be split
])
def test_chains_parts_split_only_where_the_card_has_room(
        config, blocks, tiles, dp, want):
    """T1's kv split: only where the blocks number at most the card's SMs
    and the merge buffers fit; 2 parts, each at least one tile."""
    assert fv.chains_parts(config, blocks, tiles, dp) == want


@pytest.mark.parametrize('instances,tiles,dp,want', [
    (32, 16, 80, 2),     # (2,8,1024,80): 32 instances fill a quarter
    (16, 16, 48, 2),     # (1,2,1024,40)
    (128, 64, 48, 1),    # (2,8,4096,40): the card is full
    (66, 64, 48, 2),     # half of 132 SMs
    (67, 64, 48, 1),     # more than half
    (32, 16, 112, 1),    # no room for the merge buffers above DP 96
    (32, 16, 96, 2),
    (16, 2, 48, 2),      # one tile a part
    (16, 1, 48, 1),      # one kv tile cannot be split
])
def test_heads_parts_split_only_where_the_card_is_half_empty(
        instances, tiles, dp, want):
    """T2's kv split: only where the instances fill at most half of the
    card and DP <= HEADS_SPLIT_MAX_DP; the first of HEADS_PARTS whose
    blocks fit the card with no empty part."""
    parts = fv.heads_parts(instances, tiles, dp)
    assert parts == want
    per = -(-tiles // parts)
    assert instances * parts <= fa.SMS and (parts - 1) * per < tiles


@pytest.mark.parametrize('path', [None, fv.SM90, fv.MMA])
@pytest.mark.parametrize('label', list(fv.PATH_CONFIGS))
def test_cpu_calls_count_no_launch_on_either_path(label, path):
    """On CPU tensors every configuration with two paths returns its twin
    whatever the path asked for, and counts no launch on either path."""
    fn = fv.PATH_CONFIGS[label][0]
    _, twin, bhds = fv.CONFIGS[label]
    gen = torch.Generator().manual_seed(5)
    shape = (1, 2, 40, 256) if bhds else (1, 2, 256, 40)
    q, k, v = (torch.randn(shape, generator=gen).to(torch.bfloat16)
               for _ in range(3))
    before = (fv.launch_counts(), fv.path_counts())
    torch.testing.assert_close(fn(q, k, v, 0.15, path=path),
                               twin(q, k, v, 0.15), rtol=0, atol=0)
    assert (fv.launch_counts(), fv.path_counts()) == before


def test_path_wrappers_count_by_path():
    """Every wrapper has two paths and counts its launches by path, and
    ``path_counts`` names them all."""
    assert set(fv.path_counts()) == {
        f'{fn.__name__}_{p}' for fn in (fv.attn_opt, fv.attn_h,
                                        fv.pipelined_attention,
                                        fv.flash_tt2, fv.flash_ttv3,
                                        fv.attn_variants)
        for p in fv.PATHS}
    assert {fn for _, _, fn, _ in fv.PATH_CONFIGS.values()} == set(
        fv.WRAPPERS)
    assert fv.config_path_counts() == {}


@pytest.mark.parametrize('label', list(fv.PATH_CONFIGS))
def test_launch_options_name_the_configuration(label):
    """Each configuration's entry-point options: T1's variant code, T6's
    variant, T5's (bf16_p, sum_fold), none for T2, T3 and T4 (whose chains
    and parts come from the plan)."""
    options = fv.PATH_CONFIGS[label][3]
    if label.startswith('T5'):
        (setting,) = [key for key, name in fv.T5_SETTINGS.items()
                      if name == label.split()[1]]
        assert options == tuple(int(x) for x in setting)
    elif label.startswith('T1'):
        variant = label.split()[1]
        key = ('vG', int(variant[2])) if variant.startswith('vG') else (
            variant, 1)
        assert options == (fv.T1_CODES[key],)
    elif label.startswith('T6'):
        assert options == (int(label[-1]),)
    else:
        assert options == ()


@pytest.mark.parametrize('label', list(fv.PATH_CONFIGS))
def test_unknown_path_raises(label):
    fn, plan, _, _ = fv.PATH_CONFIGS[label]
    x = torch.zeros((1, 1, 40, 256) if fv.CONFIGS[label][2] else
                    (1, 1, 256, 40))
    with pytest.raises(ValueError):
        fn(x, x, x, 0.1, path='wide')
    with pytest.raises(ValueError):
        plan(x, x, path='mma.sync')


def test_split_twin_of_one_part_is_plain_exp():
    gen = torch.Generator().manual_seed(6)
    q, k, v = (torch.randn((1, 2, 128, 24), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    torch.testing.assert_close(fv.plain_split_exp(q, k, v, 0.2, 1),
                               fv.plain_exp(q, k, v, 0.2), rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _jax_attn_h(shape, dtype):
    jdt = DTYPES[dtype][0]
    rng = np.random.default_rng(shape[-1])
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    ref = np.asarray(flash_opt.attn_h(
        *(jnp.asarray(a).astype(jdt) for a in arrs),
        shape[-1]**-0.5).astype(jnp.float32))
    return arrs, ref


@functools.lru_cache(maxsize=None)
def _jax_attn_vg4(shape, dtype):
    jdt = DTYPES[dtype][0]
    rng = np.random.default_rng(shape[-1] + 1)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    ref = np.asarray(JAX_CALLS['T1 vG4'](
        *(jnp.asarray(a).astype(jdt) for a in arrs),
        shape[-1]**-0.5).astype(jnp.float32))
    return arrs, ref


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_t1_split_twin_matches_jax_tool_kernel(dtype, interpret):
    """T1's kv split on 'sm90' (vG4 at the 1024-token head takes 2 parts),
    its twin ``plain_split_exp``, against the JAX tool kernel
    ``tools/flash_opt.py::attn`` ('vG', g = 4) in interpret mode at
    (1,2,1024,80), with ``test_twin_matches_jax_tool_kernel``'s
    tolerance."""
    shape = (1, 2, 1024, 80)
    q = torch.empty(shape, dtype=torch.bfloat16, device='meta')
    parts = fv.plan_attn_opt(q, q, 'vG', 4).parts
    assert parts == 2
    arrs, ref = _jax_attn_vg4(shape, dtype)
    tdt = DTYPES[dtype][1]
    got = fv.plain_split_exp(*(torch.from_numpy(a).to(tdt) for a in arrs),
                             shape[-1]**-0.5, parts)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _tolerance('T1 vG4', dtype) * np.abs(ref).max(), err


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_t4_split_twin_matches_jax_tool_kernel(dtype, interpret):
    """T4's kv split on 'sm90' (four chains at the 1024-token head take 2
    parts), its twin ``plain_split_exp`` over the transposed views
    (``planned_twin``), against the JAX tool kernel
    ``tools/flash_tt.py::flash_tt2`` in interpret mode at (1,2,1024,80),
    with ``test_twin_matches_jax_tool_kernel``'s tolerance."""
    shape = (1, 2, 1024, 80)
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(shape[-1] + 2)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    scale = shape[-1]**-0.5
    ref = np.asarray(JAX_CALLS['T4'](
        *(jnp.asarray(a).astype(jdt) for a in arrs), scale).astype(
            jnp.float32))
    q, k, v = (torch.from_numpy(a).to(tdt).transpose(-1, -2).contiguous()
               for a in arrs)
    assert fv.plan_tt2(q, k).parts == 2
    got = fv.planned_twin('T4', q, k, v, scale).transpose(-1, -2)
    torch.testing.assert_close(
        got, fv._bhds(fv.plain_split_exp, q, k, v, scale, 2).transpose(
            -1, -2), rtol=0, atol=0)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _tolerance('T4', dtype) * np.abs(ref).max(), err


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('parts', [2, 4])
def test_split_twin_matches_jax_tool_kernel(parts, dtype, interpret):
    """T2's kv split and merge (``plain_split_exp``, the kernel's order)
    against the JAX tool kernel ``tools/flash_opt.py::attn_h`` in interpret
    mode at (1,2,1024,80), the main 1024-token head, with
    ``test_twin_matches_jax_tool_kernel``'s tolerance: fp32 1e-5 of max|ref|
    (the split only reorders fp32 sums: observed ≤ 5e-7), bf16 2⁻⁷ (P is
    rounded relative to each part's max, as in every online kernel)."""
    shape = (1, 2, 1024, 80)
    arrs, ref = _jax_attn_h(shape, dtype)
    tdt = DTYPES[dtype][1]
    got = fv.plain_split_exp(*(torch.from_numpy(a).to(tdt) for a in arrs),
                             shape[-1]**-0.5, parts)
    err = np.abs(got.float().numpy() - ref).max()
    assert err <= _tolerance('T2', dtype) * np.abs(ref).max(), err
