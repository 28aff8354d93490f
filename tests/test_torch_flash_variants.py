"""PyTorch port: the attention variants T1–T6 and the ported experiment
tools, held against the JAX package's tool kernels on the CPU.

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


@pytest.mark.parametrize('tool', [port_variants, port_flash_opt,
                                  port_pipelined])
def test_tool_exactness_on_cpu(tool):
    """Each attention tool's CPU run: its exactness part at a small shape,
    through the twins, within the JAX scripts' 0.04 of fp32 attention."""
    res = tool.run(torch.Generator().manual_seed(0), device='cpu')
    rows = res if isinstance(res, list) else [res]
    assert rows and all(r['max_abs_err'] < 0.04 for r in rows)


def test_flash_tt_tools_exactness_on_cpu():
    """flash_tt's check_exact (K1 and T4) and flash_tt3's main (K1, ttv3,
    ttv4, no-fold) at their CPU shapes."""
    gen = torch.Generator().manual_seed(0)
    rows = port_flash_tt.run(gen, device='cpu')['exact']
    rows += port_flash_tt3.run(gen, device='cpu')['main']
    assert len(rows) == 4 + 8
    assert all(r['max_abs_err'] < 0.04 for r in rows)


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
