"""PyTorch port: the attention dispatcher and the plain twin of the Hopper
flash kernel, held against the JAX package on the CPU.

The JAX flash kernel runs in Pallas interpret mode here, as the JAX
package's own tests run it. The Hopper kernel itself needs the card; its
test is ``tests/test_torch_kernels_cuda.py``.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu.ops import attention as jax_attention_mod
from flexdiffuse_tpu.ops import flash_backward as jax_flash_backward
from flexdiffuse_tpu.ops.attention import xla_attention
from flexdiffuse_tpu.ops.flash_attention import flash_attention as jax_flash
from flexdiffuse_tpu_torch.ops import attention as port_attention_mod
from flexdiffuse_tpu_torch.ops.attention import attention, flash_eligible
from flexdiffuse_tpu_torch.ops.flash_attention import (flash_attention,
                                                       plain_attention)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Every module of the port, imported by the subprocess checks below.
PORT_MODULES = [
    'flexdiffuse_tpu_torch', 'flexdiffuse_tpu_torch.config',
    'flexdiffuse_tpu_torch.encode', 'flexdiffuse_tpu_torch.runner',
    'flexdiffuse_tpu_torch.models', 'flexdiffuse_tpu_torch.models.clip',
    'flexdiffuse_tpu_torch.models.configs',
    'flexdiffuse_tpu_torch.models.unet', 'flexdiffuse_tpu_torch.models.vae',
    'flexdiffuse_tpu_torch.ops.attention',
    'flexdiffuse_tpu_torch.ops.flash_attention',
    'flexdiffuse_tpu_torch.ops.flash_backward',
    'flexdiffuse_tpu_torch.ops.group_norm',
    'flexdiffuse_tpu_torch.ops.flash_variants',
    'flexdiffuse_tpu_torch.tools',
    'flexdiffuse_tpu_torch.tools.perf_experiment',
    'flexdiffuse_tpu_torch.tools.flash_variants',
    'flexdiffuse_tpu_torch.tools.flash_opt',
    'flexdiffuse_tpu_torch.tools.flash_pipelined',
    'flexdiffuse_tpu_torch.tools.flash_tt',
    'flexdiffuse_tpu_torch.tools.flash_tt3',
    'flexdiffuse_tpu_torch.tools.gn_compare',
    'flexdiffuse_tpu_torch.composition',
    'flexdiffuse_tpu_torch.composition.embeds',
    'flexdiffuse_tpu_torch.composition.schema',
    'flexdiffuse_tpu_torch.pipeline.guides',
    'flexdiffuse_tpu_torch.schedulers.ddim',
    'flexdiffuse_tpu_torch.schedulers.lms',
    'flexdiffuse_tpu_torch.schedulers.pndm',
    'flexdiffuse_tpu_torch.text.tokenizer',
    'flexdiffuse_tpu_torch.utils.image',
    'flexdiffuse_tpu_torch.weights.bridge',
    'flexdiffuse_tpu_torch.guidance', 'flexdiffuse_tpu_torch.schedulers',
    'flexdiffuse_tpu_torch.pipeline', 'flexdiffuse_tpu_torch.training',
    'flexdiffuse_tpu_torch.training.checkpoint',
    'flexdiffuse_tpu_torch.training.data',
    'flexdiffuse_tpu_torch.training.dreambooth',
    'flexdiffuse_tpu_torch.training.loop',
    'flexdiffuse_tpu_torch.training.train',
]


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One torch intra-op thread while a port test module runs: the suite
    runs in several worker processes on shared cores, and torch's small CPU
    ops slow down many times over when every worker starts a thread per
    core. Imported (autouse) by every CPU test module of the port."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize('shape', [(1, 2, 1024, 40), (1, 2, 1024, 80)])
def test_plain_attention_matches_jax(shape):
    """plain_attention vs JAX flash (interpret) and xla_attention, fp32.
    Observed max|Δ| ≈ 1e-7 to xla_attention, ≈ 1e-6 to the online-softmax
    kernel."""
    q, k, v = _qkv(shape, seed=shape[-1])
    scale = shape[-1]**-0.5
    got = plain_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          scale).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_xla = np.asarray(xla_attention(jq, jk, jv, scale))
    ref_flash = np.asarray(jax_flash(jq, jk, jv, scale, interpret=True))
    np.testing.assert_allclose(got, ref_xla, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, ref_flash, rtol=0, atol=1e-5)


def test_cpu_wrapper_and_dispatcher_take_plain_path():
    """On CPU tensors the kernel wrapper and the dispatcher both give the
    plain result, and the launch counter does not move."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((1, 2, 1024, 40), 3))
    before = flash_attention.launches
    ref = plain_attention(q, k, v, 40**-0.5)
    torch.testing.assert_close(flash_attention(q, k, v, 40**-0.5), ref,
                               rtol=0, atol=0)
    for name in ('auto', 'flash', 'plain'):
        torch.testing.assert_close(attention(q, k, v, backend=name), ref,
                                   rtol=0, atol=0)
    assert flash_attention.launches == before
    with pytest.raises(ValueError):
        attention(q, k, v, backend='xla')


# (q tokens, kv tokens, head dim): cross-attention's 77-token context, the
# 256-token level, the 1024- and 4096-token levels, a non-square 1536, the
# VAE's 512-wide head, a 160-wide head, and non-multiples of 128.
ELIGIBILITY = [(4096, 77, 40), (1024, 77, 80), (256, 256, 160),
               (1024, 1024, 80), (4096, 4096, 40), (1536, 1536, 40),
               (4096, 4096, 512), (1024, 1024, 160), (4096, 4096, 64),
               (1000, 1000, 40), (10816, 10816, 40), (512, 512, 40)]


def _jax_takes_flash(sq, skv, d, monkeypatch) -> bool:
    """Whether the JAX dispatcher routes this shape to its flash kernel
    (traced with eval_shape, so nothing runs)."""
    taken = []

    def fake(q, k, v, scale):
        taken.append(True)
        return q

    monkeypatch.setattr(jax_flash_backward, 'flash_attention_diff', fake)
    q = jax.ShapeDtypeStruct((1, 1, sq, d), jnp.float32)
    k = jax.ShapeDtypeStruct((1, 1, skv, d), jnp.float32)
    jax.eval_shape(lambda a, b, c: jax_attention_mod.attention(
        a, b, c, backend='flash'), q, k, k)
    return bool(taken)


@pytest.mark.parametrize('sq,skv,d', ELIGIBILITY)
def test_flash_eligible_matches_jax_rule(sq, skv, d, monkeypatch):
    q = torch.empty((1, 1, sq, d), device='meta')
    k = torch.empty((1, 1, skv, d), device='meta')
    assert flash_eligible(q, k) == _jax_takes_flash(sq, skv, d, monkeypatch)


def _run_isolated(code: str, env=None) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_triton_or_nvcc():
    """Every port module imports, and the CPU path runs, with ``triton``
    unimportable and no ``nvcc`` on PATH."""
    code = (
        'import shutil, sys\n'
        "sys.modules['triton'] = None\n"
        "assert shutil.which('nvcc') is None\n"
        f'for m in {PORT_MODULES!r}:\n'
        '    __import__(m)\n'
        'import torch\n'
        'from flexdiffuse_tpu_torch.ops.attention import attention\n'
        'q = torch.randn(1, 1, 1024, 40)\n'
        'assert attention(q, q, q).shape == q.shape\n'
        "print('ok')\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) +
               ':/usr/bin:/bin')
    proc = _run_isolated(code, env)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == 'ok'


def test_port_import_leaves_jax_out():
    """Importing the whole port pulls in neither JAX nor the JAX package."""
    code = (
        'import sys\n'
        f'for m in {PORT_MODULES!r}:\n'
        '    __import__(m)\n'
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'flexdiffuse_tpu' or "
        "m.startswith('flexdiffuse_tpu.'))\n"
        'print(bad)\n')
    proc = _run_isolated(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


def test_backend_context_is_scoped():
    assert port_attention_mod._BACKEND.get() == 'auto'
    with port_attention_mod.backend('plain'):
        assert port_attention_mod._BACKEND.get() == 'plain'
    assert port_attention_mod._BACKEND.get() == 'auto'
