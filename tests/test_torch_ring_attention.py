"""PyTorch port: ring attention (``ops/ring_attention.py``) and the
sequence-parallel attention dispatch (``ops/attention.py`` ``sp_context``)
across gloo ranks on the CPU, held against full attention and the JAX
package's ``ring_attention`` on the conftest's 8 virtual devices.

One spawn of 4 ranks runs every multi-rank case: a ring over all 4 (a 1-D
``seq`` mesh) and rings over 2 (the ``model`` axis of a 2×2 mesh, both
groups on the same problem). The JAX references are computed in this
process and handed to the ranks as files. Tolerance 2e-5, JAX's own
(``tests/test_ring_attention.py``). The worker imports no JAX.
"""
import os

import numpy as np
import pytest
import torch

from flexdiffuse_tpu_torch.ops.flash_attention import plain_attention
from flexdiffuse_tpu_torch.ops.flash_backward import plain_attention_lse
from flexdiffuse_tpu_torch.ops.ring_attention import merge, ring_round

# JAX's shapes (tests/test_ring_attention.py:17).
SHAPES = [(1, 2, 256, 40), (2, 4, 128, 64)]
ATOL = 2e-5


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _shard(x: np.ndarray, rank: int, n: int) -> torch.Tensor:
    s = x.shape[2] // n
    return torch.from_numpy(x[:, :, rank * s:(rank + 1) * s].copy())


def _worker(rank, world, out_dir):
    """Every multi-rank case; rank 0 writes the gathered outputs."""
    import torch.distributed as dist

    from flexdiffuse_tpu_torch.ops import attention as A
    from flexdiffuse_tpu_torch.ops import ring_attention as R
    from flexdiffuse_tpu_torch.parallel.axis import MeshAxis, gather
    from flexdiffuse_tpu_torch.parallel import make_mesh, make_sp_mesh
    results = {}
    seq = make_sp_mesh()
    pair = make_mesh(model_parallel=2)
    sp4 = MeshAxis.of(seq, 'seq')
    sp2 = MeshAxis.of(pair, 'model')
    for i, shape in enumerate(SHAPES):
        q, k, v = _qkv(shape, i)
        scale = shape[-1]**-0.5
        for name, mesh, ax, sp in (('ring4', seq, 'seq', sp4),
                                   ('ring2', pair, 'model', sp2)):
            lq, lk, lv = (_shard(a, sp.rank, sp.size) for a in (q, k, v))
            o = R.ring_attention(lq, lk, lv, mesh, ax, scale)
            results[f'{name}_{i}'] = gather(o, sp, -2).numpy()
    # The dispatcher under sp_context: the ring above min_seq, gathered
    # K/V below it, cross-attention (77 replicated tokens) local.
    q, k, v = _qkv((1, 2, 256, 40), 7)
    ctx = np.random.default_rng(8).normal(size=(1, 2, 77, 40)).astype(
        np.float32)
    lq, lk, lv = (_shard(a, sp4.rank, 4) for a in (q, k, v))
    calls = []
    orig = R.ring_attention

    def spy(*args, **kw):
        calls.append(args[0].shape[-2])
        return orig(*args, **kw)

    R.ring_attention = spy
    try:
        for label, min_seq in (('sp_ring', 256), ('sp_gather', 4096)):
            with A.sp_context(seq, 'seq', min_seq=min_seq):
                o = A.attention(lq, lk, lv)
            results[label] = gather(o, sp4, -2).numpy()
        with A.sp_context(seq, 'seq', min_seq=0):
            c = torch.from_numpy(ctx)
            results['sp_cross'] = gather(A.attention(lq, c, c), sp4,
                                         -2).numpy()
    finally:
        R.ring_attention = orig
    results['ring_calls'] = np.asarray(calls)
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, 'ring.npz'), **results)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    from flexdiffuse_tpu_torch.parallel import launch
    out = tmp_path_factory.mktemp('ring')
    launch.spawn(_worker, 4, device='cpu', args=(str(out),), timeout=120,
                 join_timeout=240)
    return dict(np.load(out / 'ring.npz'))


def _full(q, k, v, scale):
    return plain_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                           scale).numpy()


@pytest.mark.parametrize('ring', ['ring4', 'ring2'])
@pytest.mark.parametrize('i', range(len(SHAPES)))
def test_ring_matches_full_and_jax_ring(ranks, ring, i):
    """The ring over 4 and over 2 gloo ranks equals full attention and
    JAX's ring on 8 virtual devices, at JAX's shapes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from flexdiffuse_tpu.ops.ring_attention import ring_attention as jring
    shape = SHAPES[i]
    q, k, v = _qkv(shape, i)
    scale = shape[-1]**-0.5
    got = ranks[f'{ring}_{i}']
    np.testing.assert_allclose(got, _full(q, k, v, scale), rtol=0,
                               atol=ATOL)
    mesh = Mesh(np.array(jax.devices()).reshape(8), ('sp',))
    want = np.asarray(jring(*(jnp.asarray(a) for a in (q, k, v)), mesh,
                            'sp', scale))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_sp_context_routes_as_jax(ranks):
    """Self-attention at ≥ min_seq global tokens rides the ring (one call
    per rank with the 64-row shard); below it K/V are gathered; the
    77-token cross-attention stays local. All equal full attention."""
    q, k, v = _qkv((1, 2, 256, 40), 7)
    scale = 40**-0.5
    ctx = np.random.default_rng(8).normal(size=(1, 2, 77, 40)).astype(
        np.float32)
    full = _full(q, k, v, scale)
    np.testing.assert_allclose(ranks['sp_ring'], full, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ranks['sp_gather'], full, rtol=0, atol=ATOL)
    np.testing.assert_allclose(ranks['sp_cross'], _full(q, ctx, ctx, scale),
                               rtol=0, atol=ATOL)
    assert ranks['ring_calls'].tolist() == [64]


@pytest.mark.parametrize('blocks', [1, 2, 4])
def test_ring_round_merge_matches_plain_lse(blocks):
    """``ring_round`` over K/V blocks, rotated by hand, against full
    attention, and its first round against ``plain_attention_lse``."""
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 3, 128, 32), 11))
    scale = 32**-0.5
    kb, vb = k.chunk(blocks, dim=2), v.chunk(blocks, dim=2)
    state = None
    for j in range(blocks):
        state = ring_round(q, kb[j], vb[j], state, scale)
    torch.testing.assert_close(state[0], plain_attention(q, k, v, scale),
                               rtol=0, atol=ATOL)
    _, lse = plain_attention_lse(q, k, v, scale)
    torch.testing.assert_close(state[1], lse, rtol=0, atol=ATOL)
    o0, lse0 = plain_attention_lse(q, kb[0], vb[0], scale)
    first = merge(None, o0, lse0)
    got = ring_round(q, kb[0], vb[0], None, scale)
    assert torch.equal(got[0], first[0]) and torch.equal(got[1], first[1])
