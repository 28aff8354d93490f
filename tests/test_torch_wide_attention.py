"""PyTorch port: flash attention at head widths above 128 (the 'wide_sm90'
and 'wide' paths, ``csrc/flash_wide.cu``), which replace the JAX package's
K1 (``_flash_tt_kernel``) and K2 (``_flash_stream_kernel``) at those
widths.

On the CPU: the port's ``flash_attention`` on CPU tensors (its plain
version) against the JAX ``flash_attention`` in interpret mode on the same
numpy inputs, on JAX's K1 path ((1,1,1024,512): K/V take 8 MiB) and K2
path ((1,2,2048,512): 16 MiB), at d = 200 and 256 with Sq != Skv, and at
d = 640 and 1024; ``plan`` choosing 'wide_sm90' for bf16/fp16 aligned
inputs with 128 < D <= 512, D % 8 == 0, and 'wide' for the rest and for
every D > 512; the plain twin of 'wide_sm90''s kv split against
``plain_attention``; the dispatcher's eligibility unchanged (D <= 128, as
JAX); K3, and so ``FlashAttentionFn``, refusing D > 128 on the card.

On the card (marked ``cuda``, skipped here): both kernels against
``plain_attention`` by chip_smoke.py's rule, and exactly one launch on the
planned path per call. This file imports JAX only inside the CPU tests, so
the card runs it with ``python -m pytest tests/test_torch_wide_attention.py
-m cuda -q --noconftest``.
"""
import numpy as np
import pytest
import torch

from flexdiffuse_tpu_torch.ops import attention as attn
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops.flash_attention import (flash_attention,
                                                       plain_attention)

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32

# (q shape, kv tokens): JAX's K1 path, its K2 path, d = 200 and 256 with
# Sq != Skv, and two heads wider than 512.
PARITY = [((1, 1, 1024, 512), 1024), ((1, 2, 2048, 512), 2048),
          ((1, 2, 384, 200), 640), ((2, 1, 256, 256), 1152),
          ((1, 1, 256, 640), 384), ((1, 2, 128, 1024), 256)]


def _inputs(shape, skv, seed=0):
    rng = np.random.default_rng(seed)
    b, h, sq, d = shape
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(b, h, skv, d)).astype(np.float32),
            rng.normal(size=(b, h, skv, d)).astype(np.float32))


@pytest.mark.parametrize('shape,skv', PARITY)
def test_wide_heads_match_jax_flash_attention(shape, skv):
    """fp32 on both sides: observed max|Δ| 4.3e-7 to 5.4e-7 up to D = 512,
    9.8e-7 at D = 640 and 1.5e-6 at D = 1024 (unit-normal inputs); the
    bound is 2e-5."""
    import jax.numpy as jnp

    from flexdiffuse_tpu.ops.flash_attention import \
        flash_attention as jax_flash
    q, k, v = _inputs(shape, skv)
    scale = shape[-1]**-0.5
    ref = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale))
    before = dict(flash_attention.path_launches)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), scale)
    assert flash_attention.path_launches == before   # the CPU launches none
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)


def test_jax_takes_both_of_its_kernels_at_the_parity_shapes(monkeypatch):
    """The parity shapes reach JAX's K1 and K2 as the table says: K/V of
    8 MiB stay resident (``flash_attention_tt``), 16 MiB stream."""
    import jax
    import jax.numpy as jnp

    from flexdiffuse_tpu.ops import flash_attention as jfa
    taken = []
    real = jfa.flash_attention_tt

    def spy(*args, **kw):
        taken.append(True)
        return real(*args, **kw)

    monkeypatch.setattr(jfa, 'flash_attention_tt', spy)
    for shape, skv in PARITY[:2]:
        taken.clear()
        b, h, sq, d = shape
        q = jax.ShapeDtypeStruct(shape, jnp.float32)
        kv = jax.ShapeDtypeStruct((b, h, skv, d), jnp.float32)
        jax.eval_shape(lambda q, k, v: jfa.flash_attention(q, k, v, 0.1),
                       q, kv, kv)
        assert bool(taken) == (skv == 1024), shape


def _misaligned(shape, dtype):
    """A meta tensor of ``shape`` whose data pointer is 2 bytes past a
    16-byte boundary."""
    n = int(np.prod(shape))
    return torch.empty(n + 1, dtype=dtype, device='meta')[1:].view(shape)


@pytest.mark.parametrize('d', [129, 136, 200, 256, 257, 384, 511, 512])
@pytest.mark.parametrize('dtype', [BF16, F16, F32])
def test_plan_takes_the_wide_path_above_128(d, dtype):
    """bf16/fp16 with D % 8 == 0 and aligned tensors take 'wide_sm90' (64 q
    rows, the head padded to 128, kv tile 32, two consumer warpgroups; 16 q
    tiles × 6 heads fill more than half of 132 SMs, so no kv split); fp32,
    D % 8 != 0 and misaligned tensors the kept 'wide' (32 q rows of 8
    warps per block, kv tile 32 in two stages)."""
    q = torch.empty((2, 3, 1000, d), dtype=dtype, device='meta')
    k = torch.empty((2, 3, 77, d), dtype=dtype, device='meta')
    how = fa.plan(q, k, k)
    kept = fa.Plan('wide', -(-d // 16) * 16, 32, 32, 2, (32, 6), 256)
    if dtype == F32 or d % 8:
        assert how == kept
    else:
        assert how == fa.Plan('wide_sm90', -(-d // 128) * 128, 64, 32, 2,
                              (16, 6), 256, 1)
        assert fa.plan(_misaligned(q.shape, dtype), k, k) == kept
        assert fa.plan(q, k, _misaligned(k.shape, dtype)) == kept
    assert fa.plan(q, k, k, path='wide') == kept
    assert fa.plan(q, k, k, path=how.path) == how


@pytest.mark.parametrize('d', [513, 640, 1024, 2048])
def test_plan_takes_the_kept_wide_path_above_512(d):
    """Every head wider than 512 plans a kernel path: the kept 'wide', one
    block per 512-column chunk of the output (``parts``), in any dtype;
    'wide_sm90' refuses it."""
    for dtype in (BF16, F16, F32):
        q = torch.empty((1, 1, 64, d), dtype=dtype, device='meta')
        assert fa.plan(q, q, q) == fa.Plan('wide', -(-d // 16) * 16, 32, 32,
                                           2, (2, 1), 256, -(-d // 512))
    with pytest.raises(ValueError, match='wide_sm90 path takes'):
        fa.plan(q.to(BF16), q.to(BF16), q.to(BF16), path='wide_sm90')


@pytest.mark.parametrize('d,path,dtype', [
    (128, 'wide', BF16), (40, 'wide', BF16), (200, 'sm90', BF16),
    (512, 'mma', BF16), (256, 'wide_sm90', F32), (260, 'wide_sm90', BF16),
    (128, 'wide_sm90', BF16), (640, 'wide_sm90', F16)])
def test_a_forced_path_outside_its_widths_raises(d, path, dtype):
    q = torch.empty((1, 1, 64, d), dtype=dtype, device='meta')
    with pytest.raises(ValueError):
        fa.plan(q, q, q, path=path)


@pytest.mark.parametrize('shape,skv,parts', [
    ((1, 1, 4096, 512), 4096, 2), ((1, 2, 1000, 384), 77, 2),
    ((8, 1, 4096, 512), 4096, 1), ((1, 2, 1024, 200), 1024, 2),
    ((1, 1, 64, 256), 32, 1), ((1, 1, 16384, 512), 16384, 1),
    ((1, 1, 4224, 256), 64, 2), ((1, 1, 4225, 256), 64, 1)])
def test_the_kv_split_fills_half_the_card_or_less(shape, skv, parts):
    """'wide_sm90' splits the kv range in two where its q tiles fill at most
    half of the card's 132 SMs and there are two kv tiles to split."""
    q = torch.empty(shape, dtype=BF16, device='meta')
    k = torch.empty(shape[:2] + (skv, shape[3]), dtype=BF16, device='meta')
    how = fa.plan(q, k, k)
    assert how.path == 'wide_sm90' and how.parts == parts


@pytest.mark.parametrize('skv,parts', [(1024, 2), (77, 2), (1000, 3),
                                       (33, 2), (32, 1)])
def test_the_kv_split_merge_matches_plain_attention(skv, parts):
    """The plain twin of 'wide_sm90''s split: the kv range cut into the
    kernel's parts of whole 32-row tiles, each part's (o, m, l), merged;
    fp32 on the CPU, observed max|Δ| ≤ 5e-7 (unit-normal inputs)."""
    q, k, v = (torch.from_numpy(a) for a in _inputs((1, 2, 96, 200), skv))
    scale = 200**-0.5
    got = fa.plain_split_attention(q, k, v, scale, parts)
    np.testing.assert_allclose(got.numpy(),
                               plain_attention(q, k, v, scale).numpy(),
                               rtol=0, atol=2e-6)


def test_narrow_heads_keep_their_paths():
    q = torch.empty((2, 8, 4096, 40), dtype=BF16)
    assert fa.plan(q, q, q).path == 'sm90'
    q = torch.empty((2, 8, 4096, 40), dtype=F32)
    assert fa.plan(q, q, q).path == 'mma'


@pytest.mark.parametrize('sq,skv,d', [(4096, 4096, 512), (16384, 16384, 512),
                                      (1024, 1024, 160), (4096, 4096, 129)])
def test_the_dispatcher_keeps_wide_heads_off_flash(sq, skv, d):
    """JAX's rule: the dispatcher sends heads wider than 128 to the plain
    attention, so the VAE's 512-wide head never reaches the wide kernel;
    only direct calls do, as in JAX."""
    assert not attn._eligible(sq, skv, d)
    for name in ('auto', 'flash'):
        assert attn.route((1, 1, sq, d), (1, 1, skv, d), 'cuda',
                          name) == 'plain'


def test_k3_and_so_flash_attention_fn_refuse_wide_heads(monkeypatch):
    """JAX trains wide heads through XLA's chunked backward (not ported),
    so K3, which ``FlashAttentionFn`` runs forward, keeps D <= 128 and
    raises before any launch on card tensors (meta tensors stand in)."""
    monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda t: True))
    q = torch.empty((1, 1, 256, 512), dtype=BF16, device='meta')
    before = (fb.flash_attention_lse.launches, flash_attention.launches)
    with pytest.raises(ValueError, match='head dim 512'):
        fb.flash_attention_lse(q, q, q, 0.1)
    with pytest.raises(ValueError, match='head dim 512'):
        fb.FlashAttentionFn.apply(q, q, q, 0.1)
    # flash_attention's own check takes any width: the wide kernels do.
    fa.check(*(torch.empty((1, 1, 8, 513), dtype=BF16, device='meta'),) * 3,
             None)
    assert (fb.flash_attention_lse.launches,
            flash_attention.launches) == before


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.Generator('cuda').manual_seed(0)


# The VAE mid-block at 512² (a kv split) and 1024², batch 8, a 96² latent,
# d = 200 with Sq != Skv (a split of three kv tiles), d % 8 != 0 with ragged
# rows, fp16 at d = 384 and 136, fp32, and heads wider than 512.
CUDA_SHAPES = [((1, 1, 4096, 512), 4096, BF16), ((1, 1, 16384, 512), 16384,
                                                 BF16),
               ((8, 1, 4096, 512), 4096, BF16), ((1, 1, 9216, 512), 9216,
                                                 BF16),
               ((1, 2, 1000, 200), 77, BF16), ((2, 1, 333, 130), 517, F16),
               ((1, 3, 257, 384), 1000, F16), ((3, 1, 200, 136), 40, F16),
               ((1, 1, 1024, 512), 2048, F32), ((1, 1, 500, 640), 700, BF16),
               ((1, 2, 256, 1024), 300, F16), ((1, 1, 256, 2048), 128, F32)]


@pytest.mark.cuda
@pytest.mark.parametrize('forced', [None, 'wide'])
@pytest.mark.parametrize('shape,skv,dtype', CUDA_SHAPES)
def test_wide_kernel_matches_plain(shape, skv, dtype, forced, cuda_gen):
    """Kernel max|Δ| to the fp32 reference within twice the plain
    version's (in bf16 for fp32 inputs, which the kernel rounds to bf16),
    plus 1e-3·max|ref|: chip_smoke.py's rule; on the planned path and on
    the kept kernel forced."""
    b, h, sq, d = shape
    q = torch.randn(shape, generator=cuda_gen, device='cuda', dtype=dtype)
    k, v = (torch.randn((b, h, skv, d), generator=cuda_gen, device='cuda',
                        dtype=dtype) for _ in range(2))
    scale = d**-0.5
    path = fa.plan(q, k, v, path=forced).path
    assert path == ('wide_sm90' if dtype != F32 and d % 8 == 0 and d <= 512
                    and forced is None else 'wide')
    before = dict(flash_attention.path_launches)
    out = flash_attention(q, k, v, scale, path=forced)
    torch.cuda.synchronize()
    assert flash_attention.path_launches == dict(
        before, **{path: before[path] + 1})
    assert out.dtype == dtype and out.shape == shape
    ref = plain_attention(q.float(), k.float(), v.float(), scale)
    low = BF16 if dtype == F32 else dtype
    plain = plain_attention(q.to(low), k.to(low), v.to(low), scale)
    err = (out.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    assert torch.isfinite(out).all()
    assert err <= 2 * plain_err + 1e-3 * ref.abs().max().item()
