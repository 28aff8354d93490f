"""PyTorch port: the Hopper kernels (K1 forward flash attention, K3
forward with lse, K4 dq and K5 dk/dv, each on the Hopper path and on the
kept mma.sync kernel, fp32 on the kept one; K6 fused GroupNorm, the
attention variants T1–T6 on both paths, the [D, S] wgmma forms of
T4/T5 alone, and K1's transposed and channel-major entries on both paths)
against their plain twins, on the card.
Marked ``cuda``: each test skips without a CUDA device. Run on the card with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest``
(this file imports no JAX).
"""
import copy
import dataclasses

import pytest
import torch

from flexdiffuse_tpu_torch.models.unet import CrossAttention, GroupNorm32
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops import flash_variants as fv
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.ops.attention import attention
from flexdiffuse_tpu_torch.ops.attention import backend as attention_backend
from flexdiffuse_tpu_torch.ops.flash_attention import (flash_attention,
                                                       plain_attention)
from flexdiffuse_tpu_torch.tools import perf_experiment


@pytest.fixture
def cuda_gen():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (the kernel has no CPU mode)')
    return torch.Generator('cuda').manual_seed(0)


# Ragged sequences, Sq != Skv, every padded head width, both dtypes.
SHAPES = [((2, 8, 4096, 40), 4096, torch.bfloat16),
          ((2, 8, 1024, 80), 1024, torch.bfloat16),
          ((1, 3, 200, 33), 237, torch.bfloat16),
          ((1, 2, 77, 128), 1000, torch.float16),
          ((1, 2, 1, 16), 5, torch.float16),
          ((2, 1, 130, 100), 64, torch.bfloat16),
          ((1, 4, 513, 64), 513, torch.float16)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,skv,dtype', SHAPES)
def test_kernel_matches_plain(shape, skv, dtype, cuda_gen):
    """Kernel max|Δ| to the fp32 reference within twice the 16-bit plain
    version's, plus 1e-3·max|ref| (the rule chip_smoke.py applies)."""
    b, h, sq, d = shape
    q = torch.randn(shape, generator=cuda_gen, device='cuda', dtype=dtype)
    k, v = (torch.randn((b, h, skv, d), generator=cuda_gen, device='cuda',
                        dtype=dtype) for _ in range(2))
    scale = d**-0.5
    before = flash_attention.launches
    out = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = plain_attention(q.float(), k.float(), v.float(), scale)
    plain = plain_attention(q, k, v, scale)
    err = (out.float() - ref).abs().max().item()
    plain_err = (plain.float() - ref).abs().max().item()
    assert torch.isfinite(out).all()
    assert err <= 2 * plain_err + 1e-3 * ref.abs().max().item()


# The Hopper path at every SHAPES entry it takes (d % 8 == 0), K2's 32k
# regime, a 1536-token row (a ragged last kv tile of 128), and every other
# padded width the chooser can give it (DP 16 with d = 8, 32, 96, 112, and
# 128 with d = 120), with ragged Sq and Skv; d = 104 and 120 leave the last
# 16-column slab partly past d.
HOPPER_SHAPES = [(shape, skv) for shape, skv, _ in SHAPES
                 if shape[-1] % 8 == 0] + [((1, 2, 32768, 40), 32768),
                                           ((2, 8, 1536, 40), 1536),
                                           ((1, 2, 33, 8), 40),
                                           ((1, 2, 70, 24), 100),
                                           ((1, 2, 70, 32), 75),
                                           ((1, 2, 130, 96), 200),
                                           ((1, 2, 130, 104), 187),
                                           ((1, 2, 130, 112), 190),
                                           ((1, 2, 130, 120), 129)]


def _path_launches():
    return (dict(flash_attention.path_launches),
            dict(fb.flash_attention_lse.path_launches))


def _held_by_head(out, lse, q, k, v, scale):
    """K1's rule and K3's lse bound against the fp32 twin, head by head
    (the [S, S] fp32 logits of the 32k shape fit one head at a time)."""
    err = plain_err = top = lse_err = 0.0
    for hh in range(q.shape[1]):
        sl = (slice(None), slice(hh, hh + 1))
        ref, ref_lse = fb.plain_attention_lse(q[sl].float(), k[sl].float(),
                                              v[sl].float(), scale)
        plain = plain_attention(q[sl], k[sl], v[sl], scale)
        err = max(err, (out[sl].float() - ref).abs().max().item())
        plain_err = max(plain_err, (plain.float() - ref).abs().max().item())
        top = max(top, ref.abs().max().item())
        lse_err = max(lse_err, (lse[sl] - ref_lse).abs().max().item())
    assert torch.isfinite(out).all()
    assert err <= 2 * plain_err + 1e-3 * top, (err, plain_err)
    assert lse_err <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize('shape,skv', HOPPER_SHAPES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_hopper_path_matches_plain(shape, skv, dtype, cuda_gen):
    """K1 and K3 take the Hopper path (TMA, wgmma) here, hold K1's rule and
    the lse bound, and K3's o equals K1's bit for bit."""
    b, h, sq, d = shape
    q = torch.randn(shape, generator=cuda_gen, device='cuda', dtype=dtype)
    k, v = (torch.randn((b, h, skv, d), generator=cuda_gen, device='cuda',
                        dtype=dtype) for _ in range(2))
    scale = d**-0.5
    assert fa.plan(q, k, v).path == 'sm90'
    k1, k3 = _path_launches()
    out = flash_attention(q, k, v, scale)
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    k1['sm90'] += 1
    k3['sm90'] += 1
    assert _path_launches() == (k1, k3)
    assert torch.equal(o, out)
    _held_by_head(out, lse, q, k, v, scale)


def _misaligned(shape, gen, dtype=torch.bfloat16):
    """A contiguous tensor whose data starts 2 bytes past an aligned one."""
    n = 1
    for x in shape:
        n *= x
    base = torch.randn(n + 1, generator=gen, device='cuda', dtype=dtype)
    return base[1:].view(shape)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['d33', 'd100', 'q', 'k', 'v'])
def test_kept_path_takes_what_tma_cannot(case, cuda_gen):
    """d % 8 != 0 (rows not 16-byte strided) or a misaligned pointer: the
    chooser sends K1 and K3 to the kept mma.sync kernel before the launch,
    the counters say so, and both hold K1's rule and the lse bound."""
    d = {'d33': 33, 'd100': 100}.get(case, 40)
    shape = (1, 3, 200, d)
    kv_shape = (1, 3, 237, d)
    make = lambda s, name: (_misaligned(s, cuda_gen) if case == name else
                            torch.randn(s, generator=cuda_gen, device='cuda',
                                        dtype=torch.bfloat16))
    q, k, v = make(shape, 'q'), make(kv_shape, 'k'), make(kv_shape, 'v')
    assert fa.plan(q, k, v).path == 'mma'
    with pytest.raises(ValueError):
        flash_attention(q, k, v, 0.1, path='sm90')
    k1, k3 = _path_launches()
    scale = d**-0.5
    out = flash_attention(q, k, v, scale)
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    k1['mma'] += 1
    k3['mma'] += 1
    assert _path_launches() == (k1, k3)
    assert torch.equal(o, out)
    _held_by_head(out, lse, q, k, v, scale)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 8, 4096, 40), (2, 8, 1024, 80)])
def test_both_paths_agree_on_the_main_shapes(shape, cuda_gen):
    """The kept kernel, forced through its entry point on the aligned
    main-path inputs, and the Hopper path are both within K1's rule."""
    q, k, v = (torch.randn(shape, generator=cuda_gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    scale = shape[-1]**-0.5
    k1, _ = _path_launches()
    kept = flash_attention(q, k, v, scale, path='mma')
    new = flash_attention(q, k, v, scale)
    torch.cuda.synchronize()
    k1['mma'] += 1
    k1['sm90'] += 1
    assert _path_launches()[0] == k1
    ref = plain_attention(q.float(), k.float(), v.float(), scale)
    plain = plain_attention(q, k, v, scale)
    _rule(kept, ref, plain)
    _rule(new, ref, plain)


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_gen):
    q = torch.randn((1, 1, 128, 40), generator=cuda_gen, device='cuda')
    with pytest.raises(ValueError):           # fp64
        flash_attention(q.double(), q.double(), q.double(), 0.1)
    with pytest.raises(ValueError):           # mixed dtypes
        flash_attention(q, q.to(torch.bfloat16), q, 0.1)
    qh = q.to(torch.bfloat16)
    wide = torch.zeros((1, 1, 128, 160), device='cuda', dtype=torch.bfloat16)
    before = perf_experiment.kernel_counts()
    with pytest.raises(ValueError):           # 'sm90' forced above D 128
        flash_attention(wide, wide, wide, 0.1, path='sm90')
    with pytest.raises(ValueError):           # 'wide_sm90' forced on fp32
        flash_attention(wide.float(), wide.float(), wide.float(), 0.1,
                        path='wide_sm90')
    with pytest.raises(ValueError):           # not contiguous
        t = qh.transpose(2, 3)
        flash_attention(t, t, t, 0.1)
    assert perf_experiment.kernel_counts() == before


@pytest.mark.cuda
def test_dispatcher_routes_eligible_cuda_tensors_to_kernel(cuda_gen):
    q = torch.randn((2, 8, 1024, 80), generator=cuda_gen, device='cuda',
                    dtype=torch.bfloat16)
    ctx = torch.randn((2, 8, 77, 80), generator=cuda_gen, device='cuda',
                      dtype=torch.bfloat16)
    before = flash_attention.launches
    attention(q, q, q)
    assert flash_attention.launches == before + 1
    attention(q, ctx, ctx)                      # cross-attention: plain
    assert flash_attention.launches == before + 1


def _rule(got, ref, plain):
    """The kernel's max|Δ| to the fp32 reference is within twice the 16-bit
    plain twin's plus 1e-3·max|ref| (the rule chip_smoke.py applies)."""
    err = (got.float() - ref.float()).abs().max().item()
    plain_err = (plain.float() - ref.float()).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 2 * plain_err + 1e-3 * ref.abs().max().item(), \
        (err, plain_err)


def _inputs(shape, skv, dtype, gen):
    b, h, sq, d = shape
    q, dout = (torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
               for _ in range(2))
    k, v = (torch.randn((b, h, skv, d), generator=gen, device='cuda',
                        dtype=dtype) for _ in range(2))
    return q, k, v, dout


@pytest.mark.cuda
@pytest.mark.parametrize('shape,skv,dtype', SHAPES)
def test_lse_kernel_matches_plain(shape, skv, dtype, cuda_gen):
    """K3: o as K1 (the same rule) and bit-equal to K1's output; lse within
    1e-3 of the fp32 twin."""
    q, k, v, _ = _inputs(shape, skv, dtype, cuda_gen)
    scale = shape[-1]**-0.5
    before = fb.flash_attention_lse.launches
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    torch.cuda.synchronize()
    assert fb.flash_attention_lse.launches == before + 1
    ref_o, ref_lse = fb.plain_attention_lse(q.float(), k.float(), v.float(),
                                            scale)
    _rule(o, ref_o, fb.plain_attention_lse(q, k, v, scale)[0])
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(o, flash_attention(q, k, v, scale))


def _compute_dtype(t):
    """The 16-bit type the kernels' products take ``t`` in: its own, or
    bf16 for fp32 (the kept kernels round fp32 as they stage it)."""
    return t.dtype if t.dtype in fa.DTYPES16 else torch.bfloat16


def _plain16(q, k, v, scale):
    """K1's rule's plain version: q, k, v as the kernel's products take
    them, P rounded likewise, the output in q's dtype."""
    c = _compute_dtype(q)
    return plain_attention(q.to(c), k.to(c), v.to(c), scale).to(q.dtype)


def _hold_backward(q, k, v, dout, lse, dvec, scale, dq, dk, dv):
    """K4's dq and K5's dk, dv by the rule against the fp32 twins; the
    rule's plain version takes the inputs and rounds P and dS as the
    kernels' tensor cores take them (fp32 inputs: rounded to bf16 first;
    as K1's plain version rounds P), the way chip_smoke.py checks them."""
    dtype, c = q.dtype, _compute_dtype(q)
    f32 = [t.float() for t in (q, k, v, dout)]
    r16 = [t.to(c).float() for t in (q, k, v, dout)]
    rows = (lse, dvec, scale)
    p16, ds16 = (t.to(c).float()
                 for t in fb._probs_and_ds(*r16, *rows))
    _rule(dq, fb.plain_attention_dq(*f32, *rows),
          torch.matmul(ds16, r16[1]).to(dtype))
    plain = (torch.matmul(ds16.transpose(-1, -2), r16[0]).to(dtype),
             torch.matmul(p16.transpose(-1, -2), r16[3]).to(dtype))
    for got, ref, want in zip((dk, dv), fb.plain_attention_dkv(*f32, *rows),
                              plain):
        _rule(got, ref, want)


def _rows(q, k, v, dout):
    scale = q.shape[-1]**-0.5
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    return lse, fb.attention_delta(dout, o), scale


def _bwd_path_launches():
    return (dict(fb.flash_attention_dq.path_launches),
            dict(fb.flash_attention_dkv.path_launches))


@pytest.mark.cuda
@pytest.mark.parametrize('shape,skv,dtype', SHAPES)
def test_backward_kernels_match_plain(shape, skv, dtype, cuda_gen):
    """K4 (dq) and K5 (dk, dv) on the same 16-bit inputs as their twins, on
    the path the chooser picks (the kept kernels for d = 33 and 100)."""
    q, k, v, dout = _inputs(shape, skv, dtype, cuda_gen)
    lse, dvec, scale = _rows(q, k, v, dout)
    before = (fb.flash_attention_dq.launches, fb.flash_attention_dkv.launches)
    dq = fb.flash_attention_dq(q, k, v, dout, lse, dvec, scale)
    dk, dv = fb.flash_attention_dkv(q, k, v, dout, lse, dvec, scale)
    torch.cuda.synchronize()
    assert (fb.flash_attention_dq.launches,
            fb.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    _hold_backward(q, k, v, dout, lse, dvec, scale, dq, dk, dv)


def _both_kernels(q, k, v, dout, lse, dvec, scale, path=None):
    """dq, dk, dv, launched twice on ``path``; asserts the two runs are
    bit-equal (one owner per output element, no atomics)."""
    runs = [(fb.flash_attention_dq(q, k, v, dout, lse, dvec, scale, path),
             *fb.flash_attention_dkv(q, k, v, dout, lse, dvec, scale, path))
            for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    return runs[0]


# The backward's Hopper path at every SHAPES entry it takes (d % 8 == 0),
# Sq != Skv both ways, and every padded width DP 16–128 (d = 8 ... 128 with
# ragged Sq and Skv; d = 104 and 120 leave the last slab partly past d).
BWD_HOPPER_SHAPES = [(shape, skv) for shape, skv, _ in SHAPES
                     if shape[-1] % 8 == 0] + [
                         ((4, 8, 4096, 40), 4096), ((4, 8, 1024, 80), 1024),
                         ((1, 8, 1024, 40), 2048), ((2, 4, 1000, 64), 1000)
                     ] + [((1, 2, 130, d), 200 - d) for d in range(8, 129, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,skv', BWD_HOPPER_SHAPES)
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_backward_hopper_path_matches_plain(shape, skv, dtype, cuda_gen):
    """K4 and K5 take the Hopper path (TMA, wgmma) here, the counters say
    so, they hold the rule and two launches are bit-equal."""
    q, k, v, dout = _inputs(shape, skv, dtype, cuda_gen)
    lse, dvec, scale = _rows(q, k, v, dout)
    assert fb.plan_backward('dq', q, k, v, dout).path == 'sm90'
    assert fb.plan_backward('dkv', q, k, v, dout).path == 'sm90'
    k4, k5 = _bwd_path_launches()
    dq, dk, dv = _both_kernels(q, k, v, dout, lse, dvec, scale)
    k4['sm90'] += 2
    k5['sm90'] += 2
    assert _bwd_path_launches() == (k4, k5)
    _hold_backward(q, k, v, dout, lse, dvec, scale, dq, dk, dv)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['d33', 'd100', 'q', 'k', 'v', 'dout'])
def test_backward_kept_path_takes_what_tma_cannot(case, cuda_gen):
    """d % 8 != 0 or a misaligned q, k, v or dO: the chooser sends K4 and K5
    to the kept mma.sync kernels before the launch, 'sm90' cannot be
    forced, the counters say so, and both hold the rule, bit-equal over two
    launches."""
    d = {'d33': 33, 'd100': 100}.get(case, 40)
    shape, kv_shape = (1, 3, 200, d), (1, 3, 237, d)
    make = lambda sh, name: (_misaligned(sh, cuda_gen) if case == name else
                             torch.randn(sh, generator=cuda_gen,
                                         device='cuda', dtype=torch.bfloat16))
    q, k, v = make(shape, 'q'), make(kv_shape, 'k'), make(kv_shape, 'v')
    dout = make(shape, 'dout')
    lse, dvec, scale = _rows(q.contiguous(), k, v, dout)
    for kind in ('dq', 'dkv'):
        assert fb.plan_backward(kind, q, k, v, dout).path == 'mma'
    with pytest.raises(ValueError):
        fb.flash_attention_dq(q, k, v, dout, lse, dvec, scale, path='sm90')
    with pytest.raises(ValueError):
        fb.flash_attention_dkv(q, k, v, dout, lse, dvec, scale, path='sm90')
    k4, k5 = _bwd_path_launches()
    dq, dk, dv = _both_kernels(q, k, v, dout, lse, dvec, scale)
    k4['mma'] += 2
    k5['mma'] += 2
    assert _bwd_path_launches() == (k4, k5)
    _hold_backward(q, k, v, dout, lse, dvec, scale, dq, dk, dv)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(4, 8, 4096, 40), (4, 8, 1024, 80)])
def test_backward_both_paths_agree_on_the_main_shapes(shape, cuda_gen):
    """The kept kernels, forced through their entry points on the aligned
    training shapes, and the Hopper path both hold the rule and are
    bit-deterministic."""
    q, k, v, dout = _inputs(shape, shape[2], torch.bfloat16, cuda_gen)
    lse, dvec, scale = _rows(q, k, v, dout)
    k4, k5 = _bwd_path_launches()
    kept = _both_kernels(q, k, v, dout, lse, dvec, scale, 'mma')
    new = _both_kernels(q, k, v, dout, lse, dvec, scale)
    for path in ('mma', 'sm90'):
        k4[path] += 2
        k5[path] += 2
    assert _bwd_path_launches() == (k4, k5)
    _hold_backward(q, k, v, dout, lse, dvec, scale, *kept)
    _hold_backward(q, k, v, dout, lse, dvec, scale, *new)


def _moved(before):
    return {n: c - before[n] for n, c in perf_experiment.kernel_counts()
            .items() if c != before[n]}


# fp32 on the kept kernels: the main shapes, ragged Sq != Skv, d % 8 != 0.
FP32_SHAPES = [((1, 8, 4096, 40), 4096), ((2, 8, 1024, 80), 1024),
               ((1, 3, 200, 33), 237), ((2, 1, 130, 128), 64)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape,skv', FP32_SHAPES)
def test_fp32_kernels_match_plain(shape, skv, cuda_gen):
    """K1, K3, K4 and K5 on fp32 tensors take the kept path (the counters
    say so), hold the rule against the fp32 twins with fp32 outputs (the
    plain version: the inputs rounded to bf16, as the kernels take them),
    K3's o equals K1's, and two launches of K4/K5 are bit-equal."""
    q, k, v, dout = _inputs(shape, skv, torch.float32, cuda_gen)
    scale = shape[-1]**-0.5
    k1, k3 = _path_launches()
    k4, k5 = _bwd_path_launches()
    out = flash_attention(q, k, v, scale)
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    dvec = fb.attention_delta(dout, o)
    dq, dk, dv = _both_kernels(q, k, v, dout, lse, dvec, scale)
    k1['mma'] += 1
    k3['mma'] += 1
    k4['mma'] += 2
    k5['mma'] += 2
    assert (_path_launches(), _bwd_path_launches()) == ((k1, k3), (k4, k5))
    assert all(t.dtype == torch.float32 for t in (out, o, dq, dk, dv))
    _rule(out, fb.plain_attention_lse(q, k, v, scale)[0],
          _plain16(q, k, v, scale))
    assert torch.equal(o, out)
    # lse within 1e-3 of the twin's on the inputs as the kernel takes them.
    rounded = (t.to(torch.bfloat16).float() for t in (q, k, v))
    ref_lse = fb.plain_attention_lse(*rounded, scale)[1]
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    _hold_backward(q, k, v, dout, lse, dvec, scale, dq, dk, dv)


@pytest.mark.cuda
def test_fp32_attention_runs_the_kept_kernels_on_the_card(cuda_gen):
    """fp32 CUDA q/k/v at (1,8,4096,40), a flash-eligible shape: the
    dispatcher runs K1 without a gradient and K3, K4, K5 with one, each on
    its kept path, and both hold the rule against fp32 plain attention and
    its autograd (the plain version: the same on bf16 copies)."""
    shape = (1, 8, 4096, 40)
    q, k, v, w = (torch.randn(shape, generator=cuda_gen, device='cuda')
                  for _ in range(4))
    before = perf_experiment.kernel_counts()
    with torch.no_grad():
        out = attention(q, k, v)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    grads = torch.autograd.grad((attention(*leaves) * w).sum(), leaves)
    torch.cuda.synchronize()
    assert _moved(before) == dict(k1=1, k1_mma=1, k3=1, k3_mma=1, k4=1,
                                  k4_mma=1, k5=1, k5_mma=1)

    def plain(dtype):
        ts = [t.to(dtype).requires_grad_() for t in (q, k, v)]
        o = attention(*ts, backend='plain')
        return o.detach(), torch.autograd.grad(
            (o.float() * w).sum(), ts)

    (ref, ref_grads), (p16, p16_grads) = plain(torch.float32), \
        plain(torch.bfloat16)
    assert out.dtype == torch.float32
    _rule(out, ref, p16)
    for got, want, rounded in zip(grads, ref_grads, p16_grads):
        assert got.dtype == torch.float32
        _rule(got, want, rounded)


@pytest.mark.cuda
def test_fp32_unet_self_attention_runs_the_kept_kernel(cuda_gen):
    """An fp32 SD-1.x self-attention (CrossAttention, 320 channels, 8 heads
    of 40) at 4096 tokens, which raised before fp32 had a kernel: one K1
    launch on the kept path, and the rule against the layer with plain
    attention (the plain version: the layer in bf16)."""
    torch.manual_seed(0)
    layer = CrossAttention(320, 8).cuda().requires_grad_(False)
    x = torch.randn((1, 4096, 320), generator=cuda_gen, device='cuda')
    before = perf_experiment.kernel_counts()
    y = layer(x)
    torch.cuda.synchronize()
    assert _moved(before) == dict(k1=1, k1_mma=1)
    with attention_backend('plain'):
        ref = layer(x)
        p16 = layer.to(torch.bfloat16)(x.to(torch.bfloat16))
    _rule(y, ref, p16)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 8, 1024, 80), (1, 2, 4096, 40)])
def test_dispatcher_gradients_reach_the_kernels(shape, cuda_gen):
    """A gradient through the dispatcher on CUDA tensors that require grad
    runs K3 forward and K4/K5 backward (no K1: its output has no gradient)
    and equals plain autograd's within the kernel rule."""
    q, k, v, w = _inputs(shape, shape[2], torch.bfloat16, cuda_gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    launches = (flash_attention.launches, fb.flash_attention_lse.launches,
                fb.flash_attention_dq.launches,
                fb.flash_attention_dkv.launches)
    out = attention(*leaves)
    grads = torch.autograd.grad((out.float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert (flash_attention.launches, fb.flash_attention_lse.launches,
            fb.flash_attention_dq.launches,
            fb.flash_attention_dkv.launches) == (
                launches[0], launches[1] + 1, launches[2] + 1,
                launches[3] + 1)
    assert all(g is not None for g in grads)

    def plain_grads(dtype):
        ts = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        o = attention(*ts, backend='plain')
        return torch.autograd.grad((o.float() * w.float()).sum(), ts)

    for got, ref, plain in zip(grads, plain_grads(torch.float32),
                               plain_grads(torch.bfloat16)):
        _rule(got, ref, plain)
    with torch.no_grad():                       # inference: K1 only
        attention(q, k, v)
    assert flash_attention.launches == launches[0] + 1


# chip_smoke.py's K6 shapes: (NCHW shape, silu, eps, in dtype, out dtype),
# channels-last in memory. The UNet's levels at 512² (CFG batch 2, compose
# batch 4; its largest group (2,960,64,64) and the 8² calls), the VAE's
# mid-block and its largest decoder activations (the stream path), fp32 in
# and out, and a ragged one (C/G = 3, HW = 391).
GN_SHAPES = [((2, 320, 64, 64), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((2, 320, 64, 64), False, 1e-6, torch.bfloat16, torch.bfloat16),
             ((2, 2560, 8, 8), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((2, 1280, 8, 8), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((2, 960, 64, 64), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((4, 640, 64, 64), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((1, 512, 64, 64), False, 1e-6, torch.bfloat16, torch.bfloat16),
             ((1, 256, 512, 512), True, 1e-6, torch.bfloat16,
              torch.bfloat16),
             ((1, 128, 512, 512), True, 1e-6, torch.bfloat16,
              torch.bfloat16),
             ((4, 320, 64, 64), True, 1e-5, torch.float32, torch.float32),
             ((3, 96, 17, 23), True, 1e-5, torch.float32, torch.bfloat16)]
# The last resident slab and the first that no cluster holds (bf16, 16
# channels of 32 bytes per group: 16 blocks of 96 KB hold 49,152 pixels).
GN_BOUNDARY = [((1, 512, 192, 256), 'resident'),
               ((1, 512, 193, 256), 'stream')]


def _gn_inputs(shape, dtype, gen, offset=0):
    """x not centred (so the statistics matter) and channels-last, as the
    models' activations are on the card (``offset`` elements into its
    storage: a misaligned view); the affine in x's dtype as the models hold
    it."""
    x = (1.5 * torch.randn(shape, generator=gen, device='cuda') +
         0.7).to(dtype).contiguous(memory_format=torch.channels_last)
    if offset:
        base = torch.empty(x.numel() + offset, dtype=dtype, device='cuda')
        x = base[offset:].as_strided(x.shape, x.stride()).copy_(x)
    w = (1.0 + 0.5 * torch.randn(shape[1], generator=gen,
                                 device='cuda')).to(dtype)
    b = (0.3 * torch.randn(shape[1], generator=gen, device='cuda')).to(dtype)
    return x, w, b


def gn_rule(got, ref, plain, out_dtype):
    """K6's max|Δ| to the fp32 plain version within twice the plain
    version's in the output dtype plus 1e-3·max|ref| (K1's rule), and
    within 1e-4·max|ref| for fp32 outputs (the kernel's merge order)."""
    err = (got.float() - ref).abs().max().item()
    top = ref.abs().max().item()
    assert torch.isfinite(got).all()
    if out_dtype == torch.float32:
        assert err <= 1e-4 * top, (err, top)
    else:
        plain_err = (plain.float() - ref).abs().max().item()
        assert err <= 2 * plain_err + 1e-3 * top, (err, plain_err)


def _gn_check(x, groups, w, b, eps, silu, dout, path=None):
    """One K6 call (on ``path``, or the planned one) held to the rule, with
    exactly one launch counted, on that path; y channels-last, as x."""
    want = path or gn.plan_group_norm(tuple(x.shape), groups, x.dtype, dout,
                                      x.data_ptr() % 16 == 0).path
    before = dict(gn.fused_group_norm.path_launches)
    y = gn.fused_group_norm(x, groups, w, b, eps, silu, dout, path=path)
    torch.cuda.synchronize()
    before[want] += 1
    assert gn.fused_group_norm.path_launches == before
    assert y.dtype == dout and y.shape == x.shape
    assert y.stride() == x.stride()
    ref = gn.plain_group_norm(x, groups, w, b, eps, silu, torch.float32)
    gn_rule(y, ref, gn.plain_group_norm(x, groups, w, b, eps, silu, dout),
            dout)
    return y


@pytest.mark.cuda
@pytest.mark.parametrize('shape,silu,eps,din,dout', GN_SHAPES)
def test_group_norm_kernel_matches_plain(shape, silu, eps, din, dout,
                                         cuda_gen):
    """K6 on its planned path within K1's rule of the fp32 plain version;
    one launch, counted on that path; y channels-last, as x."""
    x, w, b = _gn_inputs(shape, din, cuda_gen)
    before = gn.fused_group_norm.launches
    _gn_check(x, 32, w, b, eps, silu, dout)
    assert gn.fused_group_norm.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 320, 64, 64), (2, 960, 64, 64),
                                   (2, 1280, 8, 8), (2, 2560, 8, 8),
                                   (1, 512, 64, 64), (3, 96, 17, 23)])
@pytest.mark.parametrize('path', gn.PATHS)
def test_group_norm_both_paths_match_plain(shape, path, cuda_gen):
    """The resident and the stream path, forced, at shapes both take."""
    x, w, b = _gn_inputs(shape, torch.bfloat16, cuda_gen)
    _gn_check(x, 32, w, b, 1e-5, True, torch.bfloat16, path)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,path', GN_BOUNDARY)
def test_group_norm_plan_boundary_matches_plain(shape, path, cuda_gen):
    """Each side of the resident/stream boundary, on its planned path."""
    x, w, b = _gn_inputs(shape, torch.bfloat16, cuda_gen)
    assert gn.plan_group_norm(shape, 32, x.dtype, x.dtype, True).path == path
    _gn_check(x, 32, w, b, 1e-6, True, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('groups', [1, 12, 60])
def test_group_norm_kernel_odd_channels(groups, cuda_gen):
    """C = 60 (C % 8 != 0: the stream path with scalar loads), HW = 99, 1
    to 60 channels per group; and a misaligned x (2 bytes into its
    storage) at C = 64, scalar loads too."""
    x, w, b = _gn_inputs((2, 60, 9, 11), torch.bfloat16, cuda_gen)
    _gn_check(x, groups, w, b, 1e-5, True, torch.bfloat16)
    x, w, b = _gn_inputs((2, 64, 9, 11), torch.bfloat16, cuda_gen, offset=1)
    assert gn.plan_group_norm(tuple(x.shape), 4, x.dtype, x.dtype,
                              False).vec == 0
    _gn_check(x, 4, w, b, 1e-5, True, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('shape,path', [
    ((2, 320, 64, 64), None), ((2, 320, 64, 64), 'stream'),
    ((1, 256, 512, 512), None), ((3, 96, 17, 23), None),
    ((3, 96, 17, 23), 'stream')])
def test_group_norm_kernel_is_deterministic(shape, path, cuda_gen):
    """No atomics, a fixed merge order: two runs are bit-identical, on
    both paths."""
    x, w, b = _gn_inputs(shape, torch.bfloat16, cuda_gen)
    first = gn.fused_group_norm(x, 32, w, b, 1e-6, True, path=path)
    assert torch.equal(first, gn.fused_group_norm(x, 32, w, b, 1e-6, True,
                                                  path=path))


@pytest.mark.cuda
def test_group_norm_refused_launch_raises_without_fallback(cuda_gen):
    """A plan the CUDA runtime refuses (a cluster of 32 blocks; a 1 MB tile
    in one block) raises, counts no launch and writes nothing: no other
    path runs."""
    shape = (1, 512, 128, 128)
    x, w, b = _gn_inputs(shape, torch.bfloat16, cuda_gen)
    how = gn.plan_group_norm(shape, 32, x.dtype, x.dtype, True)
    assert how.path == 'resident'
    sc, hw = how.slab * 16, 128 * 128
    too_wide = dataclasses.replace(
        how, cluster=32, pixels=hw // 32,
        smem=gn.resident_smem(hw // 32, sc, 2, how.slab, 32),
        grid=(32 * 32 // how.slab, 1))
    too_deep = dataclasses.replace(
        how, cluster=1, pixels=hw,
        smem=gn.resident_smem(hw, sc, 2, how.slab, 1),
        grid=(32 // how.slab, 1))
    before = dict(gn.fused_group_norm.path_launches)
    for bad in (too_wide, too_deep):
        y = torch.zeros_like(x)
        with pytest.raises(RuntimeError):
            gn.launch(x, 32, w, b, y, 1e-5, True, bad)
        torch.cuda.synchronize()
        assert not y.any()
    assert gn.fused_group_norm.path_launches == before
    _gn_check(x, 32, w, b, 1e-5, True, torch.bfloat16)   # still launches


@pytest.mark.cuda
def test_group_norm_kernel_rejects_what_it_does_not_take(cuda_gen):
    x, w, b = _gn_inputs((2, 64, 8, 8), torch.bfloat16, cuda_gen)
    with pytest.raises(ValueError):           # contiguous NCHW
        gn.fused_group_norm(x.contiguous(), 32, w, b, 1e-5)
    with pytest.raises(ValueError):           # neither layout
        gn.fused_group_norm(x.transpose(2, 3), 32, w, b, 1e-5)
    with pytest.raises(ValueError):           # not 4-d
        gn.fused_group_norm(x.flatten(2), 32, w, b, 1e-5)
    with pytest.raises(ValueError):           # C % G != 0
        gn.fused_group_norm(x, 24, w, b, 1e-5)
    with pytest.raises(ValueError):           # fp64
        gn.fused_group_norm(x.double(), 32, w, b, 1e-5)
    with pytest.raises(ValueError):           # affine of the wrong width
        gn.fused_group_norm(x, 32, w[:32], b[:32], 1e-5)


@pytest.mark.cuda
def test_group_norm32_launches_k6_only_without_gradient(cuda_gen):
    """GroupNorm32 on the card: K6 with grad off, and with grad on while
    nothing requires grad; the plain version (with autograd) once x or the
    affine requires grad."""
    norm = GroupNorm32(32, 320, eps=1e-5, silu=True).cuda().to(
        torch.bfloat16).requires_grad_(False)
    x, _, _ = _gn_inputs((2, 320, 16, 16), torch.bfloat16, cuda_gen)
    before = gn.fused_group_norm.launches
    with torch.no_grad():
        y = norm(x, torch.bfloat16)
    y2 = norm(x, torch.bfloat16)
    assert gn.fused_group_norm.launches == before + 2
    assert y.dtype == torch.bfloat16 and torch.equal(y, y2)
    out = norm(x.clone().requires_grad_(), torch.bfloat16)
    norm.weight.requires_grad_(True)
    out_w = norm(x, torch.bfloat16)
    assert gn.fused_group_norm.launches == before + 2
    assert out.grad_fn is not None and out_w.grad_fn is not None
    ref = gn.plain_group_norm(x, 32, norm.weight.detach(), norm.bias, 1e-5,
                              True, torch.float32)
    gn_rule(y, ref, out.detach(), torch.bfloat16)


# T1–T6 at the 1024-token level's head and a 4096-token row of heads of 40.
T_SHAPES = [(2, 8, 1024, 80), (1, 4, 4096, 40)]


@pytest.mark.cuda
@pytest.mark.parametrize('shape', T_SHAPES)
@pytest.mark.parametrize('label', list(fv.CONFIGS))
def test_variant_kernel_matches_twin(label, shape, cuda_gen):
    """Each T configuration against the fp32 reference, within twice its
    16-bit twin's max|Δ| plus 1e-3·max|ref| (K1's rule); T4/T5 take and
    return [B, H, D, S]."""
    kernel, _, bhds = fv.CONFIGS[label]
    q, k, v = (torch.randn(shape, generator=cuda_gen, device='cuda',
                           dtype=torch.bfloat16) for _ in range(3))
    scale = shape[-1]**-0.5
    t = (lambda x: x.transpose(-1, -2).contiguous()) if bhds else \
        (lambda x: x)
    before = sum(fv.launch_counts().values())
    out = kernel(t(q), t(k), t(v), scale)
    torch.cuda.synchronize()
    assert sum(fv.launch_counts().values()) == before + 1
    assert out.shape == t(q).shape and out.is_contiguous()
    ref = plain_attention(q.float(), k.float(), v.float(), scale)
    _rule(t(out), ref, t(fv.planned_twin(label, t(q), t(k), t(v), scale)))


@pytest.mark.cuda
def test_variant_kernels_reject_what_they_do_not_take(cuda_gen):
    q = torch.randn((1, 2, 128, 40), generator=cuda_gen, device='cuda',
                    dtype=torch.bfloat16)
    cases = [
        lambda: fv.attn_opt('v0', q.float(), q.float(), q.float(), 0.1),
        lambda: fv.attn_h(q[:, :, :100], q[:, :, :100], q[:, :, :100], 0.1),
        lambda: fv.attn_opt('vG', q, q, q, 0.1, g=4),      # Sq % 256
        lambda: fv.attn_opt('vG', q, q, q, 0.1, g=3),
        lambda: fv.pipelined_attention(q[..., :36], q[..., :36], q[..., :36],
                                       0.1),               # d % 8
        lambda: fv.attn_variants(0, q.transpose(2, 3), q.transpose(2, 3),
                                 q.transpose(2, 3), 0.1),  # not contiguous
        lambda: fv.flash_tt2(q, q, q, 0.1),                # D = 128, S = 40
        lambda: fv.flash_ttv3(*(torch.zeros((1, 1, 128, 64), device='cuda',
                                            dtype=torch.bfloat16),) * 3,
                              0.1),                        # fold, d = 128
        lambda: fv.flash_ttv3(q, q, q, 0.1, bf16_p=True, sum_fold=False),
        lambda: fv.attn_variants(3, q, q, q, 0.1),
    ]
    before = sum(fv.launch_counts().values())
    for case in cases:
        with pytest.raises(ValueError):
            case()
    assert sum(fv.launch_counts().values()) == before


# The Hopper path of T1 (v0, vU, vG2, vG4), T2, T3, T4, T5 (ttv3, ttv4,
# no-fold) and T6 (v1, v2): the main shapes and every head width of each
# domain (the fold's d <= 120), in both dtypes (Sq a multiple of vG4's 256
# q rows). Each label's (call, plan, counting wrapper, entry-point
# options); T4/T5 take [B, H, D, S] (:func:`_operands`).
T_SM90_SHAPES = T_SHAPES[:1] + [(2, 8, 4096, 40)] + [
    (1, 2, 1024, d) for d in range(8, fv.MAX_HEAD_DIM + 1, 8)]
T_PATHS = fv.PATH_CONFIGS
FOLDS = ('T5 ttv3', 'T5 ttv4')


def _in_domain(label, shape):
    return label not in FOLDS or shape[3] <= fv.MAX_FOLD_HEAD_DIM


def _operands(label, shape, dtype, gen):
    """Seeded q, k, v ``[B, H, S, D]`` and the configuration's own
    operands of them (transposed, contiguous, for T4/T5)."""
    q, k, v = (torch.randn(shape, generator=gen, device='cuda', dtype=dtype)
               for _ in range(3))
    if fv.CONFIGS[label][2]:
        return (q, k, v), tuple(x.transpose(-1, -2).contiguous()
                                for x in (q, k, v))
    return (q, k, v), (q, k, v)


def _back(label, x):
    """A configuration's output as ``[B, H, S, D]``."""
    return x.transpose(-1, -2) if fv.CONFIGS[label][2] else x


def _one_launch(fn, path, call):
    before = dict(fn.path_launches)
    out = call()
    torch.cuda.synchronize()
    assert fn.path_launches == dict(before, **{path: before[path] + 1})
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
@pytest.mark.parametrize('label,shape', [
    (label, shape) for label in T_PATHS for shape in T_SM90_SHAPES
    if _in_domain(label, shape)])
def test_variant_sm90_path_matches_twin(label, shape, dtype, cuda_gen):
    """A configuration with two paths on the one its plan picks ('sm90'
    everywhere in the domain), one launch on it, by K1's rule against the
    twin of that path (the kv split's, ``plain_split_exp``, where T1's,
    T2's or T4's plan splits)."""
    call, plan, fn, _ = T_PATHS[label]
    (q, k, v), args = _operands(label, shape, dtype, cuda_gen)
    scale = shape[-1]**-0.5
    how = plan(*args[:2])
    assert how.path == fv.SM90
    out = _one_launch(fn, fv.SM90, lambda: call(*args, scale))
    twin = fv.planned_twin(label, *args, scale)
    _rule(_back(label, out),
          plain_attention(q.float(), k.float(), v.float(), scale),
          _back(label, twin))


@pytest.mark.cuda
@pytest.mark.parametrize('shape', T_SHAPES)
@pytest.mark.parametrize('label', list(T_PATHS))
def test_variant_kept_path_still_right(label, shape, cuda_gen):
    """The first port's kernel, forced with ``path='mma'``: one launch on
    'mma', by K1's rule."""
    call, _, fn, _ = T_PATHS[label]
    (q, k, v), args = _operands(label, shape, torch.bfloat16, cuda_gen)
    scale = shape[-1]**-0.5
    out = _one_launch(fn, fv.MMA, lambda: call(*args, scale, path=fv.MMA))
    _rule(_back(label, out),
          plain_attention(q.float(), k.float(), v.float(), scale),
          _back(label, fv.CONFIGS[label][1](*args, scale)))


@pytest.mark.cuda
@pytest.mark.parametrize('label', list(T_PATHS))
def test_variant_paths_refuse_out_of_domain_inputs(label, cuda_gen):
    """Inputs outside the domain raise on either path before any launch."""
    fn = T_PATHS[label][0]
    bhds = fv.CONFIGS[label][2]
    q = torch.randn((1, 2, 40, 128) if bhds else (1, 2, 128, 40),
                    generator=cuda_gen, device='cuda', dtype=torch.bfloat16)
    odd = torch.empty(q.numel() + 8, device='cuda', dtype=torch.bfloat16)[
        4:q.numel() + 4].view(q.shape)   # 8 bytes off 16-byte alignment
    short = q[..., :100] if bhds else q[:, :, :100]   # S % 64
    narrow = q[:, :, :36] if bhds else q[..., :36]    # d % 8
    cases = [(q.float(),) * 3, (short,) * 3, (narrow,) * 3,
             (q.transpose(2, 3),) * 3, (odd, q, q), (q, q.cpu(), q)]
    before = fv.path_counts()
    for path in (None, fv.SM90, fv.MMA):
        for args in cases:
            with pytest.raises(ValueError):
                fn(*args, 0.1, path=path)
    with pytest.raises(ValueError):
        fn(q, q, q, 0.1, path='wide')
    assert fv.path_counts() == before


@pytest.mark.cuda
def test_variant_refused_launch_raises_without_fallback(cuda_gen):
    """A launch the kernel refuses (T2's kv split in 3 parts; either
    kernel on a sequence that is not a multiple of 64, past the wrapper's
    check) raises, counts no launch and writes nothing: no other path
    runs."""
    q = torch.randn((1, 2, 1024, 80), generator=cuda_gen, device='cuda',
                    dtype=torch.bfloat16)
    bad = torch.randn((1, 2, 100, 80), generator=cuda_gen, device='cuda',
                      dtype=torch.bfloat16)
    how = fv.plan_attn_h(q, q)
    assert how.parts > 1
    cases = [(fv.attn_h, q, dataclasses.replace(how, parts=3)),
             (fv.attn_h, bad, fv.plan_attn_h(bad, bad)),
             (fv.pipelined_attention, bad, fv.plan_pipelined(bad, bad))]
    before = fv.path_counts()
    for fn, x, plan in cases:
        out = torch.zeros_like(x)
        with pytest.raises(RuntimeError):
            fv.launch(fn, x, x, x, out, 0.1, plan)
        torch.cuda.synchronize()
        assert not out.any()
    assert fv.path_counts() == before
    _one_launch(fv.attn_h, fv.SM90, lambda: fv.attn_h(q, q, q, 0.1))


@pytest.mark.cuda
@pytest.mark.parametrize('path', fv.PATHS)
@pytest.mark.parametrize('label', list(T_PATHS))
def test_variant_refused_launch_raises_on_either_path(label, path, cuda_gen):
    """Each configuration's kernel, on either path, refuses Sq = 100 past
    the wrapper's check (and on 'sm90' T1's, T4's and T6's a kv split in 3
    parts, T4's and T5's 3 q chains a block): the launch raises, counts
    no launch and writes nothing."""
    call, plan, fn, options = T_PATHS[label]
    bhds = fv.CONFIGS[label][2]
    bad = torch.randn((1, 2, 40, 100) if bhds else (1, 2, 100, 40),
                      generator=cuda_gen, device='cuda',
                      dtype=torch.bfloat16)
    q = torch.randn((1, 2, 40, 768) if bhds else (1, 2, 768, 40),
                    generator=cuda_gen, device='cuda', dtype=torch.bfloat16)
    cases = [(bad, plan(bad, bad, path=path))]
    if path == fv.SM90 and fn in (fv.attn_opt, fv.attn_variants,
                                  fv.flash_tt2):
        cases.append((q, dataclasses.replace(plan(q, q), parts=3)))
    if path == fv.SM90 and bhds:
        cases.append((q, dataclasses.replace(plan(q, q), block_q=192)))
    before = fv.path_counts()
    for x, how in cases:
        out = torch.zeros_like(x)
        with pytest.raises(RuntimeError):
            fv.launch(fn, x, x, x, out, 0.1, how, *options)
        torch.cuda.synchronize()
        assert not out.any()
    assert fv.path_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float16])
def test_ds_wgmma_forms_match_matmul(dtype, cuda_gen):
    """T4/T5's two products alone (``fv.ds_products``) at every head width:
    S = qᵀ·k by the SS wgmma with both operands MN-major, and O =
    round16(S)·vᵀ by the RS wgmma with V K-major, against ``torch.matmul``
    in fp32 on the same 16-bit inputs (and the kernel's own S rounded):
    exact products, so within 1e-5 of max|ref| (the fp32 sums' order);
    O's padded columns past d are 0."""
    for d in range(8, fv.MAX_HEAD_DIM + 1, 8):
        q, k, v = (torch.randn((d, 64), generator=cuda_gen, device='cuda',
                               dtype=dtype) for _ in range(3))
        s, o = fv.ds_products(q, k, v)
        torch.cuda.synchronize()
        s_ref = torch.matmul(q.float().T, k.float())
        o_ref = torch.matmul(s.to(dtype).float(), v.float().T)
        assert (s - s_ref).abs().max() <= 1e-5 * s_ref.abs().max(), d
        assert (o[:, :d] - o_ref).abs().max() <= 1e-5 * o_ref.abs().max(), d
        assert not o[:, d:].any(), d


# K1's transposed and channel-major entries: (layout, [B, H, S, D] shape,
# dtype, path forced or None). The main shapes and SDXL's 64-wide heads on
# both paths, fp16, fp32 and d = 33 on the kept one (as planned), the widest
# head.
DS_CASES = [(layout, shape, dtype, path)
            for layout in ('tt', 'cm')
            for shape, dtype, path in (
                ((2, 8, 4096, 40), torch.bfloat16, None),
                ((2, 8, 1024, 80), torch.bfloat16, None),
                ((2, 10, 4096, 64), torch.bfloat16, None),
                ((2, 8, 1024, 80), torch.bfloat16, 'mma'),
                ((2, 4, 1024, 40), torch.float16, None),
                ((1, 8, 1024, 40), torch.float32, None),
                ((2, 2, 1024, 33), torch.bfloat16, None),
                ((3, 2, 1280, 128), torch.bfloat16, None))]
TO_DS = {'tt': lambda x: x.transpose(-1, -2).contiguous(),
         'cm': lambda x: x.permute(1, 3, 0, 2).contiguous()}
FROM_DS = {'tt': lambda x: x.transpose(-1, -2),
           'cm': lambda x: x.permute(2, 0, 3, 1)}


def _ds_fn(layout):
    return fa.flash_attention_tt if layout == 'tt' else fa.flash_attention_cm


@pytest.mark.cuda
@pytest.mark.parametrize('layout,shape,dtype,path', DS_CASES)
def test_ds_entries_match_plain(layout, shape, dtype, path, cuda_gen):
    """``flash_attention_tt`` / ``flash_attention_cm`` against fp32 plain
    attention on the same inputs by the kernel rule (the plain version on
    16-bit inputs; fp32 ones rounded to bf16, as the kept kernel stages
    them), with exactly one launch on the path ``fa.plan_ds`` picks:
    'sm90' for 16-bit tensors with d % 8 == 0, 'mma' otherwise."""
    q, k, v = (torch.randn(shape, generator=cuda_gen, device='cuda',
                           dtype=dtype) for _ in range(3))
    fn, scale = _ds_fn(layout), shape[3]**-0.5
    args = [TO_DS[layout](x) for x in (q, k, v)]
    how = fa.plan_ds(*args, layout=layout, path=path)
    want = path or ('sm90' if dtype != torch.float32 and shape[3] % 8 == 0
                    else 'mma')
    assert how.path == want
    before = perf_experiment.kernel_counts()
    out = fn(*args, scale, path=path)
    torch.cuda.synchronize()
    assert _moved(before) == {layout: 1, f'{layout}_{want}': 1}
    ref = plain_attention(q.float(), k.float(), v.float(), scale)
    p16 = q.dtype if q.dtype != torch.float32 else torch.bfloat16
    plain = plain_attention(q.to(p16), k.to(p16), v.to(p16), scale)
    assert out.shape == args[0].shape and out.dtype == dtype
    _rule(FROM_DS[layout](out), ref, plain)


@pytest.mark.cuda
@pytest.mark.parametrize('path', ['sm90', 'mma'])
def test_cm_batches_do_not_mix(path, cuda_gen):
    """Each q tile of a channel-major call reads its own batch's K/V:
    zeroing batch 1's V leaves batch 0's output bit-equal and batch 1's
    zero, on both paths; two launches are bit-equal."""
    q, k, v = (torch.randn((2, 40, 2, 1024), generator=cuda_gen,
                           device='cuda', dtype=torch.bfloat16)
               for _ in range(3))
    out = fa.flash_attention_cm(q, k, v, 0.3, path=path)
    assert torch.equal(out, fa.flash_attention_cm(q, k, v, 0.3, path=path))
    v2 = v.clone()
    v2[:, :, 1] = 0
    out2 = fa.flash_attention_cm(q, k, v2, 0.3, path=path)
    assert torch.equal(out[:, :, 0], out2[:, :, 0])
    assert not out2[:, :, 1].any()


@pytest.mark.cuda
@pytest.mark.parametrize('layout', ['tt', 'cm'])
def test_ds_entries_refuse_what_they_do_not_take(layout, cuda_gen):
    """A layout or a forced path the kernels do not take raises ValueError
    before any launch: no quiet fall to the twin."""
    fn = _ds_fn(layout)
    x = torch.randn((2, 2, 40, 1024) if layout == 'tt' else (2, 40, 2, 1024),
                    generator=cuda_gen, device='cuda', dtype=torch.bfloat16)
    bad = [(x.float(), 'sm90'),                  # fp32 forced onto 'sm90'
           (x[..., :1000].contiguous(), None),   # S % 128 != 0
           (x.transpose(0, 1), None),            # not contiguous
           (x.double(), None)]                   # fp64
    wide = torch.zeros((1, 1, 136, 128) if layout == 'tt' else
                       (1, 136, 1, 128), device='cuda',
                       dtype=torch.bfloat16)
    bad.append((wide, None))                     # D > 128
    before = perf_experiment.kernel_counts()
    for t, path in bad:
        with pytest.raises(ValueError):
            fn(t, t, t, 0.1, path=path)
    assert perf_experiment.kernel_counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 8, 1024, 80), (1, 2, 4096, 40)])
def test_attention_cm_runs_the_kernels(shape, cuda_gen):
    """``attention_cm`` on channel-major CUDA tensors: without a gradient
    one 'cm' launch; with one ``FlashAttentionCmFn`` (K3 forward, K4/K5
    backward, no 'cm') and plain autograd's gradients by the kernel rule;
    cross-attention over 77 tokens runs plain."""
    from flexdiffuse_tpu_torch.ops.attention import attention_cm
    q, k, v, w = (TO_DS['cm'](x) for x in _inputs(shape, shape[2],
                                                  torch.bfloat16, cuda_gen))
    before = perf_experiment.kernel_counts()
    with torch.no_grad():
        attention_cm(q, k, v)
        attention_cm(q, k[..., :77].contiguous(), v[..., :77].contiguous())
    assert _moved(before) == dict(cm=1, cm_sm90=1)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = perf_experiment.kernel_counts()
    grads = torch.autograd.grad(
        (attention_cm(*leaves).float() * w.float()).sum(), leaves)
    torch.cuda.synchronize()
    assert _moved(before) == dict(k3=1, k3_sm90=1, k4=1, k4_sm90=1, k5=1,
                                  k5_sm90=1)

    def plain_grads(dtype):
        ts = [t.detach().to(dtype).requires_grad_() for t in (q, k, v)]
        o = attention_cm(*ts, backend='plain')
        return torch.autograd.grad((o.float() * w.float()).sum(), ts)

    for got, ref, plain in zip(grads, plain_grads(torch.float32),
                               plain_grads(torch.bfloat16)):
        _rule(got, ref, plain)


@pytest.mark.cuda
def test_channel_major_self_attention_layer(cuda_gen):
    """An SD-1.x self-attention (320 channels, 8 heads of 40) at 4096
    tokens in the channel-major orientation: one 'cm' launch, no K1, and
    the layer's standard forward with plain attention by the kernel rule
    (the plain version: the layer in bf16 with plain attention)."""
    torch.manual_seed(0)
    layer = CrossAttention(320, 8).cuda().to(torch.bfloat16)
    layer.requires_grad_(False)
    x = torch.randn((2, 4096, 320), generator=cuda_gen, device='cuda',
                    dtype=torch.bfloat16)
    before = perf_experiment.kernel_counts()
    y = layer.forward_cm(x.permute(2, 0, 1).reshape(320, -1), None, 2)
    torch.cuda.synchronize()
    assert _moved(before) == dict(cm=1, cm_sm90=1)
    with attention_backend('plain'):
        plain = layer(x)
        ref = copy.deepcopy(layer).float()(x.float())
    _rule(y.reshape(320, 2, 4096).permute(1, 2, 0), ref, plain)
