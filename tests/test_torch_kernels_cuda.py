"""PyTorch port: the Hopper kernels (K1 forward flash attention, K3
forward with lse, K4 dq, K5 dk/dv, K6 fused GroupNorm) against their plain
twins, on the card.
Marked ``cuda``: each test skips without a CUDA device. Run on the card with
``python -m pytest tests/test_torch_kernels_cuda.py -m cuda -q --noconftest``
(this file imports no JAX).
"""
import pytest
import torch

from flexdiffuse_tpu_torch.models.unet import GroupNorm32
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.ops.attention import attention
from flexdiffuse_tpu_torch.ops.flash_attention import (flash_attention,
                                                       plain_attention)


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


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_gen):
    q = torch.randn((1, 1, 128, 40), generator=cuda_gen, device='cuda')
    with pytest.raises(ValueError):           # fp32
        flash_attention(q, q, q, 0.1)
    qh = q.to(torch.bfloat16)
    with pytest.raises(ValueError):           # head wider than 128
        wide = torch.zeros((1, 1, 128, 160), device='cuda',
                           dtype=torch.bfloat16)
        flash_attention(wide, wide, wide, 0.1)
    with pytest.raises(ValueError):           # not contiguous
        t = qh.transpose(2, 3)
        flash_attention(t, t, t, 0.1)


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


@pytest.mark.cuda
@pytest.mark.parametrize('shape,skv,dtype', SHAPES)
def test_backward_kernels_match_plain(shape, skv, dtype, cuda_gen):
    """K4 (dq) and K5 (dk, dv) on the same 16-bit inputs as their twins."""
    q, k, v, dout = _inputs(shape, skv, dtype, cuda_gen)
    scale = shape[-1]**-0.5
    o, lse = fb.flash_attention_lse(q, k, v, scale)
    dvec = fb.attention_delta(dout, o)
    before = (fb.flash_attention_dq.launches, fb.flash_attention_dkv.launches)
    dq = fb.flash_attention_dq(q, k, v, dout, lse, dvec, scale)
    dk, dv = fb.flash_attention_dkv(q, k, v, dout, lse, dvec, scale)
    torch.cuda.synchronize()
    assert (fb.flash_attention_dq.launches,
            fb.flash_attention_dkv.launches) == (before[0] + 1, before[1] + 1)
    args32 = [t.float() for t in (q, k, v, dout)] + [lse, dvec, scale]
    args16 = [q, k, v, dout, lse, dvec, scale]
    _rule(dq, fb.plain_attention_dq(*args32), fb.plain_attention_dq(*args16))
    for got, ref, plain in zip((dk, dv), fb.plain_attention_dkv(*args32),
                               fb.plain_attention_dkv(*args16)):
        _rule(got, ref, plain)


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
# batch 4), the VAE's mid-block and its largest decoder activation, fp32 in
# and out, and a ragged one (C/G = 3, HW = 391).
GN_SHAPES = [((2, 320, 64, 64), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((2, 320, 64, 64), False, 1e-6, torch.bfloat16, torch.bfloat16),
             ((2, 2560, 8, 8), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((4, 640, 64, 64), True, 1e-5, torch.bfloat16, torch.bfloat16),
             ((1, 512, 64, 64), False, 1e-6, torch.bfloat16, torch.bfloat16),
             ((1, 256, 512, 512), True, 1e-6, torch.bfloat16,
              torch.bfloat16),
             ((4, 320, 64, 64), True, 1e-5, torch.float32, torch.float32),
             ((3, 96, 17, 23), True, 1e-5, torch.float32, torch.bfloat16)]


def _gn_inputs(shape, dtype, gen):
    """x not centred (so the statistics matter) and channels-last, as the
    models' activations are on the card; the affine in x's dtype as the
    models hold it."""
    x = (1.5 * torch.randn(shape, generator=gen, device='cuda') +
         0.7).to(dtype).contiguous(memory_format=torch.channels_last)
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


@pytest.mark.cuda
@pytest.mark.parametrize('shape,silu,eps,din,dout', GN_SHAPES)
def test_group_norm_kernel_matches_plain(shape, silu, eps, din, dout,
                                         cuda_gen):
    """K6 within K1's rule of the fp32 plain version; y channels-last, as
    x."""
    x, w, b = _gn_inputs(shape, din, cuda_gen)
    before = gn.fused_group_norm.launches
    y = gn.fused_group_norm(x, 32, w, b, eps, silu, dout)
    torch.cuda.synchronize()
    assert gn.fused_group_norm.launches == before + 1
    assert y.dtype == dout and y.shape == x.shape
    assert y.stride() == x.stride()
    ref = gn.plain_group_norm(x, 32, w, b, eps, silu, torch.float32)
    gn_rule(y, ref, gn.plain_group_norm(x, 32, w, b, eps, silu, dout), dout)


@pytest.mark.cuda
@pytest.mark.parametrize('groups', [1, 12, 60])
def test_group_norm_kernel_odd_channels(groups, cuda_gen):
    """C = 60 (C % 8 != 0: the scalar stats pass, scalar loads everywhere),
    HW = 99, 1 to 60 channels per group."""
    x, w, b = _gn_inputs((2, 60, 9, 11), torch.bfloat16, cuda_gen)
    y = gn.fused_group_norm(x, groups, w, b, 1e-5, True)
    assert y.stride() == x.stride()
    ref = gn.plain_group_norm(x, groups, w, b, 1e-5, True, torch.float32)
    gn_rule(y, ref, gn.plain_group_norm(x, groups, w, b, 1e-5, True),
            torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(2, 320, 64, 64), (1, 256, 512, 512),
                                   (3, 96, 17, 23)])
def test_group_norm_kernel_is_deterministic(shape, cuda_gen):
    """No atomics, a fixed merge order: two runs are bit-identical."""
    x, w, b = _gn_inputs(shape, torch.bfloat16, cuda_gen)
    first = gn.fused_group_norm(x, 32, w, b, 1e-6, True)
    assert torch.equal(first, gn.fused_group_norm(x, 32, w, b, 1e-6, True))


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
