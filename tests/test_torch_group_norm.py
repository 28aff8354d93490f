"""PyTorch port: the GroupNorm dispatcher and the plain twin of the Hopper
kernel K6, held against the JAX package on the CPU.

The JAX side is ``flexdiffuse_tpu/ops/group_norm.py``: its Pallas kernel in
interpret mode (as the JAX package's own tests run it) and its XLA
reference, on NHWC inputs; the port takes NCHW, so the inputs and outputs
are transposed. The Hopper kernel itself needs the card; its tests are in
``tests/test_torch_kernels_cuda.py``.
"""
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
