"""PyTorch port: the plain twins of the flash-attention training kernels
(K3 forward with lse, K4 dq, K5 dk/dv) and ``FlashAttentionFn``, held
against the JAX package's Pallas kernels on the CPU.

The JAX kernels run in Pallas interpret mode here, as
``tests/test_flash_backward.py`` runs them; they take ``[B, H, D, S]``, the
port ``[B, H, S, D]``. All fp32; the tolerance is 1e-5·max(|ref|, 1).
Observed: o, dq, dk, dv and the gradients within 7.8e-7 of JAX (max|g|
0.26-0.51), lse within 1.9e-6, and 2.3e-7 of torch autograd.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu.ops import flash_backward as jfb
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops.attention import attention
from flexdiffuse_tpu_torch.ops.flash_attention import plain_attention
from tests.test_torch_attention import one_torch_thread  # noqa: F401

# (b, h, sq, skv, d): d=40 as SD's 4096-token level, several 512-blocks at
# d=64, and a q sequence shorter than K/V.
SHAPES = [(1, 2, 512, 512, 40), (2, 1, 1024, 1024, 64),
          (1, 2, 512, 1024, 40)]


def _inputs(shape, seed):
    b, h, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    q, g = (rng.standard_normal((b, h, sq, d)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.standard_normal((b, h, skv, d)).astype(np.float32)
            for _ in range(2))
    return q, k, v, g


def _close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    err = np.abs(got - ref).max()
    assert err <= 1e-5 * max(np.abs(ref).max(), 1.0), (name, err)


def _tt(x):
    return jnp.asarray(x).transpose(0, 1, 3, 2)


@pytest.mark.parametrize('shape', SHAPES)
def test_plain_twins_match_jax_kernels(shape):
    """plain_attention_lse against ``_tt_forward_lse``; plain_attention_dq
    and plain_attention_dkv against ``_tt_backward``."""
    q, k, v, g = _inputs(shape, seed=shape[-1])
    scale = shape[-1]**-0.5
    jo, jlse = jfb._tt_forward_lse(_tt(q), _tt(k), _tt(v), scale,
                                   interpret=True)
    jdq, jdk, jdv = jfb._tt_backward(_tt(q), _tt(k), _tt(v), jo, jlse, _tt(g),
                                     scale, interpret=True)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = fb.plain_attention_lse(tq, tk, tv, scale)
    _close(o.numpy(), np.asarray(jo).transpose(0, 1, 3, 2), 'o')
    _close(lse.numpy(), jlse, 'lse')
    dvec = fb.attention_delta(tg, o)
    dq = fb.plain_attention_dq(tq, tk, tv, tg, lse, dvec, scale)
    dk, dv = fb.plain_attention_dkv(tq, tk, tv, tg, lse, dvec, scale)
    for got, ref, name in ((dq, jdq, 'dq'), (dk, jdk, 'dk'), (dv, jdv, 'dv')):
        _close(got.numpy(), np.asarray(ref).transpose(0, 1, 3, 2), name)


@pytest.mark.parametrize('shape', SHAPES)
def test_flash_attention_fn_grads_match_jax_and_autograd(shape):
    """FlashAttentionFn's gradients on CPU tensors (the plain twins) against
    ``jax.grad`` of ``flash_attention_diff`` (interpret) and against torch
    autograd through plain_attention."""
    q, k, v, w = _inputs(shape, seed=shape[-1] + 1)
    scale = shape[-1]**-0.5

    def jloss(q, k, v):
        return jnp.sum(jfb.flash_attention_diff(q, k, v, scale) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                                for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    tw = torch.from_numpy(w)
    out = fb.FlashAttentionFn.apply(*leaves, scale)
    got = torch.autograd.grad((out * tw).sum(), leaves)
    plain = torch.autograd.grad(
        (plain_attention(*leaves, scale) * tw).sum(), leaves)
    for g, j, p, name in zip(got, want, plain, 'qkv'):
        _close(g.numpy(), j, f'd{name} vs jax')
        _close(g.numpy(), p.numpy(), f'd{name} vs autograd')


def test_dispatcher_takes_the_differentiable_path_under_grad():
    """backend='flash' at an eligible shape: with a gradient needed the
    dispatcher goes through FlashAttentionFn (K3/K4/K5's plain twins here),
    and its gradients equal plain autograd's; without one it returns the
    same values with no gradient."""
    q, k, v, w = _inputs((1, 2, 1024, 1024, 40), seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = attention(*leaves, backend='flash')
    assert out.grad_fn is not None and \
        type(out.grad_fn).__name__ == 'FlashAttentionFnBackward'
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    plain = torch.autograd.grad(
        (attention(*leaves, backend='plain') * torch.from_numpy(w)).sum(),
        leaves)
    for g, p, name in zip(got, plain, 'qkv'):
        _close(g.numpy(), p.numpy(), name)
    with torch.no_grad():
        inf = attention(*leaves, backend='flash')
    assert inf.grad_fn is None
    _close(inf.numpy(), out.detach().numpy(), 'o')


def test_cpu_wrappers_take_plain_twins_and_do_not_count():
    q, k, v, g = (torch.from_numpy(a)
                  for a in _inputs((1, 1, 128, 128, 16), seed=5))
    counts = (fb.flash_attention_lse.launches, fb.flash_attention_dq.launches,
              fb.flash_attention_dkv.launches)
    o, lse = fb.flash_attention_lse(q, k, v, 0.25)
    ref_o, ref_lse = fb.plain_attention_lse(q, k, v, 0.25)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    dvec = fb.attention_delta(g, o)
    assert torch.equal(fb.flash_attention_dq(q, k, v, g, lse, dvec, 0.25),
                       fb.plain_attention_dq(q, k, v, g, lse, dvec, 0.25))
    for a, b in zip(fb.flash_attention_dkv(q, k, v, g, lse, dvec, 0.25),
                    fb.plain_attention_dkv(q, k, v, g, lse, dvec, 0.25)):
        assert torch.equal(a, b)
    assert counts == (fb.flash_attention_lse.launches,
                      fb.flash_attention_dq.launches,
                      fb.flash_attention_dkv.launches)
