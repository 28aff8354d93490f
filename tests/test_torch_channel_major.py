"""PyTorch port: the channel-major UNet interior and its attention entries,
held against the JAX package on the CPU in fp32.

* ``fa.flash_attention_tt`` / ``fa.flash_attention_cm`` on CPU tensors (their
  plain twins) against JAX's ``flash_attention_tt`` / ``flash_attention_cm``
  in interpret mode (H 2, D 40, B 2, S 256, 128-blocks): max|Δ| ≤ 1e-5;
  the batches of a channel-major call do not mix.
* ``FlashAttentionCmFn``'s gradients (the plain K3–K5 twins on the CPU)
  against autograd through ``plain_attention_cm``: max|Δ| ≤ 1e-5.
* ``layer_norm_cm`` (both branches) against JAX's ``LayerNormCM`` and
  flax's axis-0 LayerNorm at (320, 512): 2e-5, the JAX test's tolerance.
* The GEGLU feed-forward with ``approx_gelu`` in both orientations against
  JAX's ``FeedForwardGEGLU``: 1e-5.
* ToMe's ``merge_cm`` / ``unmerge_cm`` / ``metric_from_cm`` against the
  row layout's (bit-equal) and JAX's (1e-6).
* The tiny UNet of ``tests/test_channel_major.py`` (``CFG``) at 32² latents,
  so that level 0 has 1024 tokens and the interior engages: the port's
  channel-major UNet against its standard one (1e-4, JAX's
  ``test_outputs_match_standard``) and against JAX's channel-major UNet on
  bridged weights (1e-4, ``test_torch_models.py``'s ATOL); one state dict
  for both orientations; bit-equal below the threshold; PAG, an
  IP-Adapter and a ControlNet in channel-major against the standard
  orientation (1e-4); the resolution rules; the SP pipeline's standard
  orientation.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu.models import UNet2DCondition as JUNet
from flexdiffuse_tpu.models.configs import UNetConfig as JConfig
from flexdiffuse_tpu_torch.models import unet as unet_mod
from flexdiffuse_tpu_torch.models.configs import UNetConfig
from flexdiffuse_tpu_torch.models.controlnet import ControlNetModel
from flexdiffuse_tpu_torch.models.unet import UNet2DCondition
from flexdiffuse_tpu_torch.ops import attention as attn
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import tome
from flexdiffuse_tpu_torch.ops.flash_backward import FlashAttentionCmFn
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401

FIELDS = dict(block_channels=(8, 16), layers_per_block=1,
              attention_levels=(True, True), num_heads=2,
              cross_attention_dim=16, norm_groups=4)
CFG = UNetConfig(**FIELDS)
ATOL = 1e-4


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


# --- the attention entries ----------------------------------------------

@pytest.mark.parametrize('layout', ['tt', 'cm'])
def test_entries_match_jax_interpret(layout):
    from flexdiffuse_tpu.ops import flash_attention as jfa
    rng = np.random.default_rng(3)
    # tt: [B, H, D, S]; cm: [H, D, B, S].
    shape = (2, 2, 40, 256) if layout == 'tt' else (2, 40, 2, 256)
    q, k, v = (_rand(rng, *shape) for _ in range(3))
    jfn = jfa.flash_attention_tt if layout == 'tt' else \
        jfa.flash_attention_cm
    ref = np.asarray(jfn(*(jnp.asarray(t) for t in (q, k, v)), scale=0.2,
                         block_q=128, block_k=128, interpret=True))
    fn = fa.flash_attention_tt if layout == 'tt' else fa.flash_attention_cm
    twin = fa.plain_attention_tt if layout == 'tt' else fa.plain_attention_cm
    args = [torch.from_numpy(t) for t in (q, k, v)]
    for got in (fn(*args, 0.2), twin(*args, 0.2)):
        assert got.shape == shape
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_flash_cm_batches_do_not_mix():
    """Zeroing batch 1's V leaves batch 0's output as it was (each q tile
    reads its batch's K/V), in the port and in JAX alike."""
    from flexdiffuse_tpu.ops import flash_attention as jfa
    rng = np.random.default_rng(5)
    q, k, v = (_rand(rng, 1, 8, 2, 512) for _ in range(3))
    v2 = v.copy()
    v2[:, :, 1] = 0.0
    t = lambda x: torch.from_numpy(x)
    out, out2 = (fa.flash_attention_cm(t(q), t(k), t(vv), 1.0).numpy()
                 for vv in (v, v2))
    np.testing.assert_array_equal(out[:, :, 0], out2[:, :, 0])
    assert np.abs(out2[:, :, 1]).max() < 1e-6
    ref = np.asarray(jfa.flash_attention_cm(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v2), scale=1.0,
        block_q=128, block_k=128, interpret=True))
    np.testing.assert_allclose(out2, ref, rtol=0, atol=1e-5)


def test_cm_autograd_fn_matches_plain_autograd():
    rng = np.random.default_rng(7)
    q, k, v, w = (torch.from_numpy(_rand(rng, 2, 16, 2, 128))
                  for _ in range(4))

    def grads(f):
        ts = [x.clone().requires_grad_() for x in (q, k, v)]
        out = f(*ts)
        return (out,) + torch.autograd.grad((out * w).sum(), ts)

    got = grads(lambda *ts: FlashAttentionCmFn.apply(*ts, 0.25))
    ref = grads(lambda *ts: fa.plain_attention_cm(*ts, 0.25))
    for a, b in zip(got, ref):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize('backend', ['auto', 'flash', 'plain'])
def test_attention_cm_matches_jax_and_standard(backend, monkeypatch):
    """Self-attention at 1024 tokens (eligible) and cross-attention over 7
    tokens (never eligible), under each backend: the port's
    ``attention_cm`` against JAX's and against the port's standard
    ``attention`` on the permuted operands; with a gradient, the eligible
    call under 'flash' runs ``FlashAttentionCmFn``."""
    from flexdiffuse_tpu.ops.attention import attention_cm as jattention_cm

    class Spy:
        calls = 0

        @staticmethod
        def apply(*a):
            Spy.calls += 1
            return FlashAttentionCmFn.apply(*a)

    monkeypatch.setattr(attn, 'FlashAttentionCmFn', Spy)
    rng = np.random.default_rng(9)
    std = lambda x: x.permute(2, 0, 3, 1)
    for skv in (1024, 7):
        q = _rand(rng, 2, 8, 2, 1024)
        k, v = (_rand(rng, 2, 8, 2, skv) for _ in range(2))
        args = [torch.from_numpy(x) for x in (q, k, v)]
        got = attn.attention_cm(*args, backend=backend)
        ref = np.asarray(jattention_cm(*(jnp.asarray(x) for x in (q, k, v))))
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
        torch.testing.assert_close(
            std(got), attn.attention(*(std(x) for x in args)), rtol=0,
            atol=1e-5)
        leaves = [x.clone().requires_grad_() for x in args]
        attn.attention_cm(*leaves, backend=backend)
        assert Spy.calls == (backend == 'flash')


# (layout, [B, H, S, D] shape, dtype, forced path) → (path, q rows a block,
# kv parts): the chains tiling of T4's plan (four chains where Sq % 256 ==
# 0 and DP <= 96, the kv split where the blocks fill at most the card's
# SMs), the kept kernel for fp32 and d % 8 != 0, or forced.
PLANS = [(('cm', (2, 8, 4096, 40), torch.bfloat16, None), ('sm90', 256, 1)),
         (('cm', (2, 8, 1024, 80), torch.bfloat16, None), ('sm90', 256, 2)),
         (('tt', (2, 10, 4096, 64), torch.float16, None), ('sm90', 256, 1)),
         (('tt', (2, 2, 1152, 128), torch.bfloat16, None), ('sm90', 128, 2)),
         (('cm', (2, 8, 1024, 80), torch.bfloat16, 'mma'), ('mma', 64, 1)),
         (('cm', (1, 8, 4096, 40), torch.float32, None), ('mma', 64, 1)),
         (('tt', (2, 2, 1024, 33), torch.bfloat16, None), ('mma', 64, 1))]


@pytest.mark.parametrize('case,want', PLANS)
def test_plan_ds_picks_the_path_and_tiles(case, want):
    layout, (b, h, s, d), dtype, path = case
    shape = (b, h, d, s) if layout == 'tt' else (h, d, b, s)
    q = torch.empty(shape, dtype=dtype, device='meta')
    how = fa.plan_ds(q, q, q, layout=layout, path=path)
    assert (how.path, how.block_q, how.parts) == want and how.bhds
    assert how.grid == (b * s // how.block_q if layout == 'cm'
                        else s // how.block_q, h if layout == 'cm' else b * h)


def test_plan_ds_refuses_sm90_where_it_cannot_go():
    q = torch.empty((2, 40, 2, 1024), dtype=torch.float32, device='meta')
    with pytest.raises(ValueError):
        fa.plan_ds(q, q, q, layout='cm', path='sm90')
    with pytest.raises(ValueError):
        fa.plan_ds(q, q, q, layout='cm', path='tma')


# --- the interior's layers ---------------------------------------------

@pytest.mark.parametrize('lncm', ['mxu', 'xla'])
def test_layer_norm_cm_matches_jax(lncm, monkeypatch):
    from flax import linen as nn

    from flexdiffuse_tpu.models.unet import LayerNormCM
    rng = np.random.default_rng(2)
    x = _rand(rng, 320, 512) * 1.7 - 0.3
    w, b = _rand(rng, 320), _rand(rng, 320)
    params = {'params': {'scale': jnp.asarray(w), 'bias': jnp.asarray(b)}}
    if lncm == 'xla':
        monkeypatch.setenv('LNCM', 'xla')
        ref = nn.LayerNorm(epsilon=1e-5, reduction_axes=0, feature_axes=0)
    else:
        monkeypatch.delenv('LNCM', raising=False)
        ref = LayerNormCM(epsilon=1e-5)
    want = np.asarray(ref.apply(params, jnp.asarray(x)))
    got = unet_mod.layer_norm_cm(torch.from_numpy(x), torch.from_numpy(w),
                                 torch.from_numpy(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize('cm', [False, True])
@pytest.mark.parametrize('approx', [False, True])
def test_geglu_matches_jax(cm, approx):
    from flexdiffuse_tpu.models.unet import FeedForwardGEGLU as JFF
    rng = np.random.default_rng(4)
    dim, n = 16, 96
    w_in, b_in = _rand(rng, dim, 8 * dim, scale=0.3), _rand(rng, 8 * dim)
    w_out, b_out = _rand(rng, 4 * dim, dim, scale=0.3), _rand(rng, dim)
    x = _rand(rng, n, dim)
    params = {'params': {'proj_in': {'kernel': w_in, 'bias': b_in},
                         'proj_out': {'kernel': w_out, 'bias': b_out}}}
    jx = x.T if cm else x
    want = np.asarray(JFF(dim, channel_major=cm, approx_gelu=approx).apply(
        params, jnp.asarray(jx)))
    ff = unet_mod.FeedForwardGEGLU(dim)
    with torch.no_grad():
        ff.net[0].proj.weight.copy_(torch.from_numpy(w_in.T))
        ff.net[0].proj.bias.copy_(torch.from_numpy(b_in))
        ff.net[2].weight.copy_(torch.from_numpy(w_out.T))
        ff.net[2].bias.copy_(torch.from_numpy(b_out))
        tx = torch.from_numpy(np.ascontiguousarray(jx))
        got = ff.forward_cm(tx, approx) if cm else ff(tx, approx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_tome_cm_matches_rows_and_jax():
    from flexdiffuse_tpu.ops import tome as jtome
    rng = np.random.default_rng(6)
    b, c, hh, ww = 2, 6, 16, 16
    x = _rand(rng, b, hh * ww, c)
    r = tome.resolve_r(hh, ww, 0.5)
    jplan = jtome.merge_plan(jnp.asarray(x), (hh, ww), r)
    plan = tome.TomePlan(*(torch.from_numpy(np.array(f)).long()
                           for f in jplan[:5]), (hh, ww))
    xc = np.ascontiguousarray(x.transpose(2, 0, 1).reshape(c, b * hh * ww))
    tx = torch.from_numpy(xc)
    np.testing.assert_array_equal(tome.metric_from_cm(tx, b).numpy(), x)
    m = tome.merge_cm(tx, plan, b)
    assert torch.equal(m.reshape(c, b, -1).permute(1, 2, 0),
                       tome.merge(torch.from_numpy(x), plan))
    np.testing.assert_allclose(
        m.numpy(), np.asarray(jtome.merge_cm(jnp.asarray(xc), jplan, b)),
        rtol=0, atol=1e-6)
    y = _rand(rng, c, b * plan.merged_len)
    u = tome.unmerge_cm(torch.from_numpy(y), plan, b)
    rows = torch.from_numpy(y).reshape(c, b, -1).permute(1, 2, 0)
    assert torch.equal(u.reshape(c, b, -1).permute(1, 2, 0),
                       tome.unmerge(rows.contiguous(), plan))
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jtome.unmerge_cm(jnp.asarray(y), jplan, b)))


# --- the UNet ---------------------------------------------------------------

@pytest.fixture(scope='module')
def nets():
    """JAX's CFG UNet initialised, the port's standard and channel-major
    UNets with its weights (bridged), and one input set at 32² latents."""
    jcfg = JConfig(**FIELDS)
    rng = np.random.default_rng(8)
    lat = _rand(rng, 2, 32, 32, 4)
    ctx = _rand(rng, 2, 7, 16)
    t = np.array([3.0, 500.0], np.float32)
    junet = JUNet(jcfg, channel_major=False)
    # The parameters do not depend on the latent size: initialise at 8².
    params = jax.jit(lambda key: junet.init(
        key, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 7, 16))))(jax.random.PRNGKey(0))
    sd = params_to_state_dict(jax.tree.map(np.asarray, params), jcfg)
    std = UNet2DCondition(CFG).eval()
    std.load_state_dict(sd, strict=True)
    cm = UNet2DCondition(CFG, channel_major=True).eval()
    cm.load_state_dict(sd, strict=True)
    return dict(jcfg=jcfg, params=params, std=std, cm=cm, sd=sd,
                args=[torch.from_numpy(a) for a in (lat, t, ctx)],
                np_args=(lat, t, ctx))


def _eps(unet, args, **kw):
    with torch.no_grad():
        return unet(*args, **kw)


def test_cm_unet_matches_standard(nets):
    got, want = _eps(nets['cm'], nets['args']), _eps(nets['std'],
                                                       nets['args'])
    assert got.shape == (2, 32, 32, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_cm_unet_matches_jax(nets):
    """JAX's channel-major UNet (XLA attention off a TPU) on the same
    weights and inputs, within test_torch_models.py's ATOL."""
    jcm = JUNet(nets['jcfg'], channel_major=True)
    want = np.asarray(jax.jit(jcm.apply)(
        nets['params'], *(jnp.asarray(a) for a in nets['np_args'])))
    got = _eps(nets['cm'], nets['args']).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_state_dict_is_the_standard_one(nets):
    a, b = nets['std'].state_dict(), nets['cm'].state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    assert list(UNet2DCondition(CFG, channel_major=True).state_dict()) == \
        list(UNet2DCondition(CFG).state_dict())


def test_below_the_threshold_is_bit_equal(nets):
    """16² latents: 256 tokens at level 0, below cm_min_seq (1024), so the
    channel-major flag changes nothing, as JAX's
    ``test_small_levels_stay_standard``; a threshold of 64 through the
    ``CM_MIN_SEQ`` override engages the interior there."""
    lat = nets['args'][0][:, :16, :16].contiguous()
    args = [lat] + nets['args'][1:]
    assert torch.equal(_eps(nets['cm'], args), _eps(nets['std'], args))
    calls = []
    real = unet_mod.attention_cm
    unet_mod.attention_cm = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv('CM_MIN_SEQ', '64')
            got = _eps(nets['cm'], args)
    finally:
        unet_mod.attention_cm = real
    assert calls
    torch.testing.assert_close(got, _eps(nets['std'], args), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize('case', ['pag', 'tome', 'ip_adapter',
                                  'controlnet'])
def test_cm_features_match_standard(nets, case):
    """PAG on every transformer (row 1 perturbed), ToMe at ratio 0.5 from
    1024 tokens, an IP-Adapter UNet (4 image tokens at scale 0.7) and a
    ControlNet, each in channel-major against the standard orientation."""
    torch.manual_seed(1)
    args, kw = nets['args'], {}
    std, cm = nets['std'], nets['cm']
    if case == 'pag':
        std, cm = (u.with_settings(pag_layers=('down', 'mid', 'up'))
                   for u in (std, cm))
        kw['pag_mask'] = torch.tensor([0.0, 1.0])
    elif case == 'tome':
        std, cm = (u.with_settings(tome=(0.5, 1024)) for u in (std, cm))
    elif case == 'ip_adapter':
        cfg = UNetConfig(**FIELDS, ip_adapter=True)
        std = UNet2DCondition(cfg).eval()
        for p in std.parameters():
            p.data.normal_(0.0, 0.2)
        cm = std.with_settings(channel_major=True)
        kw = dict(ip_ctx=torch.randn(2, 4, 16), ip_scale=0.7)
    else:
        net = ControlNetModel(CFG, cond_channels=(4, 8)).eval()
        for p in net.parameters():
            p.data.normal_(0.0, 0.2)
        net_cm = copy.copy(net)
        net_cm.channel_major = True
        cond = torch.rand(2, 64, 64, 3)
        with torch.no_grad():
            down, mid = net(*args, cond)
            down_cm, mid_cm = net_cm(*args, cond)
        for a, b in zip(down + (mid,), down_cm + (mid_cm,)):
            torch.testing.assert_close(b, a, rtol=0, atol=ATOL)
        kw['control'] = (down, mid)
    got, want = _eps(cm, args, **kw), _eps(std, args, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


def test_resolution_rules():
    """None resolves to the standard orientation and the exact gelu off a
    TPU (always, on this port); an explicit flag is taken as given."""
    assert unet_mod.resolve_channel_major(None) is False
    assert unet_mod.resolve_channel_major(True) is True
    assert unet_mod.resolve_approx_gelu(None, torch.bfloat16) is False
    assert unet_mod.resolve_approx_gelu(True, torch.float32) is True
    assert unet_mod.resolve_approx_gelu(False, torch.bfloat16) is False
    assert UNet2DCondition(CFG).settings()['channel_major'] is None
    assert ControlNetModel(CFG, cond_channels=(4, 8)).channel_major is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('CM_MIN_SEQ', '256')
        assert unet_mod._cm_threshold(CFG.cm_min_seq) == 256
    assert unet_mod._cm_threshold(4096) == 4096


def test_sp_pipeline_runs_standard(nets):
    """A sequence-parallel pipeline turns both models standard (copies that
    share the weights), as JAX's ``test_sp_pipeline_forces_standard``;
    the models given stay as they were."""
    from flexdiffuse_tpu_torch.models import TINY_VAE, AutoencoderKL
    from flexdiffuse_tpu_torch.pipeline import FlexPipeline
    net = ControlNetModel(CFG, cond_channels=(4, 8), channel_major=True)
    pipe = FlexPipeline(nets['cm'], AutoencoderKL(TINY_VAE), controlnet=net,
                        sp_mesh=object())
    assert pipe.unet.channel_major is False
    assert pipe.controlnet.channel_major is False
    assert pipe.unet.conv_in is nets['cm'].conv_in
    assert nets['cm'].channel_major is True and net.channel_major is True
    plain = FlexPipeline(nets['cm'], AutoencoderKL(TINY_VAE))
    assert plain.unet is nets['cm']
