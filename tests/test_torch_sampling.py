"""PyTorch port: the sampling features of the tenth slice (FreeU, PAG,
DeepCache, the LCM guidance embedding, CFG rescale, the CFG interval and
ToMe) held against the JAX package on the CPU, with the same weights
(``weights/bridge.py``) and JAX's key chain replayed.

(a) One tiny UNet forward with each feature matches JAX's within 1e-4, the
    golden-loop bar (ROADMAP Queue 3, "PNDM golden loop": the two UNets'
    fp32 ε differ by 1.1-1.7e-5).
(b) A DeepCache 'use' call with the cache saved at the same (latents, t)
    is bit-identical to the port's own full forward.
(c) A 4-step CFG loop through ``FlexPipeline`` with each feature and
    their JAX-allowed combinations matches JAX's latents within 1e-4 and
    its uint8 images within one level.
(d) ToMe: ``resolve_r`` and the merge plan's indices equal JAX's on the
    same metric; merge/unmerge match within 1e-6.
(e) ToMe's drift against the exact loop stays inside
    ``tests/goldens/accuracy_budget.json`` (tools/accuracy_budget.py's
    tiny geometry: 128², a 64² latent, PNDM 25 steps, CFG 8), as the JAX
    package's test_accuracy_budget.py holds it, and above its floor. The
    other approximations of the budget are held to JAX's own loop by (c);
    running each at the budget's geometry on the CPU would take minutes.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu.models import TINY_UNET, UNet2DCondition
from flexdiffuse_tpu.models import unet as junet
from flexdiffuse_tpu.ops import tome as jtome
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.models import unet as tunet
from flexdiffuse_tpu_torch.ops import tome
from flexdiffuse_tpu_torch.pipeline import (CompositeGuidance, FlexPipeline,
                                            SimpleGuidance, rescale_cfg)
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_slice import T, D, _compare, models  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens',
                      'accuracy_budget.json')
FREEU = (1.5, 1.6, 0.9, 0.2)


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _inputs(b=2, hw=8, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.standard_normal((b, hw, hw, 4)).astype(np.float32)
    ctx = rng.standard_normal((b, T, D)).astype(np.float32)
    t = np.full((b,), 501.0, np.float32)
    return lat, t, ctx


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


FORWARD = [('freeu', dict(freeu=FREEU), {}),
           ('pag_mid', dict(pag_layers=('mid',)), {'pag': True}),
           ('pag_down_0_up_1', dict(pag_layers=('down_0', 'up_1')),
            {'pag': True}),
           ('freeu_pag', dict(freeu=FREEU, pag_layers=('up',)),
            {'pag': True})]


@pytest.mark.parametrize('name,settings,kw', FORWARD,
                         ids=[f[0] for f in FORWARD])
def test_unet_forward_matches_jax(models, name, settings, kw):
    """FreeU, PAG (a [0, 1] row mask: the second row's self-attention is
    the identity in the selected layers) and both: within 1e-4."""
    lat, t, ctx = _inputs()
    mask = np.array([0.0, 1.0], np.float32)
    junit = models['unet'].clone(**settings)
    jkw = {'pag_mask': jnp.asarray(mask)} if kw.get('pag') else {}
    want = junit.apply(models['unet_params'], *_j(lat, t, ctx), **jkw)
    unet = models['port_unet'].with_settings(**settings)
    tkw = {'pag_mask': torch.from_numpy(mask)} if kw.get('pag') else {}
    with torch.no_grad():
        got = unet(*_t(lat, t, ctx), **tkw)
        plain = models['port_unet'](*_t(lat, t, ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    # The feature changed the output (it engaged).
    assert (got - plain).abs().max() > 1e-3


def test_fourier_filter_matches_jax_on_unequal_sides_and_odd_channels():
    """NCHW in the port, NHWC in JAX: H ≠ W and an odd channel count, so a
    swapped axis cannot pass; fp32 within 1e-6."""
    x = np.random.default_rng(1).standard_normal((2, 7, 12, 10)).astype(
        np.float32)          # NHWC: H 7, W 12, C 10 → NCHW (2, 10, 7, 12)
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))
    for threshold, scale in ((1, 0.9), (2, 0.2), (3, 1.3)):
        want = np.asarray(junet.fourier_filter(jnp.asarray(x), threshold,
                                               scale))
        got = tunet.fourier_filter(xt, threshold, scale).numpy()
        np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                                   atol=1e-6)
    x = np.random.default_rng(2).standard_normal((1, 9, 5, 3)).astype(
        np.float32)
    want = np.asarray(junet.fourier_filter(jnp.asarray(x), 1, 0.5))
    got = tunet.fourier_filter(torch.from_numpy(np.ascontiguousarray(
        x.transpose(0, 3, 1, 2))), 1, 0.5).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), want, rtol=0,
                               atol=1e-6)


def test_pag_selection_matches_jax_names():
    names = ['down_0_attn_0', 'down_1_attn_1', 'mid_attn', 'up_1_attn_2',
             'up_2_attn_0']
    for layers in (None, ('mid',), ('down_1',), ('up_2_attn_0', 'down'),
                   ('up',)):
        for name in names:
            assert tunet.pag_selected(layers, name) == \
                junet.pag_selected(layers, name)


def test_deepcache_save_and_use_match_jax_and_use_is_exact(models):
    """'save' returns the full ε and the hidden state entering the
    shallowest decoder level (NCHW in the port, NHWC in JAX); 'use' with
    that cache at the same (latents, t) is bit-identical to the port's full
    forward; both match JAX within 1e-4."""
    lat, t, ctx = _inputs(seed=3)
    params = models['unet_params']
    jeps, jcache = models['unet'].apply(params, *_j(lat, t, ctx),
                                        cache_mode='save')
    jused, _ = models['unet'].apply(params, *_j(lat, t, ctx),
                                    deep_cache=jcache, cache_mode='use')
    unet = models['port_unet']
    with torch.no_grad():
        full = unet(*_t(lat, t, ctx))
        eps, cache = unet(*_t(lat, t, ctx), cache_mode='save')
        used, same = unet(*_t(lat, t, ctx), deep_cache=cache,
                          cache_mode='use')
        # A cache from another step: the shallow path really ran on it.
        other, _ = unet(*_t(lat, t * 0.5, ctx), deep_cache=cache,
                        cache_mode='use')
    assert same is cache
    assert torch.equal(eps, full) and torch.equal(used, full)
    assert not torch.equal(other, full)
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(cache.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jcache), rtol=0, atol=1e-4)
    np.testing.assert_allclose(used.numpy(), np.asarray(jused), rtol=0,
                               atol=1e-4)


@pytest.fixture(scope='module')
def lcm_models():
    """TINY_UNET with the LCM guidance projection, in both packages."""
    cfg = TINY_UNET.__class__(**{**TINY_UNET.__dict__,
                                 'time_cond_proj_dim': 8})
    unet = UNet2DCondition(cfg)
    params = jax.jit(lambda k: unet.init(
        k, jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)),
        jnp.zeros((2, T, D)), timestep_cond=jnp.zeros((2, 8))))(
            jax.random.PRNGKey(4))
    tcfg = tm.TINY_UNET.__class__(**{**tm.TINY_UNET.__dict__,
                                     'time_cond_proj_dim': 8})
    port = tm.UNet2DCondition(tcfg).eval()
    port.load_state_dict(params_to_state_dict(_np_tree(params), tcfg),
                         strict=True)
    return unet, params, port


def test_lcm_guidance_embedding_and_forward_match_jax(lcm_models):
    """The embedding's sin/cos arguments reach 1000·w, where one fp32 ulp
    is 1000·w·2⁻²³: within 4 such ulps of the largest argument. The
    forward on JAX's embedding: within 1e-4."""
    unet, params, port = lcm_models
    w = np.array([7.0, 2.5], np.float32)
    want = np.asarray(junet.guidance_scale_embedding(jnp.asarray(w), 8))
    got = tunet.guidance_scale_embedding(torch.from_numpy(w), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * 7000.0 * 2.0**-23)
    np.testing.assert_allclose(
        tunet.guidance_scale_embedding(torch.tensor([3.0]), 7).numpy(),
        np.asarray(junet.guidance_scale_embedding(jnp.asarray([3.0]), 7)),
        rtol=0, atol=4 * 3000.0 * 2.0**-23)
    lat, t, ctx = _inputs(seed=5)
    jeps = unet.apply(params, *_j(lat, t, ctx), timestep_cond=jnp.asarray(
        want))
    with torch.no_grad():
        eps = port(*_t(lat, t, ctx),
                   timestep_cond=torch.from_numpy(want.copy()))
        with pytest.raises(ValueError, match='timestep_cond'):
            port(*_t(lat, t, ctx))
    np.testing.assert_allclose(eps.numpy(), np.asarray(jeps), rtol=0,
                               atol=1e-4)


# --- the loop -----------------------------------------------------------

def _guides(batch=1, seed=0, **features):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(batch, T, D)).astype(np.float32)
    unc = rng.normal(size=(1, T, D)).astype(np.float32)
    jf = {k: (jnp.float32(v) if isinstance(v, float) else v)
          for k, v in features.items()}
    jguide = jp.SimpleGuidance(embeddings=jnp.asarray(emb),
                               uncond=jnp.asarray(unc),
                               guidance_scale=jnp.float32(8.0), cfg=True,
                               **jf)
    tguide = SimpleGuidance(embeddings=torch.from_numpy(emb),
                            uncond=torch.from_numpy(unc), guidance_scale=8.0,
                            **features)
    return jguide, tguide


def _step_noise(key, length, shape):
    """JAX's per-row step draws (``sub`` of ``split(k, 3)``)."""
    _, _, _, k = jax.random.split(key, 4)
    out = []
    for _ in range(length):
        k, sub, _ = jax.random.split(k, 3)
        out.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
    return out


INTERVAL = dict(cfg_interval=True, cfg_from=0.0, cfg_to=0.6)
RESCALE = dict(rescale=True, guidance_rescale=0.7)
PAG = dict(pag=True, pag_scale=3.0)
# (name, UNet settings, pipeline kwargs, guide features, batch)
LOOPS = [
    ('freeu', dict(freeu=FREEU), {}, {}, 1),
    ('pag_cfg', dict(pag_layers=('mid',)), {}, PAG, 1),
    ('pag_up_b2', dict(pag_layers=('up_1',)), {}, PAG, 2),
    ('deepcache2', {}, dict(deepcache=2), {}, 1),
    ('deepcache3_b2', {}, dict(deepcache=3), {}, 2),
    ('cfg_interval', {}, {}, INTERVAL, 1),
    ('cfg_interval_late', {}, {}, dict(cfg_interval=True, cfg_from=0.3,
                                       cfg_to=1.0), 1),
    ('rescale', {}, {}, RESCALE, 1),
    ('deepcache2_interval', {}, dict(deepcache=2), INTERVAL, 1),
    ('pag_deepcache2', dict(pag_layers=('mid',)), dict(deepcache=2), PAG,
     1),
    ('pag_interval_rescale', dict(pag_layers=('mid',)), {},
     dict(**PAG, **INTERVAL, **RESCALE), 1),
    ('freeu_deepcache2_rescale', dict(freeu=FREEU), dict(deepcache=2),
     RESCALE, 1),
]


@pytest.mark.parametrize('name,settings,pipe_kw,features,batch', LOOPS,
                         ids=[c[0] for c in LOOPS])
def test_cfg_loop_matches_jax(models, name, settings, pipe_kw, features,
                              batch):
    """PNDM, 4 steps (5 UNet rows), CFG 8, the same initial latents:
    latents within 1e-4 and images within one uint8 level (_compare)."""
    jpipe = jp.FlexPipeline(models['unet'].clone(**settings),
                            models['unet_params'], models['vae'],
                            models['vae_params'], scheduler='pndm',
                            **pipe_kw)
    tpipe = FlexPipeline(models['port_unet'].with_settings(**settings),
                         models['port_vae'], scheduler='pndm', **pipe_kw)
    jguide, tguide = _guides(batch, seed=7, **features)
    noise = np.random.default_rng(8).standard_normal(
        (batch, 8, 8, 4)).astype(np.float32)
    jlat = jpipe(jguide, steps=4, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(2),
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)


@pytest.mark.parametrize('kind', ['euler_a', 'heun', 'dpmpp', 'unipc',
                                  'ddpm'])
def test_scheduler_loops_match_jax(models, kind):
    """The new kinds through the pipeline (Heun: 7 UNet rows for 4 steps;
    Euler-a and DDPM with JAX's per-row step noise replayed): within 1e-4
    of max|x| (σ-space kinds carry σ-scaled latents) and one uint8
    level."""
    jpipe = jp.FlexPipeline(models['unet'], models['unet_params'],
                            models['vae'], models['vae_params'],
                            scheduler=kind)
    tpipe = FlexPipeline(models['port_unet'], models['port_vae'],
                         scheduler=kind)
    jguide, tguide = _guides(1, seed=9)
    key = jax.random.PRNGKey(4)
    _, _, k_noise, _ = jax.random.split(key, 4)
    noise = np.array(jax.random.normal(k_noise, (1, 8, 8, 4), jnp.float32))
    length = tpipe.schedule(4).length
    jlat = jpipe(jguide, steps=4, init_size=(16, 16), key=key,
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise),
                 variance_noise=_step_noise(key, length, (1, 8, 8, 4)),
                 output_type='latent').images
    ref = np.asarray(jlat)
    np.testing.assert_allclose(tlat.numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    ju8 = np.asarray(jpipe.decode_u8_device(jlat)).astype(np.int16)
    tu8 = tpipe.decode_u8_device(tlat).numpy().astype(np.int16)
    assert np.abs(tu8 - ju8).max() <= 1


def test_lcm_pipeline_matches_jax(lcm_models):
    """A guidance-embedded UNet: the pipeline builds the embedding from the
    guidance scale and turns CFG off (UNet batch 1); LCM's 4 steps with
    JAX's step noise replayed. The consistency step divides ε's
    contribution by √ᾱ (0.068 at t = 999), so the UNets' fp32 ε gap
    arrives ×14.6: within 1e-4·max|x|."""
    unet, params, port = lcm_models
    vae_models = {}
    jpipe = jp.FlexPipeline(unet, params, *_vae_pair(vae_models, 'jax'),
                            scheduler='lcm')
    tpipe = FlexPipeline(port, _vae_pair(vae_models, 'torch'),
                         scheduler='lcm')
    jguide, tguide = _guides(1, seed=10)
    key = jax.random.PRNGKey(6)
    _, _, k_noise, _ = jax.random.split(key, 4)
    noise = np.array(jax.random.normal(k_noise, (1, 8, 8, 4), jnp.float32))
    calls = []
    hook = port.register_forward_pre_hook(
        lambda m, args: calls.append(args[0].shape[0]))
    jlat = jpipe(jguide, steps=4, init_size=(16, 16), key=key,
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise),
                 variance_noise=_step_noise(key, 4, (1, 8, 8, 4)),
                 output_type='latent').images
    hook.remove()
    assert calls == [1, 1, 1, 1]
    ref = np.asarray(jlat)
    np.testing.assert_allclose(tlat.numpy(), ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


_VAES = {}


def _vae_pair(cache, which):
    from flexdiffuse_tpu.models import TINY_VAE, AutoencoderKL
    if not _VAES:
        vae = AutoencoderKL(TINY_VAE)
        vp = jax.jit(lambda k: vae.init(k, jnp.zeros((1, 16, 16, 3)), k))(
            jax.random.PRNGKey(0))
        port = tm.AutoencoderKL(tm.TINY_VAE).eval()
        port.load_state_dict(params_to_state_dict(_np_tree(vp), TINY_VAE),
                             strict=True)
        _VAES.update(jax=(vae, vp), torch=port)
    return _VAES[which]


def test_pipeline_refuses_what_jax_refuses(models):
    """PAG needs pag_layers; PAG with DeepCache and the CFG interval
    together, and DeepCache + interval on composite guidance, raise."""
    tpipe = FlexPipeline(models['port_unet'], models['port_vae'])
    _, tguide = _guides(1, **PAG)
    with pytest.raises(ValueError, match='pag_layers'):
        tpipe(tguide, steps=2, init_size=(16, 16), output_type='latent')
    both = FlexPipeline(models['port_unet'].with_settings(
        pag_layers=('mid',)), models['port_vae'], deepcache=2)
    _, tguide = _guides(1, **PAG, **INTERVAL)
    with pytest.raises(ValueError, match='not both'):
        both(tguide, steps=2, init_size=(16, 16), output_type='latent')
    comp = CompositeGuidance(
        background=torch.zeros(1, T, D), entities=torch.zeros(0, T, D),
        masks=torch.zeros(0, 8, 8, 1), blends=torch.zeros(0),
        uncond=torch.zeros(1, T, D), guidance_scale=8.0, **INTERVAL)
    with pytest.raises(ValueError, match='composite'):
        FlexPipeline(models['port_unet'], models['port_vae'],
                     deepcache=2)(comp, steps=2, init_size=(16, 16))
    with pytest.raises(ValueError, match='rescale'):
        SimpleGuidance(embeddings=torch.zeros(1, T, D),
                       uncond=torch.zeros(1, T, D), guidance_scale=8.0,
                       guidance_rescale=0.7)
    with pytest.raises(ValueError):
        FlexPipeline(models['port_unet'], models['port_vae'], deepcache=-1)


def test_rescale_cfg_matches_jax():
    rng = np.random.default_rng(12)
    a, b = (rng.standard_normal((2, 8, 8, 4)).astype(np.float32) * s
            for s in (3.0, 1.0))
    from flexdiffuse_tpu.pipeline.guides import rescale_cfg as jrescale
    for phi in (0.0, 0.7, 1.0):
        np.testing.assert_allclose(
            rescale_cfg(*_t(a, b), phi).numpy(),
            np.asarray(jrescale(*_j(a, b), phi)), rtol=0, atol=1e-6)


# --- ToMe -----------------------------------------------------------------

@pytest.mark.parametrize('hw,ratio', [((64, 64), 0.5), ((48, 48), 0.5),
                                      ((16, 16), 0.5), ((7, 9), 0.3),
                                      ((32, 32), 0.7), ((96, 96), 0.5)])
def test_tome_resolve_r_matches_jax(hw, ratio):
    assert tome.resolve_r(*hw, ratio) == jtome.resolve_r(*hw, ratio)
    if hw == (64, 64):
        assert 4096 - tome.resolve_r(*hw, ratio) == 2048


@pytest.mark.parametrize('b,hw,r', [(2, (16, 16), 128), (1, (32, 32), 512),
                                    (3, (12, 10), 40)])
def test_tome_plan_and_merge_match_jax(b, hw, r):
    """The same fp32 metric gives the same indices (bipartite split, the
    merged and kept srcs, each merged src's dst); merge and unmerge within
    1e-6."""
    s = hw[0] * hw[1]
    rng = np.random.default_rng(13)
    metric = rng.standard_normal((b, s, 24)).astype(np.float32)
    x = rng.standard_normal((b, s, 8)).astype(np.float32)
    jplan = jtome.merge_plan(jnp.asarray(metric), hw, r)
    plan = tome.merge_plan(torch.from_numpy(metric), hw, r)
    for name in ('dst_idx', 'src_idx', 'merged_pos', 'kept_pos', 'assign'):
        np.testing.assert_array_equal(getattr(plan, name).numpy(),
                                      np.asarray(getattr(jplan, name)),
                                      err_msg=name)
    assert plan.merged_len == jplan.merged_len == s - r
    merged = tome.merge(torch.from_numpy(x), plan)
    np.testing.assert_allclose(
        merged.numpy(), np.asarray(jtome.merge(jnp.asarray(x), jplan)),
        rtol=0, atol=1e-6)
    y = rng.standard_normal((b, s - r, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tome.unmerge(torch.from_numpy(y), plan).numpy(),
        np.asarray(jtome.unmerge(jnp.asarray(y), jplan)))


def test_tome_unet_forward_matches_jax(models):
    """ToMe on the tiny UNet's 32×32 level (1024 tokens merged to 512,
    min_seq 256): the same plan and the same merged attention, within
    1e-4; it changes the output."""
    lat, t, ctx = _inputs(hw=32, seed=14)
    want = models['unet'].clone(tome=(0.5, 256)).apply(
        models['unet_params'], *_j(lat, t, ctx))
    unet = models['port_unet'].with_settings(tome=(0.5, 256))
    with torch.no_grad():
        got = unet(*_t(lat, t, ctx))
        plain = models['port_unet'](*_t(lat, t, ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    assert (got - plain).abs().max() > 1e-3


# --- the accuracy budget --------------------------------------------------

@pytest.fixture(scope='module')
def budget_parts():
    """tools/accuracy_budget.py's tiny parts (PRNGKey(0) weights, 128²),
    in the port, and its PRNGKey(7) initial latents."""
    from flexdiffuse_tpu.models import TINY_VAE, AutoencoderKL
    k = jax.random.PRNGKey(0)
    unet = UNet2DCondition(TINY_UNET)
    up = jax.jit(lambda kk: unet.init(
        kk, jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, TINY_UNET.cross_attention_dim))))(k)
    vae = AutoencoderKL(TINY_VAE)
    vp = jax.jit(lambda kk: vae.init(kk, jnp.zeros((1, 16, 16, 3)), kk))(k)
    rng = np.random.default_rng(0)
    emb, unc = (rng.normal(size=(1, 77, TINY_UNET.cross_attention_dim))
                .astype(np.float32) for _ in range(2))
    port_unet = tm.UNet2DCondition(tm.TINY_UNET).eval()
    port_unet.load_state_dict(params_to_state_dict(_np_tree(up), TINY_UNET),
                              strict=True)
    port_vae = tm.AutoencoderKL(tm.TINY_VAE).eval()
    port_vae.load_state_dict(params_to_state_dict(_np_tree(vp), TINY_VAE),
                             strict=True)
    # TINY_VAE downsamples by 2: 128² is a 64² latent (4096 tokens).
    _, _, k_noise, _ = jax.random.split(jax.random.PRNGKey(7), 4)
    noise = np.array(jax.random.normal(k_noise, (1, 64, 64, 4),
                                       jnp.float32))
    return port_unet, port_vae, emb, unc, noise


BUDGET = {'tome_05': (dict(tome=(0.5, 256)), {}, {})}


@pytest.fixture(scope='module')
def drift(budget_parts):
    unet, vae, emb, unc, noise = budget_parts

    def run(settings, pipe_kw, features):
        pipe = FlexPipeline(unet.with_settings(**settings), vae,
                            scheduler='pndm', **pipe_kw)
        guide = SimpleGuidance(embeddings=torch.from_numpy(emb),
                               uncond=torch.from_numpy(unc),
                               guidance_scale=8.0, **features)
        return pipe(guide, steps=25, init_size=(128, 128),
                    noise=torch.from_numpy(noise),
                    output_type='latent').images.double().numpy()

    exact = run({}, {}, {})
    e_ms, e_max = float(np.mean(exact**2)), float(np.abs(exact).max())
    out = {}
    for name, cfg in BUDGET.items():
        lat = run(*cfg)
        assert np.isfinite(lat).all(), name
        out[name] = dict(rel_mse=float(np.mean((lat - exact)**2) / e_ms),
                         max_rel=float(np.abs(lat - exact).max() / e_max))
    return out


@pytest.mark.parametrize('name', sorted(BUDGET))
def test_drift_within_the_accuracy_budget(drift, name):
    """Each approximation's drift stays under the committed bound (recorded
    × 2) and above a tenth of the recorded rel_mse (it engaged)."""
    with open(GOLDEN) as f:
        entry = json.load(f)['tiny_geometry'][name]
    for metric in ('rel_mse', 'max_rel'):
        assert drift[name][metric] <= entry['bound'][metric], (
            name, metric, drift[name][metric])
    assert drift[name]['rel_mse'] >= entry['recorded']['rel_mse'] / 10.0


@pytest.mark.parametrize('kind', ['euler_a', 'heun', 'dpmpp', 'unipc',
                                  'ddpm'])
def test_new_kinds_inpaint_matches_jax(models, kind):
    """img2img at strength 0.7 with latent inpainting (the kept half
    re-anchored at each row's output level: σ tables, VP tables, Heun's
    interleaved rows), JAX's whole key chain replayed (posterior, initial
    noise, step noise, anchor noise): within 1e-4·max|x| (the σ kinds carry
    σ-scaled latents) and one uint8 level."""
    from tests.test_torch_composition import _left_half, _pixels, _rows
    jpipe = jp.FlexPipeline(models['unet'], models['unet_params'],
                            models['vae'], models['vae_params'],
                            scheduler=kind)
    tpipe = FlexPipeline(models['port_unet'], models['port_vae'],
                         scheduler=kind)
    jguide, tguide = _guides(1, seed=13)
    pixels, mask = _pixels(4), _left_half()
    key = jax.random.PRNGKey(23)
    _, k_enc, k_noise, _ = jax.random.split(key, 4)
    shape = (1, 8, 8, 4)
    posterior = np.array(jax.random.normal(k_enc, shape, jnp.float32))
    noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    subs, inps = _rows(key, tpipe.schedule(4).length, shape)
    jlat = jpipe(jguide, steps=4, init_image=jnp.asarray(pixels),
                 strength=0.7, key=key, mask=mask,
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_image=pixels, strength=0.7,
                 mask=mask, noise=torch.from_numpy(noise),
                 posterior_noise=torch.from_numpy(posterior),
                 variance_noise=subs, inpaint_noise=inps,
                 output_type='latent').images
    ref = np.asarray(jlat)
    np.testing.assert_allclose(tlat.numpy(), ref, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(ref).max()))
    ju8 = np.asarray(jpipe.decode_u8_device(jlat)).astype(np.int16)
    tu8 = tpipe.decode_u8_device(tlat).numpy().astype(np.int16)
    assert np.abs(tu8 - ju8).max() <= 1


@pytest.mark.parametrize('pipe_kw,features', [
    ({}, dict(cfg_interval=True, cfg_from=0.0, cfg_to=0.6)),
    (dict(deepcache=2), dict(rescale=True, guidance_rescale=0.7))])
def test_composite_guidance_features_match_jax(models, pipe_kw, features):
    """Regional composition with the CFG interval (the uncond row drops out
    of the stack outside it) and with DeepCache and CFG rescale: 4 PNDM
    steps, within 1e-4 and one uint8 level."""
    import dataclasses
    from tests.test_torch_composition import _composites
    jguide, tguide = _composites(2)
    jf = {k: (jnp.float32(v) if isinstance(v, float) else v)
          for k, v in features.items()}
    jguide = jguide.replace(**jf)
    tguide = dataclasses.replace(tguide, **features)
    jpipe = jp.FlexPipeline(models['unet'], models['unet_params'],
                            models['vae'], models['vae_params'],
                            scheduler='pndm', **pipe_kw)
    tpipe = FlexPipeline(models['port_unet'], models['port_vae'],
                         scheduler='pndm', **pipe_kw)
    noise = np.random.default_rng(17).standard_normal(
        (1, 8, 8, 4)).astype(np.float32)
    jlat = jpipe(jguide, steps=4, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(3),
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)
