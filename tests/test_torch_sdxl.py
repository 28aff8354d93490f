"""PyTorch port: the SDXL backbone (``models/sdxl.py``, the text tower's
SDXL outputs, the UNet's and ControlNet's text-time embedding, the guides'
``added_cond`` rows, the tween of the CLIP-L half, SDXL composition and the
SGM LoRA merge), held against the JAX package case for case with
``tests/test_sdxl.py`` on the tiny configs, fp32 on the CPU.

Both packages get the same weights (the JAX params bridged by
``weights/bridge.py``) and the same numpy inputs; tolerance max|Δ| ≤ 1e-4
(``test_torch_models.py``'s). The meta-device parameter counts of the
published SDXL geometries are held against the checkpoint manifests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu.guidance import GuidanceParams as JGuidanceParams
from flexdiffuse_tpu.guidance import Tweener as JTweener
from flexdiffuse_tpu.models import sdxl as jsdxl
from flexdiffuse_tpu.models.clip import CLIPTextModel as JCLIPText
from flexdiffuse_tpu.models.configs import (TINY_BIGG_TEXT, TINY_REFINER_UNET,
                                            TINY_SDXL_UNET, TINY_TEXT,
                                            TINY_VAE)
from flexdiffuse_tpu.models.controlnet import ControlNetModel as JControlNet
from flexdiffuse_tpu.models.unet import UNet2DCondition as JUNet
from flexdiffuse_tpu.models.vae import AutoencoderKL as JVAE
from flexdiffuse_tpu.pipeline import FlexPipeline as JFlexPipeline
from flexdiffuse_tpu.text.tokenizer import FakeTokenizer as JFakeTokenizer
from flexdiffuse_tpu.weights import lora as jlora
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.composition import EntitySchema, Schema
from flexdiffuse_tpu_torch.config import GuidanceParams
from flexdiffuse_tpu_torch.guidance.tween import Tweener
from flexdiffuse_tpu_torch.models import sdxl as tsdxl
from flexdiffuse_tpu_torch.models.controlnet import ControlNetModel
from flexdiffuse_tpu_torch.pipeline import FlexPipeline
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.weights import lora as tlora
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests import checkpoint_manifests as man
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_controlnet import _live

ATOL = 1e-4
CTX = TINY_TEXT.hidden_size + TINY_BIGG_TEXT.hidden_size   # 32 + 24
# The tiny SDXL UNet with the cross-attention width of the two tiny
# encoders' concatenation (flax infers it from the JAX test's context; the
# port's projections take it from the config).
XL = dataclasses.replace(TINY_SDXL_UNET, cross_attention_dim=CTX)
T_XL = dataclasses.replace(tm.TINY_SDXL_UNET, cross_attention_dim=CTX)
POOLED = TINY_SDXL_UNET.addition_pooled_dim
RAMP = (8, 16)      # the tiny VAE halves the image once


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(cls, config, params, **kw):
    model = cls(config, **kw).eval()
    model.load_state_dict(params_to_state_dict(_np(params), config),
                          strict=True)
    return model.requires_grad_(False)


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _added(b, ids=6, seed=0):
    rng = np.random.default_rng(seed)
    pooled = rng.normal(size=(b, POOLED)).astype(np.float32)
    tids = np.tile(np.array([[64, 64, 0, 0, 64, 64, 6.0][:ids]],
                            np.float32), (b, 1))
    tids[:, 0] += np.arange(b, dtype=np.float32) * 128
    return pooled, tids


def _jadded(pooled, tids):
    return {'text_embeds': jnp.asarray(pooled), 'time_ids': jnp.asarray(tids)}


def _tadded(pooled, tids):
    p, t = _t(pooled, tids)
    return {'text_embeds': p, 'time_ids': t}


@pytest.fixture(scope='module')
def enc():
    """The dual tiny encoders in both packages (the JAX test's
    ``dual_encoder``: both inits from ``PRNGKey(0)``)."""
    k = jax.random.PRNGKey(0)
    j1, j2 = JCLIPText(TINY_TEXT), JCLIPText(TINY_BIGG_TEXT)
    p1 = jax.jit(lambda key: j1.init(key, jnp.zeros((1, 77), jnp.int32)))(k)
    p2 = jax.jit(lambda key: j2.init(key, jnp.zeros((1, 77), jnp.int32),
                                     output='penultimate_and_pooled'))(k)
    t1 = _port(tm.CLIPTextModel, tm.TINY_TEXT, p1)
    t2 = _port(tm.CLIPTextModel, tm.TINY_BIGG_TEXT, p2)
    return dict(jax=jsdxl.SDXLTextEncoder(j1, p1, j2, p2, JFakeTokenizer()),
                port=tsdxl.SDXLTextEncoder(t1, t2, FakeTokenizer()),
                j1=j1, p1=p1, j2=j2, p2=p2, t1=t1, t2=t2)


def _unet_pair(config, port_config, seed=0, ids=6):
    net = JUNet(config)
    lat = jnp.zeros((2, 8, 8, 4))
    ctx = jnp.zeros((2, 77, config.cross_attention_dim))
    ac = {'text_embeds': jnp.zeros((2, config.addition_pooled_dim)),
          'time_ids': jnp.zeros((2, ids))}
    params = jax.jit(lambda k: net.init(k, lat, jnp.zeros((2,)), ctx, ac))(
        jax.random.PRNGKey(seed))
    return net, params, _port(tm.UNet2DCondition, port_config, params)


def _apply(jnet):
    """``jnet.apply`` jitted (``pag_mask`` a keyword)."""
    return jax.jit(lambda p, *a, pag_mask=None: jnet.apply(
        p, *a, pag_mask=pag_mask))


@pytest.fixture(scope='module')
def unets():
    base = _unet_pair(XL, T_XL)
    refiner = _unet_pair(TINY_REFINER_UNET, tm.TINY_REFINER_UNET, seed=1,
                         ids=5)
    return dict(base=base, refiner=refiner)


@pytest.fixture(scope='module')
def vaes():
    k = jax.random.PRNGKey(0)
    vae = JVAE(TINY_VAE)
    params = jax.jit(lambda key: vae.init(key, jnp.zeros((1, 16, 16, 3)),
                                          key))(k)
    return vae, params, _port(tm.AutoencoderKL, tm.TINY_VAE, params)


# --- the text tower's SDXL outputs -----------------------------------------

def test_penultimate_differs_from_final(enc):
    """'penultimate' is the hidden state before the last layer,
    un-normalised, and matches JAX's (observed max|Δ| ≈ 1e-6)."""
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77)).astype(
        np.int32)
    (tids,) = _t(ids.astype(np.int64))
    ref = np.asarray(enc['j1'].apply(enc['p1'], jnp.asarray(ids),
                                     output='penultimate'))
    with torch.no_grad():
        final = enc['t1'](tids, output='final').numpy()
        penult = enc['t1'](tids, output='penultimate').numpy()
        norm = enc['t1'](tids, output='penultimate_norm').numpy()
    assert final.shape == penult.shape == (2, 77, TINY_TEXT.hidden_size)
    assert np.abs(final - penult).max() > 1e-4
    assert np.abs(norm - penult).max() > 1e-4
    np.testing.assert_allclose(penult, ref, rtol=0, atol=ATOL)


def test_pooled_uses_eos_position(enc):
    """'penultimate_and_pooled' against JAX: the pooled row moves with the
    EOS position."""
    tk = FakeTokenizer()
    out = {}
    for text in ('a cat', 'a cat sat'):
        ids = tk(text)
        with torch.no_grad():
            pen, pooled = enc['t2'](torch.from_numpy(ids).long(),
                                    output='penultimate_and_pooled')
        jpen, jpooled = enc['j2'].apply(enc['p2'], jnp.asarray(ids),
                                        output='penultimate_and_pooled')
        np.testing.assert_allclose(pen.numpy(), np.asarray(jpen), rtol=0,
                                   atol=ATOL)
        np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled),
                                   rtol=0, atol=ATOL)
        out[text] = pooled.numpy()
    assert out['a cat'].shape == (1, TINY_BIGG_TEXT.projection_dim)
    assert np.abs(out['a cat'] - out['a cat sat']).max() > 1e-6


def test_pooled_matches_first_eos_not_argmax():
    """With a token id above the EOS id (a textual-inversion token) the
    pooled row is the first EOS position's, as JAX's, not ``argmax``'s."""
    cfg = dataclasses.replace(TINY_BIGG_TEXT, vocab_size=1002)
    jm = JCLIPText(cfg)
    ids = np.array([[998, 5, 1001, 7, 999] + [0] * 72], np.int32)
    params = jax.jit(lambda k: jm.init(k, jnp.asarray(ids),
                                       output='penultimate_and_pooled'))(
        jax.random.PRNGKey(3))
    port = _port(tm.CLIPTextModel, dataclasses.replace(tm.TINY_BIGG_TEXT,
                                                       vocab_size=1002),
                 params)
    jpooled = np.asarray(jm.apply(params, jnp.asarray(ids),
                                  output='penultimate_and_pooled')[1])
    with torch.no_grad():
        pooled = port(torch.from_numpy(ids).long(),
                      output='penultimate_and_pooled')[1].numpy()
        final = port.text_model.final_layer_norm(port.text_model.encoder(
            port.text_model.embeddings.token_embedding(
                torch.from_numpy(ids).long()) +
            port.text_model.embeddings.position_embedding.weight,
            torch.triu(torch.full((77, 77), torch.finfo(torch.float32).min),
                       diagonal=1)))
        at_argmax = port.text_projection(final[:, 2]).numpy()
    np.testing.assert_allclose(pooled, jpooled, rtol=0, atol=ATOL)
    assert np.abs(pooled - at_argmax).max() > 1e-4


def test_dual_encoder_concat_width(enc):
    """Context ``[B, 77, 32 + 24]`` and pooled ``[B, 24]``, both JAX's."""
    ctx, pooled = enc['port'].encode(['a deer', 'a bear'])
    jctx, jpooled = enc['jax'].encode(['a deer', 'a bear'])
    assert tuple(ctx.shape) == (2, 77, CTX)
    assert tuple(pooled.shape) == (2, TINY_BIGG_TEXT.projection_dim)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(pooled.numpy(), np.asarray(jpooled), rtol=0,
                               atol=ATOL)
    rctx, rpooled = enc['port'].encode_refiner('a deer')
    jrctx, jrpooled = enc['jax'].encode_refiner('a deer')
    np.testing.assert_allclose(rctx.numpy(), np.asarray(jrctx), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(rpooled.numpy(), np.asarray(jrpooled),
                               rtol=0, atol=ATOL)


# --- the UNet's and the ControlNet's text-time embedding ------------------

@pytest.mark.parametrize('which', ['base', 'refiner'])
def test_unet_added_cond_matches_jax(unets, which):
    """ε with ``added_cond`` (the base's 6 time ids; the refiner's 5, an
    ``add_embedding`` input of 24 + 5·256)."""
    jnet, params, port = unets[which]
    cfg = jnet.config
    ids = cfg.num_time_ids
    rng = np.random.default_rng(4)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, cfg.cross_attention_dim)).astype(
        np.float32)
    t = np.array([981.0, 21.0], np.float32)
    pooled, tids = _added(2, ids)
    ref = np.asarray(_apply(jnet)(params, jnp.asarray(lat), jnp.asarray(t),
                                  jnp.asarray(ctx), _jadded(pooled, tids)))
    with torch.no_grad():
        got = port(*_t(lat, t, ctx),
                   added_cond=_tadded(pooled, tids)).numpy()
    assert port.add_embedding.linear_1.in_features == \
        cfg.addition_pooled_dim + ids * cfg.addition_time_embed_dim
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_added_cond_affects_output(unets):
    """Other pooled embeddings change ε."""
    _, _, port = unets['base']
    rng = np.random.default_rng(0)
    ctx = rng.normal(size=(1, 77, CTX)).astype(np.float32)
    lat = np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    tids = jsdxl.time_ids((64, 64))
    out = []
    with torch.no_grad():
        for fill in (np.zeros, np.ones):
            out.append(port(*_t(lat, np.full((1,), 500.0, np.float32), ctx),
                            added_cond=_tadded(
                                fill((1, POOLED), np.float32),
                                np.asarray(tids))).numpy())
    assert np.abs(out[0] - out[1]).max() > 1e-6


def test_time_ids_affect_output(unets):
    """Other time ids change ε; without ``added_cond`` the UNet refuses."""
    _, _, port = unets['base']
    lat, ctx = np.zeros((1, 8, 8, 4), np.float32), np.zeros((1, 77, CTX),
                                                            np.float32)
    t = np.full((1,), 500.0, np.float32)
    out = []
    with torch.no_grad():
        for size in ((64, 64), (1024, 1024)):
            out.append(port(*_t(lat, t, ctx), added_cond=_tadded(
                np.zeros((1, POOLED), np.float32),
                tsdxl.time_ids(size).numpy())).numpy())
        with pytest.raises(ValueError, match='added_cond'):
            port(*_t(lat, t, ctx))
    assert np.abs(out[0] - out[1]).max() > 1e-6


def test_controlnet_added_cond_matches_jax():
    """An SDXL ControlNet (``add_embedding``): residuals with
    ``added_cond`` equal JAX's, and other time ids move them."""
    net = JControlNet(XL, cond_channels=RAMP)
    ac = {'text_embeds': jnp.zeros((1, POOLED)),
          'time_ids': jnp.zeros((1, 6))}
    params = _live(jax.jit(lambda k: net.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, CTX)),
        jnp.zeros((1, 16, 16, 3)), 1.0, ac))(jax.random.PRNGKey(5)))
    port = _port(ControlNetModel, T_XL, params, cond_channels=RAMP)
    rng = np.random.default_rng(6)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, CTX)).astype(np.float32)
    cond = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    t = np.array([981.0, 21.0], np.float32)
    pooled, tids = _added(2)
    jdown, jmid = jax.jit(net.apply)(params, *map(jnp.asarray,
                                                  (lat, t, ctx, cond)),
                                     1.0, _jadded(pooled, tids))
    with torch.no_grad():
        down, mid = port(*_t(lat, t, ctx, cond), 1.0,
                         added_cond=_tadded(pooled, tids))
        _, mid2 = port(*_t(lat, t, ctx, cond), 1.0,
                       added_cond=_tadded(pooled, tids * 2))
    assert len(down) == len(jdown)
    for got, want in zip(down + (mid,), tuple(jdown) + (jmid,)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), rtol=0, atol=ATOL)
    assert (mid - mid2).abs().max() > 1e-6


# --- the guides' added_cond rows -------------------------------------------

def _guide_pair(refiner: bool = False, b: int = 1):
    """The same SimpleGuidance in both packages (random embeddings, one
    uncond row, the refiner's own uncond time ids with ``refiner``)."""
    rng = np.random.default_rng(8)
    d = TINY_REFINER_UNET.cross_attention_dim if refiner else CTX
    emb = rng.normal(size=(b, 77, d)).astype(np.float32)
    unc = rng.normal(size=(1, 77, d)).astype(np.float32)
    pooled = rng.normal(size=(b, POOLED)).astype(np.float32)
    upooled = rng.normal(size=(1, POOLED)).astype(np.float32)
    if refiner:
        tids = np.asarray(jsdxl.refiner_time_ids((64, 64), (0, 0), 6.0))
        utids = np.asarray(jsdxl.refiner_time_ids((64, 64), (0, 0), 2.5))
    else:
        tids, utids = np.asarray(jsdxl.time_ids((64, 64))), None
    from flexdiffuse_tpu.pipeline.guides import SimpleGuidance as JSG
    from flexdiffuse_tpu_torch.pipeline.guides import SimpleGuidance as TSG
    j = JSG(embeddings=jnp.asarray(emb), uncond=jnp.asarray(unc),
            guidance_scale=jnp.float32(5.0), pooled=jnp.asarray(pooled),
            uncond_pooled=jnp.asarray(upooled), time_ids=jnp.asarray(tids),
            uncond_time_ids=None if utids is None else jnp.asarray(utids))
    t = TSG(*_t(emb, unc), guidance_scale=5.0,
            pooled=torch.from_numpy(pooled),
            uncond_pooled=torch.from_numpy(upooled),
            time_ids=torch.tensor(tids),
            uncond_time_ids=None if utids is None else
            torch.tensor(utids))
    return j, t


@pytest.mark.parametrize('refiner', [False, True], ids=['base', 'refiner'])
@pytest.mark.parametrize('layout', ['cfg', 'cond', 'pag_cfg', 'pag_cond'])
def test_added_rows_match_jax(refiner, layout):
    """``_added`` under CFG (uncond rows first), the CFG interval's
    cond-only half batch and PAG's second copy of the cond rows, with and
    without the refiner's own negative time ids (2.5 against 6.0)."""
    jg, tg = _guide_pair(refiner, b=2)
    n, with_uncond, copies = {'cfg': (4, True, 1), 'cond': (2, False, 1),
                              'pag_cfg': (6, True, 2),
                              'pag_cond': (4, False, 2)}[layout]
    want = jg._added(n, with_uncond, copies)
    got = tg._added(n, with_uncond, copies)
    for key in ('text_embeds', 'time_ids'):
        assert tuple(got[key].shape)[0] == n
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))


def _jnf(jnet, params):
    apply = _apply(jnet)

    def noise_fn(lat, t, ctx, added=None, ip=None, tcond=None,
                 pag_mask=None):
        return apply(params, lat, t, ctx, added, pag_mask=pag_mask)
    return noise_fn


def _refiner_guides(enc, score: float = 6.0, negative: float = 2.5):
    """``sdxl_refiner_guidance`` of both packages on the dual encoders; the
    port's fields equal JAX's (the time ids exactly)."""
    kw = dict(negative_prompt='blurry', guidance_scale=5.0, size=(64, 64),
              aesthetic_score=score, negative_aesthetic_score=negative)
    jg = jsdxl.sdxl_refiner_guidance(enc['jax'], 'a deer', **kw)
    tg = tsdxl.sdxl_refiner_guidance(enc['port'], 'a deer', **kw)
    for key in ('time_ids', 'uncond_time_ids'):
        np.testing.assert_array_equal(getattr(tg, key).numpy(),
                                      np.asarray(getattr(jg, key)))
    for key in ('embeddings', 'uncond', 'pooled', 'uncond_pooled'):
        np.testing.assert_allclose(getattr(tg, key).numpy(),
                                   np.asarray(getattr(jg, key)), rtol=0,
                                   atol=ATOL)
    assert tg.cfg and jg.cfg
    return jg, tg


@pytest.mark.parametrize('mode', ['cfg', 'cond', 'pag', 'refiner'])
def test_noise_pred_with_added_cond_matches_jax(enc, unets, mode):
    """The guided ε through the UNet with the guide's ``added_cond`` rows:
    CFG, the CFG interval's cond-only guide, PAG on ('mid',) under CFG, and
    the refiner's CFG from ``sdxl_refiner_guidance`` (its own negative
    aesthetic score, 2.5 against 6.0; swapping the two moves ε by far more
    than the tolerance)."""
    jnet, params, port = unets['refiner' if mode == 'refiner' else 'base']
    if mode == 'refiner':
        jg, tg = _refiner_guides(enc)
    else:
        jg, tg = _guide_pair()
    if mode == 'cond':
        jg, tg = jg.replace(cfg=False), tg.replace(cfg=False)
    if mode == 'pag':
        jnet = jnet.clone(pag_layers=('mid',))
        port = port.with_settings(pag_layers=('mid',))
        jg = jg.replace(pag=True, pag_scale=jnp.float32(3.0))
        tg = tg.replace(pag=True, pag_scale=3.0)
    lat = np.random.default_rng(9).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    want = jg.noise_pred(_jnf(jnet, params), jnp.asarray(lat),
                         jnp.float32(601.0))
    with torch.no_grad():
        got = tg.noise_pred(port, torch.from_numpy(lat), torch.tensor(601.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    if mode == 'refiner':
        _, swapped = _refiner_guides(enc, 2.5, 6.0)
        with torch.no_grad():
            other = swapped.noise_pred(port, torch.from_numpy(lat),
                                       torch.tensor(601.0))
        assert (other - got).abs().max() > 10 * ATOL


# --- the pipeline ----------------------------------------------------------

def test_sdxl_guidance_and_pipeline(enc, unets, vaes):
    """``sdxl_guidance`` and a 3-step Euler txt2img at SDXL's latent scale,
    on JAX's initial noise: the images equal JAX's within 1e-4."""
    jnet, params, port = unets['base']
    jvae, vparams, tvae = vaes
    jpipe = JFlexPipeline(jnet, params, jvae, vparams, scheduler='euler',
                          latent_scale=jsdxl.SDXL_LATENT_SCALE)
    tpipe = FlexPipeline(port, tvae, scheduler='euler',
                         latent_scale=tsdxl.SDXL_LATENT_SCALE)
    jg = jsdxl.sdxl_guidance(enc['jax'], 'a deer', negative_prompt='blurry',
                             guidance_scale=5.0, size=(64, 64))
    tg = tsdxl.sdxl_guidance(enc['port'], 'a deer', negative_prompt='blurry',
                             guidance_scale=5.0, size=(64, 64))
    assert tg.pooled is not None and tuple(tg.time_ids.shape) == (1, 6)
    np.testing.assert_array_equal(tg.time_ids.numpy(),
                                  np.asarray(jg.time_ids))
    noise = np.random.default_rng(10).normal(size=(1, 32, 32, 4)).astype(
        np.float32)
    want = jpipe(jg, steps=3, init_size=(64, 64), output_type='np',
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(1)).images
    got = tpipe(tg, steps=3, init_size=(64, 64), output_type='np',
                noise=torch.from_numpy(noise)).images
    assert got.shape == (1, 64, 64, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


# --- the tween of the CLIP-L half ------------------------------------------

def _tween_both(enc, prompts, seed):
    patches = np.random.default_rng(seed).normal(
        size=(40, TINY_TEXT.hidden_size)).astype(np.float32)
    l = TINY_TEXT.hidden_size
    ctx, _ = enc['port'].encode(prompts)
    jctx, _ = enc['jax'].encode(prompts)
    out = tsdxl.tween_sdxl_context(Tweener(GuidanceParams.ui_defaults()),
                                   ctx, torch.from_numpy(patches)[None],
                                   l_dim=l)
    want = jsdxl.tween_sdxl_context(JTweener(JGuidanceParams.ui_defaults()),
                                    jctx, jnp.asarray(patches)[None],
                                    l_dim=l)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    return ctx, out, patches, l


def test_tween_sdxl_context_blends_l_half_only(enc):
    ctx, out, _, l = _tween_both(enc, 'a deer', 2)
    assert out.shape == ctx.shape
    # bigG half untouched; L half modified.
    np.testing.assert_array_equal(out[..., l:].numpy(), ctx[..., l:].numpy())
    assert (out[..., :l] - ctx[..., :l]).abs().max() > 1e-6


def test_tween_sdxl_context_batched_rows_independent(enc):
    """Each row gets its own tween, equal to tweening that row alone."""
    ctx, out, patches, l = _tween_both(enc, ['a deer', 'a bear in a forest'],
                                       3)
    tw = Tweener(GuidanceParams.ui_defaults())
    for i in range(ctx.shape[0]):
        solo = tsdxl.tween_sdxl_context(tw, ctx[i:i + 1],
                                        torch.from_numpy(patches)[None],
                                        l_dim=l)
        np.testing.assert_allclose(out[i].numpy(), solo[0].numpy(),
                                   atol=1e-6)
    assert (out[0, :, :l] - out[1, :, :l]).abs().max() > 1e-6


# --- composition -------------------------------------------------------------

SCHEMA = dict(background_prompt='a forest', style_start_prompt='',
              style_end_prompt='', style_blend=(0.0, 1.0))


def test_sdxl_composition_end_to_end(enc, unets, vaes):
    """``encode_schema_sdxl`` through CompositeGuidance: per-row pooled
    embeddings; the guided ε equals JAX's, and a 3-step Euler run is
    finite."""
    from flexdiffuse_tpu.composition import EntitySchema as JEntity
    from flexdiffuse_tpu.composition import Schema as JSchema
    jnet, params, port = unets['base']
    ents = [('a bear', (0, 0), (32, 32)), ('a deer', (32, 32), (32, 32))]
    jschema = JSchema(*SCHEMA.values(), [JEntity(*e) for e in ents])
    tschema = Schema(*SCHEMA.values(), [EntitySchema(*e) for e in ents])
    jg = jsdxl.encode_schema_sdxl(jschema, enc['jax'], (32, 32),
                                  guidance_scale=5.0, size=(64, 64), scale=2)
    tg = tsdxl.encode_schema_sdxl(tschema, enc['port'], (32, 32),
                                  guidance_scale=5.0, size=(64, 64), scale=2)
    assert tg.pooled_stack.shape[0] == 3  # bg + 2 entities
    lat = np.random.default_rng(11).normal(size=(1, 32, 32, 4)).astype(
        np.float32)
    apply = _apply(jnet)
    want = jg.noise_pred(lambda l, t, c, a: apply(params, l, t, c, a),
                         jnp.asarray(lat), jnp.float32(701.0),
                         jnp.float32(0.2))
    with torch.no_grad():
        got = tg.noise_pred(port, torch.from_numpy(lat), torch.tensor(701.0),
                            torch.tensor(0.2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    pipe = FlexPipeline(port, vaes[2], scheduler='euler',
                        latent_scale=tsdxl.SDXL_LATENT_SCALE)
    out = pipe(tg, steps=3, init_size=(64, 64), output_type='np',
               generator=torch.Generator().manual_seed(2))
    assert out.images.shape[0] == 1 and np.isfinite(out.images).all()


# --- the SGM LoRA merge ------------------------------------------------------

def _sgm_lora(unet_config, te1=TINY_TEXT, te2=TINY_BIGG_TEXT, rank=2,
              seed=12):
    """A kohya SDXL LoRA: SGM-named attention modules of every transformer
    of ``unet_config`` and text layers of encoder 1 (config ``te1``) and
    encoder 2 (``te2``)."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, d_in, d_out):
        sd[f'{name}.lora_down.weight'] = rng.normal(
            size=(rank, d_in)).astype(np.float32)
        sd[f'{name}.lora_up.weight'] = rng.normal(
            size=(d_out, rank)).astype(np.float32) * 0.1
        sd[f'{name}.alpha'] = np.array(1.0, np.float32)

    with torch.device('meta'):
        named = dict(tm.UNet2DCondition(unet_config).named_modules())
    for sgm, port_name in tlora.sgm_block_map(unet_config).items():
        ch = named[port_name].proj_in.in_channels
        base = f'lora_unet_{sgm}_transformer_blocks_0'
        put(f'{base}_attn1_to_q', ch, ch)
        put(f'{base}_attn2_to_k', unet_config.cross_attention_dim, ch)
        put(f'{base}_ff_net_2', 4 * ch, ch)
        put(f'lora_unet_{sgm}_proj_in', ch, ch)
    put('lora_te1_text_model_encoder_layers_1_mlp_fc1', te1.hidden_size,
        te1.intermediate_size)
    put('lora_te2_text_model_encoder_layers_0_self_attn_q_proj',
        te2.hidden_size, te2.hidden_size)
    return sd


def test_sgm_lora_merge_matches_jax(enc, unets):
    """SGM ``lora_unet_*`` modules into the SDXL UNet and ``lora_te1_`` /
    ``lora_te2_`` into the two encoders, merged as JAX merges them (every
    weight within 1e-6 of the bridged JAX merge)."""
    jnet, params, _ = unets['base']
    sd = _sgm_lora(T_XL)
    unet = _port(tm.UNet2DCondition, T_XL, params)
    t1 = _port(tm.CLIPTextModel, tm.TINY_TEXT, enc['p1'])
    t2 = _port(tm.CLIPTextModel, tm.TINY_BIGG_TEXT, enc['p2'])
    done = tlora.apply_lora(unet, t1, sd, scale=0.8, text2_model=t2,
                            unet_config=T_XL)
    assert {tag.split(':')[0] for tag in done} == {'unet', 'te', 'te2'}
    ju, j1, j2 = jlora.apply_lora(params, enc['p1'], sd, scale=0.8,
                                  text2_params=enc['p2'],
                                  unet_config=XL)
    for model, tree, cfg in ((unet, ju, XL),
                             (t1, j1, TINY_TEXT), (t2, j2, TINY_BIGG_TEXT)):
        want = params_to_state_dict(_np(tree), cfg)
        for name, w in model.state_dict().items():
            np.testing.assert_allclose(w.numpy(), want[name].numpy(),
                                       rtol=0, atol=1e-6, err_msg=name)
    before = params_to_state_dict(_np(params), XL)
    changed = [k for k, w in unet.state_dict().items()
               if not torch.equal(w, before[k])]
    assert len(changed) == 4 * len(tlora.sgm_block_map(XL))


# --- the published geometries ------------------------------------------------

@pytest.mark.parametrize('name', ['unet', 'refiner', 'bigg'])
def test_published_param_counts(name):
    """On the meta device: SDXL_UNET has 2,567,463,684 parameters; the
    refiner UNet and OpenCLIP bigG text tower as many as their checkpoint
    manifests."""
    cls, cfg, want = {
        'unet': (tm.UNet2DCondition, tm.SDXL_UNET, 2_567_463_684),
        'refiner': (tm.UNet2DCondition, tm.SDXL_REFINER_UNET,
                    man.param_count(man.sdxl_refiner_unet_manifest())),
        'bigg': (tm.CLIPTextModel, tm.OPENCLIP_BIGG_TEXT,
                 man.param_count(man.sdxl_text_encoder_2_manifest())),
    }[name]
    with torch.device('meta'):
        model = cls(cfg)
    assert sum(p.numel() for p in model.parameters()) == want
