"""PyTorch port: regional composition, inpainting, debug mode and DDIM η,
held against the JAX package on the CPU on tiny models.

(a) ``entity_masks``, ``encode_schema``, the schema's JSON and
    ``prepare_latent_mask`` equal the JAX package's.
(b) ``CompositeGuidance.noise_pred`` equals JAX's through the two tiny
    UNets, and a compose run of ``FlexPipeline`` with injected noise matches
    JAX's: latents to 1e-4, uint8 images within one level.
(c) Latent inpainting (PNDM, LMS, DDIM at η 0.5), 9-channel inpainting and
    debug mode match JAX with its key chain replayed: ``key, k_enc,
    k_noise, k_scan = split(key, 4)``, then ``k, sub, k_inp = split(k, 3)``
    per scan row.
(d) ``Runner.compose`` and ``Runner.gen(mask=, debug=)`` run end to end.
"""
import dataclasses
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu.composition import Schema as JSchema
from flexdiffuse_tpu.composition import encode_schema as jax_encode_schema
from flexdiffuse_tpu.models import TINY_UNET, UNet2DCondition
from flexdiffuse_tpu.pipeline.flex import \
    prepare_latent_mask as jax_prepare_latent_mask
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.composition import (EntitySchema, Schema,
                                               encode_schema)
from flexdiffuse_tpu_torch.pipeline import (CompositeGuidance, FlexPipeline,
                                            entity_masks,
                                            prepare_latent_mask)
from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_slice import (_compare, _guides, _np_tree,  # noqa: F401
                                    models, runner)

T, D = 77, 32
RECTS = [((0, 0), (4, 4)), ((2, 3), (5, 2)), ((6, 6), (4, 4)),
         ((1, 0), (2, 8))]


def test_entity_masks_match_jax():
    for rects in (RECTS, RECTS[:1], []):
        for hw in ((8, 8), (6, 10)):
            np.testing.assert_array_equal(
                entity_masks(rects, hw).numpy(),
                np.asarray(jp.entity_masks(rects, hw)))


def test_schema_json_round_trip_and_matches_jax():
    schema = Schema('a forest', 'oil painting', 'watercolour', (0.2, 0.9),
                    [EntitySchema('a deer', (64, 128), (256, 192), 0.7),
                     EntitySchema('a fox', (0, 0), (128, 128))])
    text = schema.json()
    assert Schema.from_json(text) == schema
    assert JSchema.from_json(text).json() == text


class _Encoder:
    """A stand-in CLIP encoder for both packages: each prompt maps to fixed
    [1, T, D] embeddings (seeded by the prompt's CRC)."""

    def __init__(self, to):
        self.to = to

    def prompt(self, text):
        rng = np.random.default_rng(zlib.crc32(text.encode()))
        return self.to(rng.standard_normal((1, T, D)).astype(np.float32))


TORCH_ENC, JAX_ENC = _Encoder(torch.from_numpy), _Encoder(jnp.asarray)


def _schemas():
    ents = [EntitySchema('a deer', (2, 4), (8, 6), 0.8),
            EntitySchema('a fox', (6, 0), (10, 8), 1.0)]
    return [Schema('a forest', '', '', (0.0, 1.0), ents),
            Schema('a forest', 'oil', 'ink', (0.25, 0.75), ents[:1]),
            Schema('a field', '', '', (0.0, 1.0), [])]


def _jax_schema(schema):
    return JSchema.from_json(schema.json())


@pytest.mark.parametrize('index', range(3))
def test_encode_schema_matches_jax(index):
    schema = _schemas()[index]
    kw = dict(guidance_scale=7.5, cfg=True, style_strength=0.6, scale=2)
    got = encode_schema(schema, TORCH_ENC, (8, 8), **kw)
    want = jax_encode_schema(_jax_schema(schema), JAX_ENC, (8, 8), **kw)
    for name in ('background', 'entities', 'masks', 'blends', 'uncond',
                 'style_start', 'style_end', 'style_range', 'style_strength'):
        g, w = getattr(got, name), getattr(want, name)
        assert (g is None) == (w is None), name
        if g is not None:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=name)
    assert got.guidance_scale == float(want.guidance_scale)


@pytest.mark.parametrize('shape,hw', [((16, 16), (8, 8)),
                                      ((20, 12, 3), (8, 8)),
                                      ((2, 16, 16), (8, 8)),
                                      ((4, 4), (8, 8))])
def test_prepare_latent_mask_matches_jax(shape, hw):
    """Linear resizing, antialiased when shrinking, as jax.image.resize;
    within 1e-6 (observed ≤ 1.2e-7)."""
    mask = np.random.default_rng(len(shape)).uniform(size=shape).astype(
        np.float32)
    np.testing.assert_allclose(prepare_latent_mask(mask, hw).numpy(),
                               np.asarray(jax_prepare_latent_mask(mask, hw)),
                               rtol=0, atol=1e-6)
    plane = mask if mask.ndim == 2 else mask[0]
    pil = Image.fromarray((plane * 255).astype(np.uint8))
    np.testing.assert_allclose(prepare_latent_mask(pil, hw).numpy(),
                               np.asarray(jax_prepare_latent_mask(pil, hw)),
                               rtol=0, atol=1e-6)


def _composites(batch_entities=2, style=False, cfg=True):
    """The same CompositeGuidance in both packages."""
    rng = np.random.default_rng(batch_entities + 10 * style + 100 * cfg)
    arr = lambda *s: rng.standard_normal(s).astype(np.float32)
    bg, unc, ents = arr(1, T, D), arr(1, T, D), arr(batch_entities, T, D)
    rects = RECTS[:batch_entities]
    blends = rng.uniform(0.3, 1.0, batch_entities).astype(np.float32)
    style_kw = {}
    if style:
        style_kw = dict(style_start=arr(1, T, D), style_end=arr(1, T, D),
                        style_range=np.array([0.2, 0.9], np.float32),
                        style_strength=np.float32(0.5))
    jguide = jp.CompositeGuidance(
        background=jnp.asarray(bg), entities=jnp.asarray(ents),
        masks=jp.entity_masks(rects, (8, 8)), blends=jnp.asarray(blends),
        uncond=jnp.asarray(unc), guidance_scale=jnp.float32(7.5), cfg=cfg,
        **{k: jnp.asarray(v) for k, v in style_kw.items()})
    tguide = CompositeGuidance(
        background=torch.from_numpy(bg), entities=torch.from_numpy(ents),
        masks=entity_masks(rects, (8, 8)), blends=torch.from_numpy(blends),
        uncond=torch.from_numpy(unc), guidance_scale=7.5, cfg=cfg,
        **{k: torch.as_tensor(v) for k, v in style_kw.items()})
    return jguide, tguide


@pytest.mark.parametrize('entities,style,cfg,batch', [
    (2, False, True, 1), (1, True, True, 2), (3, False, False, 1)])
def test_composite_noise_pred_matches_jax(models, entities, style, cfg,
                                          batch):
    """One composite ε through the two tiny UNets, within 1e-4 (CFG 7.5
    scales the UNets' ~2e-6 gap; observed ≤ 2.3e-5)."""
    jguide, tguide = _composites(entities, style, cfg)
    lat = np.random.default_rng(5).standard_normal(
        (batch, 8, 8, 4)).astype(np.float32)
    unet, params = models['unet'], models['unet_params']
    t = np.float32(601.0)
    progress = np.float32(0.4)
    want = jguide.noise_pred(lambda *a: unet.apply(params, *a),
                             jnp.asarray(lat), jnp.asarray(t),
                             jnp.asarray(progress))
    with torch.no_grad():
        got = tguide.noise_pred(models['port_unet'], torch.from_numpy(lat),
                                torch.tensor(t), torch.tensor(progress))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize('cfg,batch', [(True, 1), (True, 2), (False, 2)])
def test_composite_sdxl_added_rows_match_jax(cfg, batch):
    """SDXL's ``pooled_stack``/``uncond_pooled``/``time_ids`` on the
    composite guide: the ``added_cond`` rows beside the stack's (``[uncond,]
    background, entities`` per latent row) equal JAX's, and its noise
    function receives them."""
    jguide, tguide = _composites(2, cfg=cfg)
    rng = np.random.default_rng(21)
    pooled = rng.standard_normal((3, 24)).astype(np.float32)
    upooled = rng.standard_normal((1, 24)).astype(np.float32)
    tids = np.array([[64, 64, 0, 0, 64, 64]], np.float32)
    jguide = jguide.replace(pooled_stack=jnp.asarray(pooled),
                            uncond_pooled=jnp.asarray(upooled),
                            time_ids=jnp.asarray(tids))
    tguide = tguide.replace(pooled_stack=torch.from_numpy(pooled),
                            uncond_pooled=torch.from_numpy(upooled),
                            time_ids=torch.from_numpy(tids))
    n = 3 + cfg
    want = jguide._added(batch, n)
    got = tguide._added(batch, n)
    for key in ('text_embeds', 'time_ids'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    seen = []

    def noise_fn(lat, t, ctx, added_cond=None):
        seen.append(added_cond)
        return torch.zeros(lat.shape)
    tguide.noise_pred(noise_fn, torch.zeros((batch, 8, 8, 4)),
                      torch.tensor(501.0))
    assert seen[0]['text_embeds'].shape == (batch * n, 24)
    np.testing.assert_array_equal(seen[0]['text_embeds'].numpy(),
                                  np.asarray(want['text_embeds']))


def test_unported_guidance_fields_name_their_step(models):
    """The CFG interval and CFG rescale fields (step 9 until the tenth
    slice) are taken as the JAX guide takes them: rescale's gate refuses a
    phi without its flag, and a rescaled composite prediction matches JAX's
    within 1e-4. (SDXL's fields, step 11 until the twelfth slice, are held
    by test_composite_sdxl_added_rows_match_jax.)"""
    jguide, tguide = _composites(1)
    interval = dataclasses.replace(tguide, cfg_interval=True, cfg_from=0.1,
                                   cfg_to=0.6)
    assert (interval.cfg_interval, interval.cfg_from, interval.cfg_to) == \
        (True, 0.1, 0.6)
    for mod_guide in (jguide, tguide):
        with pytest.raises(ValueError, match='rescale'):
            mod_guide.replace(guidance_rescale=0.7)
    jg = jguide.replace(rescale=True, guidance_rescale=jnp.float32(0.7))
    tg = tguide.replace(rescale=True, guidance_rescale=0.7)
    lat = np.random.default_rng(5).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    unet, params = models['unet'], models['unet_params']
    want = jg.noise_pred(lambda *a: unet.apply(params, *a),
                         jnp.asarray(lat), jnp.float32(501.0),
                         jnp.float32(0.3))
    with torch.no_grad():
        got = tg.noise_pred(models['port_unet'], torch.from_numpy(lat),
                            torch.tensor(501.0), torch.tensor(0.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def _rows(key, length, shape):
    """JAX's per-row draws: the DDIM variance noise (``sub``) and the
    inpainting anchor noise (``k_inp``) at every scan position."""
    _, _, _, k = jax.random.split(key, 4)
    subs, inps = [], []
    for _ in range(length):
        k, sub, k_inp = jax.random.split(k, 3)
        subs.append(torch.from_numpy(np.array(
            jax.random.normal(sub, shape, jnp.float32))))
        inps.append(torch.from_numpy(np.array(
            jax.random.normal(k_inp, shape, jnp.float32))))
    return subs, inps


def _pipes(models, kind, config=None, jconfig=None):
    return (jp.FlexPipeline(models['unet'], models['unet_params'],
                            models['vae'], models['vae_params'],
                            scheduler=kind, scheduler_config=jconfig),
            FlexPipeline(models['port_unet'], models['port_vae'],
                         scheduler=kind, scheduler_config=config))


def test_compose_pipeline_matches_jax(models):
    """Composite guidance through the whole loop (PNDM, 4 steps, 2
    entities, injected initial latents)."""
    jpipe, tpipe = _pipes(models, 'pndm')
    jguide, tguide = _composites(2, style=True)
    noise = np.random.default_rng(11).standard_normal(
        (1, 8, 8, 4)).astype(np.float32)
    jlat = jpipe(jguide, steps=4, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(1),
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)


def _left_half(size=16):
    mask = np.zeros((size, size), np.float32)
    mask[:, :size // 2] = 1.0
    return mask


def _pixels(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)


INPAINT = [('pndm', 0.0, 0.6), ('lms', 0.0, 0.7), ('ddim', 0.5, 0.8)]


@pytest.mark.parametrize('kind,eta,strength', INPAINT)
def test_latent_inpainting_matches_jax(models, kind, eta, strength):
    """Latent inpainting (the kept half re-anchored every step) with JAX's
    key chain replayed; DDIM at η 0.5 also replays the variance noise."""
    jpipe, tpipe = _pipes(models, kind)
    jguide, tguide = _guides(batch=1, seed=3)
    pixels, mask = _pixels(4), _left_half()
    key = jax.random.PRNGKey(21)
    _, k_enc, k_noise, _ = jax.random.split(key, 4)
    shape = (1, 8, 8, 4)
    posterior = np.array(jax.random.normal(k_enc, shape, jnp.float32))
    noise = np.array(jax.random.normal(k_noise, shape, jnp.float32))
    subs, inps = _rows(key, jpipe.schedule(4).length, shape)
    jlat = jpipe(jguide, steps=4, init_image=jnp.asarray(pixels),
                 strength=strength, eta=eta, key=key, mask=mask,
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_image=pixels, strength=strength,
                 eta=eta, mask=mask, noise=torch.from_numpy(noise),
                 posterior_noise=torch.from_numpy(posterior),
                 variance_noise=subs, inpaint_noise=inps,
                 output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)


@pytest.fixture(scope='module')
def inpaint_models(models):
    """A 9-channel tiny UNet (mask + masked-image latents as inputs) in both
    packages."""
    cfg = dataclasses.replace(TINY_UNET, in_channels=9)
    unet = UNet2DCondition(cfg)
    params = jax.jit(lambda k: unet.init(
        k, jnp.zeros((2, 8, 8, 9)), jnp.zeros((2,)),
        jnp.zeros((2, T, D))))(jax.random.PRNGKey(3))
    port = tm.UNet2DCondition(dataclasses.replace(tm.TINY_UNET,
                                                  in_channels=9)).eval()
    port.load_state_dict(params_to_state_dict(_np_tree(params), cfg),
                         strict=True)
    return dict(models, unet=unet, unet_params=params, port_unet=port)


@pytest.mark.parametrize('strength', [1.0, 0.6])
def test_nine_channel_inpainting_matches_jax(inpaint_models, strength):
    """The inpainting-checkpoint path: the masked image's posterior noise
    (``k_enc``), at strength < 1 the original's (``fold_in(k_enc, 1)``),
    and the initial or add_noise noise (``k_noise``), replayed."""
    jpipe, tpipe = _pipes(inpaint_models, 'pndm')
    jguide, tguide = _guides(batch=2, seed=6)
    pixels, mask = _pixels(7), _left_half()
    key = jax.random.PRNGKey(33)
    _, k_enc, k_noise, _ = jax.random.split(key, 4)
    normal = lambda k, s: torch.from_numpy(np.array(
        jax.random.normal(k, s, jnp.float32)))
    jlat = jpipe(jguide, steps=4, init_image=jnp.asarray(pixels),
                 strength=strength, key=key, mask=mask,
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_image=pixels, strength=strength,
                 mask=mask, noise=normal(k_noise, (2, 8, 8, 4)),
                 mask_posterior_noise=normal(k_enc, (1, 8, 8, 4)),
                 posterior_noise=normal(jax.random.fold_in(k_enc, 1),
                                        (1, 8, 8, 4)),
                 output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)


def test_debug_mode_matches_jax(models):
    """Debug decodes the latents after every step from t_start on: one
    image per recorded step and sample (img2img at strength 0.5 on PNDM:
    3 of the 5 positions), each within one uint8 level of JAX's."""
    jpipe, tpipe = _pipes(models, 'pndm')
    jguide, tguide = _guides(batch=2, seed=8)
    pixels = _pixels(9)
    key = jax.random.PRNGKey(44)
    _, k_enc, k_noise, _ = jax.random.split(key, 4)
    posterior = np.array(jax.random.normal(k_enc, (1, 8, 8, 4), jnp.float32))
    noise = np.array(jax.random.normal(k_noise, (2, 8, 8, 4), jnp.float32))
    want = jpipe(jguide, steps=4, init_image=jnp.asarray(pixels),
                 strength=0.5, key=key, debug=True).images
    got = tpipe(tguide, steps=4, init_image=pixels, strength=0.5,
                noise=torch.from_numpy(noise),
                posterior_noise=torch.from_numpy(posterior),
                debug=True).images
    assert len(got) == len(want) == 2 * 3
    for g, w in zip(got, want):
        assert g.size == w.size == (16, 16)
        diff = np.asarray(g).astype(np.int16) - np.asarray(w)
        assert np.abs(diff).max() <= 1


def test_debug_mode_np_matches_jax(models):
    """``debug=True`` with ``output_type='np'``: every recorded step from
    t_start on, decoded to float32 [0, 1] and concatenated on axis 0, as
    JAX's ``_package`` (``flexdiffuse_tpu/pipeline/flex.py:769-782``);
    within one uint8 level of JAX's, as the 'pil' case."""
    jpipe, tpipe = _pipes(models, 'pndm')
    jguide, tguide = _guides(batch=2, seed=8)
    pixels = _pixels(9)
    key = jax.random.PRNGKey(44)
    _, k_enc, k_noise, _ = jax.random.split(key, 4)
    posterior = np.array(jax.random.normal(k_enc, (1, 8, 8, 4), jnp.float32))
    noise = np.array(jax.random.normal(k_noise, (2, 8, 8, 4), jnp.float32))
    want = jpipe(jguide, steps=4, init_image=jnp.asarray(pixels),
                 strength=0.5, key=key, debug=True, output_type='np').images
    got = tpipe(tguide, steps=4, init_image=pixels, strength=0.5,
                noise=torch.from_numpy(noise),
                posterior_noise=torch.from_numpy(posterior), debug=True,
                output_type='np').images
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert got.shape == np.asarray(want).shape == (2 * 3, 16, 16, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1.0 / 255)


def test_prk_rejects_img2img(models):
    _, tpipe = _pipes(models, 'pndm', SchedulerConfig(skip_prk_steps=False))
    _, tguide = _guides()
    with pytest.raises(NotImplementedError, match='PRK'):
        tpipe(tguide, steps=4, init_image=_pixels(1))


def test_runner_compose_end_to_end(runner):
    """Rows as the UI's table gives them: a bad row and an empty prompt are
    skipped; ``batches`` images of ``init_size``; the reference's file
    names."""
    rows = [['a deer', 0, 0, 8, 8, 0.8], ['bad row'],
            [' ', 0, 0, 4, 4, 1.0], ['a fox', 8, 8, 8, 8, '1.0']]
    images, grid = runner.compose('a forest', rows, init_size=(16, 16),
                                  steps=2, batches=2, seed=5, save=True)
    assert len(images) == 2 and grid.size == (32, 16)
    assert all(im.size == (16, 16) for im in images)
    assert any('ct2i_st2_gs8_se5' in f for f in os.listdir(runner.output_dir))
    debug, _ = runner.compose('a forest', rows[:1], init_size=(16, 16),
                              steps=2, batches=1, seed=5, save=False,
                              debug=True)
    assert len(debug) == 3                       # PLMS: steps + 1 positions


def test_runner_gen_mask_and_debug(runner):
    init = _pixels(12)
    images, _ = runner.gen(prompt='a deer', init_image=init, mask=_left_half(),
                           strength=0.6, steps=4, seed=3, save=True)
    assert len(images) == 1 and images[0].size == (16, 16)
    assert any('inp_ds60' in f for f in os.listdir(runner.output_dir))
    images, _ = runner.gen(prompt='a deer', steps=3, init_size=(16, 16),
                           samples=2, seed=3, debug=True, save=False)
    assert len(images) == 2 * 4                   # 2 batches × 4 positions
