"""PyTorch port: the guided-generation slice end to end on the CPU.

(a) ``tests/test_golden.py``'s loop (TINY_UNET, CFG 8, 4 PNDM steps)
    through the port's UNet and scheduler hits the committed golden.
(b) ``FlexPipeline`` txt2img (with ``noise=``) and img2img (with the two
    noises replayed from JAX's ``jax.random.split(key, 4)``) match the JAX
    pipeline on tiny models: latents to 1e-4, uint8 images within 1 level;
    ``return_dict=False`` returns JAX's ``(images, False)``.
(c) ``Runner.from_models(...).gen`` with a PIL guide returns PIL images of
    the requested size.
(d) The host-side copies (tokenizers, image prep) equal the originals.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu import schedulers as jsch
from flexdiffuse_tpu.models import (TINY_UNET, TINY_VAE, AutoencoderKL,
                                    UNet2DCondition)
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.pipeline import FlexPipeline, SimpleGuidance
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens',
                      'latents_pndm.npy')
T, D = 77, 32


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope='module')
def models():
    """The golden's UNet params (PRNGKey(42) init, as test_golden.py) and a
    tiny VAE, in both packages."""
    unet = UNet2DCondition(TINY_UNET)
    ctx = jax.random.normal(jax.random.PRNGKey(8), (2, 77, 32), jnp.float32)
    unet_params = jax.jit(lambda k: unet.init(
        k, jnp.zeros((2, 8, 8, 4)), jnp.zeros((2,)), ctx))(
            jax.random.PRNGKey(42))
    vae = AutoencoderKL(TINY_VAE)
    k = jax.random.PRNGKey(0)
    vae_params = jax.jit(lambda kk: vae.init(kk, jnp.zeros((1, 16, 16, 3)),
                                             kk))(k)
    port_unet = tm.UNet2DCondition(tm.TINY_UNET).eval()
    port_unet.load_state_dict(
        params_to_state_dict(_np_tree(unet_params), TINY_UNET), strict=True)
    port_vae = tm.AutoencoderKL(tm.TINY_VAE).eval()
    port_vae.load_state_dict(
        params_to_state_dict(_np_tree(vae_params), TINY_VAE), strict=True)
    return dict(unet=unet, unet_params=unet_params, vae=vae,
                vae_params=vae_params, ctx=np.array(ctx),
                port_unet=port_unet, port_vae=port_vae)


def test_golden_pndm_loop(models):
    """Observed max|Δ| to the golden 4.4e-5 at max|x| 15.8 (relative 3e-6),
    so the bound is 1e-4; the golden test's own 1e-5 does not hold across
    the two frameworks. The gap is the UNet's, not the scheduler's: on the
    same input at each of the 5 steps the CFG-combined ε of the two UNets
    differs by 1.1e-5 to 1.7e-5 (CFG 8 amplifies their ~2e-6), while the two
    PLMS steppers fed the same ε agree to 1 ulp
    (test_pndm_step_matches_jax_on_the_same_eps)."""
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, 8, 8, 4),
                                       jnp.float32))
    ctx = torch.from_numpy(models['ctx'])
    unet = models['port_unet']
    sch = schedulers.make('pndm', 4)
    lat = torch.from_numpy(lat.copy())
    state = schedulers.init_state(sch, lat.shape, lat.dtype)
    with torch.no_grad():
        for i in range(sch.length):
            xin = schedulers.scale_model_input(sch, lat, i)
            eps = unet(torch.cat([xin, xin]), sch.timesteps[i].expand(2), ctx)
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + 8.0 * (eps_c - eps_u)
            state, lat = schedulers.step(sch, state, eps, i, i, lat)
    np.testing.assert_allclose(lat.numpy(), np.load(GOLDEN), rtol=0,
                               atol=1e-4)


def test_pndm_step_matches_jax_on_the_same_eps(models):
    """The golden loop's scheduler arithmetic alone: the JAX loop's ε at
    every step, fed to the port's PLMS step, reproduces the JAX latents.
    Observed: bit-equal at steps 0-2, 9.5e-7 (1 ulp at |x| ≈ 15.8) at steps
    3-4 from the order of the Adams-Bashforth sum; the bound is 2 ulp."""
    unet, params = models['unet'], models['unet_params']
    ctx = jnp.asarray(models['ctx'])
    jsc, tsch = jsch.make('pndm', 4), schedulers.make('pndm', 4)
    jlat = jax.random.normal(jax.random.PRNGKey(7), (1, 8, 8, 4), jnp.float32)
    tlat = torch.from_numpy(np.array(jlat))
    jstate = jsch.init_state(jsc, jlat.shape, jlat.dtype)
    tstate = schedulers.init_state(tsch, tlat.shape, tlat.dtype)
    apply = jax.jit(unet.apply)
    for i in range(jsc.length):
        eps = apply(params, jnp.concatenate([jlat, jlat]),
                    jnp.broadcast_to(jsc.timesteps[i], (2,)), ctx)
        eps_u, eps_c = jnp.split(eps, 2)
        eps = eps_u + 8.0 * (eps_c - eps_u)
        jstate, jlat = jsch.step(jsc, jstate, eps, jnp.int32(i),
                                 jnp.int32(i), jlat, None, 0.0)
        tstate, tlat = schedulers.step(tsch, tstate,
                                       torch.from_numpy(np.array(eps)), i, i,
                                       tlat)
        np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=0,
                                   atol=2e-6, err_msg=f'step {i}')


def test_pndm_schedule_tables_match_jax():
    for steps in (4, 25, 30):
        ref = jsch.make('pndm', steps)
        got = schedulers.make('pndm', steps)
        assert got.length == ref.length
        np.testing.assert_array_equal(got.timesteps.numpy(),
                                      np.asarray(ref.timesteps))
        np.testing.assert_array_equal(got.alphas_cumprod.numpy(),
                                      np.asarray(ref.alphas_cumprod))
        for strength in (0.3, 0.6, 1.0):
            assert (schedulers.init_timestep_info(got, strength, steps) ==
                    jsch.init_timestep_info(ref, strength, steps))


def _guides(batch=1, seed=0):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(batch, T, D)).astype(np.float32)
    unc = rng.normal(size=(1, T, D)).astype(np.float32)
    jguide = jp.SimpleGuidance(embeddings=jnp.asarray(emb),
                               uncond=jnp.asarray(unc),
                               guidance_scale=jnp.float32(8.0), cfg=True)
    tguide = SimpleGuidance(embeddings=torch.from_numpy(emb),
                            uncond=torch.from_numpy(unc), guidance_scale=8.0)
    return jguide, tguide


@pytest.fixture(scope='module')
def pipes(models):
    jpipe = jp.FlexPipeline(models['unet'], models['unet_params'],
                            models['vae'], models['vae_params'],
                            scheduler='pndm')
    tpipe = FlexPipeline(models['port_unet'], models['port_vae'],
                         scheduler='pndm')
    return jpipe, tpipe


def _compare(jpipe, tpipe, jlat, tlat):
    """Latents to 1e-4; decoded uint8 images within one level. Observed:
    txt2img 6.0e-5 (max|x| 20.5), img2img 1.0e-5 at strength 0.6 and
    3.2e-5 at 1.0; the uint8 images were identical."""
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=0,
                               atol=1e-4)
    ju8 = np.asarray(jpipe.decode_u8_device(jlat)).astype(np.int16)
    tu8 = tpipe.decode_u8_device(tlat).numpy()
    assert tu8.dtype == np.uint8 and tu8.shape == ju8.shape
    assert np.abs(tu8.astype(np.int16) - ju8).max() <= 1


def test_pipeline_txt2img_matches_jax(pipes):
    jpipe, tpipe = pipes
    jguide, tguide = _guides(batch=2)
    noise = np.random.default_rng(1).normal(size=(2, 8, 8, 4)).astype(
        np.float32)
    jlat = jpipe(jguide, steps=4, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(5),
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)


@pytest.mark.parametrize('output_type', ['latent', 'np'])
def test_pipeline_output_fields_match_jax(pipes, output_type):
    """The output answers ``['sample']`` and ``['images']`` with its images
    and carries ``nsfw_content_detected`` (``[False]`` per image), with
    ``KeyError`` for any other key, as JAX's ``FlexPipelineOutput``
    (``flexdiffuse_tpu/pipeline/flex.py:44-58``) on the same call."""
    jpipe, tpipe = pipes
    jguide, tguide = _guides(batch=2, seed=6)
    noise = np.random.default_rng(7).normal(size=(2, 8, 8, 4)).astype(
        np.float32)
    jout = jpipe(jguide, steps=2, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(2),
                 output_type=output_type)
    tout = tpipe(tguide, steps=2, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type=output_type)
    for out in (jout, tout):
        assert out['sample'] is out.images and out['images'] is out.images
        assert out['nsfw_content_detected'] is out.nsfw_content_detected
        with pytest.raises(KeyError):
            out['latents']
    assert tout.nsfw_content_detected == jout.nsfw_content_detected \
        == [False] * 2


@pytest.mark.parametrize('output_type', ['latent', 'np'])
def test_pipeline_return_dict_false_matches_jax(pipes, output_type):
    """``return_dict=False`` returns ``(images, False)``, as JAX's
    ``__call__`` (``flexdiffuse_tpu/pipeline/flex.py:796-797``), with the
    images the dict form gives."""
    jpipe, tpipe = pipes
    jguide, tguide = _guides(batch=1, seed=4)
    noise = np.random.default_rng(5).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    jout = jpipe(jguide, steps=3, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(1),
                 output_type=output_type, return_dict=False)
    tout = tpipe(tguide, steps=3, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type=output_type,
                 return_dict=False)
    assert isinstance(tout, tuple) and len(tout) == 2
    assert tout[1] is False and jout[1] is False
    as_dict = tpipe(tguide, steps=3, init_size=(16, 16),
                    noise=torch.from_numpy(noise),
                    output_type=output_type).images
    if output_type == 'latent':
        _compare(jpipe, tpipe, jout[0], tout[0])
        assert torch.equal(tout[0], as_dict)
    else:
        assert tout[0].shape == np.asarray(jout[0]).shape == (1, 16, 16, 3)
        np.testing.assert_allclose(tout[0], np.asarray(jout[0]), rtol=0,
                                   atol=1.0 / 255)
        np.testing.assert_array_equal(tout[0], as_dict)


@pytest.mark.parametrize('strength', [0.6, 1.0])
def test_pipeline_img2img_matches_jax(pipes, strength):
    """The two noises the JAX pipeline draws from its key (flex.py:593)
    are replayed and handed to the port."""
    jpipe, tpipe = pipes
    jguide, tguide = _guides(batch=1, seed=2)
    pixels = np.random.default_rng(3).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(9)
    _, k_enc, k_noise, _ = jax.random.split(key, 4)
    posterior = np.array(jax.random.normal(k_enc, (1, 8, 8, 4), jnp.float32))
    noise = np.array(jax.random.normal(k_noise, (1, 8, 8, 4), jnp.float32))
    jlat = jpipe(jguide, steps=4, init_image=jnp.asarray(pixels),
                 strength=strength, key=key, output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_image=pixels, strength=strength,
                 noise=torch.from_numpy(noise),
                 posterior_noise=torch.from_numpy(posterior),
                 output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)


@pytest.fixture(scope='module')
def runner(tmp_path_factory):
    torch.manual_seed(0)
    out_dir = str(tmp_path_factory.mktemp('outputs'))
    return Runner.from_models(
        tm.CLIPTextModel(tm.TINY_TEXT).eval(),
        tm.CLIPVisionModel(tm.TINY_VISION).eval(),
        tm.UNet2DCondition(tm.TINY_UNET).eval(),
        tm.AutoencoderKL(tm.TINY_VAE).eval(), FakeTokenizer(),
        config=RunConfig(output_dir=out_dir))


def _pil(size, seed):
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, (size, size, 3), np.uint8))


def test_runner_gen_with_pil_guide(runner):
    images, grid = runner.gen(prompt='a deer', guide=_pil(64, 0), steps=2,
                              init_size=(16, 16), samples=2, seed=1337,
                              save=True)
    assert len(images) == 2
    assert all(isinstance(im, Image.Image) and im.size == (16, 16)
               for im in images)
    assert grid.size == (32, 16)
    files = os.listdir(runner.output_dir)
    assert any('t2i_itm50' in f and '_st2_gs8_se1337' in f for f in files)


def test_runner_gen_img2img_and_seed(runner):
    init = np.random.default_rng(4).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)
    kw = dict(prompt='a deer', guide=_pil(64, 1), init_image=init,
              strength=0.6, steps=4, seed=7, save=False,
              negative_prompt='blurry', mapping_concepts='deer')
    a, _ = runner.gen(**kw)
    b, _ = runner.gen(**kw)
    assert a[0].size == (16, 16)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))


@pytest.mark.parametrize('name,value,want', [
    ('cfg_interval', (0.0, 0.6), dict(cfg_interval=True, cfg_from=0.0,
                                      cfg_to=0.6)),
    ('hires_scale', 1.5, None),
    ('pag_scale', 3.0, dict(pag=True, pag_scale=3.0))])
def test_runner_takes_the_sampling_keywords(runner, monkeypatch, name, value,
                                            want):
    """The keywords that named ROADMAP step 9 before the tenth slice reach
    the pipeline with the JAX Runner's guidance fields; the hires fix runs
    two passes (the second from the first's latents upscaled 1.5×)."""
    calls = []
    real = runner.pipe.__class__.__call__

    def record(pipe, guidance, **kw):
        calls.append((guidance, kw))
        return real(pipe, guidance, **kw)

    monkeypatch.setattr(runner.pipe.__class__, '__call__', record)
    # A 16² latent: 1.5× is 24, a multiple of 8 (the upscale snaps down).
    images, _ = runner.gen(prompt='a deer', steps=2, init_size=(32, 32),
                           save=False, seed=3, **{name: value})
    if name == 'hires_scale':
        assert [c[1].get('output_type') for c in calls] == ['latent', None]
        assert tuple(calls[1][1]['init_latents'].shape) == (1, 24, 24, 4)
        assert images[0].size == (48, 48)
    else:
        assert len(calls) == 1 and images[0].size == (32, 32)
        assert {k: getattr(calls[0][0], k) for k in want} == want
    if name == 'pag_scale':
        assert runner.pipe.unet.pag_layers == ('mid',)
        runner.disable_pag()


@pytest.mark.parametrize('name,match', [
    ('control_image', 'without a controlnet'),
    ('ip_image', 'no IP-Adapter is loaded'),
    ('ip_embed', 'no IP-Adapter is loaded')])
def test_runner_rejects_conditioning_without_its_model(runner, name, match):
    """A control image without a ControlNet, or an image prompt without an
    IP-Adapter, raises the JAX Runner's ``ValueError``; an unknown keyword
    a ``TypeError``."""
    value = (np.zeros((16, 16, 3), np.float32) if name == 'control_image'
             else np.zeros(32, np.float32) if name == 'ip_embed'
             else _pil(16, 1))
    with pytest.raises(ValueError, match=match):
        runner.gen(prompt='a deer', steps=2, init_size=(16, 16), save=False,
                   **{name: value})
    with pytest.raises(TypeError):
        runner.gen(prompt='a deer', not_a_keyword=1)


def test_host_prep_copies_match_jax(tmp_path):
    """The port's copies of the tokenizers and image prep give the JAX
    package's outputs exactly."""
    import json
    from flexdiffuse_tpu.text import tokenizer as jtok
    from flexdiffuse_tpu.utils import image as jimg
    from flexdiffuse_tpu_torch.text import tokenizer as ttok
    from flexdiffuse_tpu_torch.utils import image as timg
    prompts = ['a deer', 'Deer colorful, fantasy,  intricate', '', 'x ' * 90]
    for vocab in (1000, 49408):
        np.testing.assert_array_equal(ttok.FakeTokenizer(vocab)(prompts),
                                      jtok.FakeTokenizer(vocab)(prompts))
    chars = 'abcdefghijklmnopqrstuvwxyz'
    vocab = {}
    for c in chars:
        vocab[c] = len(vocab)
        vocab[c + '</w>'] = len(vocab)
    for tok in ('ca', 'cat</w>', 'de', 'deer</w>', '<|startoftext|>',
                '<|endoftext|>'):
        vocab[tok] = len(vocab)
    (tmp_path / 'vocab.json').write_text(json.dumps(vocab))
    (tmp_path / 'merges.txt').write_text(
        '\n'.join(['#version: 0.2', 'c a', 'ca t</w>', 'd e', 'e e',
                   'de e', 'dee r</w>']))
    paths = (str(tmp_path / 'vocab.json'), str(tmp_path / 'merges.txt'))
    np.testing.assert_array_equal(
        ttok.CLIPTokenizer(*paths)(['a cat', 'the deer cat']),
        jtok.CLIPTokenizer(*paths)(['a cat', 'the deer cat']))
    for size in ((80, 48), (48, 80), (64, 64)):
        im = _pil(1, 0).resize(size)
        np.testing.assert_array_equal(timg.preprocess(im), jimg.preprocess(im))
        np.testing.assert_array_equal(timg.clip_preprocess(im),
                                      jimg.clip_preprocess(im))
    u8 = np.random.default_rng(0).integers(0, 256, (3, 8, 8, 3), np.uint8)
    got = timg.image_grid(timg.to_pil(u8))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.asarray(jimg.image_grid(jimg.to_pil(u8))))
