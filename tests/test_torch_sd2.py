"""PyTorch port: the SD-2.1 family (``--model-family sd2``) at a tiny width
with SD-2's layout, held against the JAX package on the CPU.

The layout: 64-wide heads (``head_dim=64``: 1 head at the 64-channel
level, 2 in the middle), a GELU text tower (OpenCLIP-H's activation) whose
48-wide states feed the cross-attention, and v-prediction.

(a) The tiny SD-2 UNet's ε matches JAX's within 1e-4.
(b) A v-prediction DDIM loop (4 steps, CFG 8; also trailing spacing with
    zero terminal SNR) through ``FlexPipeline`` matches JAX within 1e-4,
    uint8 images within one level.
(c) ``Runner.from_models`` with the SD-2 towers and a text guide builds
    the JAX Runner's guidance and generates alike. A guide IMAGE runs the
    vision tower (CLIP ViT-L/14's, as in the JAX CLI's sd2 family) against
    text states of another width: both packages raise, the port adds no
    bridge the JAX package lacks.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu import schedulers as jsch
from flexdiffuse_tpu.models import configs as jcfg
from flexdiffuse_tpu.models import (AutoencoderKL, CLIPTextModel,
                                    CLIPVisionModel, UNet2DCondition)
from flexdiffuse_tpu.runner import Runner as JRunner
from flexdiffuse_tpu.text.tokenizer import FakeTokenizer as JFakeTokenizer
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import schedulers
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.pipeline import FlexPipeline, SimpleGuidance
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_loading import run_both
from tests.test_torch_slice import _compare

TEXT = dict(vocab_size=1000, hidden_size=48, num_layers=2, num_heads=4,
            intermediate_size=96, activation='gelu', eos_token_id=999)
UNET = dict(block_channels=(64, 128), layers_per_block=1,
            attention_levels=(True, False), head_dim=64,
            cross_attention_dim=48, norm_groups=8)
T = 77


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


def _port(cls, cfg, params, jcfg_):
    m = cls(cfg).eval()
    m.load_state_dict(params_to_state_dict(_np_tree(params), jcfg_),
                      strict=True)
    return m


@pytest.fixture(scope='module')
def sd2():
    """The tiny SD-2 layout in both packages, the same weights."""
    jtext_cfg, ttext_cfg = jcfg.CLIPTextConfig(**TEXT), \
        tm.CLIPTextConfig(**TEXT)
    junet_cfg, tunet_cfg = jcfg.UNetConfig(**UNET), tm.UNetConfig(**UNET)
    assert [tunet_cfg.heads_for(c) for c in (64, 128)] == [1, 2]
    k = jax.random.PRNGKey(21)
    text = CLIPTextModel(jtext_cfg)
    tp = jax.jit(lambda kk: text.init(kk, jnp.zeros((1, T), jnp.int32)))(k)
    vision = CLIPVisionModel(jcfg.TINY_VISION)
    vp = jax.jit(lambda kk: vision.init(kk, jnp.zeros((1, 32, 32, 3))))(k)
    unet = UNet2DCondition(junet_cfg)
    up = jax.jit(lambda kk: unet.init(kk, jnp.zeros((2, 8, 8, 4)),
                                      jnp.zeros((2,)),
                                      jnp.zeros((2, T, 48))))(k)
    vae = AutoencoderKL(jcfg.TINY_VAE)
    ap = jax.jit(lambda kk: vae.init(kk, jnp.zeros((1, 16, 16, 3)), kk))(k)
    return dict(
        jax=(text, tp, vision, vp, unet, up, vae, ap),
        port=(_port(tm.CLIPTextModel, ttext_cfg, tp, jtext_cfg),
              _port(tm.CLIPVisionModel, tm.TINY_VISION, vp,
                    jcfg.TINY_VISION),
              _port(tm.UNet2DCondition, tunet_cfg, up, junet_cfg),
              _port(tm.AutoencoderKL, tm.TINY_VAE, ap, jcfg.TINY_VAE)))


def test_sd2_unet_matches_jax(sd2):
    _, _, _, _, unet, up, _, _ = sd2['jax']
    port = sd2['port'][2]
    rng = np.random.default_rng(0)
    lat = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, T, 48)).astype(np.float32)
    t = np.array([901.0, 37.0], np.float32)
    want = unet.apply(up, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(t),
                   torch.from_numpy(ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize('spacing,zero_snr', [('leading', False),
                                              ('trailing', True)])
def test_v_prediction_ddim_loop_matches_jax(sd2, spacing, zero_snr):
    _, _, _, _, unet, up, vae, ap = sd2['jax']
    _, _, tunet, tvae = sd2['port']
    kw = dict(kind='ddim', prediction_type='v_prediction',
              timestep_spacing=spacing, rescale_betas_zero_snr=zero_snr)
    jpipe = jp.FlexPipeline(unet, up, vae, ap, scheduler='ddim',
                            scheduler_config=jsch.SchedulerConfig(**kw))
    tpipe = FlexPipeline(tunet, tvae, scheduler='ddim',
                         scheduler_config=schedulers.SchedulerConfig(**kw))
    assert tpipe.schedule(4).v_prediction
    rng = np.random.default_rng(1)
    emb = rng.standard_normal((1, T, 48)).astype(np.float32)
    unc = rng.standard_normal((1, T, 48)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    jguide = jp.SimpleGuidance(embeddings=jnp.asarray(emb),
                               uncond=jnp.asarray(unc),
                               guidance_scale=jnp.float32(8.0))
    tguide = SimpleGuidance(embeddings=torch.from_numpy(emb),
                            uncond=torch.from_numpy(unc), guidance_scale=8.0)
    jlat = jpipe(jguide, steps=4, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(2),
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type='latent').images
    _compare(jpipe, tpipe, jlat, tlat)


@pytest.fixture(scope='module')
def runners(sd2, tmp_path_factory):
    out = str(tmp_path_factory.mktemp('sd2_out'))
    jcfg_ = jsch.SchedulerConfig(kind='ddim', prediction_type='v_prediction')
    tcfg_ = schedulers.SchedulerConfig(kind='ddim',
                                       prediction_type='v_prediction')
    jr = JRunner.from_models(*sd2['jax'], JFakeTokenizer(), scheduler='ddim',
                             scheduler_config=jcfg_)
    tr = Runner.from_models(*sd2['port'], FakeTokenizer(), scheduler='ddim',
                            scheduler_config=tcfg_,
                            config=RunConfig(output_dir=out))
    return jr, tr


def test_runner_with_a_text_guide_matches_jax(runners):
    """The tween's token mapping is an argmax over softmax(100·cos) of the
    two prompts' states. In this random tiny tower the padding tokens'
    states are nearly equal (top-2 gaps down to 2.5e-6), so a guide whose
    argmax lands on such a near-tie ('an oil painting': one token of 77)
    flips on fp32 rounding in either package. 'a forest' has no such tie:
    the embeddings agree to 1e-6, the loop to _compare's bar."""
    jr, tr = runners
    jg, tg = run_both(jr, tr, prompt='a deer', guide='a forest',
                      negative_prompt='blur')
    assert tuple(tg.embeddings.shape) == (1, T, 48)
    images, _ = tr.gen(prompt='a deer', steps=2, init_size=(16, 16),
                       save=False, seed=1)
    assert np.asarray(images[0]).shape == (16, 16, 3)


def test_a_guide_image_fails_in_both_packages_alike(runners):
    """The vision tower's 32-wide projection against 48-wide text states:
    no tween is defined, and neither package invents one."""
    jr, tr = runners
    img = Image.fromarray(np.random.default_rng(3).integers(
        0, 256, (40, 40, 3), np.uint8))
    for runner in (jr, tr):
        with pytest.raises(Exception) as err:
            runner.guide.embeds(prompt='a deer', guide=img)
        assert not isinstance(err.value, NotImplementedError)


def test_cli_sd2_geometry_is_the_jax_clis():
    """``--model-family sd2`` builds JAX's OpenCLIP-H text tower, SD-2.1
    UNet and VAE; the vision tower stays CLIP ViT-L/14's."""
    from flexdiffuse_tpu_torch import cli
    c = cli.SD2_MODEL_CONFIGS
    for name, want in (('text', jcfg.OPENCLIP_H_TEXT),
                       ('unet', jcfg.SD21_UNET), ('vae', jcfg.SD21_VAE),
                       ('vision', jcfg.CLIP_VIT_L14_VISION)):
        assert dataclasses.asdict(c[name]) == dataclasses.asdict(want)



