"""PyTorch port: InstructPix2Pix (``InstructPix2PixGuidance``,
``Runner.edit``, 8-channel UNets) held against the JAX package on the CPU
in fp32, mirroring ``tests/test_ip2p.py``.

(a) ``noise_pred``'s three rows (``[uncond text, zero image; uncond text,
    image; text, image]``, all on the same noisy latents) and its dual-CFG
    combine equal JAX's through a spy noise function, and match JAX within
    ATOL through the two tiny 8-channel UNets (with CFG rescale too).
(b) ``Runner.edit`` on a tiny 8-channel UNet matches the JAX Runner's edit
    with JAX's initial noise replayed: within one uint8 level (the
    golden-loop allowance of ROADMAP Queue 3). The unscaled posterior mean
    conditions every step; the filename tag, the bare ``[H, W, 3]`` array,
    and the refusals (a 4-channel UNet, a bad array rank) are JAX's.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu.config import RunConfig as JRunConfig
from flexdiffuse_tpu.models import TINY_UNET, UNet2DCondition
from flexdiffuse_tpu.runner import Runner as JRunner
from flexdiffuse_tpu.text.tokenizer import FakeTokenizer as JFakeTokenizer
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.pipeline import InstructPix2PixGuidance
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_protocol import (ReplayNoise, jax_tiny_params,
                                       runner_pair)

ATOL = 1e-4
T, D = 77, 32
CFG8 = dataclasses.replace(TINY_UNET, in_channels=8)
T_CFG8 = dataclasses.replace(tm.TINY_UNET, in_channels=8)


def _guides(b=1, s_txt=7.5, s_img=1.5, seed=0, **features):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(b, T, D)).astype(np.float32)
    unc = rng.normal(size=(1, T, D)).astype(np.float32)
    img = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    jf = {k: (jnp.float32(v) if isinstance(v, float) else v)
          for k, v in features.items()}
    jguide = jp.InstructPix2PixGuidance(
        embeddings=jnp.asarray(emb), uncond=jnp.asarray(unc),
        image_latents=jnp.asarray(img), guidance_scale=jnp.float32(s_txt),
        image_guidance_scale=jnp.float32(s_img), **jf)
    tguide = InstructPix2PixGuidance(
        embeddings=torch.from_numpy(emb), uncond=torch.from_numpy(unc),
        image_latents=torch.from_numpy(img), guidance_scale=s_txt,
        image_guidance_scale=s_img, **features)
    return jguide, tguide


def test_rows_and_combine_equal_jax():
    """A spy noise function sees the same three rows and context in both
    packages; the combine is ``eps_u + s_img·(eps_i − eps_u) +
    s_txt·(eps_f − eps_i)``."""
    jguide, tguide = _guides(s_txt=3.0, s_img=2.0)
    lat = np.random.default_rng(1).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    seen = {}

    def spy(key):
        def fn(lat3, t, ctx, *a, **kw):
            seen[key] = (np.asarray(lat3), np.asarray(ctx), np.asarray(t))
            return (lat3[..., :4] + lat3[..., 4:] +
                    ctx.mean(axis=(1, 2))[:, None, None, None]
                    if key == 'jax' else
                    lat3[..., :4] + lat3[..., 4:] +
                    ctx.mean(dim=(1, 2))[:, None, None, None])
        return fn

    want = jguide.noise_pred(spy('jax'), jnp.asarray(lat), jnp.float32(10.0))
    got = tguide.noise_pred(spy('port'), torch.from_numpy(lat),
                            torch.tensor(10.0))
    for a, b in zip(seen['port'], seen['jax']):
        np.testing.assert_array_equal(a, b)
    lat3 = seen['port'][0]
    assert lat3.shape == (3, 8, 8, 8)
    np.testing.assert_array_equal(lat3[0, ..., 4:], 0.0)
    # fp32: the two means' summation orders differ by an ulp.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


@pytest.fixture(scope='module')
def unets():
    unet = UNet2DCondition(CFG8)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: unet.init(
        k, jnp.zeros((1, 8, 8, 8)), jnp.zeros((1,)),
        jnp.zeros((1, T, D))))(jax.random.PRNGKey(6)))
    port = tm.UNet2DCondition(T_CFG8).eval()
    port.load_state_dict(params_to_state_dict(params, CFG8), strict=True)
    return unet, params, port.requires_grad_(False)


@pytest.mark.parametrize('features,b', [({}, 1), ({}, 2),
                                        (dict(rescale=True,
                                              guidance_rescale=0.7), 1)])
def test_noise_pred_through_the_unets_matches_jax(unets, features, b):
    """UNet batch 3·B. Observed max|Δ| ≈ 1e-5 (the CFG scales amplify the
    UNets' ~2e-6)."""
    unet, params, port = unets
    jguide, tguide = _guides(b=b, seed=2, **features)
    lat = np.random.default_rng(3).normal(size=(b, 8, 8, 4)).astype(
        np.float32)
    batches = []
    hook = port.register_forward_pre_hook(
        lambda m, args: batches.append(tuple(args[0].shape)))
    want = jguide.noise_pred(lambda *a: unet.apply(params, *a[:3]),
                             jnp.asarray(lat), jnp.float32(501.0))
    with torch.no_grad():
        got = tguide.noise_pred(port, torch.from_numpy(lat),
                                torch.tensor(501.0))
    hook.remove()
    assert batches == [(3 * b, 8, 8, 8)]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)


@pytest.fixture(scope='module')
def edit_runners(tmp_path_factory, unets):
    """The JAX and port Runners on the golden's tiny text/vision/VAE and the
    8-channel UNet, fp32, the port's on the CPU."""
    out = str(tmp_path_factory.mktemp('edit'))
    mods, params = jax_tiny_params()
    unet, unet_params, port_unet = unets
    jr = JRunner.from_models(mods['text'], params['text'], mods['vision'],
                             params['vision'], unet, unet_params,
                             mods['vae'], params['vae'], JFakeTokenizer(),
                             config=JRunConfig(output_dir=out))
    _, base = runner_pair(out)
    tr = Runner.from_models(base.encoder.text_model,
                            base.encoder.vision_model, port_unet,
                            base.pipe.vae, FakeTokenizer(),
                            config=RunConfig(output_dir=out))
    return jr, tr


def _image(size=16, seed=3):
    """A preprocessed [-1, 1] NHWC array (a PIL input is resized to 512²)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, size=(1, size, size, 3)).astype(np.float32)


def _edit_port(tr, seed, *args, **kw):
    real = tr.pipe
    tr.pipe = ReplayNoise(real, seed)
    try:
        return tr.edit(*args, seed=seed, **kw)
    finally:
        tr.pipe = real


@pytest.mark.parametrize('kw', [dict(steps=3),
                                dict(steps=3, image_guidance_scale=5.0,
                                     negative_prompt='blurry'),
                                dict(steps=2, guidance_rescale=0.7)])
def test_runner_edit_matches_jax(edit_runners, kw):
    """UNet batch 3 per step from pure noise; the image's unscaled
    posterior mean conditions it."""
    jr, tr = edit_runners
    want, _ = jr.edit('make it winter', _image(), seed=11, save=False, **kw)
    batches = []
    hook = tr.pipe.unet.register_forward_pre_hook(
        lambda m, args: batches.append(tuple(args[0].shape)))
    got, grid = _edit_port(tr, 11, 'make it winter', _image(), save=False,
                           **kw)
    hook.remove()
    assert batches == [(3, 8, 8, 8)] * (kw['steps'] + 1)
    assert len(got) == 1 and got[0].size == (16, 16) and grid is not None
    diff = np.asarray(got[0]).astype(np.int16) - np.asarray(want[0])
    assert np.abs(diff).max() <= 1


def test_runner_edit_filename_hwc_and_conditioning(edit_runners):
    """The JAX filename tag; a bare [H, W, 3] array equals the batched one;
    another input image changes the output."""
    _, tr = edit_runners
    imgs, _ = tr.edit('make it winter', _image(), steps=3, seed=11)
    assert len(imgs) == 1
    assert any('edit_st3_gs7_igs150_se11' in f
               for f in os.listdir(tr.output_dir))
    a, _ = tr.edit('p', _image(seed=7), steps=2, seed=4, save=False)
    b, _ = tr.edit('p', _image(seed=7)[0], steps=2, seed=4, save=False)
    c, _ = tr.edit('p', _image(seed=8), steps=2, seed=4, save=False)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert np.abs(np.asarray(a[0]).astype(np.int16) -
                  np.asarray(c[0])).max() > 0


def test_runner_edit_refusals(edit_runners, tmp_path):
    _, tr = edit_runners
    for bad in (np.zeros((16, 16), np.float32),
                np.zeros((1, 16, 16, 4), np.float32)):
        with pytest.raises(ValueError, match=r'\[1, H, W, 3\]'):
            tr.edit('p', bad, steps=2, save=False)
    _, four = runner_pair(str(tmp_path))
    with pytest.raises(ValueError, match='8-channel'):
        four.edit('x', _image(), steps=2)
