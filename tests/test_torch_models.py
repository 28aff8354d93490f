"""PyTorch port: the weight bridge and the CLIP, UNet and VAE modules, held
against the JAX package's TINY_* models on the CPU in fp32 (exact-erf gelu,
standard orientation — what the JAX package picks off-TPU).

The JAX params are initialised once per module (jitted) and bridged into
the port with ``params_to_state_dict``; both sides get the same numpy
inputs. Tolerance max|Δ| ≤ 1e-4; observed values are in each test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import models as jm
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401

ATOL = 1e-4


def _np_tree(params):
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope='module')
def jax_models():
    k = jax.random.PRNGKey(0)
    specs = {
        'text': (jm.CLIPTextModel(jm.TINY_TEXT), jm.TINY_TEXT,
                 (jnp.zeros((1, 77), jnp.int32),)),
        'vision': (jm.CLIPVisionModel(jm.TINY_VISION), jm.TINY_VISION,
                   (jnp.zeros((1, 32, 32, 3)),)),
        'unet': (jm.UNet2DCondition(jm.TINY_UNET), jm.TINY_UNET,
                 (jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                  jnp.zeros((1, 77, 32)))),
        'vae': (jm.AutoencoderKL(jm.TINY_VAE), jm.TINY_VAE,
                (jnp.zeros((1, 16, 16, 3)), k)),
    }
    out = {}
    for name, (model, cfg, args) in specs.items():
        params = jax.jit(lambda key, m=model, a=args: m.init(key, *a))(k)
        out[name] = (model, cfg, params)
    return out


PORT = {'text': (tm.CLIPTextModel, tm.TINY_TEXT),
        'vision': (tm.CLIPVisionModel, tm.TINY_VISION),
        'unet': (tm.UNet2DCondition, tm.TINY_UNET),
        'vae': (tm.AutoencoderKL, tm.TINY_VAE)}


def _port(jax_models, name):
    _, jcfg, params = jax_models[name]
    cls, cfg = PORT[name]
    model = cls(cfg).eval()
    model.load_state_dict(params_to_state_dict(_np_tree(params), jcfg),
                          strict=True)
    return model, params


@pytest.mark.parametrize('name', ['text', 'vision', 'unet', 'vae'])
def test_bridge_state_dict_loads_strict(jax_models, name):
    """Every port parameter comes from the JAX tree, with matching shapes,
    and every JAX leaf lands somewhere."""
    _, jcfg, params = jax_models[name]
    cls, cfg = PORT[name]
    sd = params_to_state_dict(_np_tree(params), jcfg)
    model = cls(cfg)
    missing, unexpected = model.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    n_jax = sum(np.size(x) for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in model.parameters())


def test_clip_text_matches_jax(jax_models):
    """Observed max|Δ| ≈ 2.3e-6."""
    port, params = _port(jax_models, 'text')
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77)).astype(
        np.int32)
    ref = np.asarray(jax.jit(jax_models['text'][0].apply)(params,
                                                          jnp.asarray(ids)))
    with torch.no_grad():
        got = port(torch.from_numpy(ids).long()).numpy()
    assert got.shape == (2, 77, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_clip_vision_matches_jax(jax_models):
    """All 1 + 16 tokens after post-LN and the projection. Observed
    max|Δ| ≈ 9.5e-7."""
    port, params = _port(jax_models, 'vision')
    px = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jax_models['vision'][0].apply)(
        params, jnp.asarray(px)))
    with torch.no_grad():
        got = port(torch.from_numpy(px)).numpy()
    assert got.shape == (2, 17, 32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_unet_matches_jax(jax_models):
    """8×8 latents, two timesteps, 77-token context. Observed max|Δ| ≈ 2e-6
    (max|ε| ≈ 1.8)."""
    port, params = _port(jax_models, 'unet')
    rng = np.random.default_rng(2)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, 77, 32)).astype(np.float32)
    t = np.array([981.0, 21.0], np.float32)
    ref = np.asarray(jax.jit(jax_models['unet'][0].apply)(
        params, jnp.asarray(lat), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = port(torch.from_numpy(lat), torch.from_numpy(t),
                   torch.from_numpy(ctx)).numpy()
    assert got.shape == (2, 8, 8, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


def test_vae_encode_decode_matches_jax(jax_models):
    """Posterior moments and decode. Observed max|Δ| ≈ 2.3e-6 (mean),
    1.9e-6 (logvar), 2.7e-6 (decode)."""
    port, params = _port(jax_models, 'vae')
    jvae = jax_models['vae'][0]
    rng = np.random.default_rng(3)
    px = rng.uniform(-1, 1, size=(1, 16, 16, 3)).astype(np.float32)
    z = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    mean, logvar = jax.jit(lambda p, x: jvae.apply(
        p, x, method=type(jvae).encode))(params, jnp.asarray(px))
    dec = jax.jit(lambda p, x: jvae.apply(
        p, x, method=type(jvae).decode))(params, jnp.asarray(z))
    with torch.no_grad():
        m, lv = port.encode(torch.from_numpy(px))
        d = port.decode(torch.from_numpy(z))
    assert m.shape == (1, 8, 8, 4) and d.shape == (1, 16, 16, 3)
    np.testing.assert_allclose(m.numpy(), np.asarray(mean), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(lv.numpy(), np.asarray(logvar), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(d.numpy(), np.asarray(dec), rtol=0,
                               atol=ATOL)


def test_sample_latents_matches_jax():
    from flexdiffuse_tpu.models.vae import sample_latents as jax_sample
    rng = np.random.default_rng(4)
    mean, logvar = (rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
                    for _ in range(2))
    key = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(key, mean.shape, jnp.float32))
    ref = np.asarray(jax_sample(jnp.asarray(mean), jnp.asarray(logvar), key))
    got = tm.sample_latents(torch.from_numpy(mean), torch.from_numpy(logvar),
                            torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
