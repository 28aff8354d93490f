"""PyTorch port: the hires fix and the tiled VAE, held against the JAX
package on the CPU.

(a) ``upscale_latents`` matches ``jax.image.resize``'s bilinear upscale
    within 1e-5 (scales 1.5 and 2, square and not).
(b) ``tile_starts`` and ``blend_mask`` equal JAX's; ``tiled_apply`` over a
    tiny VAE decode and encode matches JAX's within 1e-5, and the
    pipeline's tiled decode and encode match JAX's within one uint8 level
    and 1e-4.
(c) The hires fix's two passes (tiny models, PNDM): pass 1 at 32², its
    latents upscaled 1.5× and refined by img2img at strength 0.55, with
    JAX's key chain replayed in both passes, match JAX's uint8 output
    within one level (latents within 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu.ops import tiled_vae as jtiled
from flexdiffuse_tpu.pipeline.flex import upscale_latents as jupscale
from flexdiffuse_tpu_torch.ops import tiled_vae
from flexdiffuse_tpu_torch.pipeline import FlexPipeline, upscale_latents
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_slice import _compare, _guides, models  # noqa: F401


@pytest.mark.parametrize('shape,scale', [((1, 16, 16, 4), 1.5),
                                         ((2, 8, 24, 4), 2.0),
                                         ((1, 64, 64, 4), 1.5)])
def test_upscale_latents_matches_jax(shape, scale):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    want = np.asarray(jupscale(jnp.asarray(x), scale))
    got = upscale_latents(torch.from_numpy(x), scale).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):
        upscale_latents(torch.from_numpy(x), 1.0)


def test_tile_grid_and_masks_match_jax():
    for total, tile, stride in ((64, 32, 24), (96, 64, 56), (30, 64, 56),
                                (100, 40, 33)):
        assert tiled_vae.tile_starts(total, tile, stride) == \
            jtiled.tile_starts(total, tile, stride)
    for args in ((64, 64, 8, 8), (48, 32, 4, 6), (8, 8, 8, 8)):
        np.testing.assert_array_equal(tiled_vae.blend_mask(*args),
                                      jtiled.blend_mask(*args))


def test_tiled_apply_matches_jax_over_the_vae(models):
    """A 24×20-latent decode in 12-unit tiles with 4 of overlap (a ragged
    grid, 2× spatial scale), and the encoder's moments the other way."""
    vae, params = models['vae'], models['vae_params']
    port = models['port_vae']
    z = np.random.default_rng(1).standard_normal((1, 24, 20, 4)).astype(
        np.float32)
    want = jtiled.tiled_apply(
        lambda t: vae.apply(params, t, method=type(vae).decode),
        jnp.asarray(z), 12, 4, out_num=2, out_den=1)
    with torch.no_grad():
        got = tiled_vae.tiled_apply(port.decode, torch.from_numpy(z), 12, 4,
                                    out_num=2, out_den=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    px = np.random.default_rng(2).uniform(-1, 1, (1, 48, 40, 3)).astype(
        np.float32)
    jmean, jlogvar = jtiled.tiled_apply(
        lambda t: vae.apply(params, t, method=type(vae).encode),
        jnp.asarray(px), 24, 8, out_num=1, out_den=2)
    with torch.no_grad():
        mean, logvar = tiled_vae.tiled_apply(port.encode,
                                             torch.from_numpy(px), 24, 8,
                                             out_num=1, out_den=2)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(jlogvar), rtol=0,
                               atol=1e-5)


def _pipes(models, **kw):
    return (jp.FlexPipeline(models['unet'], models['unet_params'],
                            models['vae'], models['vae_params'],
                            scheduler='pndm', **kw),
            FlexPipeline(models['port_unet'], models['port_vae'],
                         scheduler='pndm', **kw))


def test_pipeline_tiled_decode_and_encode_match_jax(models):
    """``vae_tile=8, overlap 2`` on a 20² latent: the u8 decode within one
    level, the tiled encode's latents (one posterior draw over the blended
    moments) within 1e-4; a canvas inside one tile is not tiled."""
    jpipe, tpipe = _pipes(models, vae_tile=8, vae_tile_overlap=2)
    assert tpipe._tiling_active(20, 20) and not tpipe._tiling_active(8, 8)
    z = np.random.default_rng(3).standard_normal((1, 20, 20, 4)).astype(
        np.float32)
    ju8 = np.asarray(jpipe.decode_u8_device(jnp.asarray(z))).astype(np.int16)
    tu8 = tpipe.decode_u8_device(torch.from_numpy(z)).numpy()
    assert tu8.shape == (1, 40, 40, 3)
    assert np.abs(tu8.astype(np.int16) - ju8).max() <= 1
    px = np.random.default_rng(4).uniform(-1, 1, (1, 40, 40, 3)).astype(
        np.float32)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (1, 20, 20, 4), jnp.float32))
    want = jpipe.encode_pixels(jnp.asarray(px), key)
    got = tpipe.encode_pixels(torch.from_numpy(px), torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)
    with pytest.raises(ValueError):
        FlexPipeline(models['port_unet'], models['port_vae'], vae_tile=8,
                     vae_tile_overlap=8)


def test_hires_fix_two_passes_match_jax(models):
    """The JAX Runner's two passes, at the pipeline: pass 1 txt2img
    (latents out), ``upscale_latents(·, 1.5)``, pass 2 img2img from those
    latents at strength 0.55. Each pass's noise is the JAX pass's own
    ``k_noise`` draw. The second pass decodes through the tiled VAE
    (``vae_tile=8``)."""
    jpipe, tpipe = _pipes(models, vae_tile=8, vae_tile_overlap=2)
    jguide, tguide = _guides(batch=1, seed=6)
    k1, k2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    draw = lambda key, shape: np.array(jax.random.normal(
        jax.random.split(key, 4)[2], shape, jnp.float32))
    jlat = jpipe(jguide, steps=4, init_size=(32, 32), key=k1,
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(32, 32),
                 noise=torch.from_numpy(draw(k1, (1, 16, 16, 4))),
                 output_type='latent').images
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), rtol=0,
                               atol=1e-4)
    jup, tup = jupscale(jlat, 1.5), upscale_latents(tlat, 1.5)
    assert tuple(tup.shape) == (1, 24, 24, 4)
    jlat2 = jpipe(jguide, steps=4, init_latents=jup, strength=0.55, key=k2,
                  output_type='latent').images
    tlat2 = tpipe(tguide, steps=4, init_latents=tup, strength=0.55,
                  noise=torch.from_numpy(draw(k2, (1, 24, 24, 4))),
                  output_type='latent').images
    _compare(jpipe, tpipe, jlat2, tlat2)
    assert tpipe.decode_u8_device(tlat2).shape == (1, 48, 48, 3)
    with pytest.raises(ValueError, match='init_latents'):
        tpipe(tguide, steps=2, init_latents=tup,
              init_image=np.zeros((1, 48, 48, 3), np.float32))
