"""PyTorch port: sequence-parallel generation (``parallel/sp.py``,
``FlexPipeline(sp_mesh=)``) across 2 gloo ranks on the CPU, held against
the port's single-process pipeline and the JAX package's ``FlexPipeline``
given the same noise; the features whose SP path differs (FreeU's filter
on the whole map, CFG rescale's std over every rank's rows, a ControlNet's
conditioning rows, regional masks) against the single-process pipeline.

The geometry is the JAX test's (``tests/test_sp_pipeline.py:22-27``):
1024² pixels → 64² latents through a 5-level VAE, so the UNet's level-0
self-attention is 4096 tokens, the ring's threshold; each rank holds 32
latent rows. DDIM, 2 steps, CFG 7. Tolerance 2e-4 on the decoded images,
JAX's own (``test_sp_pipeline.py:67``). One spawn runs every case; the
JAX references are computed in this process and the ranks import no JAX.

An uneven split: 1056×1024 pixels give 66 latent rows, 33 per rank into
the UNet's stride-2 Downsample, and 33 rows at level 1. JAX's SP pipeline
runs there on 2 of its virtual devices (GSPMD pads); the port's row plan
(``ops/row_shard.py`` ``Plan``) keeps level 0 and the VAE sharded and runs
level 1 whole.
"""
import os

import numpy as np
import pytest
import torch

from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.models.configs import UNetConfig, VAEConfig

SP_VAE = VAEConfig(block_channels=(8, 8, 8, 8, 8), layers_per_block=1,
                   norm_groups=4)
SP_UNET = UNetConfig(block_channels=(16, 32), layers_per_block=1,
                     attention_levels=(True, False), num_heads=1,
                     cross_attention_dim=16, norm_groups=4)
T = 77
ATOL = 2e-4
UNEVEN = (1056, 1024)
KW = dict(steps=2, output_type='np')


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays(seed):
    """Guide embeddings and the draws every run is given."""
    rng = np.random.default_rng(seed)
    d = SP_UNET.cross_attention_dim
    return dict(
        emb=rng.normal(size=(1, T, d)).astype(np.float32),
        unc=rng.normal(size=(1, T, d)).astype(np.float32),
        init=rng.uniform(-1, 1, size=(1, 1024, 1024, 3)).astype(np.float32))


def _guide(a):
    from flexdiffuse_tpu_torch.pipeline import SimpleGuidance
    return SimpleGuidance(embeddings=torch.from_numpy(a['emb']),
                          uncond=torch.from_numpy(a['unc']),
                          guidance_scale=7.0)


def _port_models(state_path):
    sd = torch.load(state_path, weights_only=True)
    unet = tm.UNet2DCondition(SP_UNET).eval()
    unet.load_state_dict(sd['unet'], strict=True)
    vae = tm.AutoencoderKL(SP_VAE).eval()
    vae.load_state_dict(sd['vae'], strict=True)
    return unet, vae


def _controlnet():
    """A ControlNet of SP_UNET's geometry, seeded torch init; its ramp has
    four stride-2 convs, 1024 px → the 64² latents."""
    from flexdiffuse_tpu_torch.models.controlnet import ControlNetModel
    torch.manual_seed(3)
    return ControlNetModel(SP_UNET, (8, 8, 8, 8, 16)).eval()


def _runs(make_pipe, draws):
    """Every case through ``make_pipe(unet=, controlnet=, sp_min_seq=)``'s
    pipelines: {name: images}. The feature cases run at 512² (32² latents)
    with the ring's threshold at 1024 tokens, so that level 0 still rides
    it."""
    from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                       entity_masks)
    a = _arrays(0)
    pipe = make_pipe()
    out = dict(txt=pipe(_guide(a), init_size=(1024, 1024),
                        noise=draws['noise'], **KW).images,
               i2i=pipe(_guide(a), init_image=a['init'], strength=0.7,
                        noise=draws['noise'],
                        posterior_noise=draws['posterior'], **KW).images,
               uneven=pipe(_guide(a), init_size=UNEVEN,
                           noise=draws['noise_uneven'], **KW).images)
    small = dict(init_size=(512, 512), noise=draws['noise'][:, :32, :32],
                 **KW)
    pipe = make_pipe(sp_min_seq=1024)
    out['rescale'] = pipe(_guide(a).replace(guidance_rescale=0.7,
                                            rescale=True), **small).images
    g = _guide(a)
    masks = entity_masks([((0, 0), (16, 32)), ((16, 8), (16, 16))],
                         (32, 32))
    out['compose'] = pipe(CompositeGuidance(
        background=g.embeddings, entities=g.uncond.repeat(2, 1, 1) * 0.5,
        masks=masks, blends=torch.tensor([0.8, 0.6]), uncond=g.uncond,
        guidance_scale=7.0), **small).images
    freeu = make_pipe(unet=pipe.unet.with_settings(
        freeu=(1.5, 1.6, 0.9, 0.2)), sp_min_seq=1024)
    out['freeu'] = freeu(_guide(a), **small).images
    control = make_pipe(controlnet=_controlnet(), sp_min_seq=1024)
    out['control'] = control(_guide(a), control_image=a['init'][0, :512,
                                                                :512] * 0.5
                             + 0.5, **small).images
    return out


def _worker(rank, world, state_path, draws_path, out_dir):
    import torch.distributed as dist

    import flexdiffuse_tpu_torch.ops.ring_attention as R
    from flexdiffuse_tpu_torch.parallel.axis import MeshAxis
    from flexdiffuse_tpu_torch.parallel import make_sp_mesh, sp_pipeline
    unet, vae = _port_models(state_path)
    draws = dict(np.load(draws_path))
    mesh = make_sp_mesh()
    make = lambda unet=unet, **kw: sp_pipeline(unet, vae, mesh=mesh,
                                               scheduler='ddim', **kw)
    calls = []
    orig = R.ring_attention

    def spy(q, k, v, mesh, axis, scale=None):
        calls.append((q.shape[-2] * MeshAxis.of(mesh, axis).size, axis))
        return orig(q, k, v, mesh, axis, scale)

    R.ring_attention = spy
    try:
        out = _runs(make, draws)
    finally:
        R.ring_attention = orig
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, 'sp.npz'), **out,
                 ring_tokens=np.asarray([c[0] for c in calls]),
                 ring_axes=np.asarray([c[1] for c in calls]))


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """JAX's single-device pipeline and the port's, here; the port's SP
    pipeline on 2 ranks."""
    import jax
    import jax.numpy as jnp

    from flexdiffuse_tpu import pipeline as jp
    from flexdiffuse_tpu.models import AutoencoderKL, UNet2DCondition
    from flexdiffuse_tpu.models.configs import UNetConfig as JU
    from flexdiffuse_tpu.models.configs import VAEConfig as JV
    from flexdiffuse_tpu_torch.pipeline import FlexPipeline
    from flexdiffuse_tpu_torch.weights import params_to_state_dict
    ju = JU(**{f: getattr(SP_UNET, f) for f in (
        'block_channels', 'layers_per_block', 'attention_levels',
        'num_heads', 'cross_attention_dim', 'norm_groups')})
    jv = JV(block_channels=SP_VAE.block_channels, layers_per_block=1,
            norm_groups=4)
    unet, vae = UNet2DCondition(ju), AutoencoderKL(jv)
    k = jax.random.PRNGKey(0)
    up = unet.init(k, jnp.zeros((1, 64, 64, 4)), jnp.zeros((1,)),
                   jnp.zeros((1, T, ju.cross_attention_dim)))
    vp = vae.init(k, jnp.zeros((1, 32, 32, 3)), k)
    out = tmp_path_factory.mktemp('sp')
    state = str(out / 'state.pt')
    np_tree = lambda p: jax.tree.map(np.asarray, p)
    torch.save({'unet': params_to_state_dict(np_tree(up), ju),
                'vae': params_to_state_dict(np_tree(vp), jv)}, state)
    key = jax.random.PRNGKey(11)
    _, k_enc, k_noise, _ = jax.random.split(key, 4)
    draws = dict(
        noise=np.array(jax.random.normal(k_noise, (1, 64, 64, 4))),
        posterior=np.array(jax.random.normal(k_enc, (1, 64, 64, 4))),
        noise_uneven=np.array(jax.random.normal(
            jax.random.PRNGKey(12), (1, UNEVEN[0] // 16, UNEVEN[1] // 16,
                                     4))))
    np.savez(out / 'draws.npz', **draws)
    a = _arrays(0)
    jguide = jp.SimpleGuidance(embeddings=jnp.asarray(a['emb']),
                               uncond=jnp.asarray(a['unc']),
                               guidance_scale=jnp.float32(7.0), cfg=True)
    jpipe = jp.FlexPipeline(unet, up, vae, vp, scheduler='ddim')
    jax_txt = np.asarray(jpipe(jguide, init_size=(1024, 1024),
                               noise=jnp.asarray(draws['noise']),
                               key=jax.random.PRNGKey(3), **KW).images)
    jax_i2i = np.asarray(jpipe(jguide, init_image=jnp.asarray(a['init']),
                               strength=0.7, key=key, **KW).images)
    # The uneven split on one device and on 2 of the virtual devices.
    from flexdiffuse_tpu.parallel import make_sp_mesh, sp_pipeline
    uneven = dict(init_size=UNEVEN, noise=jnp.asarray(draws['noise_uneven']),
                  key=jax.random.PRNGKey(3), **KW)
    jax_uneven = np.asarray(jpipe(jguide, **uneven).images)
    jax_sp_uneven = np.asarray(sp_pipeline(
        unet, up, vae, vp, mesh=make_sp_mesh(jax.devices()[:2]),
        scheduler='ddim')(jguide, **uneven).images)
    unet_p, vae_p = _port_models(state)
    port = _runs(lambda unet=unet_p, **kw: FlexPipeline(
        unet, vae_p, scheduler='ddim', **kw), draws)
    from flexdiffuse_tpu_torch.parallel import launch
    launch.spawn(_worker, 2, device='cpu',
                 args=(state, str(out / 'draws.npz'), str(out)),
                 timeout=120, join_timeout=300)
    sp = dict(np.load(out / 'sp.npz'))
    return dict(jax_txt=jax_txt, jax_i2i=jax_i2i, jax_uneven=jax_uneven,
                jax_sp_uneven=jax_sp_uneven, state=state,
                **{f'port_{k}': v for k, v in port.items()}, **sp)


@pytest.mark.parametrize('mode', ['txt', 'i2i'])
def test_sp_1024_matches_single_process_and_jax(runs, mode):
    """txt2img and img2img (strength 0.7) on 2 ranks: full [1, 1024, 1024,
    3] images on every rank, within 2e-4 of the port's single-process
    pipeline and of JAX's on the same noise. The single-process pipeline
    is held to JAX's too: its VAE missed it by 4.2e-4 (txt2img) and 5.1e-4
    (img2img) while the plain GroupNorm ran PyTorch's channels-last CPU
    kernel (``ops/group_norm.py``)."""
    got = runs[mode]
    assert got.shape == (1, 1024, 1024, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, runs[f'port_{mode}'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, runs[f'jax_{mode}'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(runs[f'port_{mode}'], runs[f'jax_{mode}'],
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize('mode', ['rescale', 'compose', 'freeu', 'control'])
def test_sp_features_match_single_process(runs, mode):
    """CFG rescale 0.7, a 2-entity composition, FreeU and a ControlNet on
    2 ranks at 512², within 2e-4 of the single-process pipeline."""
    got = runs[mode]
    assert got.shape == (1, 512, 512, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, runs[f'port_{mode}'], rtol=0, atol=ATOL)


def test_sp_attention_actually_rides_the_ring(runs):
    """The 4096-token level rides the ring on the 'seq' axis (the VAE's
    mid attention at 64² does too), as ``test_sp_pipeline.py:70-95``
    asserts for JAX."""
    assert runs['ring_tokens'].size, 'ring attention was never engaged'
    assert 4096 in set(runs['ring_tokens'].tolist())
    assert set(runs['ring_axes'].tolist()) == {'seq'}


def test_jax_sp_runs_the_uneven_split(runs):
    """The evidence that the port's former refusal was a gap: JAX's SP
    pipeline on 2 devices runs 1056×1024 (33 latent rows per device into
    the Downsample, 33 rows at level 1) and matches its single-device run
    at 2e-4."""
    got = runs['jax_sp_uneven']
    assert got.shape == (1, 1056, 1024, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, runs['jax_uneven'], rtol=0, atol=ATOL)


def test_sp_uneven_split_raises(runs):
    """The uneven split no longer raises: it runs and matches JAX. (The
    name is kept from the refusal this test once held.) 1056×1024 on 2
    ranks runs: the row plan keeps level 0 (33 rows each, riding the ring)
    and the VAE sharded, gathers the rows into the Downsample and runs
    level 1 whole. The images match the single-process port and JAX's
    single-device and SP runs at 2e-4."""
    got = runs['uneven']
    assert got.shape == (1, 1056, 1024, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, runs['port_uneven'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, runs['jax_uneven'], rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, runs['jax_sp_uneven'], rtol=0,
                               atol=ATOL)
    assert 66 * 64 in set(runs['ring_tokens'].tolist())


@pytest.mark.parametrize('model, sharded, whole', [
    ('unet', [0, 1], [2, 3]), ('encoder', [0, 1, 2, 3], []),
    ('decoder', [0, 1, 2, 3], [])])
def test_sp_level_plan_sd14_1088_on_4_ranks(model, sharded, whole):
    """SD-1.4 at 1088² on 4 ranks, traced through the modules on the meta
    device: 136 latent rows give the UNet 34 and 17 rows per rank at
    levels 0 and 1 (level 1's Downsample takes the gathered rows) and
    levels 2–3 (34 and 17 rows) run whole; every VAE level splits (1088
    pixel rows are 32 × 34)."""
    from flexdiffuse_tpu_torch.tools import sp_plan
    got = sp_plan.trace(model, 1088, 4)
    assert got['sharded'] == sharded and got['whole'] == whole
    assert 0.0 <= got['replicated_share'] < (0.5 if whole else 1e-3)


def test_sp_refuses_tome(runs):
    from flexdiffuse_tpu_torch.pipeline import FlexPipeline
    unet, vae = _port_models(runs['state'])
    with pytest.raises(ValueError, match='ToMe'):
        FlexPipeline(unet.with_settings(tome=(0.5, 4096)), vae,
                     sp_mesh=object())
