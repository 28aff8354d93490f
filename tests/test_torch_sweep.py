"""PyTorch port: the data-parallel sweeps (``parallel/sweep.py``) across 2
gloo ranks on the CPU, held against the JAX package's ``sweep``,
``guidance_param_sweep`` and ``compose_sweep`` on its virtual mesh: the
cases of ``tests/test_cli_and_sweep.py:46-300``.

Both packages get TINY_UNET/TINY_VAE's weights (JAX init, converted) and
the same draws: each seed's initial (or img2img) noise, the img2img
posterior sample and the inpainting anchor noise are replayed from JAX's
keys and handed to the port. One spawn of 2 ranks runs every sweep; the
JAX references are computed in this process, the ranks import no JAX.
Tolerance: 1e-4 on the [0, 1] images (observed ≤ 2e-6).
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.config import GuidanceParams

N, SIZE = 8, (32, 32)
ATOL = 1e-4
# name -> (scheduler, steps, JAX seed of the keys, extra sweep arguments)
CASES = {
    'txt2img': ('pndm', 2, 1337, {}),
    'params': ('pndm', 2, 7, {}),
    'img2img': ('pndm', 4, 11, {'strength': 0.5}),
    'heun_img2img': ('heun', 4, 3, {'strength': 0.5}),
    'inpaint': ('pndm', 4, 21, {'strength': 1.0}),
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _arrays():
    rng = np.random.default_rng(0)
    mask = np.zeros(SIZE, np.float32)
    mask[:, 16:] = 1.0   # regenerate the right half only
    return dict(
        emb=rng.normal(size=(1, 77, 32)).astype(np.float32),
        unc=rng.normal(size=(1, 77, 32)).astype(np.float32),
        init=rng.uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32),
        base=rng.normal(size=(77, 32)).astype(np.float32),
        alt=rng.normal(size=(40, 32)).astype(np.float32),
        bg=rng.normal(size=(1, 77, 32)).astype(np.float32),
        ents=rng.normal(size=(2, 77, 32)).astype(np.float32), mask=mask)


def _settings():
    """Eight guidance settings, the linear end swept (test_cli_and_sweep.py
    :94-98)."""
    return [dataclasses.replace(GuidanceParams.ui_defaults(),
                                linear=(0.0, float(e)))
            for e in np.linspace(0.0, 0.9, 8)]


def _port_pipe(state, scheduler):
    from flexdiffuse_tpu_torch.pipeline import FlexPipeline
    sd = torch.load(state, weights_only=True)
    unet = tm.UNet2DCondition(tm.TINY_UNET).eval()
    unet.load_state_dict(sd['unet'], strict=True)
    vae = tm.AutoencoderKL(tm.TINY_VAE).eval()
    vae.load_state_dict(sd['vae'], strict=True)
    return FlexPipeline(unet, vae, scheduler=scheduler)


def _composite(a, hw):
    from flexdiffuse_tpu_torch.pipeline.guides import (CompositeGuidance,
                                                       entity_masks)
    masks = entity_masks([((0, 0), (hw // 2, hw // 2)),
                          ((hw // 2, hw // 2), (hw // 2, hw // 2))],
                         (hw, hw))
    return CompositeGuidance(
        background=torch.from_numpy(a['bg']),
        entities=torch.from_numpy(a['ents']), masks=masks,
        blends=torch.tensor([0.8, 0.6]), uncond=torch.from_numpy(a['unc']),
        guidance_scale=7.5)


def _worker(rank, world, state, draws_path, out_dir):
    import torch.distributed as dist

    from flexdiffuse_tpu_torch.parallel import (compose_sweep,
                                                guidance_param_sweep,
                                                make_mesh, sweep)
    a = _arrays()
    d = dict(np.load(draws_path))
    mesh = make_mesh(model_parallel=1)
    emb, unc = torch.from_numpy(a['emb']), torch.from_numpy(a['unc'])
    seeds = list(range(100, 100 + N))
    out = {}
    for name, (kind, steps, _, kw) in CASES.items():
        pipe = _port_pipe(state, kind)
        e = emb
        if name == 'params':
            e = guidance_param_sweep(torch.from_numpy(a['base']),
                                     torch.from_numpy(a['alt']),
                                     _settings())
        if 'strength' in kw:
            kw = dict(kw, init_image=a['init'],
                      posterior_noise=d[f'{name}_posterior'])
        if name == 'inpaint':
            kw = dict(kw, mask=a['mask'],
                      inpaint_noise=list(d['inpaint_anchor']))
        out[name] = sweep(pipe, e, unc, seeds, steps=steps, init_size=SIZE,
                          mesh=mesh, noise=d[f'{name}_noise'], **kw)
    pipe = _port_pipe(state, 'pndm')
    out['compose'] = compose_sweep(pipe, _composite(a, SIZE[0] //
                                                    pipe.vae_scale),
                                   seeds, steps=3, init_size=SIZE,
                                   mesh=mesh, noise=d['compose_noise'])
    # Each seed's own generators: the images do not depend on the ranks.
    out['drawn'] = sweep(pipe, emb, unc, seeds, steps=2, init_size=SIZE,
                         mesh=mesh)
    if dist.get_rank() == 0:
        np.savez(os.path.join(out_dir, 'sweep.npz'), **out)


def _jax_pipe(jm, scheduler):
    from flexdiffuse_tpu.pipeline import FlexPipeline
    return FlexPipeline(jm['unet'], jm['up'], jm['vae'], jm['vp'],
                        scheduler=scheduler)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from flexdiffuse_tpu.models import (AutoencoderKL, TINY_UNET, TINY_VAE,
                                        UNet2DCondition)
    from flexdiffuse_tpu.parallel import (compose_sweep, make_mesh,
                                          seed_sweep_keys)
    from flexdiffuse_tpu.parallel.sweep import guidance_param_sweep, sweep
    from flexdiffuse_tpu.pipeline.guides import (CompositeGuidance,
                                                 entity_masks)
    from flexdiffuse_tpu_torch.weights import params_to_state_dict
    k = jax.random.PRNGKey(0)
    unet, vae = UNet2DCondition(TINY_UNET), AutoencoderKL(TINY_VAE)
    jm = dict(unet=unet, vae=vae,
              up=unet.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                           jnp.zeros((1, 77, 32))),
              vp=vae.init(k, jnp.zeros((1, 16, 16, 3)), k))
    out = tmp_path_factory.mktemp('sweep')
    state = str(out / 'state.pt')
    np_tree = lambda p: jax.tree.map(np.asarray, p)
    torch.save({'unet': params_to_state_dict(np_tree(jm['up']), TINY_UNET),
                'vae': params_to_state_dict(np_tree(jm['vp']), TINY_VAE)},
               state)
    a = _arrays()
    mesh = make_mesh(model_parallel=1)
    emb, unc = jnp.asarray(a['emb']), jnp.asarray(a['unc'])
    f = _jax_pipe(jm, 'pndm').vae_scale
    shape = (SIZE[0] // f, SIZE[1] // f, 4)
    draws, want = {}, {}
    for name, (kind, steps, seed, kw) in CASES.items():
        pipe = _jax_pipe(jm, kind)
        keys = seed_sweep_keys(seed, N)
        if name == 'params':
            # Same seed for every row: the images differ by the settings.
            keys = jnp.tile(seed_sweep_keys(seed, 1), (N, 1))
        draws[f'{name}_noise'] = np.array(jax.vmap(
            lambda kk: jax.random.normal(kk, shape, jnp.float32))(keys))
        e = emb
        if name == 'params':
            e = guidance_param_sweep(jnp.asarray(a['base']),
                                     jnp.asarray(a['alt']), _settings())
        if 'strength' in kw:
            kw = dict(kw, init_image=a['init'])
            draws[f'{name}_posterior'] = np.array(jax.random.normal(
                jax.random.fold_in(keys[0], 0x33), (1,) + shape,
                jnp.float32))
        if name == 'inpaint':
            kw = dict(kw, mask=a['mask'])
            kk = jax.random.fold_in(keys[0], 0x5eed)
            anchors = []
            for _ in range(pipe.schedule(steps).length):
                kk, _, k_inp = jax.random.split(kk, 3)
                anchors.append(np.array(jax.random.normal(
                    k_inp, (N,) + shape, jnp.float32)))
            draws['inpaint_anchor'] = np.stack(anchors)
        want[name] = sweep(pipe, e, unc, keys, steps=steps, init_size=SIZE,
                           mesh=mesh, **kw)
    keys = seed_sweep_keys(1337, N)
    hw = SIZE[0] // f
    jmasks = entity_masks([((0, 0), (hw // 2, hw // 2)),
                           ((hw // 2, hw // 2), (hw // 2, hw // 2))],
                          (hw, hw))
    g = CompositeGuidance(background=jnp.asarray(a['bg']),
                          entities=jnp.asarray(a['ents']), masks=jmasks,
                          blends=jnp.asarray([0.8, 0.6]), uncond=unc,
                          guidance_scale=jnp.float32(7.5))
    draws['compose_noise'] = np.array(jax.vmap(
        lambda kk: jax.random.normal(kk, shape, jnp.float32))(keys))
    want['compose'] = compose_sweep(_jax_pipe(jm, 'pndm'), g, keys,
                                    steps=3, init_size=SIZE, mesh=mesh)
    np.savez(out / 'draws.npz', **draws)
    from flexdiffuse_tpu_torch.parallel import launch
    launch.spawn(_worker, 2, device='cpu',
                 args=(state, str(out / 'draws.npz'), str(out)),
                 timeout=120, join_timeout=400)
    got = dict(np.load(out / 'sweep.npz'))
    return dict(got=got, want={k: np.asarray(v) for k, v in want.items()},
                state=state, draws=draws)


@pytest.mark.parametrize('name', list(CASES) + ['compose'])
def test_sweep_matches_jax(runs, name):
    """Each sweep on 2 ranks returns all N images, equal to JAX's sweep on
    the same draws: txt2img, per-setting conditioning, img2img, Heun's
    img2img (its t_start scaled by rows_per_step, test_cli_and_sweep.py
    :124-167), latent inpainting and regional composition."""
    got, want = runs['got'][name], runs['want'][name]
    assert got.shape == (N, 32, 32, 3) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert np.abs(got[0] - got[1]).max() > 1e-6   # one image per row


def test_inpaint_sweep_keeps_masked_region(runs):
    """The kept (left) half is anchored to the shared init trajectory
    across seeds; the regenerated right halves differ
    (test_cli_and_sweep.py:252-291)."""
    imgs = runs['got']['inpaint']
    left = np.abs(imgs[0][:, :4] - imgs[1][:, :4]).max()
    right = np.abs(imgs[0][:, 16:] - imgs[1][:, 16:]).max()
    assert right > 1e-3
    assert left < 0.2 * right, (left, right)


def test_sweep_image_is_its_seeds_alone(runs):
    """Drawn on the ranks from each seed's generator, image i equals a
    single-process batch-1 run on seed i's noise: the split over ranks
    changes nothing. 1e-5: a rank runs its 4 seeds at batch 4, whose convs
    sum in another order than at batch 1 (observed 2.8e-6)."""
    from flexdiffuse_tpu_torch.pipeline import SimpleGuidance
    a = _arrays()
    pipe = _port_pipe(runs['state'], 'pndm')
    f = pipe.vae_scale
    guide = SimpleGuidance(embeddings=torch.from_numpy(a['emb']),
                           uncond=torch.from_numpy(a['unc']),
                           guidance_scale=8.0)
    for i in (0, N - 1):
        gen = torch.Generator().manual_seed(100 + i)
        noise = torch.randn((SIZE[0] // f, SIZE[1] // f, 4), generator=gen)
        img = pipe(guide, steps=2, init_size=SIZE, noise=noise[None],
                   output_type='np').images
        np.testing.assert_allclose(runs['got']['drawn'][i], img[0], rtol=0,
                                   atol=1e-5)


def test_guidance_param_sweep_matches_jax():
    """The per-setting tweens equal JAX's vmapped groups row for row, mixed
    static configs included (test_cli_and_sweep.py:170-194)."""
    import jax.numpy as jnp

    from flexdiffuse_tpu.parallel.sweep import guidance_param_sweep as jgps
    from flexdiffuse_tpu_torch.parallel import guidance_param_sweep
    rng = np.random.default_rng(5)
    base = rng.normal(size=(77, 32)).astype(np.float32)
    alt = rng.normal(size=(40, 32)).astype(np.float32)
    d = GuidanceParams.ui_defaults()
    params = [
        dataclasses.replace(d, linear=(0.0, 0.3)),
        dataclasses.replace(d, linear=(0.1, 0.5), clustered=0.25),
        dataclasses.replace(d, mode=1, max_guidance=0.5),
        dataclasses.replace(d, threshold_mult=0.25, threshold_floor=0.75),
        dataclasses.replace(d, mode=1, reuse=True, linear=(0.0, 0.2)),
    ]
    got = guidance_param_sweep(torch.from_numpy(base), torch.from_numpy(alt),
                               params)
    want = jgps(jnp.asarray(base), jnp.asarray(alt), params)
    assert got.shape == (5, 77, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_inpaint_sweep_requires_init_image():
    """As JAX's sweep, before any mesh or model work."""
    from flexdiffuse_tpu_torch.parallel import sweep
    a = _arrays()
    with pytest.raises(ValueError, match='requires init_image'):
        sweep(None, torch.from_numpy(a['emb']), torch.from_numpy(a['unc']),
              range(N), steps=2, init_size=SIZE, mask=a['mask'])
