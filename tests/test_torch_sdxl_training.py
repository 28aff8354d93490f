"""PyTorch port: SDXL training (``encode_dataset_sdxl`` and ``added_cond``
through the train steps and loops) held against the JAX package on the CPU.

Both packages get TINY_SDXL_UNET's and TINY_VAE's weights (JAX init,
converted with ``params_to_state_dict``), the stub dual-tower encoder of
``tests/test_sdxl_training.py`` and, for the steps, the timesteps and noise
JAX draws from its key. All fp32. Tolerances: the loss 1e-5; gradients
1e-4 of each tensor's max|g|; parameters after one AdamW step 1e-5; the
dataset's samples 1e-6; the VAE posterior and the merged UNets 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flexdiffuse_tpu import training as jt
from flexdiffuse_tpu.models import TINY_VAE as J_TINY_VAE
from flexdiffuse_tpu.models import AutoencoderKL, UNet2DCondition
from flexdiffuse_tpu.models.configs import TINY_SDXL_UNET as J_SDXL
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.models import unet as unet_mod
from flexdiffuse_tpu_torch.training import train as ttrain
from flexdiffuse_tpu_torch.weights import (lora_factors_to_torch,
                                           params_to_state_dict)
from flexdiffuse_tpu_torch.weights import load as tload
from flexdiffuse_tpu_torch.weights import lora as tlora
from tests.test_sdxl_training import StubSDXLEncoder, _write_images
from tests.test_torch_attention import one_torch_thread  # noqa: F401

T_SDXL = tm.TINY_SDXL_UNET
B, CTX, POOLED = 2, J_SDXL.cross_attention_dim, J_SDXL.addition_pooled_dim


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class TorchStubEncoder:
    """The JAX tests' stub SDXLTextEncoder, returning torch tensors."""

    def encode(self, prompts):
        ctx, pooled = StubSDXLEncoder().encode(prompts)
        return (torch.from_numpy(np.array(ctx)),
                torch.from_numpy(np.array(pooled)))


@pytest.fixture(scope='module')
def jax_side():
    unet = UNet2DCondition(J_SDXL)
    ac = {'text_embeds': jnp.zeros((1, POOLED)),
          'time_ids': jnp.zeros((1, 6))}
    params = _np(jax.jit(lambda k: unet.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, CTX)), added_cond=ac))(jax.random.PRNGKey(0)))
    vae = AutoencoderKL(J_TINY_VAE)
    k = jax.random.PRNGKey(0)
    vp = _np(vae.init(k, jnp.zeros((1, 8, 8, 3)), k))
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(B, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(B, 77, CTX)).astype(np.float32)
    extra = {'text_embeds': rng.normal(size=(B, POOLED)).astype(np.float32),
             'time_ids': np.broadcast_to(
                 np.array([16, 16, 0, 0, 16, 16], np.float32), (B, 6)).copy()}
    key = jax.random.PRNGKey(3)
    k_t, k_n = jax.random.split(key)      # diffusion_loss's own draws
    t = np.array(jax.random.randint(k_t, (B,), 0, 1000))
    noise = np.array(jax.random.normal(k_n, lat.shape, jnp.float32))
    return dict(unet=unet, params=params, vae=vae, vae_params=vp, lat=lat,
                ctx=ctx, extra=extra, key=key, t=t, noise=noise)


def _port_unet(js):
    m = tm.UNet2DCondition(T_SDXL)
    m.load_state_dict(params_to_state_dict(js['params'], T_SDXL),
                      strict=True)
    return m


def _port_vae(js):
    m = tm.AutoencoderKL(tm.TINY_VAE)
    m.load_state_dict(params_to_state_dict(js['vae_params'], tm.TINY_VAE),
                      strict=True)
    return m.eval()


def _torch(js):
    return (torch.from_numpy(js['lat']), torch.from_numpy(js['ctx']),
            {k: torch.from_numpy(v) for k, v in js['extra'].items()})


def _draws(js):
    return dict(t=torch.from_numpy(js['t']),
                noise=torch.from_numpy(js['noise']))


def _jax_extra(js, shift=0.0):
    return {'text_embeds': jnp.asarray(js['extra']['text_embeds'] + shift),
            'time_ids': jnp.asarray(js['extra']['time_ids'])}


def _optax_step(cfg, params, grads):
    tx = jt.make_optimizer(cfg)

    def step(p, g):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    return _np(jax.jit(step)(params, grads))


def _close_grads(named_grads, want: dict) -> None:
    for name, g in named_grads:
        ref = want[name].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1e-30), (name, err)


def test_encode_dataset_sdxl_matches_jax(jax_side, tmp_path):
    """The port's ``encode_dataset_sdxl`` gives JAX's posterior, context,
    pooled embeddings and time ids (``time_ids[0, 0]`` the resolution);
    pooled and time ids fp32."""
    js = jax_side
    d = str(tmp_path / 'ds')
    _write_images(d)
    want = jt.encode_dataset_sdxl(jt.find_items(d), js['vae'],
                                  js['vae_params'], StubSDXLEncoder(),
                                  resolution=16)
    got = tt.encode_dataset_sdxl(tt.find_items(d), _port_vae(js),
                                 TorchStubEncoder(), resolution=16)
    assert got.captions == want.captions
    for name in ('mean', 'logvar'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-5, err_msg=name)
    for name in ('context', 'pooled', 'time_ids'):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.pooled.dtype == got.time_ids.dtype == torch.float32
    assert got.time_ids.shape == (1, 6) and got.time_ids[0, 0] == 16.0


def test_sample_added_cond_matches_jax():
    """``sample`` with the indices and posterior noise JAX's first batch
    draws yields its latents, contexts and ``added_cond`` (time ids
    broadcast to the batch)."""
    rng = np.random.default_rng(0)
    mean, logvar = (rng.normal(size=(5, 8, 8, 4)).astype(np.float32)
                    for _ in range(2))
    ctx = rng.normal(size=(5, 77, CTX)).astype(np.float32)
    pooled = rng.normal(size=(5, POOLED)).astype(np.float32)
    tids = np.array([[32, 32, 0, 0, 32, 32]], np.float32)
    jds = jt.EncodedDataset(jnp.asarray(mean), jnp.asarray(logvar),
                            jnp.asarray(ctx), ['c'] * 5,
                            pooled=jnp.asarray(pooled),
                            time_ids=jnp.asarray(tids))
    key = jax.random.PRNGKey(42)
    want = next(jds.batches(2, key))
    epoch_key, perm_key = jax.random.split(key)   # data.py batches' chain
    order = np.asarray(jax.random.permutation(perm_key, 5))
    _, draw = jax.random.split(epoch_key)
    noise = np.array(jax.random.normal(draw, (2, 8, 8, 4), jnp.float32))
    ds = tt.EncodedDataset(*(torch.from_numpy(a) for a in (mean, logvar,
                                                            ctx)),
                           ['c'] * 5, pooled=torch.from_numpy(pooled),
                           time_ids=torch.from_numpy(tids))
    lat, c, added = ds.sample(torch.from_numpy(order[:2].copy()),
                              torch.from_numpy(noise))
    np.testing.assert_allclose(lat.numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want[1]))
    assert sorted(added) == sorted(want[2]) == ['text_embeds', 'time_ids']
    for k in added:
        np.testing.assert_array_equal(added[k].numpy(),
                                      np.asarray(want[2][k]), err_msg=k)
    assert added['time_ids'].shape == (2, 6)
    with pytest.raises(ValueError, match='pooled'):
        tt.EncodedDataset(*(torch.from_numpy(a) for a in (mean, logvar,
                                                          ctx)),
                          ['c'] * 5, pooled=torch.zeros((4, POOLED)))
    batch = next(ds.batches(2, torch.Generator().manual_seed(0)))
    assert len(batch) == 3 and batch[2]['time_ids'].shape == (2, 6)


def _jax_full(js, remat):
    cfg = jt.TrainConfig(donate=False, remat=remat)
    acp = jt.train._schedule_tables(cfg)
    apply_fn = jt.train._remat_apply(js['unet'].apply, cfg)

    def loss_fn(p, extra):
        return jt.diffusion_loss(apply_fn, p, jnp.asarray(js['lat']),
                                 jnp.asarray(js['ctx']), js['key'], acp,
                                 cfg, added_cond=extra)

    vg = jax.jit(jax.value_and_grad(loss_fn))
    loss, grads = vg(js['params'], _jax_extra(js))
    moved, _ = vg(js['params'], _jax_extra(js, 1.0))
    return float(loss), _np(grads), float(moved)


@pytest.mark.parametrize('remat', ['none', 'full'])
def test_full_step_with_added_cond_matches_jax(jax_side, remat):
    """``make_train_step``'s step with ``extra``: the loss and every
    parameter's gradient match JAX's at remat 'none' and 'full', and the
    parameters after one update match optax's; ``text_embeds`` moves the
    loss in both packages."""
    js = jax_side
    want_loss, want_grads, want_moved = _jax_full(js, remat)
    assert want_moved != want_loss
    cfg = tt.TrainConfig(remat=remat)
    unet = _port_unet(js)
    lat, ctx, extra = _torch(js)
    loss = tt.diffusion_loss(ttrain._remat_apply(unet, cfg), lat, ctx,
                             ttrain.schedule_tables(cfg), cfg,
                             added_cond=extra, **_draws(js))
    assert abs(loss.item() - want_loss) <= 1e-5
    loss.backward()
    _close_grads(((n, p.grad) for n, p in unet.named_parameters()),
                 params_to_state_dict(want_grads, T_SDXL))

    jcfg = jt.TrainConfig(learning_rate=1e-5, donate=False, remat=remat)
    want = params_to_state_dict(_optax_step(jcfg, js['params'], want_grads),
                                T_SDXL)
    unet = _port_unet(js)
    step, _ = tt.make_train_step(unet, tt.TrainConfig(learning_rate=1e-5,
                                                      remat=remat))
    got = step(lat, ctx, extra, **_draws(js))
    assert abs(got.item() - want_loss) <= 1e-5
    for name, p in unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)
    shifted = dict(extra, text_embeds=extra['text_embeds'] + 1.0)
    moved = tt.diffusion_loss(_port_unet(js), lat, ctx,
                              ttrain.schedule_tables(cfg), cfg,
                              added_cond=shifted, **_draws(js))
    assert abs(moved.item() - want_moved) <= 1e-5
    assert moved.item() != loss.item()


def test_lora_step_with_added_cond_matches_jax(jax_side):
    """``make_lora_train_step``'s step with ``extra``: the loss, the
    factors' gradients and the factors after one update match JAX's."""
    js = jax_side
    cfg = jt.TrainConfig(learning_rate=1e-4, donate=False)
    factors = _np(jt.init_lora(js['params'], rank=4))
    acp = jt.train._schedule_tables(cfg)

    def loss_fn(f):
        eff = jt.merge_lora_params(js['params'], f)
        return jt.diffusion_loss(js['unet'].apply, eff,
                                 jnp.asarray(js['lat']),
                                 jnp.asarray(js['ctx']), js['key'], acp,
                                 cfg, added_cond=_jax_extra(js))

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(factors)
    want_grads = lora_factors_to_torch(_np(grads))
    want = lora_factors_to_torch(_optax_step(cfg, factors, grads))
    unet = _port_unet(js)
    tfac = lora_factors_to_torch(factors)
    assert sorted(tfac) == sorted(ttrain.lora_targets(unet))
    captured = {}
    for name, fac in tfac.items():
        for part in ('down', 'up'):
            fac[part].requires_grad_()
            fac[part].register_hook(
                lambda g, key=f'{name}/{part}': captured.update({key: g}))
    step, _ = tt.make_lora_train_step(unet, tfac,
                                      tt.TrainConfig(learning_rate=1e-4))
    lat, ctx, extra = _torch(js)
    loss = step(lat, ctx, extra, **_draws(js))
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    _close_grads(((k, g) for k, g in captured.items()),
                 {f'{n}/{p}': want_grads[n][p] for n in want_grads
                  for p in ('down', 'up')})
    assert len(captured) == 2 * len(tfac)
    for name, fac in tfac.items():
        for part in ('down', 'up'):
            np.testing.assert_allclose(fac[part].detach().numpy(),
                                       want[name][part].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f'{name}/{part}')


def test_time_ids_reach_the_sinusoid_in_fp32_under_autocast(jax_side):
    """Under bf16 autocast the UNet still computes the time ids' sinusoidal
    features from the fp32 ids: ``add_embedding`` receives exactly the
    features of the fp32 computation (1023 is not a bf16 value)."""
    unet = _port_unet(jax_side)
    tids = torch.tensor([[1023.0, 1017.0, 3.0, 5.0, 1023.0, 999.0]])
    added = {'text_embeds': torch.zeros((1, POOLED)), 'time_ids': tids}
    seen = []
    hook = unet.add_embedding.register_forward_pre_hook(
        lambda m, args: seen.append(args[0].detach().clone()))
    try:
        with torch.autocast('cpu', dtype=torch.bfloat16):
            unet.embed_time(torch.tensor([10.0]), added_cond=added)
    finally:
        hook.remove()
    feats = unet_mod.timestep_embedding(tids.reshape(-1),
                                        T_SDXL.addition_time_embed_dim)
    assert seen[0].dtype == torch.float32
    assert torch.equal(seen[0][:, POOLED:], feats.reshape(1, -1))


def _sdxl_dataset(js, tmp_path):
    d = str(tmp_path / 'ds')
    _write_images(d)
    return tt.encode_dataset_sdxl(tt.find_items(d), _port_vae(js),
                                  TorchStubEncoder(), resolution=16)


def test_train_lora_on_sdxl_merges_alike(jax_side, tmp_path):
    """``train_lora`` on an SDXL dataset exports a kohya file; the JAX
    package's ``apply_lora`` merges it into the JAX SDXL params and the
    port's (``unet_config=TINY_SDXL_UNET``) into the port's UNet, and the
    two merged UNets agree."""
    from safetensors.numpy import load_file

    from flexdiffuse_tpu.weights import lora as jlora
    js = jax_side
    out = str(tmp_path / 'sdxl_lora.safetensors')
    factors, losses = tt.train_lora(
        _port_unet(js), _sdxl_dataset(js, tmp_path),
        tt.TrainConfig(learning_rate=5e-3, weight_decay=0.0), rank=2,
        steps=4, batch_size=2, save_path=out, log_every=2)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert any(f['up'].abs().max() > 0 for f in factors.values())
    merged, _ = jlora.apply_lora(js['params'], None, load_file(out),
                                 scale=1.0, unet_config=J_SDXL)
    want = params_to_state_dict(_np(merged), T_SDXL)
    unet = _port_unet(js)
    applied = tlora.apply_lora(unet, None, tload.load_state_dict(out),
                               unet_config=T_SDXL)
    assert len(applied) == len(factors)
    base = params_to_state_dict(js['params'], T_SDXL)
    assert any(not torch.equal(want[k], base[k]) for k in base)
    for k, v in unet.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize('ema_decay', [0.0, 0.5])
def test_sdxl_full_resume_bitwise_exact(jax_side, tmp_path, ema_decay):
    """SDXL ``train_full`` interrupted at 3/6 then resumed equals an
    uninterrupted run of 6, bit for bit (the batches carry
    ``added_cond``), with and without EMA (then the EMA tensors)."""
    js = jax_side
    ds = _sdxl_dataset(js, tmp_path)
    cfg = tt.TrainConfig(learning_rate=1e-3, weight_decay=0.0,
                         ema_decay=ema_decay)
    want, want_losses = tt.train_full(_port_unet(js), ds, cfg, steps=6,
                                      batch_size=2, seed=7, log_every=1)
    cdir = str(tmp_path / 'ckpt')
    tt.train_full(_port_unet(js), ds, cfg, steps=3, batch_size=2, seed=7,
                  log_every=1, checkpoint_dir=cdir)
    got, got_losses = tt.train_full(_port_unet(js), ds, cfg, steps=6,
                                    batch_size=2, seed=999, log_every=1,
                                    checkpoint_dir=cdir)
    assert sorted(want) == sorted(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    assert got_losses == want_losses and len(got_losses) == 6
    assert os.path.isdir(cdir)
