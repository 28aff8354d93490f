"""PyTorch port: the training step (loss, gradients, optimizer, LoRA,
remat, accumulation, EMA, export) held against the JAX package on the CPU.

Both packages get TINY_UNET's weights (JAX init, converted with
``params_to_state_dict``) and the same timesteps and noise: the port is
handed the draws JAX makes from ``jax.random.split(key)``. All fp32.
Tolerances: the loss 1e-5; gradients 1e-4 of each tensor's max|g|; params
after one optimizer step 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from flexdiffuse_tpu import training as jt
from flexdiffuse_tpu.models import TINY_UNET, UNet2DCondition
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.training import train as ttrain
from flexdiffuse_tpu_torch.weights import (lora_factors_to_torch,
                                           params_to_state_dict)
from tests.test_torch_attention import one_torch_thread  # noqa: F401

B, T, D = 2, 7, 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def jax_side():
    unet = UNet2DCondition(TINY_UNET)
    params = jax.jit(lambda k: unet.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, T, D))))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(B, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(B, T, D)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    k_t, k_n = jax.random.split(key)      # diffusion_loss's own draws
    t = np.array(jax.random.randint(k_t, (B,), 0, 1000))
    noise = np.array(jax.random.normal(k_n, lat.shape, jnp.float32))
    return dict(unet=unet, params=params, lat=lat, ctx=ctx, key=key, t=t,
                noise=noise)


def _port_unet(js):
    m = tm.UNet2DCondition(tm.TINY_UNET)
    m.load_state_dict(params_to_state_dict(_np(js['params']), TINY_UNET),
                      strict=True)
    return m


def _draws(js):
    return dict(t=torch.from_numpy(js['t']),
                noise=torch.from_numpy(js['noise']))


def _batch(js):
    return torch.from_numpy(js['lat']), torch.from_numpy(js['ctx'])


@pytest.fixture(scope='module')
def jax_full_grads(jax_side):
    js = jax_side
    cfg = jt.TrainConfig(donate=False)
    acp = jt.train._schedule_tables(cfg)

    def loss_fn(p):
        return jt.diffusion_loss(js['unet'].apply, p, jnp.asarray(js['lat']),
                                 jnp.asarray(js['ctx']), js['key'], acp, cfg)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(js['params'])
    return float(loss), grads


def test_loss_and_full_grads_match_jax(jax_side, jax_full_grads):
    """Observed: loss |Δ| 3.6e-7, gradients max|Δ|/max|g| 4.1e-6."""
    js = jax_side
    want_loss, want_grads = jax_full_grads
    unet = _port_unet(js)
    cfg = tt.TrainConfig()
    loss = tt.diffusion_loss(unet, *_batch(js), ttrain.schedule_tables(cfg),
                             cfg, **_draws(js))
    assert abs(loss.item() - want_loss) <= 1e-5
    loss.backward()
    want = params_to_state_dict(_np(want_grads), TINY_UNET)
    for name, p in unet.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (name, err)


# Loss variants on a linear stand-in model (pred = 0.5·noisy + 0.1), so the
# loss arithmetic is compared without the UNet.
VARIANTS = [dict(prediction_type='v_prediction'), dict(snr_gamma=5.0),
            dict(snr_gamma=5.0, prediction_type='v_prediction'),
            dict(sample_weights=True)]


@pytest.mark.parametrize('variant', VARIANTS)
def test_loss_variants_match_jax(jax_side, variant):
    js = jax_side
    variant = dict(variant)
    sw = np.array([1.0, 0.7], np.float32) if variant.pop(
        'sample_weights', False) else None
    jcfg, tcfg = jt.TrainConfig(**variant), tt.TrainConfig(**variant)
    want = jt.diffusion_loss(
        lambda p, x, t, c: 0.5 * x + 0.1, {}, jnp.asarray(js['lat']),
        jnp.asarray(js['ctx']), js['key'], jt.train._schedule_tables(jcfg),
        jcfg, sample_weights=None if sw is None else jnp.asarray(sw))
    got = tt.diffusion_loss(
        lambda x, t, c: 0.5 * x + 0.1, *_batch(js),
        ttrain.schedule_tables(tcfg), tcfg,
        sample_weights=None if sw is None else torch.from_numpy(sw),
        **_draws(js))
    assert abs(got.item() - float(want)) <= 1e-5


def test_train_step_matches_jax(jax_side, jax_full_grads):
    """One clip + AdamW update (optax on JAX's gradients vs the port's
    step). Observed max|Δ| ≈ 1e-6 at lr 1e-5 (Adam's first step moves every
    weight by about lr, so a gradient near 0 that the two frameworks round
    differently moves by up to 2·lr)."""
    js = jax_side
    jcfg = jt.TrainConfig(learning_rate=1e-5, donate=False)
    want = params_to_state_dict(
        _np(_optax_step(jcfg, js['params'], jax_full_grads[1])), TINY_UNET)
    unet = _port_unet(js)
    step, _ = tt.make_train_step(unet, tt.TrainConfig(learning_rate=1e-5))
    step(*_batch(js), **_draws(js))
    for name, p in unet.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   rtol=0, atol=1e-5, err_msg=name)


def _optax_step(cfg, params, grads):
    """One update of the JAX package's optimizer from fresh state."""
    tx = jt.make_optimizer(cfg)

    def step(p, g):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    return jax.jit(step)(params, grads)


@pytest.fixture(scope='module')
def lora_side(jax_side):
    js = jax_side
    cfg = jt.TrainConfig(learning_rate=1e-4, donate=False)
    factors = jt.init_lora(js['params'], rank=4)
    acp = jt.train._schedule_tables(cfg)

    def loss_fn(f):
        eff = jt.merge_lora_params(js['params'], f)
        return jt.diffusion_loss(js['unet'].apply, eff,
                                 jnp.asarray(js['lat']),
                                 jnp.asarray(js['ctx']), js['key'], acp, cfg)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(factors)
    return dict(factors=factors, loss=float(loss),
                stepped=_optax_step(cfg, factors, grads))


def test_lora_factors_merge_and_step_match_jax(jax_side, lora_side):
    """JAX init_lora's factors through lora_factors_to_torch: every port
    target gets one; the merge is an exact no-op at step 0; one LoRA step
    updates the factors as JAX's does (observed max|Δ| 2.8e-7)."""
    js = jax_side
    unet = _port_unet(js)
    factors = lora_factors_to_torch(_np(lora_side['factors']))
    assert sorted(factors) == sorted(ttrain.lora_targets(unet))
    merged = tt.merge_lora_params(unet, factors)
    for name, w in merged.items():
        assert torch.equal(w, unet.get_submodule(name[:-len('.weight')])
                           .weight)
    step, _ = tt.make_lora_train_step(unet, factors,
                                      tt.TrainConfig(learning_rate=1e-4))
    loss = step(*_batch(js), **_draws(js))
    assert abs(loss.item() - lora_side['loss']) <= 1e-5
    want = lora_factors_to_torch(_np(lora_side['stepped']))
    for name, fac in factors.items():
        for part in ('down', 'up'):
            np.testing.assert_allclose(fac[part].detach().numpy(),
                                       want[name][part].numpy(), rtol=0,
                                       atol=1e-5, err_msg=f'{name}/{part}')
    assert not any(p.requires_grad for p in unet.parameters())


def test_port_init_lora_targets_and_noop(jax_side):
    unet = _port_unet(jax_side)
    factors = tt.init_lora(unet, rank=4,
                           generator=torch.Generator().manual_seed(0))
    assert len(factors) == len(ttrain.lora_targets(unet)) == 40
    assert len(tt.init_lora(unet, rank=4, include_ff=False)) == 32
    for f in factors.values():
        assert f['down'].shape[0] == 4 and f['up'].shape[1] == 4
        assert not f['up'].any()
    for name, w in tt.merge_lora_params(unet, factors).items():
        assert torch.equal(w, unet.get_submodule(name[:-len('.weight')])
                           .weight)


@pytest.mark.parametrize('mode', ['full', 'dots'])
def test_remat_matches_no_remat(jax_side, mode):
    """Rematerialization changes memory, not math: one step with remat
    gives the loss and the params of one without."""
    outs = []
    for remat in ('none', mode):
        unet = _port_unet(jax_side)
        step, _ = tt.make_train_step(
            unet, tt.TrainConfig(learning_rate=1e-3, remat=remat))
        loss = step(*_batch(jax_side), **_draws(jax_side))
        outs.append((loss.item(), [p.detach() for p in unet.parameters()]))
    assert outs[0][0] == outs[1][0]
    for a, b in zip(outs[0][1], outs[1][1]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def _adamw_grads(opt) -> list:
    """Record, at each AdamW step of ``opt``, the gradients it steps on
    (after accumulation and clipping)."""
    seen, real = [], opt.adamw.step

    def step(*args, **kwargs):
        seen.append([p.grad.clone() for p in opt.params])
        return real(*args, **kwargs)
    opt.adamw.step = step
    return seen


def test_grad_accum_matches_one_step_on_the_joined_batch(jax_side):
    """grad_accum=2 over two halves == one step on the joined batch (the
    loss is a mean over rows, so the mean of the halves' gradients is the
    joined batch's); params stay unchanged after the first micro-step.

    The two runs sum in different orders, and AdamW's first step maps a
    gradient g to lr·g/(|g| + 1e-8): at |g| near 1e-8 a rounding difference
    δg moves the update by up to lr·δg/4e-8 (2.5e4·δg here). So the
    joined batch is held where the comparison is well conditioned, on the
    gradient AdamW receives (within 1e-6 of each tensor's max|g|; this
    CPU reads ≤ 1e-8), and the update on that gradient is held against one
    AdamW step from the initial weights (within 2e-6)."""
    lat, ctx = _batch(jax_side)
    rng = np.random.default_rng(4)
    lat = torch.cat([lat, torch.from_numpy(
        rng.normal(size=lat.shape).astype(np.float32))])
    ctx = torch.cat([ctx, ctx.flip(0)])
    t = torch.tensor([10, 500, 900, 250])
    noise = torch.from_numpy(rng.normal(size=lat.shape).astype(np.float32))
    cfg = tt.TrainConfig(learning_rate=1e-3)
    step, ref_opt = tt.make_train_step(_port_unet(jax_side), cfg)
    joined = _adamw_grads(ref_opt)
    step(lat, ctx, t=t, noise=noise)

    unet = _port_unet(jax_side)
    before = [p.detach().clone() for p in unet.parameters()]
    step, opt = tt.make_train_step(
        unet, dataclasses.replace(cfg, grad_accum=2))
    accum = _adamw_grads(opt)
    step(lat[:2], ctx[:2], t=t[:2], noise=noise[:2])
    for a, b in zip(before, unet.parameters()):
        assert torch.equal(a, b)
    assert opt.mini_step == 1 and not accum
    step(lat[2:], ctx[2:], t=t[2:], noise=noise[2:])
    assert len(joined) == len(accum) == 1
    for gj, ga in zip(joined[0], accum[0]):
        torch.testing.assert_close(ga, gj, rtol=0,
                                   atol=1e-6 * float(gj.abs().max()))
    once = _port_unet(jax_side)
    adamw = tt.make_optimizer(once.parameters(), cfg).adamw
    for p, g in zip(once.parameters(), accum[0]):
        p.grad = g
    adamw.step()
    for a, b in zip(once.parameters(), unet.parameters()):
        torch.testing.assert_close(b, a, rtol=0, atol=2e-6)


def test_ema_update_formula():
    ema = {'k': torch.ones(3)}
    out = tt.ema_update(ema, {'k': torch.full((3,), 2.0)}, 0.9)
    assert out is ema
    torch.testing.assert_close(ema['k'], torch.full((3,), 1.1))


def test_lora_export_matches_jax(jax_side, tmp_path):
    """The port's safetensors of the converted factors holds the keys and
    arrays of JAX's export_lora_safetensors."""
    from safetensors.numpy import load_file
    factors = jax.tree.map(
        lambda x: x + 0.01 * np.arange(x.size, dtype=np.float32).reshape(
            x.shape) / x.size, jt.init_lora(jax_side['params'], rank=4))
    jpath, tpath = str(tmp_path / 'jax.st'), str(tmp_path / 'port.st')
    n = jt.export_lora_safetensors(factors, jpath)
    assert tt.export_lora_safetensors(
        lora_factors_to_torch(_np(factors)), tpath) == n
    want, got = load_file(jpath), load_file(tpath)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize('mode', ['full', 'lora'])
def test_training_reduces_loss_on_one_draw(jax_side, mode):
    """Overfit one (batch, timestep, noise) draw: the loss must fall."""
    unet = _port_unet(jax_side)
    if mode == 'full':
        step, _ = tt.make_train_step(
            unet, tt.TrainConfig(learning_rate=3e-4, weight_decay=0.0))
    else:
        factors = tt.init_lora(unet, rank=4,
                               generator=torch.Generator().manual_seed(1))
        step, _ = tt.make_lora_train_step(
            unet, factors, tt.TrainConfig(learning_rate=1e-2,
                                          weight_decay=0.0))
    losses = [step(*_batch(jax_side), **_draws(jax_side)).item()
              for _ in range(25)]
    assert losses[-1] < (0.5 if mode == 'full' else 0.8) * losses[0], losses


@pytest.mark.parametrize('remat,k3', [('none', 3), ('full', 6), ('dots', 6)])
def test_flash_path_calls_per_step(monkeypatch, remat, k3):
    """How often one train step runs each flash kernel's path, counted on
    the plain twins that stand in for the kernels on the CPU. TINY_UNET at a
    32×32 latent has three flash-eligible self-attentions (1024 tokens):
    one step runs the K3 path once per attention (twice under 'full' and
    'dots', whose backward recomputes the forward), K4 and K5 once each, and
    never K1. (SD-1.4 at 512² has ten.)"""
    calls = {'k1': 0, 'k3': 0, 'k4': 0, 'k5': 0}

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(fa, 'plain_attention',
                        counting('k1', fa.plain_attention))
    for name, attr in (('k3', 'plain_attention_lse'),
                       ('k4', 'plain_attention_dq'),
                       ('k5', 'plain_attention_dkv')):
        monkeypatch.setattr(fb, attr, counting(name, getattr(fb, attr)))
    torch.manual_seed(0)
    unet = tm.UNet2DCondition(tm.TINY_UNET)
    step, _ = tt.make_train_step(
        unet, tt.TrainConfig(remat=remat, attention_backend='flash'))
    g = torch.Generator().manual_seed(0)
    step(torch.randn((1, 32, 32, 4), generator=g),
         torch.randn((1, T, D), generator=g), generator=g)
    assert calls == {'k1': 0, 'k3': k3, 'k4': 3, 'k5': 3}


def test_world1_mesh_trains_bit_equal(jax_side, tmp_path):
    """A data mesh over a one-rank gloo group trains bit-equal to no mesh:
    the global draws, the rows of rank 0 (all of them), a gradient
    all-reduce over one rank. The multi-rank cases are
    ``tests/test_torch_parallel.py``'s."""
    import torch.distributed as dist

    from flexdiffuse_tpu_torch.parallel import launch, make_mesh
    lat, ctx = _batch(jax_side)
    runs = []
    launch.init_rank(0, 1, str(tmp_path / 'store'), 'cpu', timeout=60)
    try:
        for mesh in (None, make_mesh()):
            unet = _port_unet(jax_side)
            step, _ = tt.make_train_step(unet, tt.TrainConfig(), mesh=mesh)
            g = torch.Generator().manual_seed(5)
            losses = [step(lat, ctx, generator=g) for _ in range(2)]
            runs.append((losses, [p.detach() for p in unet.parameters()]))
    finally:
        dist.destroy_process_group()
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
