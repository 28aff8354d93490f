"""PyTorch port: DDIM, K-LMS and PNDM's PRK mode held against the JAX
package on the CPU.

(a) Every schedule table equals JAX's.
(b) ``tests/test_golden.py``'s DDIM and LMS loops (TINY_UNET, CFG 8, 4
    steps) through the port's UNet and schedulers hit the committed goldens,
    and through the port's schedulers on the JAX UNet's ε too.
(c) Each stepper alone, fed the JAX loop's ε at every step, reproduces the
    JAX latents (DDIM also at η > 0 with JAX's variance noise injected).
(d) ``add_noise``, ``anchor_noise`` and ``scale_model_input`` per kind
    equal JAX's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import schedulers as jsch
from flexdiffuse_tpu_torch import schedulers
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_slice import models  # noqa: F401

GOLDENS = os.path.join(os.path.dirname(__file__), 'goldens')
PRK = schedulers.SchedulerConfig(skip_prk_steps=False)
JPRK = jsch.SchedulerConfig(skip_prk_steps=False)
# (kind, port config, JAX config): DDIM with diffusers' defaults and with
# the JAX package's other DDIM switches, LMS, PNDM in PRK mode.
KINDS = [('ddim', None, None),
         ('ddim', schedulers.SchedulerConfig(clip_sample=False,
                                             set_alpha_to_one=False),
          jsch.SchedulerConfig(kind='ddim', clip_sample=False,
                               set_alpha_to_one=False)),
         ('lms', None, None), ('pndm', PRK, JPRK)]
TABLES = ('timesteps', 'alphas_cumprod', 'final_alpha_cumprod', 'sigmas',
          'lms_coeffs', 't_tr', 'prev_tr', 'eps_a', 'eps_b', 'eps_w',
          'acc_g', 'acc_keep')


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize('kind,cfg,jcfg', KINDS)
@pytest.mark.parametrize('steps', [4, 25, 30])
def test_schedule_tables_match_jax(kind, cfg, jcfg, steps):
    got = schedulers.make(kind, steps, cfg)
    ref = jsch.make(kind, steps, jcfg)
    assert (got.length, got.ratio, got.steps_offset, got.num_steps) == (
        ref.length, ref.ratio, ref.steps_offset, ref.num_steps)
    assert got.clip_sample == ref.clip_sample
    for name in TABLES:
        r = getattr(ref, name, None)
        if r is None or (name in ('sigmas', 'lms_coeffs') and kind != 'lms'):
            continue
        np.testing.assert_array_equal(getattr(got, name).numpy(), _np(r),
                                      err_msg=name)
    if kind == 'pndm':
        for name in ('push', 'stash', 'use_stash'):
            assert getattr(got, name) == tuple(_np(getattr(ref, name)))
    for strength in (0.3, 0.6, 1.0):
        assert (schedulers.init_timestep_info(got, strength, steps) ==
                jsch.init_timestep_info(ref, strength, steps))


def test_make_names_the_step_that_ports_a_kind():
    with pytest.raises(NotImplementedError, match='step 9'):
        schedulers.make('euler', 10)
    with pytest.raises(ValueError):
        schedulers.make('no_such_scheduler', 10)
    with pytest.raises(ValueError):
        schedulers.make('pndm', 3, PRK)


def _jax_unet(models, jit=False):
    """The JAX golden UNet behind the port UNet's call signature: op by op
    as tests/test_golden.py runs it, or compiled by XLA."""
    apply = jax.jit(models['unet'].apply) if jit else models['unet'].apply

    def unet(x, t, ctx):
        return torch.from_numpy(np.array(apply(
            models['unet_params'], jnp.asarray(x.numpy()),
            jnp.asarray(t.numpy()), jnp.asarray(ctx.numpy()))))

    return unet


def _port_loop(models, kind, steps=4, unet=None):
    """tests/test_golden.py's loop through the port's scheduler and the
    port's UNet (or ``unet``)."""
    lat = np.asarray(jax.random.normal(jax.random.PRNGKey(7), (1, 8, 8, 4),
                                       jnp.float32))
    ctx = torch.from_numpy(models['ctx'])
    unet = models['port_unet'] if unet is None else unet
    sch = schedulers.make(kind, steps)
    lat = torch.from_numpy(lat.copy())
    if kind == 'lms':
        lat = lat * sch.sigmas[0]
    state = schedulers.init_state(sch, lat.shape, lat.dtype)
    with torch.no_grad():
        for i in range(sch.length):
            xin = schedulers.scale_model_input(sch, lat, i)
            eps = unet(torch.cat([xin, xin]), sch.timesteps[i].expand(2), ctx)
            eps_u, eps_c = eps.chunk(2)
            eps = eps_u + 8.0 * (eps_c - eps_u)
            state, lat = schedulers.step(sch, state, eps, i, i, lat)
    return lat.numpy()


@pytest.mark.parametrize('kind', ['ddim', 'lms'])
def test_golden_loop(models, kind):
    """The gap is the UNets', as in test_golden_pndm_loop: with CFG 8 the
    two UNets' ε differ by ~1.5e-5 per step, while the steppers agree to
    ulps (test_stepper_matches_jax_on_the_same_eps). DDIM: 1e-4 (observed
    8.3e-5; its clipped x0 keeps |x| ≤ 1). LMS carries x in σ space (σ₀ =
    14.6), so the same ε gap arrives scaled by σ and 1e-4 does not hold:
    the bound is 1e-5 of max|x| (observed 2.3e-4 at max|x| = 65.2, 3.6e-6
    relative; PNDM's is 2.8e-6). test_golden_loop_on_jax_eps is the
    witness: the port's loop on the golden's own ε is within 7.6e-6, and
    the JAX UNet under ``jax.jit`` misses the golden by 2.3e-4 as well."""
    want = np.load(os.path.join(GOLDENS, f'latents_{kind}.npy'))
    atol = 1e-4 if kind == 'ddim' else 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(_port_loop(models, kind), want, rtol=0,
                               atol=atol)


@pytest.mark.parametrize('kind', ['ddim', 'lms'])
def test_golden_loop_on_jax_eps(models, kind):
    """The witness for test_golden_loop's LMS bound. The port's loop (its
    σ₀-scaled start, scale_model_input and stepper) with the golden's own
    ε, the JAX UNet run op by op, hits the golden within 1e-4. The same
    JAX UNet compiled by ``jax.jit`` (other fusions, other fp32 rounding)
    lands as far from the LMS golden as the port's UNet does, within
    test_golden_loop's bound: the gap there is the UNet's fp32 rounding
    scaled by σ, not the port's loop."""
    want = np.load(os.path.join(GOLDENS, f'latents_{kind}.npy'))
    got = _port_loop(models, kind, unet=_jax_unet(models))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    jitted = _port_loop(models, kind, unet=_jax_unet(models, jit=True))
    gap = np.abs(jitted - want).max()
    print(f'{kind}: op by op {np.abs(got - want).max():.3e}, jitted '
          f'{gap:.3e}, max|x| {np.abs(want).max():.3e}')
    assert gap <= (1e-4 if kind == 'ddim' else 1e-5 * np.abs(want).max())


def _jax_eps_chain(models, sch, jlat):
    """The JAX golden loop's ε at each position, as a function of the
    current JAX latents."""
    unet, params = models['unet'], models['unet_params']
    ctx = jnp.asarray(models['ctx'])
    apply = jax.jit(unet.apply)

    def eps_at(i, lat):
        xin = jsch.scale_model_input(sch, lat, jnp.int32(i))
        eps = apply(params, jnp.concatenate([xin, xin]),
                    jnp.broadcast_to(sch.timesteps[i], (2,)), ctx)
        eps_u, eps_c = jnp.split(eps, 2)
        return eps_u + 8.0 * (eps_c - eps_u)

    return eps_at


STEPPERS = [('ddim', None, None, 0.0), ('ddim', None, None, 0.7),
            ('lms', None, None, 0.0), ('pndm', PRK, JPRK, 0.0)]


@pytest.mark.parametrize('kind,cfg,jcfg,eta', STEPPERS)
def test_stepper_matches_jax_on_the_same_eps(models, kind, cfg, jcfg, eta):
    """The scheduler arithmetic alone: the JAX loop's ε (and, for DDIM at
    η > 0, the variance noise JAX draws from each step's key) fed to the
    port's step reproduces the JAX latents at every step, to 2e-6.
    Observed: DDIM bit-equal at η 0 and 0.7; LMS 4.8e-7 at |x| ≈ 65; PRK
    bit-equal through the RK warm-up and 9.5e-7 (1 ulp at |x| ≈ 19.6) in
    its PLMS phase, from the order of the multistep sums."""
    steps = 5 if kind == 'pndm' else 4
    jsc, tsch = jsch.make(kind, steps, jcfg), schedulers.make(kind, steps,
                                                               cfg)
    jlat = jax.random.normal(jax.random.PRNGKey(7), (1, 8, 8, 4), jnp.float32)
    if kind == 'lms':
        jlat = jlat * jsc.sigmas[0]
    tlat = torch.from_numpy(np.array(jlat))
    jstate = jsch.init_state(jsc, jlat.shape, jlat.dtype)
    tstate = schedulers.init_state(tsch, tlat.shape, tlat.dtype)
    eps_at = _jax_eps_chain(models, jsc, jlat)
    key = jax.random.PRNGKey(3)
    for i in range(jsc.length):
        eps = eps_at(i, jlat)
        key, sub = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax.random.normal(
            sub, jlat.shape, jnp.float32))) if eta else None
        jstate, jlat = jsch.step(jsc, jstate, eps, jnp.int32(i), jnp.int32(i),
                                 jlat, sub if eta else None, eta)
        tstate, tlat = schedulers.step(tsch, tstate,
                                       torch.from_numpy(np.array(eps)), i, i,
                                       tlat, eta, noise)
        ref = np.asarray(jlat)
        np.testing.assert_allclose(tlat.numpy(), ref, rtol=0, atol=2e-6,
                                   err_msg=f'step {i}')


ANCHOR_KINDS = [('ddim', None, None), ('pndm', None, None),
                ('pndm', PRK, JPRK), ('lms', None, None)]


@pytest.mark.parametrize('kind,cfg,jcfg', ANCHOR_KINDS)
def test_noise_levels_and_input_scaling_match_jax(kind, cfg, jcfg):
    """add_noise (img2img at each strength) and anchor_noise (every
    position; PLMS with counters 0, 1 and 2) noise a clean latent to a
    level of the schedule; scale_model_input scales the UNet's input at
    every position (LMS's 1/√(σ²+1)). The same fp32 arithmetic on the same
    table entries: bit-equal."""
    steps = 6
    jsc, tsch = jsch.make(kind, steps, jcfg), schedulers.make(kind, steps,
                                                               cfg)
    rng = np.random.default_rng(0)
    x, n = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
            for _ in range(2))
    tx, tn = torch.from_numpy(x), torch.from_numpy(n)
    for strength in (0.3, 0.6, 1.0):
        init_timestep, _ = jsch.init_timestep_info(jsc, strength, steps)
        np.testing.assert_array_equal(
            schedulers.add_noise(tsch, tx, tn, init_timestep).numpy(),
            _np(jsch.add_noise(jsc, jnp.asarray(x), jnp.asarray(n),
                               init_timestep)))
    for i in range(tsch.length):
        np.testing.assert_array_equal(
            schedulers.scale_model_input(tsch, 14.6 * tx, i).numpy(),
            _np(jsch.scale_model_input(jsc, 14.6 * jnp.asarray(x),
                                       jnp.int32(i))))
        for counter in (0, 1, 2):
            np.testing.assert_array_equal(
                schedulers.anchor_noise(tsch, tx, tn, i, counter).numpy(),
                _np(jsch.anchor_noise(jsc, jnp.asarray(x), jnp.asarray(n),
                                      jnp.int32(i), jnp.int32(counter))),
                err_msg=f'position {i}, counter {counter}')
