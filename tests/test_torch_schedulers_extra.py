"""PyTorch port: the schedulers of the tenth slice (Euler, Euler-a, Heun,
DPM++ 2M, UniPC, DDPM, LCM) and the config fields every kind honours
(v-prediction, Karras σ, trailing spacing, zero terminal SNR), held against
the JAX package on the CPU.

(a) Every table of every kind equals JAX's bit for bit, under each
    {epsilon, v_prediction} × {leading, trailing} × {Karras off, on where a
    kind takes it} × {zero SNR off, on}.
(b) Each stepper, fed the same ε at every position (a deterministic
    function of JAX's own trajectory) and the same per-step noise (drawn
    from JAX's step key), ends a whole loop within 2e-6·max|x| of the JAX
    stepper. For the σ-space kinds max|x| is the σ-scaled latent, so the
    bar is relative to σ₀ there, as LMS's is (ROADMAP Queue 3).
(c) add_noise, anchor_noise and scale_model_input per kind equal JAX's
    bit for bit; convert_v_prediction is within 4 fp32 ulps.
(d) The JAX package's own oracles (numpy transcriptions of diffusers and
    k-diffusion in tests/test_heun.py, test_unipc_ddpm.py, test_lcm.py,
    test_scheduler_oracles.py) hold the port's steppers at their bars.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import schedulers as jsch
from flexdiffuse_tpu_torch import schedulers
from tests.test_heun import OracleHeun, _fake as heun_fake
from tests.test_lcm import _oracle_step as lcm_oracle_step
from tests.test_scheduler_oracles import OracleDDIM, OraclePLMS
from tests.test_unipc_ddpm import OracleDDPM, OracleUniPC

ALL_KINDS = ('ddim', 'pndm', 'lms', 'euler', 'euler_a', 'heun', 'dpmpp',
             'unipc', 'ddpm', 'lcm')
KARRAS = ('euler', 'euler_a', 'dpmpp', 'unipc', 'heun')
STEPS = 6


def _configs():
    """(kind, prediction, spacing, karras, zero_snr) for every kind: all
    combinations, Karras only where the kind takes it."""
    out = []
    for kind in ALL_KINDS:
        for pred in ('epsilon', 'v_prediction'):
            for spacing in ('leading', 'trailing'):
                for karras in ((False, True) if kind in KARRAS
                               else (False,)):
                    for zsnr in (False, True):
                        out.append((kind, pred, spacing, karras, zsnr))
    return out


CONFIGS = _configs()


def _pair(kind, pred, spacing, karras, zsnr, steps=STEPS):
    kw = dict(kind=kind, prediction_type=pred, timestep_spacing=spacing,
              use_karras_sigmas=karras, rescale_betas_zero_snr=zsnr)
    return (schedulers.make(kind, steps, schedulers.SchedulerConfig(**kw)),
            jsch.make(kind, steps, jsch.SchedulerConfig(**kw)))


def _id(c):
    kind, pred, spacing, karras, zsnr = c
    return (f'{kind}-{pred[:1]}-{spacing[:1]}{"-karras" if karras else ""}'
            f'{"-zsnr" if zsnr else ""}')


@pytest.mark.parametrize('cfg', CONFIGS, ids=_id)
def test_tables_match_jax(cfg):
    got, ref = _pair(*cfg)
    for name in ('kind', 'num_steps', 'num_train_timesteps', 'ratio',
                 'steps_offset', 'length', 'v_prediction', 'rows_per_step',
                 'clip_sample'):
        assert getattr(got, name) == getattr(ref, name), name
    for f in dataclasses.fields(got):
        r = getattr(ref, f.name, None)
        v = getattr(got, f.name)
        if isinstance(v, torch.Tensor) and r is not None:
            if f.name in ('sigmas', 'lms_coeffs') and \
                    cfg[0] not in jsch.SIGMA_SPACE_KINDS + ('dpmpp',
                                                            'unipc'):
                continue
            np.testing.assert_array_equal(v.numpy(), np.asarray(r),
                                          err_msg=f.name)
        elif isinstance(v, tuple) and v and r is not None:
            assert v == tuple(np.asarray(r).tolist()), f.name


def _eps_fn(seed, shape):
    """A fake model output that depends on the sample and the timestep, so
    a divergence compounds."""
    pattern = np.random.default_rng(seed).standard_normal(shape)

    def eps(x, t):
        return (np.tanh(x / 8.0) * 0.3 +
                np.cos(t / 17.0) * pattern).astype(np.float32)
    return eps


@pytest.mark.parametrize('cfg', CONFIGS, ids=_id)
def test_stepper_loop_matches_jax_on_the_same_eps(cfg):
    """2e-6·max|x| over the whole loop (observed: bit-equal for most
    kinds, a few fp32 ulps where XLA orders a sum differently)."""
    tsch, jsc = _pair(*cfg)
    kind = cfg[0]
    shape = (1, 4, 4, 4)
    rng = np.random.default_rng(11)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind in jsch.SIGMA_SPACE_KINDS:
        x = x * np.float32(np.asarray(jsc.sigmas)[0])
    jx, tx = jnp.asarray(x), torch.from_numpy(x.copy())
    jstate = jsch.init_state(jsc, shape, jnp.float32)
    tstate = schedulers.init_state(tsch, shape, torch.float32)
    eps_at = _eps_fn(5, shape)
    key = jax.random.PRNGKey(3)
    eta = 0.5 if kind == 'ddim' else 0.0
    for i in range(jsc.length):
        t = float(np.asarray(jsc.timesteps)[i])
        eps = eps_at(np.asarray(jx), t)
        key, sub = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax.random.normal(
            sub, shape, jnp.float32)))
        jstate, jx = jsch.step(jsc, jstate, jnp.asarray(eps), jnp.int32(i),
                               jnp.int32(i), jx, sub, eta)
        tstate, tx = schedulers.step(tsch, tstate, torch.from_numpy(eps), i,
                                     i, tx, eta, noise)
    ref = np.asarray(jx)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(tx.numpy(), ref, rtol=0,
                               atol=2e-6 * np.abs(ref).max())


@pytest.mark.parametrize('cfg', [c for c in CONFIGS if c[1] == 'epsilon'
                                 and c[2] == 'leading'], ids=_id)
def test_noise_levels_and_conversions_match_jax(cfg):
    """add_noise at three strengths, scale_model_input and anchor_noise
    (three counters) at every position: bit-equal. convert_v_prediction
    within 4 fp32 ulps of max|ε| (the σ-space form's rsqrt and XLA's fused
    multiply-adds round differently)."""
    tsch, jsc = _pair(*cfg)
    rng = np.random.default_rng(0)
    x, n = (rng.standard_normal((2, 4, 4, 4)).astype(np.float32)
            for _ in range(2))
    tx, tn = torch.from_numpy(x), torch.from_numpy(n)
    jx, jn = jnp.asarray(x), jnp.asarray(n)
    for strength in (0.3, 0.6, 1.0):
        init_timestep, t_start = jsch.init_timestep_info(jsc, strength,
                                                         STEPS)
        assert schedulers.init_timestep_info(tsch, strength, STEPS) == (
            init_timestep, t_start)
        np.testing.assert_array_equal(
            schedulers.add_noise(tsch, tx, tn, init_timestep).numpy(),
            np.asarray(jsch.add_noise(jsc, jx, jn, init_timestep)))
    for i in range(tsch.length):
        np.testing.assert_array_equal(
            schedulers.scale_model_input(tsch, 14.6 * tx, i).numpy(),
            np.asarray(jsch.scale_model_input(jsc, 14.6 * jx, jnp.int32(i))))
        ref = np.asarray(jsch.convert_v_prediction(jsc, jn, jnp.int32(i),
                                                   jx))
        np.testing.assert_allclose(
            schedulers.convert_v_prediction(tsch, tn, i, tx).numpy(), ref,
            rtol=0, atol=4 * 2.0**-23 * np.abs(ref).max())
        for counter in (0, 1, 2):
            np.testing.assert_array_equal(
                schedulers.anchor_noise(tsch, tx, tn, i, counter).numpy(),
                np.asarray(jsch.anchor_noise(jsc, jx, jn, jnp.int32(i),
                                             jnp.int32(counter))),
                err_msg=f'position {i}, counter {counter}')


def test_every_jax_kind_is_ported_and_the_guards_match():
    """The port's kinds are the JAX package's; both refuse the same
    configurations."""
    assert set(schedulers._KINDS) == set(jsch._KINDS)
    for kind in jsch._KINDS:
        assert schedulers.make(kind, 10).kind == kind
    for kind in ('ddim', 'pndm', 'lms', 'ddpm', 'lcm'):
        cfg = dict(kind=kind, use_karras_sigmas=True)
        with pytest.raises(ValueError, match='karras'):
            jsch.make(kind, 10, jsch.SchedulerConfig(**cfg))
        with pytest.raises(ValueError, match='karras'):
            schedulers.make(kind, 10, schedulers.SchedulerConfig(**cfg))
    for mod in (schedulers, jsch):
        with pytest.raises(ValueError):
            mod.make('no_such_scheduler', 10)
        with pytest.raises(ValueError):
            mod.make('ddim', 10, mod.SchedulerConfig(prediction_type='x0'))
        with pytest.raises(ValueError):
            mod.make('lcm', 51)
        with pytest.raises(ValueError):
            mod.make('pndm', 3, mod.SchedulerConfig(skip_prk_steps=False))


# --- the JAX package's own oracles --------------------------------------

@pytest.mark.parametrize('karras', [False, True])
def test_heun_matches_the_sequential_oracle(karras):
    """tests/test_heun.py's k-diffusion oracle, at its bar (rtol 2e-4,
    atol 2e-5), every corrected step."""
    steps = 8
    sch = schedulers.make('heun', steps, schedulers.SchedulerConfig(
        use_karras_sigmas=karras))
    assert (sch.length, sch.rows_per_step) == (2 * steps - 1, 2)
    rows_sig = sch.sigmas.double().numpy()
    rows_ts = sch.timesteps.double().numpy()
    step_sigmas = np.concatenate([rows_sig[0:1], rows_sig[1::2]])
    step_ts = np.concatenate([rows_ts[0:1], rows_ts[1::2]])
    rng = np.random.default_rng(3)
    shape = (2, 5)
    pattern = rng.normal(size=shape)
    x0 = rng.normal(size=shape) * float(step_sigmas[0])
    x_ref, ref_outs = OracleHeun(step_sigmas, step_ts).run(x0.copy(),
                                                           pattern)
    x = torch.tensor(x0, dtype=torch.float32)
    state = schedulers.init_state(sch, shape, torch.float32)
    corrected = []
    for i in range(sch.length):
        eps = torch.tensor(heun_fake(x.double().numpy(), rows_ts[i],
                                     pattern), dtype=torch.float32)
        state, x = schedulers.step(sch, state, eps, i, i, x)
        if i % 2 == 1 or i == sch.length - 1:
            corrected.append(x.double().numpy())
    assert len(corrected) == len(ref_outs)
    for k, (got, ref) in enumerate(zip(corrected, ref_outs)):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5,
                                   err_msg=f'step {k}')


def _drive_oracle(kind, steps, oracle, t_start=0, seed=0):
    """tests/test_unipc_ddpm.py's drive: ε = 0.1·x + noise[i] on both
    trajectories, rtol = atol = 2e-4 at every position."""
    rng = np.random.default_rng(seed)
    shape = (1, 4, 4, 3)
    noises = rng.normal(size=(steps,) + shape).astype(np.float32)
    x_o = rng.normal(size=shape).astype(np.float32)
    sch = schedulers.make(kind, steps)
    x_p = torch.from_numpy(x_o.copy())
    state = schedulers.init_state(sch, shape, torch.float32)
    for i in range(t_start, sch.length):
        eps_o = 0.1 * x_o + noises[i]
        t = int(sch.timesteps[i]) if kind == 'ddpm' else i
        prev_o = oracle.step(eps_o, t, x_o)
        eps_p = 0.1 * x_p + torch.from_numpy(noises[i])
        state, x_p = schedulers.step(sch, state, eps_p, i, i - t_start, x_p)
        np.testing.assert_allclose(x_p.numpy(), prev_o, rtol=2e-4,
                                   atol=2e-4, err_msg=f'position {i}')
        x_o = prev_o


@pytest.mark.parametrize('steps', [1, 2, 3, 8, 20])
def test_unipc_matches_the_oracle(steps):
    _drive_oracle('unipc', steps, OracleUniPC(steps))


def test_unipc_img2img_counter_gating_matches_the_oracle():
    """Entering at position 5 restarts the order warm-up (counter 0)."""
    steps, t_start = 12, 5
    oracle = OracleUniPC(steps)
    rng = np.random.default_rng(7)
    shape = (1, 4, 4, 3)
    noises = rng.normal(size=(steps,) + shape).astype(np.float32)
    x_o = rng.normal(size=shape).astype(np.float32)
    sch = schedulers.make('unipc', steps)
    x_p = torch.from_numpy(x_o.copy())
    state = schedulers.init_state(sch, shape, torch.float32)
    for i in range(t_start, steps):
        eps = (0.1 * x_o + noises[i]).astype(np.float32)
        prev_o = oracle.step(eps, i, x_o)
        state, x_p = schedulers.step(sch, state, torch.from_numpy(eps), i,
                                     i - t_start, x_p)
        np.testing.assert_allclose(x_p.numpy(), prev_o, rtol=2e-4,
                                   atol=2e-4)
        x_o = prev_o


@pytest.mark.parametrize('steps', [1, 4, 10, 50])
def test_ddpm_mean_matches_the_oracle(steps):
    """Without noise the step is the posterior mean (the oracle's)."""
    _drive_oracle('ddpm', steps, OracleDDPM(steps))


def test_lcm_trajectory_matches_the_oracle():
    """tests/test_lcm.py's numpy transcription, atol 2e-5, with JAX's
    per-step noise draws."""
    steps = 4
    s = schedulers.make('lcm', steps)
    np.testing.assert_array_equal(s.timesteps.numpy(),
                                  [999.0, 759.0, 519.0, 279.0])
    np.testing.assert_array_equal(s.prev_tr.numpy(),
                                  [759.0, 519.0, 279.0, -1.0])
    acp = schedulers.alphas_cumprod(schedulers.SchedulerConfig())
    rng = np.random.default_rng(0)
    shape = (1, 4, 4, 4)
    x = rng.normal(size=shape).astype(np.float32)
    x_ref = x.copy()
    for i in range(steps):
        eps = rng.normal(size=shape).astype(np.float32) * 0.3
        noise = np.asarray(jax.random.normal(jax.random.PRNGKey(100 + i),
                                             shape, jnp.float32))
        _, x_new = schedulers.step(s, (), torch.from_numpy(eps), i, i,
                                   torch.from_numpy(x),
                                   noise=torch.from_numpy(noise.copy()))
        x_ref = lcm_oracle_step(acp, x_ref, eps, int(s.timesteps[i]),
                                int(s.prev_tr[i]), noise)
        x = x_new.numpy()
        np.testing.assert_allclose(x, x_ref, rtol=0, atol=2e-5)


@pytest.mark.parametrize('kind,oracle', [('ddim', OracleDDIM),
                                         ('pndm', OraclePLMS)])
def test_ddim_and_plms_match_the_oracles(kind, oracle):
    """tests/test_scheduler_oracles.py's diffusers-0.3.0 oracles at their
    bar (rtol 2e-4, atol 2e-5)."""
    steps = 10
    orc = oracle(steps)
    sch = schedulers.make(kind, steps)
    rng = np.random.default_rng(7)
    shape = (2, 6)
    pattern = rng.normal(size=shape)
    x_ref = rng.normal(size=shape)
    x_got = torch.tensor(x_ref, dtype=torch.float32)
    state = schedulers.init_state(sch, shape, torch.float32)
    for i in range(sch.length):
        t = int(orc.timesteps[i])
        assert t == int(sch.timesteps[i])
        x_ref = orc.step(0.12 * x_ref + np.sin(t / 89.0) * pattern, t, x_ref)
        eps = torch.tensor(0.12 * x_got.double().numpy() +
                           np.sin(t / 89.0) * pattern, dtype=torch.float32)
        state, x_got = schedulers.step(sch, state, eps, i, i, x_got)
        np.testing.assert_allclose(x_got.numpy(), x_ref, rtol=2e-4,
                                   atol=2e-5, err_msg=f'position {i}')


@pytest.mark.parametrize('kind', ['ddim', 'pndm', 'lms', 'euler', 'dpmpp',
                                  'unipc', 'heun', 'ddpm'])
def test_v_mode_reproduces_the_eps_trajectory(kind):
    """tests/test_v_prediction.py's identity: feeding v = √ᾱ·ε − √(1−ᾱ)·x₀
    (in the sample's own space) to a v-prediction schedule reproduces the
    ε-mode trajectory (atol 1e-4 relative to max|x|)."""
    steps = 8
    se = schedulers.make(kind, steps)
    sv = schedulers.make(kind, steps, schedulers.SchedulerConfig(
        prediction_type='v_prediction'))
    assert sv.v_prediction and not se.v_prediction
    rng = np.random.default_rng(1)
    shape = (1, 4, 4, 4)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    if kind in schedulers.SIGMA_SPACE_KINDS:
        x = x * se.sigmas[0]
    xe, xv = x.clone(), x.clone()
    st_e = schedulers.init_state(se, shape, torch.float32)
    st_v = schedulers.init_state(sv, shape, torch.float32)
    pattern = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    for i in range(se.length):
        eps = 0.3 * pattern * float(np.cos(i))
        # v from ε at this position: invert convert_v_prediction.
        if kind in schedulers.SIGMA_SPACE_KINDS:
            sigma = se.sigmas[i]
            v = (eps - xv * (sigma / (sigma * sigma + 1.0))) * torch.sqrt(
                sigma * sigma + 1.0)
        elif kind in ('dpmpp', 'unipc'):
            v = (eps - se.vp_sigma[i] * xv) / se.vp_alpha[i]
        else:
            t = min(max(int(se.timesteps[i]), 0), 999)
            ap = se.alphas_cumprod[t]
            v = (eps - torch.sqrt(1.0 - ap) * xv) / torch.sqrt(ap)
        st_e, xe = schedulers.step(se, st_e, eps, i, i, xe)
        st_v, xv = schedulers.step(sv, st_v, v, i, i, xv)
    np.testing.assert_allclose(xv.numpy(), xe.numpy(), rtol=0,
                               atol=1e-4 * float(xe.abs().max()))
