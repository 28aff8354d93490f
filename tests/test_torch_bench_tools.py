"""PyTorch port: the JAX package's bench and A/B tools
(``flexdiffuse_tpu_torch/tools/``), on the CPU at tiny widths.

(a) Every ported tool's ``main`` runs with ``--device cpu`` (the tiny
    models) and prints one JSON line carrying the JAX tool's keys (where
    the JAX tool printed text, the keys of its figures), plus the device.
(b) Every number that is not a time is held against the JAX package's own
    modules on bridged weights and the same injected noise and guides:
    DeepCache's and ToMe's final-latent MSE from the exact loop, the CFG
    interval's MSE and its scale-1 anchor, ``param_dtype_exp``'s
    bit-identity of ``bf16-mm``, and ``bench_vae``'s finite decodes.
"""
import dataclasses
import importlib
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu.models import (TINY_UNET, TINY_VAE, AutoencoderKL,
                                    UNet2DCondition)
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.pipeline import SimpleGuidance
from flexdiffuse_tpu_torch.tools import (bench_vae, cfg_interval_exp,
                                         deepcache_exp, param_dtype_exp,
                                         tome_exp)
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401

# Each tool's keys: the JAX tool's JSON keys, or, where it printed text,
# the keys of the port's line for the same figures. Nested: 'key.sub'.
KEYS = {
    'bench_vae': ['flash_maxerr_vs_fp32', 'mid_attn_flash_ms',
                  'mid_attn_plain_ms', 'decode.plain', 'decode.flash'],
    'bench_batch': ['batch', 'steps_per_sec', 'images_per_min_25step'],
    'bench_train': ['metric', 'lora_rank8.batch', 'lora_rank8.step_ms',
                    'lora_rank8.images_per_sec', 'lora_rank8.modules',
                    'lora_rank8.remat', 'lora_rank8.finite',
                    'full_finetune.batch', 'full_finetune.step_ms',
                    'full_finetune.images_per_sec', 'full_finetune.remat',
                    'full_finetune.finite'],
    'bench_serving': ['metric', 'images_per_min', 'latency_s_p50',
                      'latency_s_p95', 'mean_rows_per_batch', 'batches',
                      'requests'],
    'bench_lcm': ['metric', 'p50_latency_s', 'images_per_min', 'compile_s',
                  'finite'],
    'deepcache_exp': ['rows', 'drift'],
    'bench_deepcache': ['metric', 'interval', 'value', 'unit',
                        'exact_steps_per_sec', 'speedup_vs_exact',
                        'latent_mse_vs_exact', 'finite',
                        'serving_batch4.interval', 'serving_batch4.batch',
                        'serving_batch4.images_per_min'],
    'cfg_interval_exp': ['metric', 'deepcache', 'exact_steps_per_sec',
                         'interval_steps_per_sec', 'speedup', 'finite',
                         'anchor_max_abs'],
    'tome_exp': ['metric', 'exact_steps_per_sec', 'tome'],
    'cmajor_exp': ['metric', 'rows', 'single_forward_max_abs_diff',
                   'loop_max_abs_diff', 'steps_per_sec_change'],
    'bench_sdxl': ['metric', 'value', 'unit', 'seconds_per_image_25step',
                   'deepcache.interval', 'deepcache.steps_per_sec',
                   'deepcache.seconds_per_image_25step',
                   'deepcache.finite'],
    'sdxl_deepcache_exp': ['rows', 'drift'],
    'sdxl_exp': ['metric', 'steps_per_sec', 'k1_tiles', 'finite'],
    'param_dtype_exp': ['variants', 'bf16_mm_bit_identical'],
    'bench_tokenizer': ['python_cold_tok_per_s', 'python_warm_tok_per_s',
                        'native_cold_tok_per_s', 'native_warm_tok_per_s',
                        'native_available', 'speedup_cold',
                        'speedup_warm'],
}


def _get(res: dict, key: str):
    for part in key.split('.'):
        res = res[part]
    return res


@pytest.mark.parametrize('tool', sorted(KEYS))
def test_tool_prints_the_jax_keys_on_the_cpu(tool, monkeypatch, capsys):
    mod = importlib.import_module(f'flexdiffuse_tpu_torch.tools.{tool}')
    argv = [tool] if tool == 'bench_tokenizer' else [tool, '--device', 'cpu']
    monkeypatch.setattr(sys, 'argv', argv)
    mod.main()
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith('{')]
    assert lines, f'{tool} printed no JSON line'
    for line in lines:
        res = json.loads(line)
        assert res['device'] in ('cpu', 'host')
        for key in KEYS[tool]:
            _get(res, key)
        flags = [v for k, v in res.items() if k == 'finite']
        assert all(flags)


# --- (b): the non-time numbers against the JAX package ---------------------

STEPS = 4


@pytest.fixture(scope='module')
def tiny():
    """Tiny UNet and VAE in both packages, the port's bridged from JAX's
    init, and one guide (CFG 8) and start noise for both."""
    k = jax.random.PRNGKey(0)
    unet = UNet2DCondition(TINY_UNET)
    up = jax.jit(lambda kk: unet.init(kk, jnp.zeros((1, 8, 8, 4)),
                                      jnp.zeros((1,)),
                                      jnp.zeros((1, 77, 32))))(k)
    vae = AutoencoderKL(TINY_VAE)
    vp = jax.jit(lambda kk: vae.init(kk, jnp.zeros((1, 16, 16, 3)), kk))(k)
    tree = lambda p: jax.tree.map(np.asarray, p)
    port_unet = tm.UNet2DCondition(tm.TINY_UNET).eval()
    port_unet.load_state_dict(params_to_state_dict(tree(up), TINY_UNET),
                              strict=True)
    port_vae = tm.AutoencoderKL(tm.TINY_VAE).eval()
    port_vae.load_state_dict(params_to_state_dict(tree(vp), TINY_VAE),
                             strict=True)
    rng = np.random.default_rng(0)
    emb = (rng.normal(size=(1, 77, 32)) * .3).astype(np.float32)
    unc = (rng.normal(size=(1, 77, 32)) * .3).astype(np.float32)
    noise = rng.normal(size=(1, 16, 16, 4)).astype(np.float32)
    return dict(unet=unet, up=up, vae=vae, vp=vp, port_unet=port_unet,
                port_vae=port_vae, emb=emb, unc=unc, noise=noise)


def _jguide(t, scale=8.0, **kw):
    return jp.SimpleGuidance(embeddings=jnp.asarray(t['emb']),
                             uncond=jnp.asarray(t['unc']),
                             guidance_scale=jnp.float32(scale), cfg=True,
                             **kw)


def _tguide(t):
    return SimpleGuidance(embeddings=torch.from_numpy(t['emb']),
                          uncond=torch.from_numpy(t['unc']),
                          guidance_scale=8.0)


def _jlat(t, g, unet=None, **pipe_kw):
    pipe = jp.FlexPipeline(unet or t['unet'], t['up'], t['vae'], t['vp'],
                           scheduler='pndm', **pipe_kw)
    out = pipe(g, steps=STEPS, init_size=(32, 32),
               noise=jnp.asarray(t['noise']), key=jax.random.PRNGKey(5),
               output_type='latent')
    return np.asarray(out.images)


def _mse(a, b):
    return float(np.mean((a - b)**2))


def test_deepcache_drift_matches_jax(tiny):
    """Observed: the port's MSE from the exact loop (0.339) equals JAX's
    to 9.7e-7 relative; the bound is 1e-3 relative."""
    got = deepcache_exp.run(tiny['port_unet'], tiny['port_vae'], (0, 3),
                            steps=STEPS, reps=1, guide=_tguide(tiny),
                            latents=torch.from_numpy(tiny['noise']))
    want = _mse(_jlat(tiny, _jguide(tiny), deepcache=3),
                _jlat(tiny, _jguide(tiny)))
    assert want > 0
    assert got['drift'][0]['latent_mse_vs_exact'] == pytest.approx(
        want, rel=1e-3)


def test_tome_drift_matches_jax(tiny):
    """ToMe 0.5 at the tiny UNet's 256-token first level (``min_seq``
    64). Observed: equal to JAX's MSE (0.274) to 1.1e-7 relative; the
    bound is 1e-3 relative."""
    got = tome_exp.measure(tiny['port_unet'], tiny['port_vae'], 128, (0.5,),
                           steps=STEPS, reps=1, min_seq=64, latent_side=16,
                           guide=_tguide(tiny),
                           latents=torch.from_numpy(tiny['noise']))
    want = _mse(_jlat(tiny, _jguide(tiny),
                      unet=tiny['unet'].clone(tome=(0.5, 64))),
                _jlat(tiny, _jguide(tiny)))
    assert want > 0
    assert got['tome'][0]['latent_mse_vs_exact'] == pytest.approx(
        want, rel=1e-3)


def test_cfg_interval_and_its_anchor_match_jax(tiny):
    """The interval (0, 0.6)'s MSE from the exact loop equals JAX's
    (0.0374; observed 2.2e-6 relative; bound 1e-3). The scale-1 anchor is
    exact to fp32 rounding in both (observed 4.8e-6 in the port, 3.8e-6 in
    JAX): JAX's own test bound, 2e-4."""
    got = cfg_interval_exp.measure(tiny['port_unet'], tiny['port_vae'],
                                   steps=STEPS, reps=1, guide=_tguide(tiny),
                                   latents=torch.from_numpy(tiny['noise']))
    interval = dict(cfg_interval=True, cfg_from=jnp.float32(0.0),
                    cfg_to=jnp.float32(0.6))
    want = _mse(_jlat(tiny, _jguide(tiny, **interval)),
                _jlat(tiny, _jguide(tiny)))
    assert got['latent_mse_vs_exact'] == pytest.approx(want, rel=1e-3)
    jax_anchor = np.abs(
        _jlat(tiny, _jguide(tiny, 1.0 + 1e-9)) -
        _jlat(tiny, _jguide(tiny, 1.0 + 1e-9, cfg_interval=True,
                            cfg_from=jnp.float32(0.3),
                            cfg_to=jnp.float32(1.0)))).max()
    assert jax_anchor <= 2e-4
    assert got['anchor_max_abs'] <= 2e-4 and got['anchor_ok']


def test_param_dtype_bit_identity_holds_in_both_packages(tiny):
    """The JAX script's claim: ``bf16-mm`` parameters (two or more
    dimensions in bf16, 1-D in fp32) give the fp32-parameter UNet's output
    bit for bit. Held in JAX (the tiny UNet in bf16 compute) and in the
    port (the bridged weights under bf16 autocast)."""
    unet = UNet2DCondition(TINY_UNET, dtype=jnp.bfloat16)
    lat = jnp.asarray(np.random.default_rng(1).normal(
        size=(2, 8, 8, 4)).astype(np.float32) * 0.1)
    ctx = jnp.asarray(tiny['emb'].repeat(2, axis=0))
    mm = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.ndim >= 2
                      else a, tiny['up'])
    apply = jax.jit(unet.apply)
    run = lambda p: np.asarray(apply(p, 0.1 * jnp.tanh(lat),
                                     jnp.full((2,), 500.0), ctx))
    assert np.array_equal(run(tiny['up']), run(mm))
    port = param_dtype_exp.measure(tiny['port_unet'], steps=2, side=8,
                                   reps=1)
    by = {r['variant']: r for r in port['variants']}
    assert by['bf16-mm']['max_abs_vs_fp32'] == 0.0
    assert port['bf16_mm_bit_identical']
    assert port['plain_group_norm']['bf16_mm_bit_identical']
    assert port['fp32_rerun_max_abs'] == 0.0
    assert port['first_difference'] is None


def test_bench_vae_decodes_are_finite_in_both_packages(tiny):
    got = bench_vae.measure(tiny['port_vae'], torch.device('cpu'), side=8,
                            shape=(1, 1, 128, 160), calls=2, reps=1,
                            decode_reps=1)
    assert got['decode']['plain']['finite'] and got['decode']['flash'][
        'finite'] and got['chain_finite']
    z = jnp.asarray(np.random.default_rng(0).normal(
        size=(1, 8, 8, 4)).astype(np.float32))
    img = tiny['vae'].apply(tiny['vp'], z, method=AutoencoderKL.decode)
    assert np.isfinite(np.asarray(img)).all()
    # On the CPU the flash path is the plain version: no error to fp32
    # beyond bf16's.
    assert got['flash_maxerr_vs_fp32'] < 2e-2


def test_tools_record_no_field_from_a_tpu_run():
    """The ported docstrings carry no TPU figures (img/min, ms, GB)."""
    import re
    for tool in KEYS:
        doc = importlib.import_module(
            f'flexdiffuse_tpu_torch.tools.{tool}').__doc__
        assert not re.search(r'\d+(\.\d+)?\s*(ms|img/min|GB)\b', doc), tool


def test_deepcache_build_parts_shares_the_given_models(tiny):
    parts = deepcache_exp.build_parts(tiny['port_unet'], tiny['port_vae'],
                                      3, steps=STEPS, side=8)
    assert parts['pipe'].unet is tiny['port_unet']
    assert parts['pipe'].deepcache == 3 and parts['length'] == STEPS + 1
    assert dataclasses.is_dataclass(parts['guide'])
