"""PyTorch port: the real-weight parity harness
(``flexdiffuse_tpu_torch/tools/validate_reference.py``) and the experiment
protocol tool (``tools/experiments.py``), held against the JAX package's
``tools/validate_reference.py``.

* ``--tiny --device cpu`` runs the five ``BASELINE.json`` configs with no
  skip, writes the reference-named grids and a report with the JAX tool's
  keys (``tools/validate_reference.py:221-262``); the numerics gate is
  present and true (fp32 against fp32); ``--configs`` runs a subset alone.
* ``t2i_base``'s final latents through the port's tool on the JAX golden's
  tiny weights (``weights/bridge.py``) with JAX's initial noise replayed
  equal the JAX tool's ``_final_latents`` to 1e-4, the tiny pipeline's
  bound (``test_torch_slice.py``).
* Off ``--tiny``, on a tiny HF snapshot (the CLI's geometry set to it):
  the configs whose assets are missing are skipped and say so, the others
  run, and the gate compares against a second Runner loaded on the CPU in
  fp32; ``experiments.main`` runs the protocol on the same snapshot.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from flexdiffuse_tpu_torch import cli as tcli
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.tools import experiments as texp
from flexdiffuse_tpu_torch.tools import validate_reference as tvr
from tests.test_runner_disk_loading import model_root  # noqa: F401
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_loading import CONFIGS

CONFIG_NAMES = {'t2i_base', 'linear_style', 'clustered_threshold',
                'img2img_guided', 'text2text'}
# The JAX tool's report keys: top level, each run config, the gate's.
JAX_TOP = {'protocol', 'tiny', 'configs', 'phase_summary'}
JAX_RUN = {'reference_golden', 'wall_s', 'images'}
JAX_GATE = {'latent_mse_vs_cpu_fp32', 'latent_mse_gate_1e-2'}


def _report(out):
    with open(os.path.join(out, 'parity_report.json')) as f:
        return json.load(f)


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('validate') / 'val')
    assert tvr.main(['--tiny', '--device', 'cpu', '--out', out]) == 0
    return out, _report(out)


def test_tiny_runs_every_config(tiny):
    out, report = tiny
    assert JAX_TOP <= set(report) and report['tiny'] is True
    assert set(report['configs']) == CONFIG_NAMES
    for name, cfg in report['configs'].items():
        assert 'skipped' not in cfg, (name, cfg)
        assert JAX_RUN <= set(cfg) and cfg['images'] == 1, name
        assert os.path.exists(os.path.join(out, cfg['reference_golden']))
    assert set(report['phase_summary']) == {'embeds', 'generate'}


def test_tiny_numerics_gate(tiny):
    """The gate's keys, and the port's additions (relative MSE, max|Δ|):
    fp32 on the CPU against fp32 on the CPU, the same noise, is exact."""
    t2i = tiny[1]['configs']['t2i_base']
    assert JAX_GATE | {'latent_rel_mse', 'latent_max_abs'} <= set(t2i)
    assert t2i['latent_mse_gate_1e-2'] is True
    assert t2i['latent_mse_vs_cpu_fp32'] == t2i['latent_max_abs'] == 0.0


def test_tiny_subset(tmp_path):
    out = str(tmp_path / 'val')
    assert tvr.main(['--tiny', '--device', 'cpu', '--out', out,
                     '--configs', 'text2text']) == 0
    assert list(_report(out)['configs']) == ['text2text']
    assert os.listdir(out) and not os.path.exists(
        os.path.join(out, 'deer_base.png'))


def test_final_latents_match_jax_tool(tmp_path):
    """``t2i_base`` at the tiny protocol (64², 2 PNDM steps, 1 sample,
    CFG 8, seed 1337) through both tools' latent capture, on the same
    weights, the port given the initial noise JAX's Runner draws."""
    from tests.test_torch_protocol import runner_pair
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..',
                                    'tools'))
    import validate_reference as jvr
    jr, tr = runner_pair(str(tmp_path))
    kw = {**tvr.PROTOCOL, 'steps': 2, 'samples': 1, 'init_size': (64, 64),
          'prompt': tvr.DEER_PROMPT, 'guide': None}
    want = jvr._final_latents(jr, kw)
    key = jax.random.split(jax.random.PRNGKey(kw['seed']))[1]
    k_noise = jax.random.split(key, 4)[2]
    noise = lambda shape: torch.from_numpy(np.array(
        jax.random.normal(k_noise, shape)))
    got = tvr.final_latents(tr, kw, noise)
    assert got.shape == want.shape == (1, 32, 32, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.fixture()
def tiny_configs(monkeypatch):
    """The CLI's model geometry, which both tools read a snapshot into,
    set to the tiny snapshot's."""
    monkeypatch.setattr(tcli, 'MODEL_CONFIGS', dict(
        text=CONFIGS['text'][1], vision=CONFIGS['vision'][1],
        unet=tm.TINY_UNET, vae=tm.TINY_VAE))


def test_snapshot_run_skips_missing_assets(  # noqa: F811
        model_root, tiny_configs, tmp_path):
    out = str(tmp_path / 'val')
    assets = tmp_path / 'experiments'
    assets.mkdir()
    assert tvr.main(['--models', str(model_root), '--device', 'cpu',
                     '--experiments', str(assets), '--out', out,
                     '--size', '16', '--steps', '2', '--samples', '1']) == 0
    report = _report(out)
    assert report['dtype'] == 'float32' and report['tiny'] is False
    ran = {n for n, c in report['configs'].items() if 'skipped' not in c}
    assert ran == {'t2i_base', 'text2text'}
    for name in CONFIG_NAMES - ran:
        assert 'missing asset' in report['configs'][name]['skipped']
    assert report['configs']['t2i_base']['latent_mse_gate_1e-2'] is True


def test_experiments_on_snapshot(model_root, tiny_configs,  # noqa: F811
                                 tmp_path, capsys):
    """The protocol, 2 samples at 16² and 2 steps, saved under ``--out``
    with the seed in their names. (The snapshot's vision tower projects
    to 24 wide against its 32-wide text tower, so no image guide.)"""
    out = tmp_path / 'exp'
    assert texp.main(['--models', str(model_root), '--prompt', 'a deer',
                      '--device', 'cpu', '--size', '16', '--steps', '2',
                      '--samples', '2', '--out', str(out)]) == 0
    pngs = [n for n in os.listdir(out) if n.endswith('.png')]
    assert len(pngs) == 2 and all('_se1337' in n for n in pngs)
    assert '2 images' in capsys.readouterr().out
