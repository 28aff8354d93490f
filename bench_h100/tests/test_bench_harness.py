"""The harness end to end at a tiny size on the CPU, with the kernels'
plain paths: one run of each traffic kind, the result line's shape, no
JAX in the process, cells and metrics found by name, and the faults each
cell can have turning ``correct`` false."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_h100 import harness
from bench_h100.tests import tiny

KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp('bench')))


def _check_line(last, trace):
    keys = list(last)
    # The compared numbers and their limits come last, under a key of
    # their own.
    assert keys[-1] == 'checks'
    assert keys[:-1] == KEYS + (['breakdown'] if trace else [])
    assert last['device']['count'] == 1
    for c in last['checks'].values():
        assert set(c) == {'value', 'limit'}


@pytest.mark.parametrize('cell,e2e', [(c, v[2]) for c, v in
                                      tiny.CELLS.items()])
def test_cell_end_to_end(root, cell, e2e):
    rc, last, err = tiny.run_cell(root, cell)
    assert rc == 0, err[-2000:]
    _check_line(last, trace=False)
    assert last['correct'] is True, err[-2000:]
    assert last['failed'] == 0 and last['attempted'] >= 1
    assert set(last['metrics']) == {e2e, 'peak_mem_gib', 'setup_s'}
    assert last['metrics']['setup_s']['value'] > 0
    held = harness.forbidden_modules(list(sys.modules))
    assert held == [], held


def test_traced_run_reads_per_layer_metrics(root):
    rc, last, err = tiny.run_cell(root, 'tiny.serve', trace=1)
    assert rc == 0, err[-2000:]
    _check_line(last, trace=True)
    assert last['metrics']['rows_per_dispatch.serve']['value'] >= 1
    assert set(last['device']) >= {'busy_s', 'window_s'}
    assert set(last['breakdown']) == {'device_ops', 'idle_gaps'}


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ['flexdiffuse_tpu_torch', 'flexdiffuse_tpu_torch.ops', 'jaxtyping',
         'numpy']) == []
    assert harness.forbidden_modules(
        ['jax.numpy', 'flexdiffuse_tpu.ops', 'flax']) == [
            'flax', 'flexdiffuse_tpu', 'jax']


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    out = subprocess.run(
        [sys.executable, '-m', 'bench_h100.run', '--workload',
         'sd21-768.gen', '--seed', '1', '--seconds', '1', '--trace',
         '0'],
        cwd=tiny.REPO, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ''


def test_no_program_no_result(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's folder."""
    bare = tmp_path / 'bare'
    shutil.copytree(os.path.join(tiny.REPO, 'bench_h100'),
                    bare / 'bench_h100')
    shutil.copy(os.path.join(tiny.REPO, 'BENCHMARK.json'), bare)
    out = subprocess.run(
        [sys.executable, '-m', 'bench_h100.run', '--workload',
         'sd21-768.gen', '--seed', '1', '--seconds', '1', '--trace',
         '0'],
        cwd=bare, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(bare)))
    assert out.returncode != 0 and out.stdout.strip() == ''


def test_new_cell_and_metric_found_by_name(root, tmp_path):
    """A copy of the folder gains a workload file and a metric file, and
    BENCHMARK.json entries for them: the harness runs both, no existing
    file of the folder edited."""
    new = str(tmp_path / 'copy')
    shutil.copytree(root, new)
    data = os.path.join(new, 'bench_h100')
    before = {f: open(os.path.join(dp, f), 'rb').read()
              for dp, _, fs in os.walk(data) for f in fs
              if not f.endswith('.pyc')}
    w = tiny._read(os.path.join(data, 'workloads', 'tiny.serve.json'))
    w['params'].update(rate_per_s=2.0)
    tiny._write(os.path.join(data, 'workloads', 'tiny.slow.json'), w)
    with open(os.path.join(data, 'metrics', 'padded_share.slow.py'),
              'w') as f:
        f.write('def read(ctx):\n    b = ctx["batcher"]\n'
                '    return 100.0 * b["padded_rows"] / b["rows"]\n')
    bench = tiny._read(os.path.join(new, 'BENCHMARK.json'))
    bench['workloads'].append({'name': 'tiny.slow', 'config': 'tiny',
                               'traffic': 'slow', 'chips': 1, 'why': 't'})
    bench['end_to_end'][0]['workloads'].append('tiny.slow')
    bench['per_layer'].append({'name': 'padded_share.slow', 'unit': '%',
                               'better': 'lower', 'source':
                               'program_counter', 'layer': 'serving',
                               'moves': 'served_images_per_s',
                               'workloads': ['tiny.slow']})
    tiny._write(os.path.join(new, 'BENCHMARK.json'), bench)
    rc, last, err = tiny.run_cell(new, 'tiny.slow', trace=1)
    assert rc == 0, err[-2000:]
    assert 'padded_share.slow' in last['metrics']
    for f, data_before in before.items():
        matches = [os.path.join(dp, f) for dp, _, fs in os.walk(data)
                   if f in fs]
        assert any(open(m, 'rb').read() == data_before for m in matches)


# ---------------------------------------------------------------------------
# Faults: the timed path broken underneath, ``correct`` must read false.


def test_fault_answer_altered_where_produced(root, monkeypatch):
    from flexdiffuse_tpu_torch.serving import api
    real = api.GenerationService._png_b64

    def altered(arr):
        arr = arr.copy()
        arr[: arr.shape[0] // 2] = 1.0 - arr[: arr.shape[0] // 2]
        return real(arr)
    monkeypatch.setattr(api.GenerationService, '_png_b64',
                        staticmethod(altered))
    rc, last, err = tiny.run_cell(root, 'tiny.serve')
    assert rc == 0 and last['correct'] is False


def test_fault_step_returns_its_state(root, monkeypatch):
    from flexdiffuse_tpu_torch import schedulers
    monkeypatch.setattr(schedulers, 'step',
                        lambda schedule, state, eps, i, counter, sample,
                        *a, **k: (state, sample))
    rc, last, err = tiny.run_cell(root, 'tiny21.gen')
    assert rc == 0 and last['correct'] is False


def test_fault_optimizer_leaves_the_factors(root, monkeypatch):
    from flexdiffuse_tpu_torch.training import train
    monkeypatch.setattr(train.ClippedAdamW, 'step',
                        lambda self: self.adamw.zero_grad() or True)
    rc, last, err = tiny.run_cell(root, 'tiny.train')
    assert rc == 0 and last['correct'] is False
    assert last['checks']['update_norm_gap']['value'] > \
        last['checks']['update_norm_gap']['limit']


def test_fault_half_the_batch(root, monkeypatch):
    from flexdiffuse_tpu_torch.training import train
    real = train.diffusion_loss

    def half(apply_fn, latents, context, *a, **k):
        n = latents.shape[0] // 2
        return real(apply_fn, latents[:n], context[:n], *a, **k)
    monkeypatch.setattr(train, 'diffusion_loss', half)
    rc, last, err = tiny.run_cell(root, 'tiny.train')
    assert rc == 0 and last['correct'] is False


def test_control_fails_where_the_program_passes(root):
    """The reference with fp8 operands in the program's place reads past
    the limits on at least one number; the program (fp32 here) is far
    below them."""
    from bench_h100.traffic import RunContext
    for cell in tiny.CELLS:
        d = harness.load_definition(cell, root)
        outcome = harness.traffic_module(d.workload['traffic']).run(
            RunContext(d, 4000000007, 1.5, False, torch.device('cpu'),
                       root))
        checks = {c.name: c for c in outcome.check(control=True)}
        prog = [c for n, c in checks.items() if not n.startswith('control')
                and n.startswith(('image', 'loss', 'grad', 'update'))]
        ctrl = [c for n, c in checks.items() if n.startswith('control_')]
        assert all(c.ok for c in prog), (cell, checks)
        assert any(not c.ok for c in ctrl), (cell, checks)
