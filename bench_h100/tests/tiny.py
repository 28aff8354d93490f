"""A copy of the benchmark at a size the CPU holds: the folder and
``BENCHMARK.json`` copied to a temporary checkout, with tiny
configurations and one cell of each traffic kind (fp32, the kernels'
plain paths), the cells' limits kept as the benchmark states them."""
from __future__ import annotations

import contextlib
import io
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY_TEXT = dict(vocab_size=1000, hidden_size=32, num_layers=2, num_heads=4,
                 intermediate_size=64, eos_token_id=999)
TINY_VAE = dict(block_channels=[32, 32], layers_per_block=1, norm_groups=8)
TINY_UNET = dict(block_channels=[32, 64], layers_per_block=1,
                 attention_levels=[True, False], cross_attention_dim=32,
                 norm_groups=8)

CELLS = {
    # name: (config it shrinks, workload it shrinks, e2e metric, params)
    'tiny.serve': ('sd14-512', 'sd14-512.serve-over', 'served_images_per_s',
                   dict(rate_per_s=4.0, size=64, trace_start_s=0.3,
                        trace_stop_s=1.0, drain_s=60)),
    'tiny21.gen': ('sd21-768', 'sd21-768.gen', 'images_per_s',
                   dict(size=64, trace_start_s=0.2, trace_stop_s=0.8)),
    'tiny.train': ('sd14-512', 'sd14-512.lora-train', 'train_images_per_s',
                   dict(batch=4, side=8, dataset_rows=16, trace_start_s=0.2,
                        trace_stop_s=0.6)),
}


def _read(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write(path: str, obj: dict) -> None:
    with open(path, 'w') as f:
        json.dump(obj, f, indent=1)


def make_root(tmp: str) -> str:
    """A checkout under ``tmp``: ``BENCHMARK.json`` and ``bench_h100/``
    with the tiny configurations and cells added as new files and
    entries."""
    root = os.path.join(tmp, 'checkout')
    shutil.copytree(os.path.join(REPO, 'bench_h100'),
                    os.path.join(root, 'bench_h100'),
                    ignore=shutil.ignore_patterns('__pycache__'))
    bench = _read(os.path.join(REPO, 'BENCHMARK.json'))
    data = os.path.join(root, 'bench_h100')
    for src, name, heads in (('sd14-512', 'tiny', dict(num_heads=2)),
                             ('sd21-768', 'tiny21', dict(head_dim=16))):
        cfg = _read(os.path.join(data, 'configs', f'{src}.json'))
        cfg.update(name=name, dtype='float32', resolution=64)
        cfg['text'].update(TINY_TEXT)
        cfg['vae'].update(TINY_VAE)
        cfg['unet'].update(TINY_UNET, **heads)
        _write(os.path.join(data, 'configs', f'{name}.json'), cfg)
    for cell, (src_cfg, src, e2e, params) in CELLS.items():
        w = _read(os.path.join(data, 'workloads', f'{src}.json'))
        w['config'] = 'tiny21' if src_cfg == 'sd21-768' else 'tiny'
        w['params'].update(params)
        _write(os.path.join(data, 'workloads', f'{cell}.json'), w)
        bench['workloads'].append({'name': cell, 'config': w['config'],
                                   'traffic': w['mix'], 'chips': 1,
                                   'why': 'the CPU tests'})
        for m in bench['end_to_end'] + bench['per_layer']:
            if src in m.get('workloads', []):
                m['workloads'].append(cell)
    # The serving cell is not in the benchmark (PERF.md); its metrics are
    # entries of the copy.
    bench['end_to_end'].insert(0, {
        'name': 'served_images_per_s', 'unit': 'images/s', 'better':
        'higher', 'bound': 0.25, 'source': 'host_clock',
        'workloads': ['tiny.serve']})
    for name in ('rows_per_dispatch', 'latency_p90', 'mfu', 'unet_ms_per_row',
                 'k1_roofline', 'k6_roofline', 'device_idle_pct'):
        bench['per_layer'].append({
            'name': f'{name}.serve', 'unit': 'x', 'better': 'higher',
            'source': 'device_trace', 'layer': 'serving',
            'moves': 'served_images_per_s', 'workloads': ['tiny.serve']})
    _write(os.path.join(root, 'BENCHMARK.json'), bench)
    return root


def run_cell(root: str, cell: str, seed: int = 3000000123,
             seconds: float = 2.0, trace: int = 0):
    """``(exit code, last line of standard output as a dict or None,
    standard error)`` of one run of ``cell`` on the CPU."""
    from bench_h100 import run
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(['--workload', cell, '--seed', str(seed), '--seconds',
                       str(seconds), '--trace', str(trace)], root=root,
                      device='cpu')
    lines = out.getvalue().strip().splitlines()
    last = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, last, err.getvalue()
