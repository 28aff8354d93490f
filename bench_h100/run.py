"""Run one cell of the benchmark and print its result line.

    python -m bench_h100.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Without CUDA, or with fewer cards than the cell needs, it exits with
code 2 and prints no result. With ``--trace 0`` the result carries the
cell's end-to-end metrics; with ``--trace 1`` a part of the window runs
under ``torch.profiler`` and the result carries the cell's per-layer
metrics, ``device.busy_s``/``window_s`` and a ``breakdown``. The compared
numbers and their limits close standard error and the result line
(``checks``). A run whose process holds JAX or the JAX package once the
window has closed exits with code 3 and prints no result.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import traceback


def checkout_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def set_caches(root: str) -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ['TRITON_CACHE_DIR'] = os.path.join(root, '.bench_cache',
                                                  'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = os.path.join(root, '.bench_cache',
                                                      'torch_extensions')
    os.environ.setdefault('USE_FLAX', '0')


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, root: str = None, device: str = 'cuda') -> int:
    """``root``: the checkout (default: this file's). ``device='cpu'``
    skips the look for a card (the harness's CPU tests)."""
    args = parse(argv)
    root = root or checkout_root()
    set_caches(root)
    import torch
    from bench_h100 import harness
    from bench_h100.traffic import RunContext

    definition = harness.load_definition(args.workload, root)
    chips = int(definition.workload.get('chips', 1))
    if device == 'cuda':
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if found < chips:
            print(f'{args.workload} needs {chips} CUDA card(s); found '
                  f'{found}', file=sys.stderr)
            return 2
        print(f'card: {harness.card_limit()}', file=sys.stderr, flush=True)
    ctx = RunContext(definition, args.seed, args.seconds, bool(args.trace),
                     torch.device(device), root)
    traffic = harness.traffic_module(definition.workload['traffic'])
    outcome = traffic.run(ctx)
    t_ran = harness.setup_seconds()
    checks = outcome.check()
    print(f'process: {t_ran!r} s to the window\'s close and drain, '
          f'{harness.setup_seconds() - t_ran!r} s in the reference',
          file=sys.stderr)
    correct = all(c.ok for c in checks) and outcome.failed == 0
    dev = {'platform': 'gpu' if device == 'cuda' else 'cpu',
           'kind': torch.cuda.get_device_name(0) if device == 'cuda'
           else 'cpu', 'count': chips,
           'memory_peak_bytes': int(outcome.memory_peak_bytes)}
    breakdown = None
    if args.trace:
        traced = outcome.window.result if outcome.window else None
        layer_ctx = dict(outcome.layer, traced=traced,
                         config=definition.config,
                         workload=definition.workload,
                         window=outcome.window)
        metrics = {}
        for m in definition.per_layer:
            value = harness.metric_reader(m['name'], root)(layer_ctx)
            if value is not None and math.isfinite(value):
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
        if traced is not None:
            dev['busy_s'] = traced.busy_s()
            dev['window_s'] = traced.window_s
            breakdown = traced.breakdown()
    else:
        metrics = {m['name']: {'value': outcome.metrics[m['name']],
                               'unit': m['unit']}
                   for m in definition.end_to_end}

    held = harness.forbidden_modules(list(sys.modules))
    if held:
        print(f'the process holds {held}: refused', file=sys.stderr)
        return 3
    harness.emit(correct, outcome.attempted, outcome.failed, metrics, dev,
                 checks, breakdown)
    return 0


if __name__ == '__main__':
    try:
        rc = main()
    except BaseException:
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.stderr.flush()
    # Caller threads still blocked on a request that never came would hold
    # the interpreter open; whatever was to be printed is printed by now.
    os._exit(rc)
