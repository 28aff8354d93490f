"""The readings behind a cell's correctness limit, on the card at the
cell's own size: for each seed, the program's run (a short window at the
cell's own load) compared with the fp32 reference, and the control (the
reference with fp8 operands in the program's place) compared with the
same reference images. Not run by the benchmark's own runs.

    python -m bench_h100.control --workload sd14-512.serve \
        --seconds 10 --seeds 11 12 13

Prints one JSON line per seed with every compared number.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from bench_h100 import harness, run as bench_run
from bench_h100.traffic import RunContext


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    root = bench_run.checkout_root()
    bench_run.set_caches(root)
    if not torch.cuda.is_available():
        print('the control needs a CUDA card', file=sys.stderr)
        return 2
    definition = harness.load_definition(args.workload, root)
    traffic = harness.traffic_module(definition.workload['traffic'])
    print(f'card: {harness.card_limit()}', flush=True)
    for seed in args.seeds:
        ctx = RunContext(definition, seed, args.seconds, False,
                         torch.device('cuda'), root)
        outcome = traffic.run(ctx)
        checks = outcome.check(control=True)
        print(json.dumps({'seed': seed, 'attempted': outcome.attempted,
                          'failed': outcome.failed,
                          **{c.name: c.value for c in checks},
                          **{k: v for k, v in outcome.metrics.items()}}),
              flush=True)
    return 0


if __name__ == '__main__':
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
