"""The knee sweep of an open-loop serving cell: the cell's traffic at a
list of rates, one window each, in one process, to find the highest rate
the program sustains. Run once when the cell is defined; the chosen rate
(0.8 of the knee) goes into the cell's workload file as a number.

    python -m bench_h100.knee --workload sd14-512.serve --seed 7 \
        --seconds 30 --rates 2 2.5 3 3.5

Prints one JSON line per rate: requests sent and answered, answers per
second over the window and its drain, latency p50/p90/max, and the mean
latency of the last quarter of the requests against the first (a backlog
that grows all through the window shows as a ratio well above 1).
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import os
import sys
import time

import torch

from bench_h100 import harness, run as bench_run
from bench_h100.traffic import RunContext
from bench_h100.traffic import open_loop_serve as serve


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--rates', type=float, nargs='+', required=True)
    args = ap.parse_args(argv)
    root = bench_run.checkout_root()
    bench_run.set_caches(root)
    if not torch.cuda.is_available():
        print('the knee sweep needs a CUDA card', file=sys.stderr)
        return 2
    definition = harness.load_definition(args.workload, root)
    ctx = RunContext(definition, args.seed, args.seconds, False,
                     torch.device('cuda'), root)
    p = definition.workload['params']
    service, runner = serve.make_service(ctx)
    runner.pipe.schedule(p['steps'])
    pool = cf.ThreadPoolExecutor(max_workers=p['threads'])
    serve.warm(service, p, pool)
    print(f'card: {harness.card_limit()}', flush=True)
    for rate in args.rates:
        q = dict(p, rate_per_s=rate)
        reqs = serve.schedule(q, args.seed, args.seconds)
        t0 = time.monotonic()
        results, late, _ = serve.drive(service, reqs, q, args.seconds, pool)
        took = time.monotonic() - t0
        lat = [r[0] if r is not None else float('inf') for r in results]
        done = [v for v in lat if v != float('inf')]
        k = max(1, len(lat) // 4)
        mean = lambda xs: sum(xs) / len(xs)
        print(json.dumps({
            'rate_per_s': rate, 'sent': len(reqs), 'answered': len(done),
            'answers_per_s': len(done) / took, 'seconds_with_drain': took,
            'p50_s': harness.nearest_rank(lat, 0.5),
            'p90_s': harness.nearest_rank(lat, 0.9),
            'max_s': max(lat), 'late_s': late,
            'last_over_first_quarter': mean(lat[-k:]) / mean(lat[:k])}),
            flush=True)
    service.batcher.shutdown()
    return 0


if __name__ == '__main__':
    rc = main()
    sys.stdout.flush()
    os._exit(rc)
