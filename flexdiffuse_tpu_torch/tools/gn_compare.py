"""K6 on the card, per GroupNorm of a 512² UNet evaluation and VAE decode.

    python flexdiffuse_tpu_torch/tools/gn_compare.py [--root DIR] [--label L]
    python flexdiffuse_tpu_torch/tools/gn_compare.py --sweep

Times ``fused_group_norm`` of the package found under ``--root`` (default:
this checkout) at every GroupNorm shape of one SD-1.x UNet evaluation at
512² (CFG batch 2) and one VAE decode at 512², bf16 in and out, with SiLU,
channels-last: device ms per call as CUDA-graph replays (the median of 3
runs of 20 calls), summed over the calls of an evaluation and of a decode
beside the summed bound (one bf16 read of x and one write of y per call at
3.35 TB/s),
and the host µs per call (the median of 3 runs of 200 calls enqueued back
to back) at two shapes.
Pointed at an unpacked earlier commit, the same script times that commit's
K6, so two versions are compared within one call on one card; run them in
turns (old, new, new, old). Prints one JSON line. Needs a CUDA device.

``--sweep`` (this checkout only) times, at every shape above, the planned
call, the stream path forced, and the resident path on every other plan:
every slab of whole groups that fills 16-byte vectors, at every cluster of
1 to 16 blocks that holds it; one JSON line per shape.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

# (NCHW shape, calls): the GroupNorms of one UNet evaluation (61) and of
# one VAE decode (30), as the port's SD-1.4 models run them.
UNET = [((2, 1280, 8, 8), 12), ((2, 2560, 8, 8), 3),
        ((2, 1280, 16, 16), 11), ((2, 2560, 16, 16), 2),
        ((2, 1920, 16, 16), 1), ((2, 640, 16, 16), 1),
        ((2, 640, 32, 32), 11), ((2, 1920, 32, 32), 1),
        ((2, 1280, 32, 32), 1), ((2, 960, 32, 32), 1),
        ((2, 320, 32, 32), 1), ((2, 320, 64, 64), 13),
        ((2, 640, 64, 64), 2), ((2, 960, 64, 64), 1)]
DECODE = [((1, 512, 64, 64), 11), ((1, 512, 128, 128), 6),
          ((1, 256, 256, 256), 5), ((1, 512, 256, 256), 1),
          ((1, 128, 512, 512), 6), ((1, 256, 512, 512), 1)]
HOST_SHAPES = [(2, 320, 64, 64), (2, 1280, 8, 8)]
PEAK_BYTES = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)


def graph_ms(torch, fn, iters: int = 20, reps: int = 3) -> float:
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def host_us(torch, fn, calls: int = 200, reps: int = 3) -> float:
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return statistics.median(times)


def sweep(torch, gn, inputs) -> None:
    for shape, _ in UNET + DECODE:
        a = inputs(shape)
        x, groups = a[0], a[1]
        planned = gn.plan_group_norm(shape, groups, x.dtype, x.dtype, True)
        times = {'planned': graph_ms(torch, lambda: gn.fused_group_norm(*a)),
                 'stream': graph_ms(torch, lambda: gn.fused_group_norm(
                     *a, path='stream'))}
        hw, cpg = shape[2] * shape[3], shape[1] // groups
        for slab in range(1, groups + 1):
            sc = slab * cpg
            if groups % slab or sc % 8 or sc // 8 > gn.THREADS:
                continue
            for cluster in (1, 2, 4, 8, 16):
                pixels = -(-hw // cluster)
                if pixels * sc * 2 > gn.TILE_BYTES:
                    continue
                how = gn.Plan('resident', 1, slab, cluster, pixels,
                              gn.resident_smem(pixels, sc, 2, slab, cluster),
                              (cluster * (groups // slab), shape[0]), 0, 0)
                y = torch.empty_like(x)
                times[f'slab {slab} cluster {cluster}'] = graph_ms(
                    torch, lambda: gn.launch(x, *a[1:4], y, *a[4:], how))
        print(json.dumps(dict(shape=shape, path=planned.path,
                              planned=[planned.slab, planned.cluster],
                              ms=times)), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--root', default=os.path.join(os.path.dirname(
        os.path.abspath(__file__)), '..', '..'),
        help='the checkout whose flexdiffuse_tpu_torch is timed')
    ap.add_argument('--label', default='this checkout')
    ap.add_argument('--sweep', action='store_true',
                    help='time the resident path on other plans instead')
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from flexdiffuse_tpu_torch.ops import group_norm as gn
    if not torch.cuda.is_available():
        print('gn_compare: no CUDA device', file=sys.stderr)
        return 1
    gen = torch.Generator('cuda').manual_seed(0)

    def inputs(shape):
        x = (1.5 * torch.randn(shape, generator=gen, device='cuda') + 0.7).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        w = (1 + 0.5 * torch.randn(shape[1], generator=gen,
                                   device='cuda')).to(torch.bfloat16)
        b = (0.3 * torch.randn(shape[1], generator=gen,
                               device='cuda')).to(torch.bfloat16)
        return x, 32, w, b, 1e-5, True

    if args.sweep:
        sweep(torch, gn, inputs)
        return 0
    res = dict(label=args.label, root=os.path.abspath(args.root),
               card=torch.cuda.get_device_name(0), unet={}, decode={})
    for key, shapes in (('unet', UNET), ('decode', DECODE)):
        total = 0.0
        res[f'{key}_bound_ms'] = sum(
            calls * 4 * math.prod(shape) / PEAK_BYTES * 1e3
            for shape, calls in shapes)
        for shape, calls in shapes:
            a = inputs(shape)
            ms = graph_ms(torch, lambda: gn.fused_group_norm(*a))
            res[key][str(shape)] = ms
            total += calls * ms
            del a
        res[f'{key}_ms'] = total
    res['host_us'] = {}
    for shape in HOST_SHAPES:
        a = inputs(shape)
        res['host_us'][str(shape)] = host_us(
            torch, lambda: gn.fused_group_norm(*a))
    print(json.dumps(res))
    return 0


if __name__ == '__main__':
    sys.exit(main())
