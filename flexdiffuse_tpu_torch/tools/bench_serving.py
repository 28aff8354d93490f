"""Serving-API load test: concurrent requests against the batched service.

Port of ``tools/bench_serving.py``. Runs the port's ``GenerationService``
in-process over a ``Runner`` on seeded SD-1.4 weights, fires 8 concurrent
clients at it (4 requests each, 25 PNDM steps at 512², CFG), and reports
images/min, latency percentiles and the micro-batcher's fusion: the
end-to-end number of the dynamic-batching path (``serving/api.py``,
``serving/batcher.py``). Two warm-up rounds (one request, then 8 at once)
run outside the clock; ``batches`` counts the measured window's.

    python -m flexdiffuse_tpu_torch.tools.bench_serving [--device cpu]

Prints one JSON line. On the CPU it serves the tiny models at 64², 2
clients of 2 requests of 2 steps, as a check that the path runs.
"""
from __future__ import annotations

import threading
import time

import torch

from flexdiffuse_tpu_torch.models import (CLIP_VIT_L14_TEXT,
                                          CLIP_VIT_L14_VISION, SD14_UNET,
                                          SD14_VAE, AutoencoderKL,
                                          CLIPTextModel, CLIPVisionModel,
                                          UNet2DCondition)
from flexdiffuse_tpu_torch.models.configs import (TINY_TEXT, TINY_UNET,
                                                  TINY_VAE, TINY_VISION)
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.serving.api import GenerationService
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.tools import BF16, parser, resolve_device
from flexdiffuse_tpu_torch.tools.bench_common import emit, seeded

CLIENTS = 8
REQUESTS_PER_CLIENT = 4
STEPS = 25


def make_runner(device: torch.device, dtype=BF16, text=CLIP_VIT_L14_TEXT,
                vision=CLIP_VIT_L14_VISION, unet=SD14_UNET, vae=SD14_VAE
                ) -> Runner:
    """A Runner over seeded models of the given geometry."""
    return Runner.from_models(
        seeded(CLIPTextModel, text, device, dtype),
        seeded(CLIPVisionModel, vision, device, dtype),
        seeded(UNet2DCondition, unet, device, dtype),
        seeded(AutoencoderKL, vae, device, dtype),
        FakeTokenizer(text.vocab_size))


def measure(runner: Runner, clients: int = CLIENTS,
            requests_per_client: int = REQUESTS_PER_CLIENT,
            steps: int = STEPS, size: int = 512,
            max_wait_ms: float = 40.0) -> dict:
    svc = GenerationService(runner, max_batch_rows=8,
                            max_wait_ms=max_wait_ms)
    base = {'steps': steps, 'width': size, 'height': size}
    try:
        svc.generate(dict(base, prompt='warm', seed=0))
        errors = []

        def call(payload):
            try:
                svc.generate(payload)
            except Exception as e:   # re-raised below, in the caller
                errors.append(e)
                raise

        warm = [threading.Thread(target=call, args=(
            dict(base, prompt=f'warm {i}', seed=i),)) for i in range(8)]
        for t in warm:
            t.start()
        for t in warm:
            t.join()
        if errors:
            raise errors[0]
        warm_batches = svc.stats()['batches']

        lat = []
        lock = threading.Lock()

        def client(cid: int):
            for r in range(requests_per_client):
                t1 = time.perf_counter()
                call(dict(base, prompt=f'client {cid} request {r}',
                          seed=cid * 100 + r))
                with lock:
                    lat.append(time.perf_counter() - t1)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        stats = svc.stats()
    finally:
        svc.batcher.shutdown()
    n = clients * requests_per_client
    lat.sort()
    return {
        'metric': (f'serving API, {clients} concurrent clients, SD-1.4 '
                   f'{size}^2 {steps}-step CFG'),
        'images_per_min': 60.0 * n / wall,
        'latency_s_p50': lat[n // 2],
        'latency_s_p95': lat[int(n * 0.95)],
        'mean_rows_per_batch': stats['mean_rows_per_batch'],
        'batches': stats['batches'] - warm_batches,
        'requests': n,
    }


def main() -> None:
    args = parser(__doc__).parse_args()
    device = resolve_device(args.device)
    if device.type == 'cuda':
        res = measure(make_runner(device))
    else:
        runner = make_runner(device, torch.float32, TINY_TEXT, TINY_VISION,
                             TINY_UNET, TINY_VAE)
        res = measure(runner, clients=2, requests_per_client=2, steps=2,
                      size=64)
    emit(res, device)


if __name__ == '__main__':
    main()
