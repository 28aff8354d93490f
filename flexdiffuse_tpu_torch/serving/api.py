"""JSON serving API — batched text-to-image over HTTP (port of
``flexdiffuse_tpu/serving/api.py``).

A headless counterpart to the browser UI (interface/server.py): stdlib
``ThreadingHTTPServer`` accepting concurrent JSON requests, with the
micro-batcher (serving/batcher.py) fusing same-shape requests into one
batched pipeline call per dispatch.

Endpoints:

* ``POST /v1/generate`` — ``{"prompt": ..., "negative_prompt": "",
  "steps": 25, "width": 512, "height": 512, "guidance_scale": 8.0,
  "seed": null, "samples": 1, "weighted": false}`` →
  ``{"images": [<base64 PNG>, ...], "latency_ms": ..., "batched_with": N}``.
  Requests with equal (steps, size, cfg-mode) batch together;
  ``guidance_scale`` rides as a per-row tensor so mixed scales share one
  call. A bad payload answers 400, any other failure 500, both as
  ``{"error": ...}`` (never a stack trace).
* ``GET /v1/health`` — liveness and the torch device the model runs on
  (with the card's name).
* ``GET /v1/stats`` — request/batch counters, mean rows per batch,
  latency percentiles.

Seeds: each row's initial latents come from :func:`row_noise` of the
request's ``seed`` and the row's sample index, so a request's sampling
trajectory does not depend on what it was batched with. Results are the
same bits for the same padded batch shape; across padded shapes they can
differ in the last bits, as the card's libraries may order a sum
differently at another batch size. Launch with ``fixed_rows=True`` (CLI
``--deterministic``) to pin one batch shape and make results bitwise
reproducible always, at the cost of padded compute on partial batches.

Threads: only the batcher's dispatcher thread runs the model (and so
touches the card and the rows' generators); HTTP threads validate,
enqueue and wait.
"""
from __future__ import annotations

import base64
import collections
import io
import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Sequence

import numpy as np
import torch

from flexdiffuse_tpu_torch.pipeline import SimpleGuidance
from flexdiffuse_tpu_torch.serving.batcher import MicroBatcher

log = logging.getLogger(__name__)

MAX_STEPS = 150
MAX_SIDE = 1024
_M64 = 2**64 - 1


def _mix64(x: int) -> int:
    """splitmix64's finaliser: spreads every input bit over all 64 output
    bits (the CPU generator keeps only the low 32 of its seed)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def row_noise(seed: int, sample: int, shape: Sequence[int],
              device) -> torch.Tensor:
    """Unit-normal fp32 noise of ``shape`` for row ``sample`` of a request
    seeded ``seed``, from a ``torch.Generator`` of its own on ``device``
    seeded by the pair: the port's counterpart of the JAX service's
    ``jax.random.normal(jax.random.fold_in(PRNGKey(seed), sample),
    shape)`` (the two generators draw different numbers). The generator's
    seed is a hash of the pair (``seed`` taken modulo 2**32), so the draw
    depends on nothing but the arguments."""
    gen = torch.Generator(device).manual_seed(_mix64(
        ((int(seed) & 0xFFFFFFFF) << 32) | (int(sample) & 0xFFFFFFFF)))
    return torch.randn(tuple(shape), generator=gen, device=device,
                       dtype=torch.float32)


def describe_device(device: torch.device) -> str:
    """``'cuda:0 (NVIDIA H100 80GB HBM3)'`` on a card, ``'cpu'`` else."""
    device = torch.device(device)
    if device.type == 'cuda':
        return f'{device} ({torch.cuda.get_device_name(device)})'
    return str(device)


class GenerationService:
    """Bridges HTTP payloads to one batched FlexPipeline call."""

    def __init__(self, runner, max_batch_rows: int = 8,
                 max_wait_ms: float = 30.0, fixed_rows: bool = False):
        self.runner = runner
        self.device = describe_device(runner.pipe.device)
        self.batcher = MicroBatcher(self._run_batch,
                                    max_batch_rows=max_batch_rows,
                                    max_wait_ms=max_wait_ms,
                                    fixed_rows=fixed_rows)
        self._latencies = collections.deque(maxlen=512)
        self._lock = threading.Lock()

    # -- request side ------------------------------------------------
    def generate(self, payload: dict) -> dict:
        t0 = time.monotonic()
        req = self._validate(payload)
        group = (req['steps'], req['width'], req['height'],
                 req['guidance_scale'] > 1.0)
        fut = self.batcher.submit(req, rows=req['samples'], group=group)
        images, batched_with = fut.result()
        out = {
            'images': [self._png_b64(im) for im in images],
            'latency_ms': round((time.monotonic() - t0) * 1e3, 1),
            'batched_with': batched_with,
        }
        with self._lock:
            self._latencies.append(out['latency_ms'])
        return out

    def stats(self) -> dict:
        s = self.batcher.stats()
        with self._lock:
            lat = sorted(self._latencies)
        if lat:
            s['latency_ms_p50'] = lat[len(lat) // 2]
            s['latency_ms_p95'] = lat[min(len(lat) - 1,
                                          int(len(lat) * 0.95))]
        return s

    @staticmethod
    def _validate(p: dict) -> dict:
        if not isinstance(p, dict):
            raise ValueError('payload must be a JSON object')
        prompt = p.get('prompt', '')
        if not isinstance(prompt, str) or not prompt.strip():
            raise ValueError('prompt is required')
        steps = int(p.get('steps', 25))
        width = int(p.get('width', 512))
        height = int(p.get('height', 512))
        samples = int(p.get('samples', 1))
        if not 1 <= steps <= MAX_STEPS:
            raise ValueError(f'steps must be in [1, {MAX_STEPS}]')
        if width % 64 or height % 64 or not (64 <= width <= MAX_SIDE) \
                or not (64 <= height <= MAX_SIDE):
            raise ValueError(
                f'width/height must be multiples of 64 in [64, {MAX_SIDE}]')
        if not 1 <= samples <= 8:
            raise ValueError('samples must be in [1, 8]')
        seed = p.get('seed')
        return {
            'prompt': prompt,
            'negative_prompt': str(p.get('negative_prompt', '') or ''),
            'steps': steps, 'width': width, 'height': height,
            'samples': samples,
            'guidance_scale': float(p.get('guidance_scale', 8.0)),
            'seed': None if seed is None else int(seed),
            # Emphasis weighting ((word:1.3) / [word]); batched rows share
            # one 77-token context, so weighted prompts use a single window
            # (longer ones truncate, like classic 77-token truncation).
            'weighted': bool(p.get('weighted', False)),
        }

    @staticmethod
    def _png_b64(arr: np.ndarray) -> str:
        from PIL import Image
        if arr.dtype != np.uint8:  # pipeline 'np' output is float [0, 1]
            arr = (np.clip(arr, 0.0, 1.0) * 255).round().astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format='PNG')
        return base64.b64encode(buf.getvalue()).decode('ascii')

    # -- device side (single dispatcher thread) -----------------------
    def _run_batch(self, reqs: List[dict], total_rows: int):
        enc = self.runner.encoder
        pipe = self.runner.pipe
        f = pipe.vae_scale
        r0 = reqs[0]
        shape = (r0['height'] // f, r0['width'] // f, pipe.latent_channels)
        rows_emb, rows_unc, rows_scale, rows_noise = [], [], [], []
        for r in reqs:
            if r.get('weighted'):
                emb = enc.prompt_weighted(r['prompt'], max_chunks=1)
                unc = enc.prompt_weighted(r['negative_prompt'] or '',
                                          max_chunks=1)
            else:
                emb = enc.prompt(r['prompt'])
                unc = enc.prompt(r['negative_prompt'] or '')
            seed = r['seed'] if r['seed'] is not None else int(
                time.time_ns() % (2**31))
            for s in range(r['samples']):
                rows_emb.append(emb[0])
                rows_unc.append(unc[0])
                rows_scale.append(r['guidance_scale'])
                rows_noise.append(row_noise(seed, s, shape, pipe.device))
        # Pad to the quantized row count by replicating the last row
        # (padding outputs are dropped below).
        n_real = len(rows_emb)
        for rows in (rows_emb, rows_unc, rows_scale, rows_noise):
            rows.extend(rows[-1:] * (total_rows - n_real))
        guidance = SimpleGuidance(
            embeddings=torch.stack(rows_emb),
            uncond=torch.stack(rows_unc),
            guidance_scale=torch.tensor(
                rows_scale, dtype=torch.float32,
                device=pipe.device).reshape(-1, 1, 1, 1),
            cfg=r0['guidance_scale'] > 1.0)
        images = pipe(guidance, steps=r0['steps'],
                      init_size=(r0['height'], r0['width']),
                      noise=torch.stack(rows_noise),
                      output_type='np').images[:n_real]
        results = []
        i = 0
        for r in reqs:
            results.append((list(images[i:i + r['samples']]),
                            len(reqs) - 1))
            i += r['samples']
        return results


# ---------------------------------------------------------------------------
# HTTP layer


class _Handler(BaseHTTPRequestHandler):
    service: 'GenerationService' = None  # set by launch()

    def log_message(self, fmt, *args):
        log.info('%s %s', self.address_string(), fmt % args)

    def _send(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header('Content-Type', 'application/json')
        self.send_header('Content-Length', str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == '/v1/health':
            self._send(200, {'status': 'ok',
                             'devices': [self.service.device]})
        elif self.path == '/v1/stats':
            self._send(200, self.service.stats())
        else:
            self._send(404, {'error': 'not found'})

    def do_POST(self):
        if self.path != '/v1/generate':
            self._send(404, {'error': 'not found'})
            return
        try:
            n = int(self.headers.get('Content-Length', 0))
            payload = json.loads(self.rfile.read(n) or b'{}')
            self._send(200, self.service.generate(payload))
        except ValueError as e:
            self._send(400, {'error': str(e)})
        except Exception as e:  # JSON-500, never a stack dump to the client
            log.exception('generate failed')
            self._send(500, {'error': str(e)[:300]})


def launch(runner_factory: Callable, port: int = 8000, lan: bool = False,
           max_batch_rows: int = 8, max_wait_ms: float = 30.0,
           fixed_rows: bool = False) -> ThreadingHTTPServer:
    """Build the service (loading models via ``runner_factory``, which
    picks the device: a ``Runner(model_root=...)`` runs on the card unless
    given ``device='cpu'``) and return a ready-to-serve
    ThreadingHTTPServer (call ``serve_forever()``; the service is
    ``httpd.RequestHandlerClass.service``)."""
    service = GenerationService(runner_factory(),
                                max_batch_rows=max_batch_rows,
                                max_wait_ms=max_wait_ms,
                                fixed_rows=fixed_rows)
    handler = type('Handler', (_Handler,), {'service': service})
    host = '0.0.0.0' if lan else '127.0.0.1'
    httpd = ThreadingHTTPServer((host, port), handler)
    log.info('serving API on http://%s:%d (%s; batch rows ≤ %d, wait %.0f '
             'ms)', host, port, service.device, max_batch_rows, max_wait_ms)
    return httpd
