"""PyTorch port: the serving API (``flexdiffuse_tpu_torch/serving``), held
against the JAX package's on the CPU with tiny models (fp32).

* The micro-batcher's cases of ``tests/test_serving.py``: ``pad_rows``,
  fusion, group separation, errors, ``fixed_rows``, the row budget. Fusion
  is shown without timing: ``max_batch_rows`` requests under a 10 s
  window fill one dispatch at once.
* ``GenerationService._run_batch`` against the JAX service's on the same
  requests, with JAX's per-row draws
  (``normal(fold_in(PRNGKey(seed), s), shape)``) injected through the
  port's :func:`row_noise`: the same 'np' images within 1e-3.
* The pieces under it: ``FlexPipeline(output_type='np')``, a per-row
  ``guidance_scale`` ``[B,1,1,1]`` and a per-row ``uncond [B,T,D]``.
* Over real HTTP: generate and health, validation, weighted prompts, and
  one request alone against the same request batched with a stranger:
  bit-equal under ``fixed_rows``, within one uint8 level under the default
  padding.
"""
import base64
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu.serving import api as japi
from flexdiffuse_tpu.serving import batcher as jbatcher
from flexdiffuse_tpu_torch.pipeline import SimpleGuidance
from flexdiffuse_tpu_torch.serving import GenerationService, api, launch
from flexdiffuse_tpu_torch.serving.batcher import MicroBatcher, pad_rows
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_protocol import runner_pair

FILL = 10000.0   # ms: a window no test waits out; dispatches fill instead


def test_pad_rows_matches_jax():
    assert [pad_rows(n, 8) for n in (1, 2, 3, 4, 5, 8)] == [1, 2, 4, 4, 8, 8]
    assert pad_rows(7, 4) == 4
    for n in range(1, 17):
        for cap in (1, 2, 4, 8, 16):
            assert pad_rows(n, cap) == jbatcher.pad_rows(n, cap)


def test_batcher_fuses_same_group():
    """Four 1-row requests with ``max_batch_rows=4`` fill one dispatch; no
    timing decides it."""
    calls = []

    def run(payloads, total_rows):
        calls.append((list(payloads), total_rows))
        return [p * 10 for p in payloads]

    b = MicroBatcher(run, max_batch_rows=4, max_wait_ms=FILL)
    try:
        futs = [b.submit(i, rows=1, group='g') for i in range(4)]
        assert [f.result(timeout=30) for f in futs] == [0, 10, 20, 30]
        assert calls == [([0, 1, 2, 3], 4)]
        s = b.stats()
        assert (s['requests'], s['batches'], s['rows'],
                s['padded_rows']) == (4, 1, 4, 0)
        assert s['mean_rows_per_batch'] == 4.0
    finally:
        b.shutdown()


def test_batcher_pads_to_a_power_of_two():
    """Each dispatch runs at its rows rounded up to a power of two (2-, 2-
    and 1-row requests: 5 rows run as 8 when they fuse)."""
    calls = []

    def run(payloads, total_rows):
        calls.append((list(payloads), total_rows))
        return payloads

    b = MicroBatcher(run, max_batch_rows=8, max_wait_ms=200)
    try:
        futs = [b.submit(rows, rows=rows, group='g') for rows in (2, 2, 1)]
        assert [f.result(timeout=30) for f in futs] == [2, 2, 1]
        assert sorted(p for ps, _ in calls for p in ps) == [1, 2, 2]
        for payloads, total in calls:
            assert total == pad_rows(sum(payloads), 8)
        s = b.stats()
        assert s['rows'] == 5
        assert s['padded_rows'] == sum(t for _, t in calls) - 5
    finally:
        b.shutdown()


def test_batcher_separates_groups():
    seen = []

    def run(payloads, total_rows):
        seen.append(sorted(payloads))
        return payloads

    b = MicroBatcher(run, max_batch_rows=2, max_wait_ms=FILL)
    try:
        futs = ([b.submit(f'a{i}', group='A') for i in range(2)] +
                [b.submit(f'b{i}', group='B') for i in range(2)])
        for f in futs:
            f.result(timeout=30)
        assert sorted(seen) == [['a0', 'a1'], ['b0', 'b1']]
    finally:
        b.shutdown()


def test_batcher_propagates_errors_and_survives():
    def run(payloads, total_rows):
        if 'boom' in payloads:
            raise RuntimeError('kaput')
        return payloads

    b = MicroBatcher(run, max_batch_rows=1, max_wait_ms=FILL)
    try:
        bad = b.submit('boom', group='x')
        with pytest.raises(RuntimeError, match='kaput'):
            bad.result(timeout=30)
        ok = b.submit('fine', group='x')
        assert ok.result(timeout=30) == 'fine'
    finally:
        b.shutdown()


def test_batcher_rejects_a_wrong_result_count():
    b = MicroBatcher(lambda payloads, rows: [], max_batch_rows=1)
    try:
        with pytest.raises(RuntimeError, match='0 results for 1'):
            b.submit('x').result(timeout=30)
    finally:
        b.shutdown()


def test_fixed_rows_pins_batch_shape():
    """``fixed_rows=True`` pads every dispatch to ``max_batch_rows``."""
    totals = []

    def run(payloads, total_rows):
        totals.append(total_rows)
        return payloads

    b = MicroBatcher(run, max_batch_rows=4, max_wait_ms=5, fixed_rows=True)
    try:
        b.submit('solo', rows=1, group='g').result(timeout=30)
        futs = [b.submit(i, rows=1, group='g') for i in range(3)]
        for f in futs:
            f.result(timeout=30)
        assert set(totals) == {4}, totals
        assert b.stats()['padded_rows'] >= 3  # solo padded 1 -> 4
    finally:
        b.shutdown()


def test_batcher_respects_row_budget():
    sizes = []

    def run(payloads, total_rows):
        sizes.append(len(payloads))
        return payloads

    b = MicroBatcher(run, max_batch_rows=2, max_wait_ms=FILL)
    try:
        futs = [b.submit(i, rows=1, group='g') for i in range(4)]
        for f in futs:
            f.result(timeout=30)
        assert sizes == [2, 2]
        with pytest.raises(ValueError):
            b.submit('too-big', rows=3, group='g')
        with pytest.raises(ValueError):
            b.submit('none', rows=0, group='g')
    finally:
        b.shutdown()


# ---------------------------------------------------------------------------
# The device side against the JAX service

@pytest.fixture(scope='module')
def runners(tmp_path_factory):
    return runner_pair(str(tmp_path_factory.mktemp('serving')))


def jax_row_noise(seed, sample, shape, device):
    """The JAX service's draw for a row, as the port's row noise."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), sample)
    return torch.from_numpy(np.array(jax.random.normal(key, tuple(shape),
                                                       jnp.float32))
                            ).to(device)


REQUESTS = [
    [{'prompt': 'a red fox', 'seed': 3, 'steps': 2, 'width': 64,
      'height': 64}],
    [{'prompt': 'a red fox', 'seed': 3, 'steps': 2, 'width': 64,
      'height': 64, 'samples': 2, 'guidance_scale': 6.5,
      'negative_prompt': 'blurry'},
     {'prompt': 'a (stone:1.4) castle', 'weighted': True, 'seed': 11,
      'steps': 2, 'width': 64, 'height': 64, 'guidance_scale': 9.0}],
    [{'prompt': 'no guidance', 'seed': 5, 'steps': 2, 'width': 64,
      'height': 64, 'guidance_scale': 1.0}],
]


@pytest.mark.parametrize('case,total', [(0, 1), (0, 4), (1, 4), (2, 2)])
def test_run_batch_matches_jax(runners, monkeypatch, case, total):
    """Same requests, same per-row noise: the port's 'np' images within
    1e-3 of the JAX service's (padding rows included in the batch and
    dropped on the way out)."""
    jr, tr = runners
    monkeypatch.setattr(api, 'row_noise', jax_row_noise)
    reqs = [japi.GenerationService._validate(r) for r in REQUESTS[case]]
    assert reqs == [GenerationService._validate(r)
                    for r in REQUESTS[case]]
    jsvc = japi.GenerationService(jr, max_batch_rows=4)
    tsvc = GenerationService(tr, max_batch_rows=4)
    try:
        want = jsvc._run_batch(reqs, total)
        got = tsvc._run_batch(reqs, total)
    finally:
        jsvc.batcher.shutdown()
        tsvc.batcher.shutdown()
    assert len(got) == len(want) == len(reqs)
    for (gi, gn), (wi, wn) in zip(got, want):
        assert gn == wn == len(reqs) - 1
        assert len(gi) == len(wi)
        for g, w in zip(gi, wi):
            assert g.dtype == np.float32 and g.shape == (64, 64, 3)
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-3)


def test_row_noise_depends_only_on_its_arguments():
    a = api.row_noise(7, 1, (4, 4, 4), 'cpu')
    assert a.dtype == torch.float32 and a.shape == (4, 4, 4)
    torch.manual_seed(0)
    torch.randn(10)
    assert torch.equal(a, api.row_noise(7, 1, (4, 4, 4), 'cpu'))
    for other in ((7, 0), (8, 1), (7 + 2**32, 2)):
        assert not torch.equal(a, api.row_noise(*other, (4, 4, 4), 'cpu'))


def test_np_output_matches_pil(runners):
    """'np' is the decode before quantising: PIL's uint8 is its round half
    up."""
    _, tr = runners
    emb = tr.encoder.prompt('a deer')
    g = SimpleGuidance(embeddings=emb.repeat(2, 1, 1),
                       uncond=tr.encoder.prompt(''), guidance_scale=8.0)
    noise = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 4)).astype(np.float32))
    kw = dict(steps=2, init_size=(64, 64), noise=noise)
    arr = tr.pipe(g, output_type='np', **kw).images
    pil = tr.pipe(g, **kw).images
    assert isinstance(arr, np.ndarray) and arr.dtype == np.float32
    assert arr.shape == (2, 64, 64, 3) and 0 <= arr.min() <= arr.max() <= 1
    for a, p in zip(arr, pil):
        np.testing.assert_array_equal((a * 255 + 0.5).astype(np.uint8),
                                      np.asarray(p))
    with pytest.raises(ValueError, match='output_type'):
        tr.pipe(g, output_type='jpeg', **kw)


def test_per_row_scale_and_uncond(runners):
    """A ``[B,1,1,1]`` scale tensor of equal values and a ``[B,T,D]``
    uncond of equal rows give the float/``[1,T,D]`` path's ε exactly; a
    per-row scale gives each row its own CFG."""
    _, tr = runners
    unet = tr.pipe.unet
    emb = torch.cat([tr.encoder.prompt('a deer'), tr.encoder.prompt('a fox')])
    unc = tr.encoder.prompt('blurry')
    lat = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, 8, 4)).astype(np.float32))
    t = torch.tensor(500.0)
    base = SimpleGuidance(embeddings=emb, uncond=unc, guidance_scale=7.0)
    rows = SimpleGuidance(embeddings=emb, uncond=unc.expand(2, -1, -1),
                          guidance_scale=torch.full((2, 1, 1, 1), 7.0))
    with torch.no_grad():
        want = base.noise_pred(unet, lat, t)
        assert torch.equal(rows.noise_pred(unet, lat, t), want)
        mixed = SimpleGuidance(embeddings=emb, uncond=unc,
                               guidance_scale=torch.tensor(
                                   [7.0, 2.0]).reshape(2, 1, 1, 1))
        got = mixed.noise_pred(unet, lat, t)
        two = SimpleGuidance(embeddings=emb, uncond=unc,
                             guidance_scale=2.0).noise_pred(unet, lat, t)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(got[1], two[1], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# Over real HTTP

@pytest.fixture(scope='module')
def serve(runners):
    """``serve(**launch_kw)`` → base URL of a server on the port's tiny
    Runner; every server started here is shut down after the module."""
    _, tr = runners
    started = []

    def start(**kw):
        httpd = launch(lambda: tr, port=0, **kw)
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        started.append((httpd, t))
        return f'http://127.0.0.1:{httpd.server_address[1]}'

    yield start
    for httpd, t in started:
        httpd.shutdown()
        httpd.server_close()
        httpd.RequestHandlerClass.service.batcher.shutdown()
        t.join(timeout=30)
        assert not t.is_alive()


def _post(base, payload):
    req = urllib.request.Request(
        base + '/v1/generate', data=json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=30) as r:
        return json.loads(r.read())


def _pixels(b64):
    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def test_api_generate_and_health(serve):
    base = serve(max_batch_rows=4, max_wait_ms=0)
    status, out = _post(base, {'prompt': 'a test', 'steps': 2, 'width': 64,
                               'height': 64, 'seed': 7, 'samples': 2})
    assert status == 200, out
    assert len(out['images']) == 2 and out['latency_ms'] > 0
    assert out['batched_with'] == 0
    png = base64.b64decode(out['images'][0])
    assert png[:8] == b'\x89PNG\r\n\x1a\n'
    assert _pixels(out['images'][0]).shape == (64, 64, 3)
    assert _get(base, '/v1/health') == {'status': 'ok', 'devices': ['cpu']}
    s = _get(base, '/v1/stats')
    assert (s['requests'], s['batches'], s['rows']) == (1, 1, 2)
    assert s['latency_ms_p50'] > 0 and s['latency_ms_p95'] > 0


def test_api_validation_errors(serve):
    base = serve(max_batch_rows=4, max_wait_ms=0)
    for payload in ({}, {'prompt': 'x', 'steps': 0},
                    {'prompt': 'x', 'width': 100},
                    {'prompt': 'x', 'samples': 99},
                    {'prompt': '   '}, {'prompt': 'x', 'steps': 151},
                    {'prompt': 'x', 'height': 2048}, [1, 2]):
        status, out = _post(base, payload)
        assert status == 400 and 'error' in out, (payload, out)
    req = urllib.request.Request(base + '/v1/generate', data=b'{not json',
                                 headers={'Content-Type': 'application/json'})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400 and 'error' in json.loads(e.value.read())
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + '/v1/nothing', timeout=30)
    assert e.value.code == 404


def test_api_failure_is_json_500(serve, runners, monkeypatch):
    """A failure inside the batch answers 500 with the message only."""
    _, tr = runners
    base = serve(max_batch_rows=1, max_wait_ms=0)

    def boom(*a, **k):
        raise RuntimeError('the card fell over')

    monkeypatch.setattr(tr.encoder, 'prompt', boom)
    status, out = _post(base, {'prompt': 'x', 'steps': 2, 'width': 64,
                               'height': 64})
    assert status == 500
    assert out == {'error': 'the card fell over'}


def _alone_then_batched(serve, fixed_rows):
    """The same request alone, then fused with a stranger into one
    2-row dispatch (the window is never waited out)."""
    req = {'prompt': 'deterministic', 'steps': 2, 'width': 64, 'height': 64,
           'seed': 1234}
    stranger = {'prompt': 'a stranger request', 'steps': 2, 'width': 64,
                'height': 64, 'seed': 999}
    alone_base = serve(max_batch_rows=2, max_wait_ms=0, fixed_rows=fixed_rows)
    status, alone = _post(alone_base, req)
    assert status == 200 and alone['batched_with'] == 0
    base = serve(max_batch_rows=2, max_wait_ms=FILL, fixed_rows=fixed_rows)
    results = {}

    def fire(name, payload):
        results[name] = _post(base, payload)

    threads = [threading.Thread(target=fire, args=('same', req)),
               threading.Thread(target=fire, args=('other', stranger))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert results['same'][0] == 200 and results['other'][0] == 200
    assert results['same'][1]['batched_with'] == 1
    s = _get(base, '/v1/stats')
    assert (s['requests'], s['batches'], s['rows'],
            s['padded_rows']) == (2, 1, 2, 0)
    return (_pixels(alone['images'][0]),
            _pixels(results['same'][1]['images'][0]))


def test_api_seed_bit_equal_alone_and_batched_under_fixed_rows(serve):
    """``fixed_rows``: one batch shape, so the request's image is the same
    bits alone (padded to 2 rows) and batched with a stranger."""
    alone, batched = _alone_then_batched(serve, fixed_rows=True)
    np.testing.assert_array_equal(alone, batched)


def test_api_seed_reproducible_across_batching(serve):
    """Default padding: alone (1 row) against batched (2 rows), within one
    uint8 level (the per-row noise contract)."""
    alone, batched = _alone_then_batched(serve, fixed_rows=False)
    assert np.abs(alone.astype(np.int16) - batched).max() <= 1


def test_api_concurrent_requests_fuse(serve):
    """Four concurrent 1-row requests under ``max_batch_rows=4`` and a
    10 s window make exactly one dispatch (no timing decides it)."""
    base = serve(max_batch_rows=4, max_wait_ms=FILL)
    results = []

    def fire(i):
        results.append(_post(base, {'prompt': f'request {i}', 'steps': 2,
                                    'width': 64, 'height': 64, 'seed': i}))

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(4)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert time.monotonic() - t0 < FILL / 1e3
    assert [s for s, _ in results] == [200] * 4
    assert all(out['batched_with'] == 3 for _, out in results)
    s = _get(base, '/v1/stats')
    assert (s['requests'], s['batches'], s['rows']) == (4, 1, 4)
    assert s['mean_rows_per_batch'] == 4.0


def test_api_weighted_prompt(serve):
    """weighted=True parses emphasis syntax: an emphasis-free weighted
    request matches plain, an emphasised one differs."""
    base = serve(max_batch_rows=1, max_wait_ms=0)
    req = {'steps': 2, 'width': 64, 'height': 64, 'seed': 21}
    s1, plain = _post(base, {**req, 'prompt': 'a red cat'})
    s2, same = _post(base, {**req, 'prompt': 'a red cat', 'weighted': True})
    s3, emph = _post(base, {**req, 'prompt': 'a (red:1.8) cat',
                            'weighted': True})
    assert s1 == s2 == s3 == 200
    assert plain['images'][0] == same['images'][0]
    assert plain['images'][0] != emph['images'][0]


def test_launch_defaults_to_the_card():
    """The service runs where the factory's Runner runs; a model_root
    Runner on its defaults needs the card here and raises, with no CPU
    fallback."""
    from flexdiffuse_tpu_torch.runner import Runner
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch(lambda: Runner(model_root='/nonexistent'), port=0)
