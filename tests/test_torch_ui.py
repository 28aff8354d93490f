"""PyTorch port: the web UI (``flexdiffuse_tpu_torch/interface``), held
against the JAX package's.

* ``handle_generate``/``handle_compose`` of both packages, fed the same JSON
  payloads, call a recording fake Runner with equal keyword arguments
  (the debug sample clamp included). The port leaves out only the
  keywords it does not port while a client leaves them off: the JAX
  handler always passes ``control_image``/``controlnet_scale`` and
  ``ip_image``/``ip_scale``, the port only with their image.
* Over real HTTP on port 0, the port's server serves the JAX package's page
  and ``/api/health``, runs a 64² generate and compose on the tiny models
  (fp32, CPU), clamps debug runs, runs a posted control image through a
  Runner with a ControlNet, and answers a failure (a control image without
  a ControlNet, an unported keyword) as JSON 500.
"""
import base64
import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu.interface import server as jserver
from flexdiffuse_tpu_torch.interface import server as tserver
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_protocol import runner_pair


def _png_b64(size=(12, 10), seed=0):
    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 256, size[::-1] + (3,), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format='png')
    return 'data:image/png;base64,' + base64.b64encode(
        buf.getvalue()).decode()


class Recorder:
    """A fake Runner: records each call's keyword arguments."""

    def __init__(self):
        self.calls = []

    def _record(self, kind, kw):
        self.calls.append((kind, kw))
        return [Image.new('RGB', (8, 8))], Image.new('RGB', (8, 8))

    def gen(self, **kw):
        return self._record('gen', kw)

    def compose(self, **kw):
        return self._record('compose', kw)


@pytest.fixture()
def recorders(monkeypatch):
    jrec, trec = Recorder(), Recorder()
    monkeypatch.setattr(jserver, '_runner', jrec)
    monkeypatch.setattr(tserver, '_runner', trec)
    return jrec, trec


# Keywords the JAX handler always passes and the port passes only with the
# image that enables them: (image keyword, its scale keyword).
OPTIONAL = (('control_image', 'controlnet_scale'), ('ip_image', 'ip_scale'))

GENERATE = {
    'empty': {},
    'page_defaults': {
        'prompt': 'a deer', 'negative_prompt': 'blurry', 'guide_text': '',
        'mapping_concepts': 'deer', 'strength': '0.6', 'steps': '30',
        'threshold_mult': '0.25', 'threshold_floor': '0.75', 'samples': '4',
        'linear_start': '0.1', 'linear_end': '0.5', 'guidance_scale': '8',
        'clustered': '0.15', 'seed': '0', 'max_guidance': '0.35',
        'header_max': '0', 'height': '512', 'width': '512',
        'guide_mode': '1', 'reuse': True, 'debug': False,
        'hires_scale': '0', 'hires_strength': '0.55', 'cfg_from': '0',
        'cfg_to': '1', 'guidance_rescale': '0', 'pag_scale': '0',
        'init_image': None, 'guide_image': None, 'mask': None,
        'control_image': None, 'controlnet_scale': '1.0',
        'ip_image': None, 'ip_scale': '1.0', 'long_prompt': False,
        'weighted': False},
    'guide_text_and_seed': {'prompt': 'a fox', 'guide_text': 'a painting',
                            'seed': 42, 'steps': 12, 'samples': 2},
    'images': {'prompt': 'x', 'guide_image': _png_b64(seed=1),
               'init_image': _png_b64(seed=2), 'mask': _png_b64(seed=3),
               'strength': 0.8, 'long_prompt': True, 'weighted': True},
    'debug_clamp': {'prompt': 'x', 'steps': 60, 'samples': 4,
                    'debug': True},
    'debug_no_clamp': {'prompt': 'x', 'steps': 20, 'samples': 5,
                       'debug': True},
    'debug_floor': {'prompt': 'x', 'steps': 150, 'samples': 3,
                    'debug': True},
    'unported_enabled': {'prompt': 'x', 'control_image': _png_b64(seed=4),
                         'controlnet_scale': 0.7,
                         'ip_image': _png_b64(seed=5), 'ip_scale': 0.4,
                         'hires_scale': 2, 'hires_strength': 0.4,
                         'cfg_from': 0.1, 'cfg_to': 0.6,
                         'guidance_rescale': 0.7, 'pag_scale': 3,
                         'refine_strength': 0.3},
}


@pytest.mark.parametrize('case', sorted(GENERATE))
def test_handle_generate_keyword_parity(recorders, case):
    jrec, trec = recorders
    jout = jserver.handle_generate(GENERATE[case])
    tout = tserver.handle_generate(GENERATE[case])
    assert tout == jout
    (jkind, jkw), = jrec.calls
    (tkind, tkw), = trec.calls
    assert jkind == tkind == 'gen'
    want = dict(jkw)
    for image, scale in OPTIONAL:
        if want[image] is None:
            del want[image], want[scale]
    assert tkw == want


COMPOSE = {
    'empty': {},
    'page_defaults': {
        'entities': [['A bear in the forest', '0', '256', '256', '256',
                      '0.8'],
                     ['A deer in the forest', '256', '256', '256', '256',
                      '0.8']],
        'bg_prompt': 'A forest with a bear and a deer',
        'start_style': 'Photo', 'end_style': 'Painting',
        'style_blend_start': '0', 'style_blend_end': '1',
        'style_strength': '0', 'samples': '4', 'strength': '0.7',
        'steps': '30', 'guidance_scale': '8', 'height': '512',
        'width': '512', 'seed': '1337', 'init_image': None},
    'init_and_style': {'bg_prompt': 'a field', 'init_image': _png_b64(),
                       'style_strength': 0.5, 'style_blend_start': 0.2,
                       'seed': 0},
    'debug_clamp': {'bg_prompt': 'x', 'steps': 40, 'samples': 4,
                    'debug': True},
}


@pytest.mark.parametrize('case', sorted(COMPOSE))
def test_handle_compose_keyword_parity(recorders, case):
    jrec, trec = recorders
    assert tserver.handle_compose(COMPOSE[case]) == \
        jserver.handle_compose(COMPOSE[case])
    assert trec.calls == jrec.calls
    assert trec.calls[0][0] == 'compose'


def test_page_is_the_jax_page():
    assert tserver.PAGE == jserver.PAGE


# ---------------------------------------------------------------------------
# Over real HTTP

@pytest.fixture(scope='module')
def ui(tmp_path_factory):
    _, tr = runner_pair(str(tmp_path_factory.mktemp('ui_outputs')))
    built = []

    def factory():
        built.append(1)
        return tr

    tserver._runner = None
    httpd = tserver.launch(factory, lan=False, port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f'http://127.0.0.1:{httpd.server_address[1]}', built
    httpd.shutdown()
    httpd.server_close()
    t.join(timeout=30)
    assert not t.is_alive()
    tserver._runner = None


def _post(url, payload):
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def _image(b64):
    return Image.open(io.BytesIO(base64.b64decode(b64.split(',')[-1])))


def test_index_and_health(ui):
    base, _ = ui
    with urllib.request.urlopen(base + '/', timeout=30) as r:
        page = r.read().decode()
    assert page == tserver.PAGE
    assert 'Sandbox' in page and 'Compose' in page
    with urllib.request.urlopen(base + '/api/health', timeout=30) as r:
        assert json.loads(r.read())['ok']
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + '/nothing', timeout=30)
    assert e.value.code == 404


def test_generate_endpoint(ui):
    base, built = ui
    out = _post(base + '/api/generate', {
        'prompt': 'a deer', 'steps': 2, 'samples': 2, 'height': 64,
        'width': 64, 'seed': 1, 'guide_image': _png_b64((40, 40))})
    assert len(out['images']) == 2
    assert all(_image(i).size == (64, 64) for i in out['images'])
    assert _image(out['grid']).size == (128, 64)
    assert built == [1]   # the singleton is built once


def test_compose_endpoint(ui):
    base, _ = ui
    out = _post(base + '/api/compose', {
        'bg_prompt': 'forest', 'steps': 2, 'samples': 1, 'height': 64,
        'width': 64, 'seed': 2,
        'entities': [['a bear', 0, 0, 32, 32, 0.8],
                     ['a deer', 32, 16, 32, 48, 1.0]]})
    assert len(out['images']) == 1
    assert _image(out['images'][0]).size == (64, 64)
    assert out['grid'] is not None


def test_debug_sample_clamp(ui):
    """debug with samples·steps > 100 clamps the samples
    (interface/sandbox.py:16-19): 1 sample of 60 steps, one frame per PLMS
    scan row (61)."""
    base, _ = ui
    out = _post(base + '/api/generate', {
        'prompt': 'x', 'steps': 60, 'samples': 4, 'height': 64, 'width': 64,
        'debug': True, 'seed': 3})
    assert len(out['images']) == 61


def test_sampling_fields_generate(ui):
    """The page's CFG interval (``cfg_from``/``cfg_to``), CFG rescale, PAG
    and hires fields reach ``Runner.gen`` and generate: 200 with the hires
    pass's 1.5× images."""
    base, _ = ui
    out = _post(base + '/api/generate', {
        'prompt': 'x', 'steps': 2, 'height': 64, 'width': 64, 'seed': 5,
        'samples': 1, 'cfg_from': 0.0, 'cfg_to': 0.5,
        'guidance_rescale': 0.7, 'pag_scale': 3.0, 'hires_scale': 1.5,
        'hires_strength': 0.5})
    assert len(out['images']) == 1
    assert _image(out['images'][0]).size == (96, 96)


@pytest.mark.parametrize('payload,message', [
    ({'prompt': 'x', 'steps': 2, 'height': 64, 'width': 64,
      'control_image': _png_b64()}, 'without a controlnet'),
    ({'prompt': 'x', 'steps': 2, 'height': 64, 'width': 64,
      'refine_strength': 0.3}, 'refine_strength'),
])
def test_error_surfaced_as_json(ui, payload, message):
    base, _ = ui
    req = urllib.request.Request(base + '/api/generate',
                                 json.dumps(payload).encode(),
                                 {'Content-Type': 'application/json'})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=300)
    assert e.value.code == 500
    body = json.loads(e.value.read())
    assert message in body['error']


def test_control_image_reaches_a_runner_with_a_controlnet(ui, monkeypatch,
                                                          tmp_path):
    """``/api/generate`` with a base64 ``control_image`` and
    ``controlnet_scale`` on a Runner that loaded a ControlNet (seeded random
    weights, diffusers layout): 200, and the control branch ran beside
    every UNet evaluation (3 PLMS rows at CFG batch 2)."""
    from flexdiffuse_tpu_torch import models as tm
    from flexdiffuse_tpu_torch.models.controlnet import ControlNetModel
    from flexdiffuse_tpu_torch.weights.safetensors import save_file
    base, _ = ui
    _, tr = runner_pair(str(tmp_path))
    torch.manual_seed(0)
    net = ControlNetModel(tm.TINY_UNET, cond_channels=(8, 16))
    path = str(tmp_path / 'controlnet.safetensors')
    save_file({k: v.detach() for k, v in net.state_dict().items()}, path)
    tr.load_controlnet(path)
    calls = []
    tr.pipe.controlnet.register_forward_pre_hook(
        lambda m, args: calls.append(args[0].shape[0]))
    monkeypatch.setattr(tserver, '_runner', tr)
    out = _post(base + '/api/generate', {
        'prompt': 'x', 'steps': 2, 'height': 64, 'width': 64, 'seed': 4,
        'samples': 1, 'control_image': _png_b64((40, 40), seed=6),
        'controlnet_scale': 0.5})
    assert len(out['images']) == 1
    assert _image(out['images'][0]).size == (64, 64)
    assert calls == [2, 2, 2]


def test_launch_keeps_the_runner_lazy(monkeypatch):
    """``launch`` builds nothing; the factory runs at the first request."""
    monkeypatch.setattr(tserver, '_runner', None)
    monkeypatch.setattr(tserver, '_runner_factory', None)
    calls = []
    httpd = tserver.launch(lambda: calls.append(1), port=0)
    try:
        assert calls == [] and tserver._runner_factory is not None
    finally:
        httpd.server_close()
