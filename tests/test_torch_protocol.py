"""PyTorch port: the seeded experiment-protocol golden
(``tests/test_protocol_golden.py``) through the port's Runner, and the
Runner's phase timer.

The README protocol (seed 1337, strength 0.6, 30 PNDM steps, CFG 8,
threshold 0.25/0.75, clustered 0.25, linear 0.0–0.5, max guidance 0.35,
header 0, best fit, reuse, text guide) runs through
``Runner.from_models`` built from the JAX golden's tiny models (their
weights carried across by ``weights/bridge.py``), fp32 on the CPU. A torch
generator cannot draw JAX's numbers, so the pipeline's initial noise is
JAX's key chain replayed: ``PRNGKey(seed)``, one ``split`` per batch, then
the pipeline's ``split(key, 4)`` and its ``k_noise``. The image must be
within one uint8 level of ``tests/goldens/protocol_t2i.npy`` at every
pixel.

This module also builds the JAX/port runner pair on those weights that
``tests/test_torch_serving.py`` and ``tests/test_torch_ui.py`` reuse.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu.config import RunConfig as JRunConfig
from flexdiffuse_tpu.models import (TINY_TEXT, TINY_UNET, TINY_VAE,
                                    TINY_VISION, AutoencoderKL,
                                    CLIPTextModel, CLIPVisionModel,
                                    UNet2DCondition)
from flexdiffuse_tpu.runner import Runner as JRunner
from flexdiffuse_tpu.text.tokenizer import FakeTokenizer as JFakeTokenizer
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.utils.profiling import PhaseTimer, trace
from flexdiffuse_tpu_torch.weights import bridge
from tests.test_torch_attention import one_torch_thread  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), 'goldens',
                      'protocol_t2i.npy')
PROTOCOL = dict(prompt='Deer colorful, fantasy, intricate, highly detailed',
                guide='colorful fantasy painting',
                guide_threshold_mult=0.25, guide_threshold_floor=0.75,
                guide_clustered=0.25, guide_linear=(0.0, 0.5),
                guide_max_guidance=0.35, guide_header_max=0.0,
                guide_mode=1, guide_reuse=True,
                strength=0.6, steps=30, guidance_scale=8,
                samples=1, seed=1337, init_size=(64, 64), save=False)


def jax_tiny_params():
    """The golden's tiny models and params (``test_protocol_golden.py``'s
    construction: every init from ``PRNGKey(0)``), as numpy trees."""
    k = jax.random.PRNGKey(0)
    text, vision = CLIPTextModel(TINY_TEXT), CLIPVisionModel(TINY_VISION)
    unet, vae = UNet2DCondition(TINY_UNET), AutoencoderKL(TINY_VAE)
    inits = dict(
        text=lambda k: text.init(k, jnp.zeros((1, 77), jnp.int32)),
        vision=lambda k: vision.init(k, jnp.zeros((1, 32, 32, 3))),
        unet=lambda k: unet.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                                 jnp.zeros((1, 77, TINY_TEXT.hidden_size))),
        vae=lambda k: vae.init(k, jnp.zeros((1, 16, 16, 3)), k))
    # One compiled init per model (eager init dispatches op by op).
    params = {n: jax.jit(f)(k) for n, f in inits.items()}
    params = {n: jax.tree.map(np.asarray, p) for n, p in params.items()}
    return dict(text=text, vision=vision, unet=unet, vae=vae), params


def runner_pair(out_dir: str, scheduler: str = 'pndm'):
    """(JAX Runner, port Runner) on the golden's weights, fp32, the port's
    on the CPU, both writing under ``out_dir``."""
    mods, params = jax_tiny_params()
    jr = JRunner.from_models(mods['text'], params['text'], mods['vision'],
                             params['vision'], mods['unet'], params['unet'],
                             mods['vae'], params['vae'], JFakeTokenizer(),
                             scheduler=scheduler,
                             config=JRunConfig(output_dir=out_dir))
    port = {}
    for name, cls, cfg in (('text', tm.CLIPTextModel, tm.TINY_TEXT),
                           ('vision', tm.CLIPVisionModel, tm.TINY_VISION),
                           ('unet', tm.UNet2DCondition, tm.TINY_UNET),
                           ('vae', tm.AutoencoderKL, tm.TINY_VAE)):
        module = cls(cfg).eval()
        module.load_state_dict(bridge.params_to_state_dict(params[name], cfg),
                               strict=True)
        port[name] = module.requires_grad_(False)
    tr = Runner.from_models(port['text'], port['vision'], port['unet'],
                            port['vae'], FakeTokenizer(),
                            scheduler=scheduler,
                            config=RunConfig(output_dir=out_dir))
    return jr, tr


class ReplayNoise:
    """Stands in for a port pipeline: each call gets the initial noise JAX's
    Runner draws for that batch (``_next_key``: ``key, sub = split(key)``;
    the pipeline: ``_, _, k_noise, _ = split(sub, 4)``)."""

    def __init__(self, pipe, seed: int) -> None:
        self._pipe = pipe
        self._key = jax.random.PRNGKey(seed)

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def __call__(self, guide, **kw):
        self._key, sub = jax.random.split(self._key)
        k_noise = jax.random.split(sub, 4)[2]
        f = self._pipe.vae_scale
        h, w = kw['init_size']
        shape = (guide.batch_size, h // f, w // f,
                 self._pipe.latent_channels)
        kw['noise'] = torch.from_numpy(np.array(
            jax.random.normal(k_noise, shape, jnp.float32)))
        return self._pipe(guide, **kw)


@pytest.fixture(scope='module')
def runners(tmp_path_factory):
    return runner_pair(str(tmp_path_factory.mktemp('protocol')))


def test_protocol_golden(runners):
    """Within one uint8 level of the JAX golden at every pixel (fp32,
    CPU)."""
    _, tr = runners
    real = tr.pipe
    tr.pipe = ReplayNoise(real, PROTOCOL['seed'])
    try:
        imgs, grid = tr.gen(**PROTOCOL)
    finally:
        tr.pipe = real
    got = np.asarray(imgs[0], np.int16)
    ref = np.load(GOLDEN).astype(np.int16)
    assert got.shape == ref.shape == (64, 64, 3)
    assert np.abs(got - ref).max() <= 1, np.abs(got - ref).max()


def test_jax_runner_still_hits_the_golden(runners):
    """The JAX Runner on the same weights draws the golden bit for bit:
    the port's comparison stands on the reference as it is."""
    jr, _ = runners
    imgs, _ = jr.gen(**PROTOCOL)
    np.testing.assert_array_equal(np.asarray(imgs[0], np.uint8),
                                  np.load(GOLDEN))


def test_runner_timer_phases(runners):
    """``gen`` adds one 'embeds' and one 'generate' phase per call, as the
    JAX Runner's timer."""
    jr, tr = runners
    tr.timer.reset()
    jr.timer.reset()
    kw = dict(PROTOCOL, steps=2)
    for runner in (jr, tr):
        runner.gen(**kw)
        runner.gen(**dict(kw, long_prompt=True))
    got, want = tr.timer.summary(), jr.timer.summary()
    assert sorted(got) == sorted(want) == ['embeds', 'generate']
    for name in got:
        assert got[name]['count'] == want[name]['count'] == 2
        assert got[name]['total_s'] > 0
        assert got[name]['mean_s'] == pytest.approx(got[name]['total_s'] / 2)


def test_phase_timer_accumulates_and_resets():
    timer = PhaseTimer()
    for _ in range(3):
        with timer.phase('a'):
            pass
    with pytest.raises(ValueError):
        with timer.phase('b'):
            raise ValueError('inside')
    s = timer.summary()
    assert s['a']['count'] == 3 and s['b']['count'] == 1
    timer.reset()
    assert timer.summary() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(None):
        pass
    assert not os.listdir(tmp_path)
    with trace(str(tmp_path / 'prof')):
        torch.ones(4) @ torch.ones(4)
    path = tmp_path / 'prof' / 'trace.json'
    assert path.exists() and path.stat().st_size > 0


@pytest.mark.parametrize('prompt,scale', [('a deer', 7.5),
                                          (['a deer', 'a fox'], 1.0)])
def test_prompt_guidance_matches_jax(runners, prompt, scale):
    """``prompt_guidance(encoder, prompt, guidance_scale)`` (JAX
    ``pipeline/guides.py:326-332``): equal ``SimpleGuidance`` fields for the
    same prompt and scale: the embeddings and the empty prompt's within
    1e-5, the scale, and CFG on only above 1."""
    from flexdiffuse_tpu.pipeline import prompt_guidance as jax_prompt_guidance
    from flexdiffuse_tpu_torch.pipeline import (SimpleGuidance,
                                                prompt_guidance)
    jr, tr = runners
    want = jax_prompt_guidance(jr.encoder, prompt, scale)
    got = prompt_guidance(tr.encoder, prompt, scale)
    assert isinstance(got, SimpleGuidance)
    for name in ('embeddings', 'uncond'):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-5)
    assert got.guidance_scale == float(want.guidance_scale) == scale
    assert got.cfg == want.cfg == (scale > 1.0)
