"""PyTorch port: host-side prompt text, held against the JAX package on the
CPU.

* The tokenizer through the port's native BPE (built with g++ into
  ``flexdiffuse_tpu_torch/_build/``), through its Python loop and with
  ``FLEXDIFFUSE_NATIVE=0`` gives the JAX tokenizer's ids on the prompts and
  the fuzz of ``tests/test_native_bpe.py``.
* ``parse``/``tokenize_weighted`` equal JAX's on every case of
  ``tests/test_emphasis.py`` and a few more.
* ``CLIPEncoder.prompt_chunked``/``prompt_weighted`` (weights, ``BREAK``,
  beyond ``max_chunks``) and ``clip_skip=1`` against the JAX encoder on the
  same tiny tower: fp32, within 1e-5 of the output's max.
* The contexts ``gen(long_prompt=True)`` and ``gen(weighted=True)`` hand the
  pipeline, cond and uncond, against the JAX Runner's (same bound), and one
  pipeline run of each by ``_compare``'s rule.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu.config import RunConfig as JRunConfig
from flexdiffuse_tpu.encode import CLIPEncoder as JEncoder
from flexdiffuse_tpu.models import (TINY_TEXT, TINY_UNET, TINY_VAE,
                                    TINY_VISION, AutoencoderKL,
                                    CLIPTextModel, CLIPVisionModel,
                                    UNet2DCondition)
from flexdiffuse_tpu.runner import Runner as JRunner
from flexdiffuse_tpu.text import emphasis as jemph
from flexdiffuse_tpu.text import tokenizer as jtok
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import native
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.encode import CLIPEncoder
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text import emphasis as temph
from flexdiffuse_tpu_torch.text import tokenizer as ttok
from flexdiffuse_tpu_torch.weights import bridge
from tests.test_native_bpe import MERGES, PROMPTS, _write_vocab
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_loading import run_both


@pytest.fixture()
def vocab(tmp_path):
    return _write_vocab(tmp_path, MERGES)


@pytest.fixture()
def toks(vocab):
    """(port native, port Python, JAX) tokenizers on one vocabulary."""
    native_tok = ttok.CLIPTokenizer(*vocab)
    assert native_tok._native is not None, 'the native BPE did not build'
    python_tok = ttok.CLIPTokenizer(*vocab)
    python_tok._native = None
    return native_tok, python_tok, jtok.CLIPTokenizer(*vocab)


@pytest.mark.parametrize('prompt', PROMPTS)
def test_tokenizer_ids_match_jax(toks, prompt):
    native_tok, python_tok, jax_tok = toks
    want = jax_tok.encode(prompt)
    assert native_tok.encode(prompt) == want
    assert python_tok.encode(prompt) == want
    np.testing.assert_array_equal(native_tok([prompt, 'a cat']),
                                  jax_tok([prompt, 'a cat']))


def test_tokenizer_fuzz_matches_jax(toks):
    native_tok, python_tok, jax_tok = toks
    rng = random.Random(0)
    alphabet = 'abcdefot hrs,.!éø語'
    for _ in range(200):
        p = ''.join(rng.choice(alphabet) for _ in range(rng.randrange(1, 60)))
        want = jax_tok.encode(p)
        assert native_tok.encode(p) == want, repr(p)
        assert python_tok.encode(p) == want, repr(p)


def test_native_build_lands_in_the_build_dir(toks):
    so = native.library_path('clip_bpe')
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.name == '_build'


def test_added_tokens_with_native_bpe(toks):
    native_tok, _, jax_tok = toks
    ids = native_tok.add_tokens('<my-concept>', num_vectors=2)
    assert jax_tok.add_tokens('<my-concept>', num_vectors=2) == ids
    p = 'a cat <my-concept> sat'
    assert native_tok.encode(p) == jax_tok.encode(p)
    assert all(i in native_tok.encode(p) for i in ids)


def test_kill_switch(vocab, monkeypatch):
    monkeypatch.setenv('FLEXDIFFUSE_NATIVE', '0')
    tok = ttok.CLIPTokenizer(*vocab)
    assert tok._native is None
    want = jtok.CLIPTokenizer(*vocab)
    for p in PROMPTS:
        assert tok.encode(p) == want.encode(p)


# Every input of tests/test_emphasis.py, then a few more.
EMPHASIS = ['a photo of a cat', '(cat)', '((cat))', '[cat]', '(cat:1.3)',
            '(cat:0.5)', 'a (cat:2) dog', '(a (b:2):3)', r'\(literal\)',
            r'50\\50', 'cat)', 'cat]', 'a (cat dog', 'ratio 16:9',
            'a cat BREAK a dog', 'unBREAKable', 'a (cat) (dog)',
            'plain stays whole', '[[x]] (y:1.5) BREAK z', '(a:abc)',
            ':1.3) stray', 'x BREAK BREAK y', '[unclosed (nested', '']


@pytest.mark.parametrize('text', EMPHASIS)
def test_emphasis_matches_jax(text):
    assert temph.parse(text) == jemph.parse(text)
    assert temph.ATTENTION_MULT == jemph.ATTENTION_MULT
    ttk, jtk = ttok.FakeTokenizer(), jtok.FakeTokenizer()
    assert (temph.tokenize_weighted(ttk, text) ==
            jemph.tokenize_weighted(jtk, text))


# --- the encoder ---------------------------------------------------------

@pytest.fixture(scope='module')
def towers():
    k = jax.random.PRNGKey(0)
    text, vision = CLIPTextModel(TINY_TEXT), CLIPVisionModel(TINY_VISION)
    tp = jax.tree.map(np.asarray,
                      text.init(k, jnp.zeros((1, 77), jnp.int32)))
    vp = jax.tree.map(np.asarray,
                      vision.init(k, jnp.zeros((1, 32, 32, 3))))
    ttext = tm.CLIPTextModel(tm.TINY_TEXT).eval()
    ttext.load_state_dict(bridge.params_to_state_dict(tp, tm.TINY_TEXT))
    tvision = tm.CLIPVisionModel(tm.TINY_VISION).eval()
    tvision.load_state_dict(bridge.params_to_state_dict(vp, tm.TINY_VISION))
    return text, tp, vision, vp, ttext, tvision


def _encoders(towers, clip_skip):
    text, tp, vision, vp, ttext, tvision = towers
    return (JEncoder(text, tp, vision, vp, jtok.FakeTokenizer(),
                     clip_skip=clip_skip),
            CLIPEncoder(ttext, tvision, ttok.FakeTokenizer(),
                        clip_skip=clip_skip))


def _words(n, seed=0):
    rng = random.Random(seed)
    return ' '.join(rng.choice(['red', 'fox', 'castle', 'misty', 'hills',
                                'sunset', 'oil', 'painting', 'detailed'])
                    for _ in range(n))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


ENCODINGS = {
    'prompt': ('prompt', 'a red fox', {}),
    'chunked_short': ('prompt_chunked', 'a red fox', {}),
    'chunked_two_windows': ('prompt_chunked', _words(100), {}),
    'chunked_beyond_max_chunks': ('prompt_chunked', _words(250, 1),
                                  {'max_chunks': 2}),
    'weighted_short': ('prompt_weighted', 'a (red:1.5) fox [castle]', {}),
    'weighted_plain': ('prompt_weighted', 'a red fox', {}),
    'weighted_break': ('prompt_weighted',
                       '(misty hills:1.3) BREAK ((oil)) painting', {}),
    'weighted_long': ('prompt_weighted',
                      f'({_words(60, 2)}:1.2) [{_words(60, 3)}]', {}),
    'weighted_beyond_max_chunks': ('prompt_weighted',
                                   f'({_words(200, 4)}:0.8)',
                                   {'max_chunks': 2}),
}


@pytest.mark.parametrize('clip_skip', [0, 1])
@pytest.mark.parametrize('case', sorted(ENCODINGS))
def test_encoder_matches_jax(towers, case, clip_skip):
    method, prompt, kw = ENCODINGS[case]
    jenc, tenc = _encoders(towers, clip_skip)
    _close(getattr(tenc, method)(prompt, **kw),
           getattr(jenc, method)(prompt, **kw))


def test_clip_skip_changes_the_context_and_refuses_two(towers):
    _, plain = _encoders(towers, 0)
    _, skip = _encoders(towers, 1)
    assert (plain.prompt('a fox') - skip.prompt('a fox')).abs().max() > 1e-4
    with pytest.raises(ValueError):
        CLIPEncoder(plain.text_model, plain.vision_model, plain.tokenizer,
                    clip_skip=2)
    with pytest.raises(ValueError):
        plain.text_model(torch.zeros((1, 77), dtype=torch.long),
                         output='penultimate_and_pooled')


# --- the Runner ----------------------------------------------------------

@pytest.fixture(scope='module')
def runners(towers, tmp_path_factory):
    text, tp, vision, vp, ttext, tvision = towers
    k = jax.random.PRNGKey(1)
    unet = UNet2DCondition(TINY_UNET)
    up = jax.tree.map(np.asarray, unet.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32))))
    vae = AutoencoderKL(TINY_VAE)
    vaep = jax.tree.map(np.asarray, vae.init(k, jnp.zeros((1, 16, 16, 3)),
                                             k))
    tunet = tm.UNet2DCondition(tm.TINY_UNET).eval()
    tunet.load_state_dict(bridge.params_to_state_dict(up, tm.TINY_UNET))
    tvae = tm.AutoencoderKL(tm.TINY_VAE).eval()
    tvae.load_state_dict(bridge.params_to_state_dict(vaep, tm.TINY_VAE))
    out = str(tmp_path_factory.mktemp('out'))
    jr = JRunner.from_models(text, tp, vision, vp, unet, up, vae, vaep,
                             jtok.FakeTokenizer(),
                             config=JRunConfig(output_dir=out))
    tr = Runner.from_models(ttext, tvision, tunet, tvae,
                            ttok.FakeTokenizer(),
                            config=RunConfig(output_dir=out))
    return jr, tr


GEN = {
    'long_prompt': dict(long_prompt=True, prompt=_words(120, 5),
                        negative_prompt='blurry'),
    'long_prompt_long_negative': dict(long_prompt=True, prompt=_words(90, 6),
                                      negative_prompt=_words(200, 7)),
    'long_prompt_with_guide': dict(long_prompt=True, prompt=_words(100, 8),
                                   guide='a misty castle'),
    'weighted': dict(weighted=True, prompt='a (red:1.4) fox, [hills]',
                     negative_prompt='(blurry:1.2)'),
    'weighted_break_long': dict(weighted=True,
                                prompt=f'({_words(80, 9)}:1.1) BREAK sunset',
                                negative_prompt=''),
}


@pytest.mark.parametrize('case', sorted(GEN))
def test_gen_contexts_match_jax(runners, case):
    jr, tr = runners
    jg, tg = run_both(jr, tr, **GEN[case])
    _close(tg.embeddings, jg.embeddings)
    _close(tg.uncond, jg.uncond)
    assert tg.embeddings.shape[1] % 77 == 0
    assert tg.uncond.shape == tg.embeddings.shape


def test_gen_windowed_takes_a_single_prompt(runners):
    _, tr = runners
    with pytest.raises(ValueError, match='single prompt'):
        tr.gen(prompt=['a', 'b'], long_prompt=True, save=False)
    images, _ = tr.gen(prompt=_words(100), weighted=True, steps=2,
                       init_size=(16, 16), seed=2, save=False)
    assert np.asarray(images[0]).shape == (16, 16, 3)
