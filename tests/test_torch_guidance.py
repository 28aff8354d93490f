"""PyTorch port: the guidance math (similarity mapping, weight curves,
tween, concept mapping, ``Guide.embeds``) held against the JAX package on
the CPU at CLIP's real widths — 77 text tokens, 257 image patches, 768
features — with seeded random inputs. Floats within max|Δ| ≤ 1e-5; mapping
indices equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu import guidance as jg
from flexdiffuse_tpu.config import GuidanceParams as JParams
from flexdiffuse_tpu_torch import guidance as tg
from flexdiffuse_tpu_torch.config import (GUIDE_ORDER_ALIGN,
                                          GUIDE_ORDER_DIRECT,
                                          GUIDE_ORDER_TEXT, GuidanceParams)
from tests.test_torch_attention import one_torch_thread  # noqa: F401

ATOL = 1e-5
T, A, D = 77, 257, 768


def _emb(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, ref, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(ref, np.float32), rtol=0,
                               atol=atol)


@pytest.fixture(scope='module')
def embs():
    txt = _emb(0, T, D)
    # Image patches partly aligned with prompt tokens, so matches are real.
    alt = _emb(1, A, D)
    alt[:40] += 2.0 * txt[np.arange(40) % T]
    return txt, alt


def test_similarity_matrix(embs):
    txt, alt = embs
    ref = jg.similarity_matrix(jnp.asarray(alt), jnp.asarray(txt))
    got = tg.similarity_matrix(torch.from_numpy(alt), torch.from_numpy(txt))
    assert got.shape == (A, T)
    _close(got, ref)


@pytest.mark.parametrize('reuse,mode', [
    (True, GUIDE_ORDER_TEXT), (True, GUIDE_ORDER_ALIGN),
    (False, GUIDE_ORDER_TEXT), (False, GUIDE_ORDER_ALIGN),
    (True, GUIDE_ORDER_DIRECT)])
def test_map_embeddings(embs, reuse, mode):
    txt, alt = embs
    ridx, rsim = jg.map_embeddings(jnp.asarray(alt), jnp.asarray(txt),
                                   reuse, mode)
    idx, sim = tg.map_embeddings(torch.from_numpy(alt),
                                 torch.from_numpy(txt), reuse, mode)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    _close(sim, rsim)


def test_map_embeddings_fewer_alts_than_tokens(embs):
    """Guide text (77 tokens) onto a prompt: greedy loops stop early."""
    txt, _ = embs
    alt = _emb(2, 20, D)
    for reuse, mode in [(False, GUIDE_ORDER_TEXT), (False, GUIDE_ORDER_ALIGN),
                        (True, GUIDE_ORDER_DIRECT)]:
        ridx, rsim = jg.map_embeddings(jnp.asarray(alt), jnp.asarray(txt),
                                       reuse, mode)
        idx, sim = tg.map_embeddings(torch.from_numpy(alt),
                                     torch.from_numpy(txt), reuse, mode)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
        _close(sim, rsim)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_clustered_threshold_and_blend_weights(seed):
    rng = np.random.default_rng(seed)
    sims = rng.uniform(0, 1, T).astype(np.float32)
    thr = float(sims.mean())
    rw, rpeaks = jg.clustered_weights(jnp.asarray(sims), jnp.float32(thr),
                                      0.7)
    w, peaks = tg.clustered_weights(torch.from_numpy(sims),
                                    torch.tensor(thr), 0.7)
    _close(w, rw)
    assert bool(peaks) == bool(rpeaks)
    _close(tg.threshold_weights(torch.from_numpy(sims), 0.6, 0.25),
           jg.threshold_weights(jnp.asarray(sims), 0.6, 0.25))
    a = rng.uniform(-0.5, 1, T).astype(np.float32)
    for b in (rng.uniform(0, 1, T), rng.uniform(-1, -0.1, T),
              rng.uniform(-1, 1, T)):
        b = b.astype(np.float32)
        for x, y in ((a, b), (b, a), (np.abs(a), b)):
            _close(tg.blend_weights(torch.from_numpy(x), torch.from_numpy(y)),
                   jg.blend_weights(jnp.asarray(x), jnp.asarray(y)))


PARAMS = [GuidanceParams(),
          GuidanceParams.ui_defaults(),
          GuidanceParams(reuse=False, mode=GUIDE_ORDER_TEXT, clustered=0.0,
                         header_max=1.0),
          GuidanceParams(reuse=False, mode=GUIDE_ORDER_ALIGN,
                         threshold_mult=-0.3, linear=(0.4, -0.2)),
          GuidanceParams(mode=GUIDE_ORDER_DIRECT, max_guidance=0.9)]


def _jparams(p):
    return JParams(**{f: getattr(p, f) for f in p.__dataclass_fields__})


@pytest.mark.parametrize('i', range(len(PARAMS)))
def test_tweener(embs, i):
    txt, alt = embs
    p = PARAMS[i]
    ref = jg.Tweener(_jparams(p)).tween(jnp.asarray(txt[None]),
                                        jnp.asarray(alt[None]))
    got = tg.Tweener(p).tween(torch.from_numpy(txt[None]),
                              torch.from_numpy(alt[None]))
    assert got.shape == (1, T, D)
    _close(got, ref)


def test_concept_mapper(embs):
    txt, alt = embs
    # Concept tokens near some prompt tokens, so hop 2 overwrites some.
    concepts = _emb(5, T, D) * 0.05 + txt[np.r_[0, 3:T + 2][:T] % T]
    ref = jg.ConceptMapper(jnp.asarray(alt[None]),
                           jnp.asarray(concepts[None])).map(
                               jnp.asarray(txt[None]))
    cm = tg.ConceptMapper(torch.from_numpy(alt[None]),
                          torch.from_numpy(concepts[None]))
    got = cm.map(torch.from_numpy(txt[None]))
    _close(got, ref)
    assert not np.allclose(got.numpy(), txt[None])  # some tokens replaced


class _NumpyEncoder:
    """Deterministic fake CLIP encoder shared by both packages: prompts and
    images hash to seeded random embeddings."""

    def __init__(self, to_array):
        self.to_array = to_array

    def prompt(self, prompt):
        prompts = [prompt] if isinstance(prompt, str) else prompt
        rows = [_emb(sum(map(ord, p)) + 10, T, D) for p in prompts]
        return self.to_array(np.stack(rows))

    def image(self, image):
        alt = _emb(7, A, D)
        alt[:30] += 2.0 * _emb(sum(map(ord, 'a deer')) + 10, T, D)[:30]
        return self.to_array(alt[None])


@pytest.mark.parametrize('case', ['text_guide', 'image_guide', 'pure_image',
                                  'batch_image_guide', 'concepts'])
def test_guide_embeds(case):
    kw = {
        'text_guide': dict(prompt='a deer', guide='colorful painting'),
        'image_guide': dict(prompt='a deer', guide='IMAGE'),
        'pure_image': dict(prompt='', guide='IMAGE'),
        'batch_image_guide': dict(prompt=['a deer', 'a bear'],
                                  guide='IMAGE'),
        'concepts': dict(prompt='a deer', guide='IMAGE',
                         mapping_concepts='deer forest'),
    }[case]
    if kw['guide'] == 'IMAGE':
        kw['guide'] = object()  # any non-str guide is an image to the fake
    ref = jg.Guide(_NumpyEncoder(jnp.asarray)).embeds(
        threshold_mult=0.25, clustered=0.15, **kw)
    got = tg.Guide(_NumpyEncoder(torch.from_numpy)).embeds(
        threshold_mult=0.25, clustered=0.15, **kw)
    assert tuple(got.shape) == tuple(ref.shape)
    _close(got, ref)
