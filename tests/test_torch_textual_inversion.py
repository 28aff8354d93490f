"""PyTorch port: textual-inversion training
(``flexdiffuse_tpu_torch/training/textual_inversion.py``) held against the
JAX package on the CPU.

Both packages get the same tiny models (TINY_TEXT at hidden size 32,
TINY_UNET, TINY_VAE; JAX init, converted with ``params_to_state_dict``),
the same FakeTokenizer ids and, for the step, the timesteps and noise JAX
draws from its key. All fp32. Tolerances: the loss 1e-5; the row gradient
1e-4 of its max|g|; the rows after one AdamW step 1e-5; embeddings read
back from a file 1e-6.
"""
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import training as jt
from flexdiffuse_tpu.models import TINY_TEXT as J_TINY_TEXT
from flexdiffuse_tpu.models import TINY_UNET as J_TINY_UNET
from flexdiffuse_tpu.models import TINY_VAE as J_TINY_VAE
from flexdiffuse_tpu.models import (AutoencoderKL, CLIPTextModel,
                                    UNet2DCondition)
from flexdiffuse_tpu.text.tokenizer import FakeTokenizer as JFakeTokenizer
from flexdiffuse_tpu.weights import load as jload
from flexdiffuse_tpu.weights import textual_inversion as jti
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.training import textual_inversion as tti
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_cli import (assert_ti_calls_agree, no_models,  # noqa
                                  ti_calls)

J_TEXT = dataclasses.replace(J_TINY_TEXT, hidden_size=32)
T_TEXT = dataclasses.replace(tm.TINY_TEXT, hidden_size=32)
VOCAB = J_TEXT.vocab_size
PLACEHOLDER = '<cat-toy>'


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope='module')
def jax_models():
    text, unet, vae = (CLIPTextModel(J_TEXT), UNet2DCondition(J_TINY_UNET),
                       AutoencoderKL(J_TINY_VAE))
    k = jax.random.PRNGKey(0)
    tp = text.init(k, jnp.zeros((1, 77), jnp.int32))
    up = unet.init(k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                   jnp.zeros((1, 77, 32)))
    vp = vae.init(k, jnp.zeros((1, 16, 16, 3)), k)
    return text, _np(tp), unet, _np(up), vae, _np(vp)


def port_models(jm):
    """The port's text tower, UNet and VAE with the JAX models' weights."""
    _, tp, _, up, _, vp = jm
    out = []
    for cls, cfg, tree in ((tm.CLIPTextModel, T_TEXT, tp),
                           (tm.UNet2DCondition, tm.TINY_UNET, up),
                           (tm.AutoencoderKL, tm.TINY_VAE, vp)):
        m = cls(cfg)
        m.load_state_dict(params_to_state_dict(tree, cfg), strict=True)
        out.append(m.eval())
    return out


def _images(tmp_path, n=3):
    paths = []
    for i in range(n):
        p = str(tmp_path / f'concept_{i}.png')
        arr = np.random.default_rng(i).uniform(0, 255, (48, 48, 3))
        Image.fromarray(arr.astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def test_init_rows_and_template_ids_match_jax(jax_models):
    """``init_rows`` with an initializer token copies its row as JAX's
    does; a multi-token initializer raises in both packages; without one
    the rows are 0.01·N(0,1) of the right shape. ``template_ids`` equals
    JAX's for both template sets."""
    _, tp, *_ = jax_models
    text, _, _ = port_models(jax_models)
    want = jt.textual_inversion.init_rows(tp, JFakeTokenizer(VOCAB), 'toy',
                                          3, jax.random.PRNGKey(0))
    got = tti.init_rows(text, FakeTokenizer(VOCAB), 'toy', 3)
    assert got.dtype == torch.float32 and got.shape == (3, 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match='single token'):
        jt.textual_inversion.init_rows(tp, JFakeTokenizer(VOCAB), 'two toys',
                                       1, jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match='single token'):
        tti.init_rows(text, FakeTokenizer(VOCAB), 'two toys', 1)
    rand = tti.init_rows(text, FakeTokenizer(VOCAB), None, 2,
                         torch.Generator().manual_seed(0))
    assert rand.shape == (2, 32) and 0 < rand.abs().max() < 0.1
    assert tt.OBJECT_TEMPLATES == jt.OBJECT_TEMPLATES
    assert tt.STYLE_TEMPLATES == jt.STYLE_TEMPLATES
    for templates in (tt.OBJECT_TEMPLATES, tt.STYLE_TEMPLATES):
        jtok, ttok = JFakeTokenizer(VOCAB), FakeTokenizer(VOCAB)
        jtok.add_tokens(PLACEHOLDER, num_vectors=2)
        ttok.add_tokens(PLACEHOLDER, num_vectors=2)
        want = jt.textual_inversion.template_ids(jtok, PLACEHOLDER,
                                                 templates)
        got = tti.template_ids(ttok, PLACEHOLDER, templates)
        assert got.shape == (len(templates), 77)
        np.testing.assert_array_equal(got, want)
        assert (got == VOCAB).sum() == len(templates)


def _patch(tp, rows, row_start):
    """JAX's ``_patch``: the rows into a copy of the table."""
    root = tp['params']
    emb = jnp.asarray(root['token_embedding']['embedding'])
    table = jax.lax.dynamic_update_slice(emb, rows, (row_start, 0))
    return {'params': dict(root, token_embedding=dict(
        root['token_embedding'], embedding=table))}


@pytest.mark.parametrize('n', [1, 2])
def test_ti_step_matches_jax(jax_models, n):
    """One TI step at ``row_start`` = the table size: the loss, the row
    gradient and the rows after the update match JAX's step; the frozen
    table, the text tower and the UNet are bit-unchanged and hold no
    gradient."""
    text_j, tp, unet_j, up, _, _ = jax_models
    rng = np.random.default_rng(n)
    jtok, ttok = JFakeTokenizer(VOCAB), FakeTokenizer(VOCAB)
    jtok.add_tokens(PLACEHOLDER, num_vectors=n)
    ttok.add_tokens(PLACEHOLDER, num_vectors=n)
    rows0 = (0.01 * rng.normal(size=(n, 32))).astype(np.float32)
    root = dict(tp['params'])
    root['token_embedding'] = dict(root['token_embedding'], embedding=(
        np.concatenate([root['token_embedding']['embedding'], rows0])))
    tp2 = {'params': root}
    text2 = CLIPTextModel(dataclasses.replace(J_TEXT, vocab_size=VOCAB + n))
    ids = np.asarray(jtok([f'a photo of {PLACEHOLDER}',
                           f'a rendering of a {PLACEHOLDER}']))
    np.testing.assert_array_equal(ids, ttok([f'a photo of {PLACEHOLDER}',
                                             f'a rendering of a '
                                             f'{PLACEHOLDER}']))
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    key = jax.random.PRNGKey(1)
    jcfg = jt.TrainConfig(learning_rate=5e-4, weight_decay=0.0,
                          donate=False)
    acp = jt.train._schedule_tables(jcfg)

    def loss_fn(r):
        ctx = text2.apply(_patch(tp2, r, VOCAB), jnp.asarray(ids))
        return jt.diffusion_loss(
            lambda _p, noisy, t, c: unet_j.apply(up, noisy, t, c), None,
            jnp.asarray(lat), ctx, key, acp, jcfg)

    want_loss, want_grad = jax.jit(jax.value_and_grad(loss_fn))(
        jnp.asarray(rows0))
    step, tx = jt.make_ti_train_step(text2, tp2, unet_j, up, jcfg, VOCAB)
    want_rows, _, loss2 = step(jnp.asarray(rows0), tx.init(
        jnp.asarray(rows0)), jnp.asarray(lat), jnp.asarray(ids), key)
    assert float(loss2) == pytest.approx(float(want_loss), abs=1e-6)
    k_t, k_n = jax.random.split(key)      # diffusion_loss's own draws
    t = torch.from_numpy(np.array(jax.random.randint(k_t, (2,), 0, 1000)))
    noise = torch.from_numpy(np.array(jax.random.normal(k_n, lat.shape,
                                                        jnp.float32)))

    text, unet, _ = port_models(jax_models)
    grown = tti.grow_text_model(text, torch.from_numpy(rows0))
    assert grown.config.vocab_size == VOCAB + n
    before = {name: {k: v.clone() for k, v in m.state_dict().items()}
              for name, m in (('text', text), ('grown', grown),
                              ('unet', unet))}
    rows = torch.from_numpy(rows0.copy()).requires_grad_()
    grads = []
    rows.register_hook(lambda g: grads.append(g.clone()))
    tstep = tt.make_ti_train_step(grown, unet, tt.TrainConfig(
        learning_rate=5e-4, weight_decay=0.0), VOCAB)
    loss = tstep(rows, torch.from_numpy(ids), torch.from_numpy(lat), t=t,
                 noise=noise)
    assert abs(loss.item() - float(want_loss)) <= 1e-5
    want_g = np.asarray(want_grad)
    assert np.abs(grads[0].numpy() - want_g).max() <= \
        1e-4 * np.abs(want_g).max()
    np.testing.assert_allclose(rows.detach().numpy(), np.asarray(want_rows),
                               rtol=0, atol=1e-5)
    assert not np.array_equal(rows.detach().numpy(), rows0)
    for name, m in (('text', text), ('grown', grown), ('unet', unet)):
        for k, v in m.state_dict().items():
            assert torch.equal(v, before[name][k]), (name, k)
        assert all(p.grad is None for p in m.parameters()), name
    assert not any(p.requires_grad for m in (grown, unet)
                   for p in m.parameters())
    with pytest.raises(ValueError, match='first call'):
        tstep(rows.clone(), torch.from_numpy(ids), torch.from_numpy(lat))


def test_grown_table_is_fresh_each_step(jax_models):
    """The patched table is a new tensor: the live rows at ``row_start``,
    every other row the frozen table's, the stored weight untouched."""
    text, unet, _ = port_models(jax_models)
    grown = tti.grow_text_model(text, torch.zeros((2, 32)))
    step = tt.make_ti_train_step(grown, unet, tt.TrainConfig(), VOCAB)
    rows = torch.ones((2, 32))
    table = step.table(rows)
    weight = grown.text_model.embeddings.token_embedding.weight
    assert table.data_ptr() != weight.data_ptr()
    assert torch.equal(table[:VOCAB], weight[:VOCAB])
    assert torch.equal(table[VOCAB:], rows)
    assert not weight[VOCAB:].any()
    assert torch.equal(text.text_model.embeddings.token_embedding.weight,
                       weight[:VOCAB])


def _rows_of(table_owner) -> np.ndarray:
    return table_owner.text_model.embeddings.token_embedding.weight.detach(
    ).numpy()


def _runner(text, unet, vae):
    vision = tm.CLIPVisionModel(tm.TINY_VISION).eval()
    return Runner.from_models(text, vision, unet, vae, FakeTokenizer(VOCAB))


def test_train_textual_inversion_end_to_end_and_reload(jax_models, tmp_path):
    """Six steps, two vectors: the file holds the returned rows under the
    placeholder; the JAX package's ``extract_embedding`` and
    ``add_textual_inversion`` read it back, and the port's
    ``Runner.load_textual_inversion`` appends the same rows at the ids the
    tokenizer hands out."""
    text, unet, vae = port_models(jax_models)
    tok = FakeTokenizer(VOCAB)
    out = str(tmp_path / 'concept.safetensors')
    before = {k: v.clone() for k, v in text.state_dict().items()}
    rows, losses = tt.train_textual_inversion(
        text, tok, unet, vae, _images(tmp_path), '<my-concept>',
        num_vectors=2, steps=6, batch_size=2, resolution=16, seed=0,
        save_path=out, log_every=2,
        cfg=tt.TrainConfig(learning_rate=5e-3, weight_decay=0.0))
    assert rows.shape == (2, 32) and rows.dtype == np.float32
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert tok.added_tokens == {'<my-concept>': [VOCAB, VOCAB + 1]}
    for k, v in text.state_dict().items():   # the caller's tower as it was
        assert torch.equal(v, before[k]), k

    token, table = jti.extract_embedding(jload.load_state_dict(out), None)
    assert token == '<my-concept>'
    np.testing.assert_allclose(table, rows, rtol=0, atol=1e-6)
    _, tp, *_ = jax_models
    new_tp = jti.add_textual_inversion(JFakeTokenizer(VOCAB), tp, token,
                                       table)
    emb = np.asarray(new_tp['params']['token_embedding']['embedding'])
    assert emb.shape[0] == VOCAB + 2
    np.testing.assert_allclose(emb[-2:], rows, rtol=0, atol=1e-6)

    runner = _runner(text, unet, vae)
    runner.load_textual_inversion(out)
    loaded = runner.encoder.text_model
    assert loaded.config.vocab_size == VOCAB + 2
    np.testing.assert_allclose(_rows_of(loaded)[-2:], rows, rtol=0,
                               atol=1e-6)
    assert runner.encoder.tokenizer.encode('a <my-concept>')[-2:] == [
        VOCAB, VOCAB + 1]


def test_jax_trained_embedding_loads_into_the_port(jax_models, tmp_path):
    """An embedding the JAX package trains loads through the port's
    ``Runner.load_textual_inversion`` to the same rows."""
    text_j, tp, unet_j, up, vae_j, vp = jax_models
    out = str(tmp_path / 'jax_concept.safetensors')
    rows, losses = jt.train_textual_inversion(
        text_j, tp, JFakeTokenizer(VOCAB), unet_j, up, vae_j, vp,
        _images(tmp_path), '<jax-concept>', num_vectors=2, steps=6,
        batch_size=2, resolution=16, key=jax.random.PRNGKey(0),
        save_path=out, log_every=2,
        cfg=jt.TrainConfig(learning_rate=5e-3, weight_decay=0.0))
    assert all(np.isfinite(losses))
    runner = _runner(*port_models(jax_models))
    runner.load_textual_inversion(out)
    np.testing.assert_allclose(_rows_of(runner.encoder.text_model)[-2:],
                               rows, rtol=0, atol=1e-6)
    assert '<jax-concept>' in runner.encoder.tokenizer.added_tokens


def test_cli_textual_inversion_reaches_the_trainer_as_in_jax(
        no_models, monkeypatch, tmp_path):  # noqa: F811
    """``train --textual-inversion '<x>' --init-token t --num-vectors 2
    --style-templates`` hands ``train_textual_inversion`` what the JAX CLI
    hands its own."""
    seen = ti_calls(monkeypatch, tmp_path, [
        'train', '--data', 'DATA', '--textual-inversion', '<x>',
        '--init-token', 't', '--num-vectors', '2', '--style-templates',
        '--steps', '7', '--seed', '3', '--out', 'e.safetensors'])
    assert_ti_calls_agree(seen)
    got = seen['port']
    assert (got['placeholder'], got['initializer_token'],
            got['num_vectors'], got['steps'], got['seed'],
            got['save_path']) == ('<x>', 't', 2, 7, 3, 'e.safetensors')
    assert got['templates'] == tt.STYLE_TEMPLATES


def test_cli_trains_an_embedding_end_to_end(jax_models, tmp_path,
                                            monkeypatch):
    """``train --textual-inversion`` on the CPU with the tiny models in
    place of the snapshot's writes an embedding the Runner loads."""
    from flexdiffuse_tpu_torch import cli as tcli
    text, unet, vae = port_models(jax_models)
    data = tmp_path / 'data'
    data.mkdir()
    for i, p in enumerate(_images(tmp_path, 2)):
        os.replace(p, data / f'{i}.png')
    encoder = types.SimpleNamespace(text_model=text,
                                    tokenizer=FakeTokenizer(VOCAB))
    monkeypatch.setattr(tcli, '_train_models',
                        lambda args, device: (encoder, unet, vae))
    out = tmp_path / 'embedding.safetensors'
    assert tcli.main(['train', '--data', str(data), '--device', 'cpu',
                      '--textual-inversion', '<y>', '--num-vectors', '2',
                      '--steps', '2', '--batch-size', '1', '--resolution',
                      '16', '--out', str(out)]) == 0
    runner = _runner(text, unet, vae)
    runner.load_textual_inversion(str(out))
    assert runner.encoder.text_model.config.vocab_size == VOCAB + 2
