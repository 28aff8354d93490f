"""PyTorch port: dataset loading and encoding, the training loops (LoRA,
full, DreamBooth) end to end, and checkpoint/resume, on tiny models on the
CPU. The folder helpers and the batch sampler are held against the JAX
package's; the exported adapter loads through the JAX package's kohya
loader."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import training as jt
from flexdiffuse_tpu.models import TINY_UNET, UNet2DCondition
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.weights import convert, params_to_state_dict
from flexdiffuse_tpu_torch.weights.load import load_unet_msgpack
from tests.test_torch_attention import one_torch_thread  # noqa: F401

T, D = 7, 32


def _write_images(d, n=3, captions=True):
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        arr = np.full((40, 56, 3), 40 * i + 10, np.uint8)  # non-square
        arr[::3, ::5] = 255 - arr[::3, ::5]
        Image.fromarray(arr).save(os.path.join(d, f'img_{i}.png'))
        if captions:
            with open(os.path.join(d, f'img_{i}.txt'), 'w') as f:
                f.write(f'a photo number {i}')


def test_find_items_and_load_pixels_match_jax(tmp_path):
    d = str(tmp_path / 'ds')
    _write_images(d, 3)
    with open(os.path.join(d, 'metadata.jsonl'), 'w') as f:
        f.write(json.dumps({'file_name': 'img_0.png', 'text': 'meta cap'}) +
                '\n')
    assert tt.find_items(d) == jt.find_items(d)
    assert tt.find_items(d, 'x') == jt.find_items(d, 'x')
    bare = str(tmp_path / 'bare')
    _write_images(bare, 2, captions=False)
    assert tt.find_items(bare, 'sks') == jt.find_items(bare, 'sks')
    with pytest.raises(ValueError):
        tt.find_items(str(tmp_path / 'empty_or_missing'))
    path = os.path.join(d, 'img_1.png')
    np.testing.assert_array_equal(tt.load_pixels(path, 16),
                                  jt.load_pixels(path, 16))


def _arrays(n=5, hw=8, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, hw, hw, 4)).astype(np.float32),
            rng.normal(size=(n, hw, hw, 4)).astype(np.float32) - 4,
            rng.normal(size=(n, T, D)).astype(np.float32))


def _dataset(n=5, seed=0):
    mean, logvar, ctx = _arrays(n, seed=seed)
    return tt.EncodedDataset(torch.from_numpy(mean), torch.from_numpy(logvar),
                             torch.from_numpy(ctx),
                             [f'cap {i}' for i in range(n)])


def test_sample_with_injected_indices_and_noise_matches_jax():
    """The port's EncodedDataset.sample with the indices and posterior noise
    that JAX's first batch draws equals that batch."""
    mean, logvar, ctx = _arrays()
    jds = jt.EncodedDataset(jnp.asarray(mean), jnp.asarray(logvar),
                            jnp.asarray(ctx), ['c'] * 5)
    key = jax.random.PRNGKey(42)
    want_lat, want_ctx = next(jds.batches(2, key))
    epoch_key, perm_key = jax.random.split(key)   # data.py batches' chain
    order = np.asarray(jax.random.permutation(perm_key, 5))
    _, draw = jax.random.split(epoch_key)
    noise = np.array(jax.random.normal(draw, (2, 8, 8, 4), jnp.float32))
    lat, c = _dataset().sample(torch.from_numpy(order[:2].copy()),
                               torch.from_numpy(noise))
    np.testing.assert_allclose(lat.numpy(), np.asarray(want_lat), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(c.numpy(), np.asarray(want_ctx))


@pytest.mark.parametrize('n,bs,skip', [
    (5, 2, 3),    # mid-epoch resume (2 batches/epoch)
    (5, 2, 4),    # epoch-boundary resume
    (3, 2, 5),    # 1 batch/epoch: skip replays 5 whole epochs
    (2, 4, 3),    # small-dataset replacement-sampling path
])
def test_batches_skip_matches_plain_stream(n, bs, skip):
    ds = _dataset(n=n)
    plain = ds.batches(bs, torch.Generator().manual_seed(42))
    for _ in range(skip):
        next(plain)
    fast = ds.batches(bs, torch.Generator().manual_seed(42), skip=skip)
    for _ in range(3):
        a, b = next(plain), next(fast)
        assert a[0].shape[0] == bs
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


class StubEncoder:
    """CLIPEncoder stand-in: a deterministic [N, 77, D] per caption."""

    def prompt(self, prompts):
        rows = [np.random.default_rng(sum(map(ord, p))).normal(
            size=(77, D)).astype(np.float32) for p in prompts]
        return torch.from_numpy(np.stack(rows))


def test_encode_dataset_shapes(tmp_path):
    d = str(tmp_path / 'ds')
    _write_images(d, 5)
    torch.manual_seed(0)
    vae = tm.AutoencoderKL(tm.TINY_VAE).eval()
    ds = tt.encode_dataset(tt.find_items(d), vae, StubEncoder(),
                           resolution=16, encode_batch=2)
    assert len(ds) == 5 and ds.device.type == 'cpu'
    assert ds.mean.shape == (5, 8, 8, 4) and ds.context.shape == (5, 77, D)
    lat, ctx = next(ds.batches(2, torch.Generator().manual_seed(0)))
    assert lat.shape == (2, 8, 8, 4) and ctx.shape == (2, 77, D)
    with torch.no_grad():
        mean, _ = vae.encode(torch.from_numpy(tt.load_pixels(
            tt.find_items(d)[3][0], 16))[None])
    torch.testing.assert_close(ds.mean[3:4], mean)


@pytest.fixture(scope='module')
def jax_params():
    unet = UNet2DCondition(TINY_UNET)
    return jax.tree.map(np.asarray, jax.jit(lambda k: unet.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, T, D))))(jax.random.PRNGKey(0)))


def _unet(jax_params):
    m = tm.UNet2DCondition(tm.TINY_UNET)
    m.load_state_dict(params_to_state_dict(jax_params, TINY_UNET),
                      strict=True)
    return m


def test_train_lora_end_to_end_loads_in_jax(tmp_path, jax_params):
    """train_lora → kohya safetensors → the JAX package's apply_lora merges
    it into the same UNet's params (the names match its loader's)."""
    from safetensors.numpy import load_file

    from flexdiffuse_tpu.weights import lora as wlora
    unet = _unet(jax_params)
    out = str(tmp_path / 'trained.safetensors')
    factors, losses = tt.train_lora(
        unet, _dataset(), tt.TrainConfig(learning_rate=5e-3,
                                         weight_decay=0.0),
        rank=2, steps=4, batch_size=2, save_path=out, log_every=2)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert any(f['up'].abs().max() > 0 for f in factors.values())
    merged, _ = wlora.apply_lora(jax_params, None, load_file(out), scale=1.0)
    deltas = jax.tree.map(lambda a, b: float(np.abs(a - b).max()),
                          jax_params, merged)
    assert max(jax.tree_util.tree_leaves(deltas)) > 0


def test_train_full_end_to_end(tmp_path, jax_params):
    unet = _unet(jax_params)
    before = [p.detach().clone() for p in unet.parameters()]
    params, losses = tt.train_full(
        unet, _dataset(), tt.TrainConfig(learning_rate=1e-4,
                                         weight_decay=0.0),
        steps=3, batch_size=2, log_every=1)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert params['conv_in.weight'] is unet.conv_in.weight
    assert any(not torch.equal(a, b)
               for a, b in zip(before, unet.parameters()))
    # save_path writes the JAX package's msgpack tree, which reads back
    # bit for bit.
    out = str(tmp_path / 'unet.msgpack')
    params, _ = tt.train_full(unet, _dataset(), steps=1, save_path=out)
    loaded = load_unet_msgpack(out, tm.TINY_UNET)
    assert sorted(loaded) == sorted(unet.state_dict())
    for k, v in params.items():
        assert torch.equal(loaded[k], v.detach()), k


@pytest.mark.parametrize('mode', ['lora', 'full'])
def test_dreambooth_trains_and_saves(tmp_path, jax_params, mode):
    unet = _unet(jax_params)
    out = str(tmp_path / 'db.safetensors') if mode == 'lora' else None
    tree, losses = tt.train_dreambooth(
        unet, _dataset(4, seed=1), _dataset(4, seed=2),
        cfg=tt.TrainConfig(learning_rate=1e-3, weight_decay=0.0),
        prior_weight=0.7, mode=mode, rank=2, steps=4, batch_size=2,
        log_every=2)
    assert losses and all(np.isfinite(losses))
    if mode == 'lora':
        tt.export_lora_safetensors(tree, out)
        assert os.path.exists(out)
    else:
        out = str(tmp_path / 'db.msgpack')
        tree, _ = tt.train_dreambooth(unet, _dataset(4), _dataset(4),
                                      mode='full', steps=1, save_path=out)
        from flax import serialization
        with open(out, 'rb') as f:
            restored = serialization.msgpack_restore(f.read())
        want = convert.state_dict_to_params(
            {k: v.detach().numpy() for k, v in unet.state_dict().items()},
            tm.TINY_UNET)
        assert (jax.tree_util.tree_structure(restored) ==
                jax.tree_util.tree_structure(want))
        for a, b in zip(jax.tree_util.tree_leaves(restored),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, b)


def test_generate_class_images(tmp_path):
    """Drives a stub runner; an incremental re-run tops up to count."""

    class StubRunner:
        def __init__(self):
            self.calls = 0

        def gen(self, prompt, samples, steps, seed, save):
            self.calls += 1
            return [Image.fromarray(np.zeros((8, 8, 3), np.uint8))] * \
                samples, None

    d = str(tmp_path / 'class')
    paths = tt.generate_class_images(StubRunner(), 'a dog', d, count=6,
                                     steps=2)
    assert len(paths) == 6 and all(os.path.exists(p) for p in paths)
    r2 = StubRunner()
    assert len(tt.generate_class_images(r2, 'a dog', d, count=7)) == 7
    assert r2.calls == 1


def _same(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_full_resume_bitwise_exact(tmp_path, jax_params):
    """train_full interrupted at 3/6 then resumed == uninterrupted 6 (the
    seed argument is irrelevant on resume: the checkpoint carries the
    generator states)."""
    cfg = tt.TrainConfig(learning_rate=1e-3, weight_decay=0.0)
    want, want_losses = tt.train_full(_unet(jax_params), _dataset(), cfg,
                                      steps=6, batch_size=2, seed=7,
                                      log_every=1)
    cdir = str(tmp_path / 'ckpt')
    tt.train_full(_unet(jax_params), _dataset(), cfg, steps=3, batch_size=2,
                  seed=7, log_every=1, checkpoint_dir=cdir)
    got, got_losses = tt.train_full(_unet(jax_params), _dataset(), cfg,
                                    steps=6, batch_size=2, seed=999,
                                    log_every=1, checkpoint_dir=cdir)
    _same(want, got)
    assert got_losses == want_losses


def test_lora_resume_with_ema_and_retention(tmp_path, jax_params):
    cfg = tt.TrainConfig(learning_rate=5e-3, weight_decay=0.0,
                         ema_decay=0.5, grad_accum=2)
    want, _ = tt.train_lora(_unet(jax_params), _dataset(), cfg, rank=2,
                            steps=5, batch_size=2, seed=3, log_every=1)
    cdir = str(tmp_path / 'lora_ckpt')
    tt.train_lora(_unet(jax_params), _dataset(), cfg, rank=2, steps=3,
                  batch_size=2, seed=3, log_every=1, checkpoint_dir=cdir,
                  checkpoint_every=1)
    got, _ = tt.train_lora(_unet(jax_params), _dataset(), cfg, rank=2,
                           steps=5, batch_size=2, seed=3, log_every=1,
                           checkpoint_dir=cdir, checkpoint_every=1)
    for name in want:
        _same(want[name], got[name])
    ck = tt.TrainCheckpointer(cdir)
    assert ck.latest_step() == 5 and ck.all_steps() == [3, 4, 5]


def test_resume_config_mismatch_raises(tmp_path, jax_params):
    cfg = tt.TrainConfig(learning_rate=5e-3, weight_decay=0.0)
    cdir = str(tmp_path / 'mismatch')
    tt.train_lora(_unet(jax_params), _dataset(), cfg, rank=2, steps=1,
                  batch_size=2, checkpoint_dir=cdir)
    with pytest.raises(RuntimeError, match='does not match'):
        tt.train_lora(_unet(jax_params), _dataset(), cfg, rank=4, steps=2,
                      batch_size=2, checkpoint_dir=cdir)
    with pytest.raises(RuntimeError, match='does not match'):
        tt.train_lora(_unet(jax_params), _dataset(),
                      tt.TrainConfig(learning_rate=1e-3), rank=2, steps=2,
                      batch_size=2, checkpoint_dir=cdir)


def test_completed_run_restores_without_stepping(tmp_path, jax_params):
    """Re-invoking with steps == the saved next_step returns the trained
    tensors without running a step."""
    cfg = tt.TrainConfig(learning_rate=1e-3, weight_decay=0.0)
    cdir = str(tmp_path / 'done')
    want, _ = tt.train_full(_unet(jax_params), _dataset(), cfg, steps=2,
                            batch_size=2, seed=1, log_every=1,
                            checkpoint_dir=cdir)
    want = {k: v.detach().clone() for k, v in want.items()}
    got, _ = tt.train_full(_unet(jax_params), _dataset(), cfg, steps=2,
                           batch_size=2, seed=1, log_every=1,
                           checkpoint_dir=cdir)
    _same(want, {k: v.detach() for k, v in got.items()})
