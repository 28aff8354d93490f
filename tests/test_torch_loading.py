"""PyTorch port: loading from disk, held against the JAX package on the CPU.

* The port's ``load_clip``/``load_sd`` state dicts equal, bit for bit,
  ``bridge`` of the JAX loader's trees on the tiny HF-layout snapshot that
  ``tests/test_runner_disk_loading.py`` builds (the rules are renames and
  transposes), also with the VAE's old attention names, 4-D 1×1 attention
  weights and Linear ``proj_in``/``proj_out``.
* The safetensors reader equals ``safetensors.numpy.load_file``; the
  msgpack writer's bytes equal ``flax.serialization.msgpack_serialize`` and
  the reader restores flax's bytes, chunked leaves included.
* ``train_full(save_path=)`` writes a file the JAX UNet applies within
  1e-5 of the port; a file the JAX package writes loads into the port.
* ``Runner(model_root, device='cpu', dtype=torch.float32)`` against the
  JAX ``Runner(model_root)``: the pipelines' latents within 1e-4 and uint8
  images within one level on the same guidance inputs and noise.
* A snapshot whose ``unet/config.json`` says ``in_channels: 8``
  (InstructPix2Pix) loads 8-channel and ``edit`` runs it.
* The port imports none of JAX, flax, msgpack, safetensors or the JAX
  package.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexdiffuse_tpu.config import RunConfig as JRunConfig
from flexdiffuse_tpu.models import TINY_UNET as J_TINY_UNET
from flexdiffuse_tpu.models import TINY_VAE as J_TINY_VAE
from flexdiffuse_tpu.models import UNet2DCondition as JUNet
from flexdiffuse_tpu.models import configs as jcfg
from flexdiffuse_tpu.runner import Runner as JRunner
from flexdiffuse_tpu.weights import convert as jconvert
from flexdiffuse_tpu.weights import load as jload
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.weights import bridge, convert, load
from flexdiffuse_tpu_torch.weights import msgpack as tmsgpack
from flexdiffuse_tpu_torch.weights import safetensors as tsafetensors
from tests.test_runner_disk_loading import model_root  # noqa: F401
from tests.test_torch_attention import PORT_MODULES, REPO
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_slice import _compare
from tests.test_weights_vae_load import _synth_vae_sd

# The tiny snapshot's geometry (test_runner_disk_loading.py).
TEXT = dict(vocab_size=86, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64)
VISION = dict(hidden_size=40, num_layers=2, num_heads=4, image_size=32,
              patch_size=8, intermediate_size=80, projection_dim=24)
CONFIGS = dict(text=(jcfg.CLIPTextConfig(**TEXT), tm.CLIPTextConfig(**TEXT)),
               vision=(jcfg.CLIPVisionConfig(**VISION),
                       tm.CLIPVisionConfig(**VISION)),
               unet=(J_TINY_UNET, tm.TINY_UNET), vae=(J_TINY_VAE, tm.TINY_VAE))
NEW_MODULES = [
    'flexdiffuse_tpu_torch.native', 'flexdiffuse_tpu_torch.native.bpe',
    'flexdiffuse_tpu_torch.text.emphasis',
    'flexdiffuse_tpu_torch.weights.convert',
    'flexdiffuse_tpu_torch.weights.load',
    'flexdiffuse_tpu_torch.weights.lora',
    'flexdiffuse_tpu_torch.weights.msgpack',
    'flexdiffuse_tpu_torch.weights.safetensors',
    'flexdiffuse_tpu_torch.weights.textual_inversion']


def _dirs(root):
    cfg = RunConfig()
    return (os.path.join(root, cfg.sd_model.split('/')[-1]),
            os.path.join(root, cfg.clip_model.split('/')[-1]))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _same(got, want):
    """Equal key sets, and every tensor equal in dtype, shape and bits."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.fixture(scope='module')
def jax_trees(model_root):  # noqa: F811
    sd_dir, clip_dir = _dirs(model_root)
    text, vision = jload.load_clip(clip_dir, CONFIGS['text'][0],
                                   CONFIGS['vision'][0], cache=False)
    unet, vae = jload.load_sd(sd_dir, J_TINY_UNET, J_TINY_VAE, cache=False)
    return dict(text=text, vision=vision, unet=unet, vae=vae)


@pytest.mark.parametrize('kind', ['text', 'vision', 'unet', 'vae'])
def test_loaders_equal_jax_trees_through_bridge(model_root, jax_trees,  # noqa: F811,E501
                                                kind):
    sd_dir, clip_dir = _dirs(model_root)
    got = dict(zip(('text', 'vision'), load.load_clip(clip_dir)))
    got.update(zip(('unet', 'vae'), load.load_sd(sd_dir)))
    want = bridge.params_to_state_dict(_np_tree(jax_trees[kind]),
                                       CONFIGS[kind][1])
    _same(got[kind], want)


@pytest.fixture(scope='module')
def vae_params():
    from flexdiffuse_tpu.models import AutoencoderKL
    vae = AutoencoderKL(J_TINY_VAE)
    k = jax.random.PRNGKey(0)
    return _np_tree(vae.init(k, jnp.zeros((1, 16, 16, 3)), k)['params'])


@pytest.mark.parametrize('old_names', [False, True])
@pytest.mark.parametrize('conv_4d', [False, True])
def test_vae_attention_variants_load(tmp_path, vae_params, old_names,
                                     conv_4d):
    """Old diffusers names (query/key/value/proj_attn) and 4-D 1×1 weights
    of the VAE's mid attention (tests/test_weights_vae_load.py:117)."""
    sd = _synth_vae_sd(vae_params)
    for side in ('encoder', 'decoder'):
        p = f'{side}.mid_block.attentions.0'
        for new, old in (('to_q', 'query'), ('to_k', 'key'),
                         ('to_v', 'value'), ('to_out.0', 'proj_attn')):
            name = old if old_names else new
            w = sd.pop(f'{p}.{new}.weight')
            sd[f'{p}.{name}.weight'] = w[:, :, None, None] if conv_4d else w
            sd[f'{p}.{name}.bias'] = sd.pop(f'{p}.{new}.bias')
    path = str(tmp_path / 'diffusion_pytorch_model.safetensors')
    tsafetensors.save_file({k: np.ascontiguousarray(v)
                            for k, v in sd.items()}, path)
    got = convert.normalize(load.load_state_dict(str(tmp_path)), 'vae')
    want = bridge.vae(jconvert.convert_vae(jload.load_state_dict(path),
                                           J_TINY_VAE), tm.TINY_VAE)
    _same(got, want)
    tm.AutoencoderKL(tm.TINY_VAE).load_state_dict(got, strict=True)


def test_unet_linear_projections_load(model_root, jax_trees):  # noqa: F811
    """``use_linear_projection`` checkpoints: proj_in/proj_out as Linear
    ``[out, in]`` load into the port's 1×1 convs as the JAX converter's
    rule does."""
    sd_dir, _ = _dirs(model_root)
    sd = {k: (v[:, :, 0, 0] if k.endswith(('proj_in.weight',
                                           'proj_out.weight')) else v)
          for k, v in load.load_state_dict(os.path.join(sd_dir,
                                                        'unet')).items()}
    assert any(v.ndim == 2 and k.endswith('proj_in.weight')
               for k, v in sd.items())
    want = bridge.params_to_state_dict(_np_tree(jax_trees['unet']),
                                       tm.TINY_UNET)
    _same(convert.normalize(sd, 'unet'), want)


def test_clip_extras_dropped_with_a_log_line(caplog):
    sd = {'logit_scale': torch.ones(()), 'text_projection.weight':
          torch.ones(2, 2), 'text_model.embeddings.position_ids':
          torch.arange(3), 'text_model.x.weight': torch.ones(2),
          'vision_model.y.weight': torch.zeros(2),
          'visual_projection.weight': torch.zeros(2, 2)}
    with caplog.at_level('INFO'):
        text = convert.normalize(sd, 'text')
        vision = convert.normalize(sd, 'vision')
    assert sorted(text) == ['text_model.x.weight']
    assert sorted(vision) == ['vision_model.y.weight',
                              'visual_projection.weight']
    assert 'logit_scale' in caplog.text and 'position_ids' in caplog.text
    with pytest.raises(ValueError):
        convert.normalize(sd, 'clip')


# --- safetensors --------------------------------------------------------

DTYPES = {'F32': np.float32, 'F16': np.float16, 'I64': np.int64,
          'BF16': 'bfloat16'}


def _arrays(dtype, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.dtype(jnp.bfloat16) if dtype == 'bfloat16' else np.dtype(dtype)
    vals = lambda shape: (rng.integers(-2**40, 2**40, shape)
                          if dt.kind == 'i' else rng.normal(size=shape))
    return {'a.weight': vals((3, 5)).astype(dt),
            'b': vals((7,)).astype(dt),
            'scalar': np.asarray(vals(()), dt),
            'empty': np.zeros((0, 4), dt),
            'big': vals((33, 17, 2)).astype(dt)}


def _bits(x):
    """Raw bits of a numpy array or torch tensor, for exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy()
    return x.view(np.int16) if x.dtype == np.dtype(jnp.bfloat16) else x


@pytest.mark.parametrize('name', sorted(DTYPES))
def test_safetensors_reader_matches_package(tmp_path, name):
    from safetensors.numpy import load_file, save_file
    path = str(tmp_path / 'x.safetensors')
    save_file(_arrays(DTYPES[name]), path, metadata={'format': 'pt'})
    want = load_file(path)
    got = tsafetensors.load_file(path)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]))
    assert got['b'].dtype == tsafetensors.DTYPES[name]


@pytest.mark.parametrize('name', sorted(DTYPES))
def test_safetensors_writer_round_trips(tmp_path, name):
    from safetensors.numpy import load_file
    arrays = _arrays(DTYPES[name], seed=1)
    tensors = {k: (torch.from_numpy(v.astype(np.float32)).to(torch.bfloat16)
                   if name == 'BF16' else torch.from_numpy(v))
               for k, v in arrays.items()}
    path = str(tmp_path / 'x.safetensors')
    tsafetensors.save_file(tensors, path, metadata={'k': 'v'})
    mine = tsafetensors.load_file(path)
    theirs = load_file(path)
    for k, v in tensors.items():
        assert mine[k].dtype == v.dtype and torch.equal(mine[k], v), k
        np.testing.assert_array_equal(_bits(theirs[k]), _bits(v))


def test_save_safetensors_stays_importable_from_training(tmp_path):
    from flexdiffuse_tpu_torch.training.train import save_safetensors
    from safetensors.numpy import load_file
    path = str(tmp_path / 'l.safetensors')
    save_safetensors({'x': np.arange(4, dtype=np.float64)}, path)
    got = load_file(path)['x']
    assert got.dtype == np.float32 and list(got) == [0, 1, 2, 3]


# --- msgpack -------------------------------------------------------------

@pytest.fixture(scope='module')
def unet_params():
    unet = JUNet(J_TINY_UNET)
    return _np_tree(jax.jit(lambda k: unet.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 77, 32))))(jax.random.PRNGKey(3)))


def _to_torch(tree):
    """numpy leaves → torch (bfloat16 through float32, exactly)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, np.generic):
        return tree
    if tree.dtype == np.dtype(jnp.bfloat16):
        return torch.from_numpy(tree.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _with_bf16(params):
    tree = jax.tree.map(lambda x: x, params)
    p = tree['params']
    p['conv_in'] = dict(p['conv_in'], kernel=np.asarray(
        jnp.asarray(p['conv_in']['kernel'], jnp.bfloat16)))
    p['step'] = np.int64(7)
    p['scale'] = np.float32(0.5)
    return tree


def _leaf_equal(a, b):
    if isinstance(a, torch.Tensor):
        a = a.float().numpy()
    if isinstance(b, torch.Tensor):
        b = b.float().numpy()
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.astype(np.float64), b.astype(np.float64))


@pytest.mark.parametrize('chunk', [None, 4096])
@pytest.mark.parametrize('bf16', [False, True])
def test_msgpack_writer_bytes_equal_flax(monkeypatch, unet_params, chunk,
                                         bf16):
    """Also with a small MAX_CHUNK_SIZE on both sides, so every large leaf
    is written chunked."""
    from flax import serialization
    if chunk:
        monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', chunk)
        monkeypatch.setattr(tmsgpack, 'MAX_CHUNK_SIZE', chunk)
    tree = _with_bf16(unet_params) if bf16 else unet_params
    want = serialization.msgpack_serialize(tree)
    assert tmsgpack.serialize(_to_torch(tree)) == want
    assert tmsgpack.serialize(tree) == want   # numpy leaves as well


@pytest.mark.parametrize('chunk', [None, 4096])
def test_msgpack_reader_restores_flax_bytes(monkeypatch, tmp_path,
                                            unet_params, chunk):
    from flax import serialization
    if chunk:
        monkeypatch.setattr(serialization, 'MAX_CHUNK_SIZE', chunk)
    tree = _with_bf16(unet_params)
    data = serialization.msgpack_serialize(tree)
    if chunk:
        assert b'__msgpack_chunked_array__' in data
    path = str(tmp_path / 't.msgpack')
    with open(path, 'wb') as f:
        f.write(data)
    for got in (tmsgpack.restore(data), tmsgpack.load(path)):
        want = serialization.msgpack_restore(data)
        assert (jax.tree_util.tree_structure(got) ==
                jax.tree_util.tree_structure(want))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(want)):
            _leaf_equal(a, b)
    assert tmsgpack.restore(data)['params']['conv_in']['kernel'].dtype == \
        torch.bfloat16


@pytest.mark.parametrize('bad', [1.5, None, [1, 2], {1: 'x'}])
def test_msgpack_writer_refuses_non_tree_values(bad):
    with pytest.raises(TypeError):
        tmsgpack.serialize({'a': bad})


def test_jax_written_unet_loads_into_the_port(tmp_path, unet_params):
    """A JAX ``train_full(save_path=)`` file: flax msgpack of the params."""
    from flax import serialization
    path = str(tmp_path / 'jax_unet.msgpack')
    with open(path, 'wb') as f:
        f.write(serialization.msgpack_serialize(unet_params))
    got = load.load_unet_msgpack(path, tm.TINY_UNET)
    want = bridge.params_to_state_dict(unet_params, tm.TINY_UNET)
    _same(got, want)
    tm.UNet2DCondition(tm.TINY_UNET).load_state_dict(got, strict=True)


def test_train_full_save_applies_in_jax(tmp_path, unet_params):
    """The port's ``train_full(save_path=)`` file restores with flax into
    the tree the JAX UNet applies to the same ε as the port's trained UNet
    (fp32, within 1e-5 of max|ε|)."""
    from flax import serialization
    unet = tm.UNet2DCondition(tm.TINY_UNET)
    unet.load_state_dict(bridge.params_to_state_dict(unet_params,
                                                     tm.TINY_UNET))
    rng = np.random.default_rng(0)
    ds = tt.EncodedDataset(
        torch.from_numpy(rng.normal(size=(4, 8, 8, 4)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(4, 8, 8, 4)).astype(np.float32)),
        torch.from_numpy(rng.normal(size=(4, 7, 32)).astype(np.float32)),
        ['x'] * 4)
    path = str(tmp_path / 'unet.msgpack')
    tt.train_full(unet, ds, tt.TrainConfig(learning_rate=1e-3), steps=2,
                  batch_size=2, save_path=path)
    with open(path, 'rb') as f:
        data = f.read()
    restored = serialization.msgpack_restore(data)
    x = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    t = np.asarray([10.0, 500.0], np.float32)
    ctx = rng.normal(size=(2, 7, 32)).astype(np.float32)
    want = np.asarray(JUNet(J_TINY_UNET).apply(
        restored, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx)))
    with torch.no_grad():
        got = unet(torch.from_numpy(x), torch.from_numpy(t),
                   torch.from_numpy(ctx)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert not any(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in
                   zip(jax.tree_util.tree_leaves(restored['params']
                                                 ['conv_in']),
                       jax.tree_util.tree_leaves(unet_params['params']
                                                 ['conv_in'])))


# --- Runner from disk ----------------------------------------------------

def _port_runner(root, out, dtype=torch.float32, **kw):
    return Runner(model_root=root, config=RunConfig(output_dir=out),
                  device='cpu', dtype=dtype,
                  text_config=CONFIGS['text'][1],
                  vision_config=CONFIGS['vision'][1],
                  unet_config=tm.TINY_UNET, vae_config=tm.TINY_VAE, **kw)


def _jax_runner(root, out, **kw):
    return JRunner(model_root=root, config=JRunConfig(output_dir=out),
                   dtype=jnp.float32, text_config=CONFIGS['text'][0],
                   vision_config=CONFIGS['vision'][0],
                   unet_config=J_TINY_UNET, vae_config=J_TINY_VAE, **kw)


@pytest.fixture(scope='module')
def runners(model_root, tmp_path_factory):  # noqa: F811
    out = str(tmp_path_factory.mktemp('out'))
    return _jax_runner(model_root, out), _port_runner(model_root, out)


def capture_guidance(runner, **gen_kw):
    """The guidance ``gen`` hands the pipeline (its ``_run`` is stubbed)."""
    seen = []
    real = runner._run
    runner._run = lambda batches, guidance, *a, **k: (seen.append(guidance)
                                                      or ([], None))
    try:
        runner.gen(save=False, **gen_kw)
    finally:
        runner._run = real
    return seen[0]


def run_both(jrunner, trunner, steps=3, seed=0, **gen_kw):
    """Both runners' guidance for ``gen_kw`` through both pipelines with the
    same noise; held by ``_compare``'s rule."""
    jg = capture_guidance(jrunner, **gen_kw)
    tg = capture_guidance(trunner, **gen_kw)
    noise = np.random.default_rng(seed).normal(size=(1, 8, 8, 4)).astype(
        np.float32)
    jlat = jrunner.pipe(jg, steps=steps, init_size=(16, 16),
                        noise=jnp.asarray(noise), key=jax.random.PRNGKey(1),
                        output_type='latent').images
    tlat = trunner.pipe(tg, steps=steps, init_size=(16, 16),
                        noise=torch.from_numpy(noise),
                        output_type='latent').images
    _compare(jrunner.pipe, trunner.pipe, jlat, tlat)
    return jg, tg


@pytest.mark.parametrize('guide', [None, 'a green forest'])
def test_runner_from_disk_matches_jax(runners, guide):
    """With and without a guide (text: the tiny snapshot's vision
    projection, 24 wide, cannot tween its 32-wide text embeddings)."""
    jr, tr = runners
    run_both(jr, tr, prompt='a deer', negative_prompt='blur', guide=guide)


def test_runner_from_disk_generates_images(runners):
    _, tr = runners
    images, grid = tr.gen(prompt='a deer', guide='a forest', steps=2,
                          init_size=(16, 16), samples=2, seed=3, save=False)
    arrs = [np.asarray(im) for im in images]
    assert len(arrs) == 2 and grid.size == (32, 16)
    assert all(a.shape == (16, 16, 3) and a.dtype == np.uint8 for a in arrs)
    p = next(tr.pipe.unet.parameters())
    assert p.device.type == 'cpu' and p.dtype == torch.float32
    assert not p.requires_grad


def test_runner_defaults_to_the_card(model_root, tmp_path):  # noqa: F811
    """No CUDA here: the default device raises, with no CPU fallback."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner(model_root=model_root)
    with pytest.raises(ValueError, match='model_root'):
        Runner()


def eight_channel_root(model_root: str, root) -> str:
    """A copy of the tiny snapshot whose SD model is an InstructPix2Pix-style
    8-channel UNet under ``instruct-pix2pix``: ``conv_in`` widened with
    seeded random weights for the image channels, ``unet/config.json``
    saying ``in_channels: 8``."""
    import shutil
    from safetensors.numpy import load_file, save_file
    shutil.copytree(model_root, root)
    sd_dir, _ = _dirs(str(root))
    dst = os.path.join(os.path.dirname(sd_dir), 'instruct-pix2pix')
    shutil.copytree(sd_dir, dst)
    path = load.weights_file(os.path.join(dst, 'unet'))
    sd = load_file(path)
    w = sd['conv_in.weight']
    extra = np.random.default_rng(0).normal(
        size=w.shape[:1] + (4,) + w.shape[2:]).astype(w.dtype) * 0.1
    sd['conv_in.weight'] = np.concatenate([w, extra], axis=1)
    save_file(sd, path)
    with open(os.path.join(dst, 'unet', 'config.json'), 'w') as f:
        json.dump({'in_channels': 8}, f)
    return str(root)


def test_runner_loads_an_eight_channel_unet(model_root, tmp_path):  # noqa: F811,E501
    """A snapshot whose unet/config.json says ``in_channels: 8`` (an
    InstructPix2Pix checkpoint) loads with that width, also over the
    tiny config given, with the stored ``conv_in``; ``edit`` runs it at
    UNet batch 3."""
    root = eight_channel_root(model_root, tmp_path / 'models')
    runner = Runner(model_root=root, device='cpu', dtype=torch.float32,
                    config=RunConfig(sd_model='timbrooks/instruct-pix2pix',
                                     output_dir=str(tmp_path / 'out')),
                    text_config=CONFIGS['text'][1],
                    vision_config=CONFIGS['vision'][1],
                    unet_config=tm.TINY_UNET, vae_config=tm.TINY_VAE)
    unet = runner.pipe.unet
    assert unet.config.in_channels == 8
    stored = load.load_state_dict(os.path.join(root, 'instruct-pix2pix',
                                               'unet'))['conv_in.weight']
    assert torch.equal(unet.conv_in.weight, stored)
    batches = []
    hook = unet.register_forward_pre_hook(
        lambda m, args: batches.append(tuple(args[0].shape)))
    image = np.random.default_rng(1).uniform(-1, 1, (1, 16, 16, 3)).astype(
        np.float32)
    images, _ = runner.edit('make it winter', image, steps=2, seed=1,
                            save=False)
    hook.remove()
    assert batches == [(3, 8, 8, 8)] * 3
    assert images[0].size == (16, 16)


def test_runner_loads_a_guidance_embedded_lcm_unet(model_root, tmp_path,  # noqa: F811,E501
                                                   monkeypatch):
    """A snapshot whose unet/config.json names ``time_cond_proj_dim`` (a
    full LCM checkpoint) loads as the JAX Runner adopts it: the UNet gains
    ``time_embedding.cond_proj`` with the stored weights, and ``gen``
    runs LCM with CFG off (UNet batch 1)."""
    import shutil
    from safetensors.numpy import load_file, save_file
    root = tmp_path / 'models'
    shutil.copytree(model_root, root)
    sd_dir, _ = _dirs(str(root))
    path = load.weights_file(os.path.join(sd_dir, 'unet'))
    sd = load_file(path)
    proj = np.random.default_rng(0).normal(
        size=(tm.TINY_UNET.block_channels[0], 16)).astype(np.float32)
    sd['time_embedding.cond_proj.weight'] = proj
    save_file(sd, path)
    with open(os.path.join(sd_dir, 'unet', 'config.json'), 'w') as f:
        json.dump({'in_channels': 4, 'time_cond_proj_dim': 16}, f)
    # The snapshot's geometry is the tiny UNet's: the default path reads it.
    monkeypatch.setattr('flexdiffuse_tpu_torch.runner.SD14_UNET',
                        tm.TINY_UNET)
    runner = Runner(model_root=str(root), device='cpu', dtype=torch.float32,
                    scheduler='lcm', text_config=CONFIGS['text'][1],
                    vision_config=CONFIGS['vision'][1],
                    vae_config=tm.TINY_VAE,
                    config=RunConfig(output_dir=str(tmp_path / 'out')))
    unet = runner.pipe.unet
    assert unet.config.time_cond_proj_dim == 16
    np.testing.assert_array_equal(
        unet.time_embedding.cond_proj.weight.numpy(), proj)
    batches = []
    hook = unet.register_forward_pre_hook(
        lambda m, args: batches.append(args[0].shape[0]))
    images, _ = runner.gen(prompt='a deer', steps=2, init_size=(16, 16),
                           seed=1, save=False)
    hook.remove()
    assert batches == [1, 1]
    assert np.asarray(images[0]).shape == (16, 16, 3)


def test_unet_overrides_read_config_json(tmp_path):
    assert load.unet_overrides(str(tmp_path)) == {}
    os.makedirs(tmp_path / 'unet')
    (tmp_path / 'unet' / 'config.json').write_text(
        json.dumps({'in_channels': 9, 'time_cond_proj_dim': None}))
    assert load.unet_overrides(str(tmp_path)) == {'in_channels': 9,
                                                  'time_cond_proj_dim': 0}


def test_instantiate_fills_every_weight_in_the_dtype():
    src = tm.UNet2DCondition(tm.TINY_UNET)
    sd = src.state_dict()
    got = load.instantiate(tm.UNet2DCondition, tm.TINY_UNET, sd, 'cpu',
                           torch.bfloat16)
    for k, v in got.state_dict().items():
        assert v.dtype == torch.bfloat16 and v.device.type == 'cpu'
        assert torch.equal(v, sd[k].to(torch.bfloat16)), k
    with pytest.raises(RuntimeError):
        load.instantiate(tm.UNet2DCondition, tm.TINY_UNET,
                         {k: v for k, v in sd.items() if 'conv_in' not in k},
                         'cpu', torch.float32)


def test_load_state_dict_flattens_torch_files(tmp_path):
    """A1111-style .pt: nested dicts flattened, non-tensors dropped."""
    path = str(tmp_path / 'e.pt')
    torch.save({'string_to_param': {'*': torch.ones(2, 3)}, 'name': 'x',
                'step': 5}, path)
    got = load.load_state_dict(path)
    assert list(got) == ['string_to_param.*']
    torch.save({'state_dict': {'a': torch.zeros(2)}}, path)
    assert list(load.load_state_dict(path)) == ['a']
    with pytest.raises(FileNotFoundError):
        load.load_state_dict(str(tmp_path))   # a directory without weights


def test_port_imports_none_of_jax_flax_msgpack_safetensors():
    """Every port module imports with jax, flax, msgpack, safetensors and
    the JAX package blocked in ``sys.modules``."""
    mods = PORT_MODULES + NEW_MODULES
    code = ('import sys\n'
            'for m in ("jax", "flax", "msgpack", "safetensors", '
            '"flexdiffuse_tpu"):\n'
            '    sys.modules[m] = None\n'
            f'import importlib\nfor m in {mods!r}:\n'
            '    importlib.import_module(m)\n'
            'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
