"""PyTorch port: SDXL as a product surface, held against
``tests/test_sdxl_product.py`` case for case: ``SDXLRunner`` loading the
tiny SDXL and refiner snapshots that test's fixtures write (imported, not
copied), ``gen``'s keyword surface, the CFG interval, IP-Adapters, the
refiner chain, the CLI's ``--model-family sdxl`` and the web UI serving an
``SDXLRunner``.

Both runners load the same snapshot, fp32 on the CPU. A torch generator
cannot draw JAX's numbers, so the port's pipelines get the initial noise
of JAX's key chain (``PRNGKey(seed)``; per sample ``key, sub = split(key)``
and the pipeline's ``split(sub, 4)[2]``; the refiner's likewise from a
second split): the images must then be within one uint8 level of JAX's.
"""
import dataclasses
import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu.models import CLIPVisionModel as JCLIPVision
from flexdiffuse_tpu.models.configs import TINY_REFINER_UNET
from flexdiffuse_tpu_torch import cli as tcli
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import sdxl_runner as tsr
from flexdiffuse_tpu_torch.models.sdxl import sdxl_guidance
from flexdiffuse_tpu_torch.utils.image import clip_preprocess
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from flexdiffuse_tpu_torch.weights.safetensors import save_file
from tests.test_sdxl_product import (TINY_XL_UNET, TINY_XL_VAE, _te_cfgs,
                                     refiner_snapshot,  # noqa: F401
                                     xl_snapshot)  # noqa: F401
from tests.test_torch_attention import one_torch_thread  # noqa: F401

SIZE = (64, 64)
ATOL = 1e-4


def _port_cfg(cfg, cls):
    """The port's copy of a JAX config dataclass."""
    return cls(**dataclasses.asdict(cfg))


def _load_kw(vocab, port: bool) -> dict:
    te1, te2 = _te_cfgs(vocab)
    kw = dict(unet_config=TINY_XL_UNET, vae_config=TINY_XL_VAE,
              te1_config=te1, te2_config=te2)
    if not port:
        return kw
    classes = dict(unet_config=tm.UNetConfig, vae_config=tm.VAEConfig,
                   te1_config=tm.CLIPTextConfig, te2_config=tm.CLIPTextConfig)
    return {k: _port_cfg(v, classes[k]) for k, v in kw.items()}


def _pair(root, vocab, out, refiner=None):
    """(JAX SDXLRunner, port SDXLRunner) on the same snapshot, fp32."""
    from flexdiffuse_tpu.sdxl_runner import SDXLRunner as JSDXLRunner
    rkw = {}
    if refiner is not None:
        rkw = dict(refiner_root=refiner, refiner_config=TINY_REFINER_UNET)
    jr = JSDXLRunner(root, scheduler='dpmpp', dtype=jnp.float32,
                     output_dir=out, **_load_kw(vocab, False), **rkw)
    if refiner is not None:
        rkw['refiner_config'] = tm.TINY_REFINER_UNET
    tr = tsr.SDXLRunner(root, scheduler='dpmpp', dtype=torch.float32,
                        device='cpu', output_dir=out, **_load_kw(vocab, True),
                        **rkw)
    return jr, tr


class JaxNoise:
    """JAX's key chain of one ``SDXLRunner.gen``, handed to the port's base
    and refiner pipelines as their ``noise=``."""

    def __init__(self, runner, seed: int) -> None:
        self.key = jax.random.PRNGKey(seed)
        self.base, self.refiner = runner.pipe, runner.refiner_pipe
        runner.pipe = self._wrap(self.base)
        if self.refiner is not None:
            runner.refiner_pipe = self._wrap(self.refiner)

    def _wrap(self, pipe):
        def call(guide, **kw):
            self.key, sub = jax.random.split(self.key)
            k_noise = jax.random.split(sub, 4)[2]
            if kw.get('init_latents') is not None:
                shape = tuple(kw['init_latents'].shape)
            else:
                f = pipe.vae_scale
                h, w = kw['init_size']
                shape = (guide.batch_size, h // f, w // f,
                         pipe.latent_channels)
            kw['noise'] = torch.from_numpy(np.array(
                jax.random.normal(k_noise, shape, jnp.float32)))
            return pipe(guide, **kw)
        return call

    def restore(self, runner) -> None:
        runner.pipe, runner.refiner_pipe = self.base, self.refiner


def _gen_both(jr, tr, **kw):
    """``gen(**kw)`` on both runners (seeded), the port on JAX's noise."""
    jimgs, _ = jr.gen(**kw)
    chain = JaxNoise(tr, kw['seed'])
    try:
        timgs, _ = tr.gen(**kw)
    finally:
        chain.restore(tr)
    return jimgs, timgs


def _u8(img) -> np.ndarray:
    return np.asarray(img, np.int16)


def _within_one_level(jimgs, timgs) -> None:
    assert len(jimgs) == len(timgs)
    for a, b in zip(jimgs, timgs):
        assert a.size == b.size
        assert np.abs(_u8(a) - _u8(b)).max() <= 1


@pytest.fixture(scope='module')
def runners(xl_snapshot, tmp_path_factory):  # noqa: F811
    root, vocab = xl_snapshot
    return _pair(root, vocab, str(tmp_path_factory.mktemp('xl_out')))


def test_sdxl_disk_gen_end_to_end(runners):
    """txt2img from the snapshot: one image of the asked size, within one
    uint8 level of JAX's."""
    jr, tr = runners
    jimgs, timgs = _gen_both(jr, tr, prompt='a deer', steps=2,
                             init_size=SIZE, samples=1, seed=3, save=False)
    assert len(timgs) == 1 and timgs[0].size == SIZE
    _within_one_level(jimgs, timgs)


def test_sdxl_runner_ui_kwarg_surface(runners):
    """The Runner.gen keywords of the CLI and the web UI, with a text guide
    (tweened into the CLIP-L half): JAX's image within one level, and the
    guide changes the image."""
    jr, tr = runners
    kw = dict(prompt='a deer', guide='a tiger', init_size=SIZE,
              guide_threshold_mult=0.25, guide_threshold_floor=0.75,
              guide_clustered=0.15, guide_linear=(0.1, 0.5),
              guide_max_guidance=0.35, guide_header_max=0.0, guide_mode=1,
              guide_reuse=True, mapping_concepts='', strength=0.6, steps=2,
              guidance_scale=5.0, samples=1, seed=3, save=False,
              negative_prompt='blurry', mask=None, control_image=None,
              controlnet_scale=1.0, ip_image=None, ip_scale=1.0,
              long_prompt=False)
    jimgs, timgs = _gen_both(jr, tr, **kw)
    _within_one_level(jimgs, timgs)
    plain, _ = tr.gen(prompt='a deer', init_size=SIZE, steps=2, samples=1,
                      seed=3, save=False)
    assert np.abs(_u8(timgs[0]) - _u8(plain[0])).max() > 0


def test_sdxl_image_guide(runners, monkeypatch):
    """An image guide: a tiny vision tower (projection to the CLIP-L half's
    24 wide) on both runners, its patches tweened into the context; JAX's
    image within one level (JAX's 224² preprocessing replaced by the tiny
    tower's 32²)."""
    import flexdiffuse_tpu.sdxl_runner as jsr
    jr, tr = runners
    cfg = dict(hidden_size=16, num_layers=2, num_heads=2, image_size=32,
               patch_size=8, intermediate_size=32, projection_dim=24)
    from flexdiffuse_tpu.models.configs import CLIPVisionConfig as JCfg
    jm = JCLIPVision(JCfg(**cfg))
    params = jax.jit(lambda k: jm.init(k, jnp.zeros((1, 32, 32, 3))))(
        jax.random.PRNGKey(4))
    port = tm.CLIPVisionModel(tm.CLIPVisionConfig(**cfg)).eval()
    port.load_state_dict(params_to_state_dict(
        jax.tree.map(np.asarray, params), JCfg(**cfg)), strict=True)
    monkeypatch.setattr(jr, 'vision', (jax.jit(jm.apply), params))
    monkeypatch.setattr(tr, 'vision', port.requires_grad_(False))
    monkeypatch.setattr(jsr, 'clip_preprocess',
                        lambda im: clip_preprocess(im, 32))
    guide = Image.fromarray(np.random.default_rng(5).integers(
        0, 256, (48, 48, 3), dtype=np.uint8))
    jimgs, timgs = _gen_both(jr, tr, prompt='a deer', guide=guide, steps=2,
                             init_size=SIZE, samples=1, seed=3, save=False)
    _within_one_level(jimgs, timgs)


def test_sdxl_cfg_interval(runners):
    """The interval reaches the loop (the latents change against
    full-range CFG, and equal JAX's within 1e-4 on the same noise), and the
    runner path tags the provenance file name."""
    jr, tr = runners
    from flexdiffuse_tpu.models.sdxl import sdxl_guidance as jguidance
    noise = np.random.default_rng(6).normal(size=(1, 32, 32, 4)).astype(
        np.float32)
    g = sdxl_guidance(tr.text, 'a deer', '', 5.0, size=SIZE)
    gi = g.replace(cfg_interval=True, cfg_from=0.0, cfg_to=0.4)
    kw = dict(steps=4, init_size=SIZE, output_type='latent',
              noise=torch.from_numpy(noise))
    la = tr.pipe(g, **kw).images.numpy()
    lb = tr.pipe(gi, **kw).images.numpy()
    assert np.isfinite(lb).all()
    assert not np.array_equal(la, lb)
    jg = jguidance(jr.text, 'a deer', '', 5.0, size=SIZE).replace(
        cfg_interval=True, cfg_from=jnp.float32(0.0), cfg_to=jnp.float32(0.4))
    want = jr.pipe(jg, steps=4, init_size=SIZE, output_type='latent',
                   noise=jnp.asarray(noise), key=jax.random.PRNGKey(3))
    np.testing.assert_allclose(lb, np.asarray(want['images']), rtol=0,
                               atol=ATOL)

    imgs, _ = tr.gen(prompt='a deer', steps=4, init_size=SIZE, samples=1,
                     seed=3, cfg_interval=(0.0, 0.4))
    assert len(imgs) == 1
    assert any('_ci0-40' in f for f in os.listdir(tr.output_dir))


@pytest.mark.parametrize('kw', ['mask', 'control_image',
                                'mapping_concepts', 'long_prompt'])
def test_sdxl_unsupported_features_raise(runners, kw):
    with pytest.raises(ValueError, match='not supported'):
        runners[1].gen(prompt='a deer', steps=1, save=False, **{kw: 'x'})


def test_sdxl_ip_image_without_adapter_raises(runners):
    with pytest.raises(ValueError, match='no IP-Adapter'):
        runners[1].gen(prompt='a deer', steps=1, save=False, ip_image='x')


def _ip_checkpoint(path, d_img: int = 20) -> str:
    """The JAX test's SDXL-geometry base IP-Adapter checkpoint."""
    from flexdiffuse_tpu.models.ip_adapter import attn2_layer_order
    rng = np.random.default_rng(13)
    d_ctx = TINY_XL_UNET.cross_attention_dim
    sd = {
        'image_proj.proj.weight':
            (rng.standard_normal((4 * d_ctx, d_img)) * 0.1).astype(
                np.float32),
        'image_proj.proj.bias': np.zeros(4 * d_ctx, np.float32),
        'image_proj.norm.weight': np.ones(d_ctx, np.float32),
        'image_proj.norm.bias': np.zeros(d_ctx, np.float32),
    }
    for n, _ in enumerate(attn2_layer_order(TINY_XL_UNET)):
        for kv in 'kv':
            sd[f'ip_adapter.{2 * n + 1}.to_{kv}_ip.weight'] = \
                (rng.standard_normal((64, d_ctx)) * 0.1).astype(np.float32)
    save_file(sd, path)
    return path


# Tiny stand-ins for the two image towers SDXL IP-Adapters use, both
# projecting to the checkpoint's 20-wide embedding.
TINY_IP_ENCODERS = {
    'vit-h': dict(hidden_size=16, num_layers=2, num_heads=2, image_size=32,
                  patch_size=8, intermediate_size=32, projection_dim=20),
    'bigg': dict(hidden_size=24, num_layers=1, num_heads=4, image_size=32,
                 patch_size=16, intermediate_size=48, projection_dim=20),
}


@pytest.mark.parametrize('encoder', ['vit-h', 'bigg'])
def test_sdxl_ip_adapter_end_to_end(xl_snapshot, tmp_path,  # noqa: F811
                                    monkeypatch, encoder):
    """An SDXL IP-Adapter loads through ``load_ip_adapter(encoder=)``: from
    a precomputed embedding JAX's image within one level and JAX's latents
    within ATOL; from an ``ip_image`` through the image encoder (a tiny
    tower of the ``encoder`` kind, in HF layout) the image prompt moves the
    latents."""
    import flexdiffuse_tpu.models.configs as jconfigs
    root, vocab = xl_snapshot
    jr, tr = _pair(root, vocab, str(tmp_path / 'out'))
    ckpt = _ip_checkpoint(str(tmp_path / 'ip.safetensors'))
    vcfg = tm.CLIPVisionConfig(**TINY_IP_ENCODERS[encoder])
    monkeypatch.setitem(tsr.IP_ENCODERS, encoder, vcfg)
    monkeypatch.setattr(jconfigs, {'vit-h': 'OPENCLIP_H_VISION',
                                   'bigg': 'OPENCLIP_BIGG_VISION'}[encoder],
                        jconfigs.CLIPVisionConfig(**TINY_IP_ENCODERS[
                            encoder]))
    torch.manual_seed(14)
    tower = tm.CLIPVisionModel(vcfg)
    # Unit-variance weights: embeddings of the scale of the JAX test's
    # ``ip_embed``, so that the image prompt shows in uint8.
    torch.nn.init.normal_(tower.visual_projection.weight)
    enc_dir = tmp_path / 'image_encoder'
    enc_dir.mkdir()
    save_file({k: v.contiguous() for k, v in tower.state_dict().items()},
              str(enc_dir / 'model.safetensors'))
    jr.load_ip_adapter(ckpt, encoder=encoder)
    tr.load_ip_adapter(ckpt, str(enc_dir), encoder=encoder)
    assert tr._ip.encoder.config == vcfg
    embed = np.random.default_rng(13).standard_normal((1, 20)).astype(
        np.float32)
    common = dict(prompt='a deer', steps=2, init_size=SIZE, samples=1,
                  seed=3, save=False)
    jimgs, timgs = _gen_both(jr, tr, ip_embed=embed, ip_scale=1.0, **common)
    _within_one_level(jimgs, timgs)
    # The tiny snapshot's 0.02-std weights keep the image prompt's effect
    # below one uint8 level in fp32 (the JAX test sees it through bf16
    # rounding): the latents on the same noise equal JAX's within ATOL, and
    # the adapter moves them by more than ten times that.
    from flexdiffuse_tpu.models.sdxl import sdxl_guidance as jguidance
    noise = np.random.default_rng(16).normal(size=(1, 32, 32, 4)).astype(
        np.float32)
    g = sdxl_guidance(tr.text, 'a deer', '', 5.0, size=SIZE)
    jg = jguidance(jr.text, 'a deer', '', 5.0, size=SIZE)
    lat = {s: tr.pipe(g.replace(**tr._ip.fields(embed, None, s)), steps=2,
                      init_size=SIZE, output_type='latent',
                      noise=torch.from_numpy(noise)).images.numpy()
           for s in (1.0, 0.0)}
    want = jr.pipe(jg.replace(**jr._ip_fields(jnp.asarray(embed), None, 1.0)),
                   steps=2, init_size=SIZE, output_type='latent',
                   noise=jnp.asarray(noise), key=jax.random.PRNGKey(3))
    np.testing.assert_allclose(lat[1.0], np.asarray(want['images']), rtol=0,
                               atol=ATOL)
    assert np.abs(lat[1.0] - lat[0.0]).max() > 10 * ATOL
    image = Image.fromarray(np.random.default_rng(15).integers(
        0, 256, (40, 40, 3), dtype=np.uint8))
    imgs, _ = tr.gen(ip_image=image, ip_scale=1.0, **common)
    assert len(imgs) == 1 and imgs[0].size == SIZE
    # From ``ip_image`` through the image encoder the image prompt moves
    # the latents too.
    from_image = [tr.pipe(g.replace(**tr._ip.fields(None, image, s)),
                          steps=2, init_size=SIZE, output_type='latent',
                          noise=torch.from_numpy(noise)).images
                  for s in (1.0, 0.0)]
    assert (from_image[0] - from_image[1]).abs().max() > 1e-6


def test_sdxl_runner_apply_lora(xl_snapshot, tmp_path):  # noqa: F811
    """``SDXLRunner.apply_lora`` of a kohya SGM LoRA (``lora_unet_*``,
    ``lora_te1_``, ``lora_te2_``) on both runners: JAX's image within one
    level, and the merged UNet weight is the snapshot's stored value plus
    the update (fp32, rounded once)."""
    from tests.test_torch_sdxl import _sgm_lora
    root, vocab = xl_snapshot
    jr, tr = _pair(root, vocab, str(tmp_path / 'out'))
    te1, te2 = _te_cfgs(vocab)
    sd = _sgm_lora(_load_kw(vocab, True)['unet_config'], te1, te2, seed=18)
    path = str(tmp_path / 'lora.safetensors')
    save_file(sd, path)
    before = {k: v.clone() for k, v in tr.pipe.unet.state_dict().items()}
    jr.apply_lora(path, 0.7)
    tr.apply_lora(path, 0.7)
    assert {t.split(':')[0] for t in tr._merged} == {'unet', 'te', 'te2'}
    changed = [k for k, v in tr.pipe.unet.state_dict().items()
               if not torch.equal(v, before[k])]
    assert changed
    jimgs, timgs = _gen_both(jr, tr, prompt='a deer', steps=2,
                             init_size=SIZE, samples=1, seed=3, save=False)
    _within_one_level(jimgs, timgs)


@pytest.mark.parametrize('argv', [
    [], ['--refiner', 'REF'], ['--refiner', 'REF', '--refine-strength',
                               '0.5']], ids=['base', 'refiner', 'strength'])
def test_cli_model_family_sdxl_wiring(xl_snapshot, monkeypatch,  # noqa: F811
                                      tmp_path, argv):
    """``generate --model-family sdxl`` builds an SDXLRunner on the
    snapshot (``--models`` pointing at it) on ``--device`` and forwards the
    generation keywords, ``refine_strength`` among them, as the JAX CLI;
    ``--controlnet`` exits naming the family."""
    from flexdiffuse_tpu import cli as jcli
    import flexdiffuse_tpu.sdxl_runner as jsr
    root, _ = xl_snapshot
    calls = {}

    def fake(tag):
        class FakeXL:
            output_dir = str(tmp_path)

            def __init__(self, root, clip_root=None, scheduler='dpmpp',
                         output_dir='./outputs', refiner_root=None,
                         **kw):
                calls[tag, 'init'] = dict(root=root, clip_root=clip_root,
                                          scheduler=scheduler,
                                          refiner_root=refiner_root, **kw)

            def gen(self, **kw):
                calls[tag, 'gen'] = kw
                img = Image.new('RGB', (8, 8))
                return [img], img
        return FakeXL

    monkeypatch.setattr(jsr, 'SDXLRunner', fake('jax'))
    monkeypatch.setattr(tsr, 'SDXLRunner', fake('port'))
    argv = [a.replace('REF', str(tmp_path)) for a in argv]
    common = ['generate', '--model-family', 'sdxl', '--models', root,
              '--prompt', 'a deer', '--steps', '2', '--height', '64',
              '--width', '64', '--scheduler', 'dpmpp', *argv]
    assert jcli.main(['--no-compile-cache', *common]) == 0
    assert tcli.main([*common, '--device', 'cpu']) == 0
    port_init = calls['port', 'init']
    assert port_init.pop('device') == torch.device('cpu')
    assert port_init.pop('dtype') == torch.float32
    assert port_init == calls['jax', 'init']
    assert port_init['root'] == root
    assert calls['port', 'gen'] == calls['jax', 'gen']
    assert calls['port', 'gen']['refine_strength'] == (
        0.5 if '--refine-strength' in argv else 0.3)

    with pytest.raises(SystemExit, match='sdxl'):
        tcli.main(['generate', '--model-family', 'sdxl', '--models', root,
                   '--controlnet', '/nope', '--prompt', 'x', '--device',
                   'cpu'])


def test_sdxl_refiner_end_to_end(xl_snapshot, refiner_snapshot,  # noqa: F811
                                 tmp_path_factory):
    """Base → refiner on the latents: JAX's image within one level; the
    refiner changes the output, ``refine_strength=0`` bypasses it, and the
    refiner pipe on ``sdxl_refiner_guidance`` gives JAX's latents, where
    the aesthetic scores show."""
    root, vocab = xl_snapshot
    jr, tr = _pair(root, vocab, str(tmp_path_factory.mktemp('xl_ref_out')),
                   refiner=refiner_snapshot)
    assert tr.refiner_pipe is not None
    common = dict(prompt='a deer', steps=3, init_size=SIZE, samples=1,
                  seed=3, save=False)
    jimgs, refined = _gen_both(jr, tr, refine_strength=0.5, **common)
    assert len(refined) == 1 and refined[0].size == SIZE
    _within_one_level(jimgs, refined)
    base_only, _ = tr.gen(refine_strength=0.0, **common)
    assert np.abs(_u8(refined[0]) - _u8(base_only[0])).max() > 0
    # The refiner pipe on ``sdxl_refiner_guidance``: its latents equal
    # JAX's within ATOL on the same init latents and noise (the effect is
    # below one uint8 level in fp32 on the tiny snapshot), and swapping the
    # aesthetic scores (6.0 and 2.5) moves them by more than twice that.
    from flexdiffuse_tpu.models.sdxl import sdxl_refiner_guidance as jrg
    from flexdiffuse_tpu_torch.models.sdxl import sdxl_refiner_guidance
    init = np.random.default_rng(17).normal(size=(1, 32, 32, 4)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.split(key, 4)[2], init.shape, jnp.float32)))
    lat = {}
    for a, n in ((6.0, 2.5), (2.5, 6.0)):
        kw = dict(size=SIZE, aesthetic_score=a, negative_aesthetic_score=n)
        lat[a] = tr.refiner_pipe(
            sdxl_refiner_guidance(tr.text, 'a deer', '', 5.0, **kw), steps=3,
            init_latents=torch.from_numpy(init), strength=0.5,
            output_type='latent', noise=noise).images.numpy()
        want = jr.refiner_pipe(jrg(jr.text, 'a deer', '', 5.0, **kw),
                               steps=3, init_latents=jnp.asarray(init),
                               strength=0.5, output_type='latent', key=key)
        np.testing.assert_allclose(lat[a], np.asarray(want['images']),
                                   rtol=0, atol=ATOL)
    assert np.abs(lat[6.0] - lat[2.5]).max() > 2 * ATOL


def test_ui_serves_sdxl_runner(runners):
    """The web UI over HTTP with an SDXLRunner behind it: generate works,
    compose returns the SD-1.x-only error as a JSON 500."""
    from flexdiffuse_tpu_torch.interface import server as ui_server
    tr = runners[1]
    ui_server._runner = None
    httpd = ui_server.launch(lambda: tr, lan=False, port=0)
    port = httpd.server_address[1]
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f'http://127.0.0.1:{port}'
        payload = {'prompt': 'a deer', 'steps': 2, 'samples': 1,
                   'height': 64, 'width': 64, 'seed': 5,
                   'refine_strength': 0.3}
        req = urllib.request.Request(
            url + '/api/generate', json.dumps(payload).encode(),
            {'Content-Type': 'application/json'})
        with urllib.request.urlopen(req) as r:
            out = json.loads(r.read())
        assert out['images']
        req = urllib.request.Request(
            url + '/api/compose', json.dumps({'bg_prompt': 'x'}).encode(),
            {'Content-Type': 'application/json'})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req)
        assert exc.value.code == 500
        assert 'SDXL' in json.loads(exc.value.read())['error']
    finally:
        httpd.shutdown()
        httpd.server_close()
        ui_server._runner = None
