"""PyTorch port: IP-Adapter (``flexdiffuse_tpu_torch/models/ip_adapter.py``,
the UNet's ``to_k_ip``/``to_v_ip``) and the vision tower's 'pooled' and
'penultimate' outputs, held against the JAX package on the CPU in fp32,
mirroring ``tests/test_ip_adapter.py``.

(a) The vision tower's three outputs, the IP cross-attention at
    ``ip_scale`` 0 and 1 and both image-projection heads
    (``ImageProjection``; the perceiver ``Resampler`` with its split
    ``1/√√d`` scale) match JAX within ATOL; at scale 0 the IP UNet equals
    the base UNet exactly.
(b) On the official key layouts (base and Plus, odd ``ip_adapter``
    indices): ``attn2_layer_order``, ``convert_ip_layers``,
    ``build_image_proj``, ``convert_ip_adapter`` and ``merge_ip_weights``
    give what JAX gives, on the port's module names; FaceID and
    mismatched geometries are refused as JAX refuses them.
(c) The pipeline with image tokens (CFG, PAG's three rows, the CFG
    interval's one-row evaluations) matches JAX's loop: latents within 1e-4
    and uint8 images within one level (ROADMAP Queue 3's golden-loop
    allowance).
(d) ``Runner.load_ip_adapter`` on an official-style nested ``.bin`` and
    ``gen(ip_embed=)`` (base and Plus) match the JAX Runner; ``ip_image``
    runs the loaded image encoder.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu.models import SD14_UNET as J_SD14_UNET
from flexdiffuse_tpu.models import SDXL_UNET as J_SDXL_UNET
from flexdiffuse_tpu.models import TINY_SDXL_UNET as J_TINY_SDXL_UNET
from flexdiffuse_tpu.models import (TINY_UNET, TINY_VISION, CLIPVisionModel,
                                    UNet2DCondition)
from flexdiffuse_tpu.models import ip_adapter as jipa
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.models import ip_adapter as ipa
from flexdiffuse_tpu_torch.pipeline import FlexPipeline, SimpleGuidance
from flexdiffuse_tpu_torch.utils.image import clip_preprocess
from flexdiffuse_tpu_torch.weights import params_to_state_dict
from tests.test_ip_adapter import _plus_sd
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_protocol import ReplayNoise, runner_pair
from tests.test_torch_slice import (T, D, _compare, _np_tree,  # noqa: F401
                                    models)

ATOL = 1e-4
IP_TINY = dataclasses.replace(TINY_UNET, ip_adapter=True, ip_tokens=4)
T_IP_TINY = dataclasses.replace(tm.TINY_UNET, ip_adapter=True, ip_tokens=4)
WIDTHS = {'down_0_attn_0': 32, 'mid_attn': 64, 'up_1_attn_0': 32,
          'up_1_attn_1': 32}


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _jax_name(path) -> str:
    return ipa._jax_to_module(path)


def _ip_layers(rng, config=TINY_UNET, first=1, step=2, d_ctx=32):
    """Official-style per-layer projections: indices 1, 3, 5, … by
    default."""
    sd = {}
    for n, path in enumerate(jipa.attn2_layer_order(config)):
        d = WIDTHS[path[0]]
        for kv in 'kv':
            sd[f'ip_adapter.{first + step * n}.to_{kv}_ip.weight'] = (
                rng.normal(size=(d, d_ctx)) * 0.1).astype(np.float32)
    return sd


def _base_sd(rng, d_img=32, tokens=4, d_ctx=32):
    sd = {'image_proj.proj.weight':
          rng.normal(size=(tokens * d_ctx, d_img)).astype(np.float32) * 0.2,
          'image_proj.proj.bias':
          rng.normal(size=(tokens * d_ctx,)).astype(np.float32),
          'image_proj.norm.weight':
          rng.normal(size=(d_ctx,)).astype(np.float32),
          'image_proj.norm.bias':
          rng.normal(size=(d_ctx,)).astype(np.float32)}
    sd.update(_ip_layers(rng))
    return sd


def _plus(rng, embed=32):
    sd = _plus_sd(rng, d_ctx=32, embed=embed)
    sd.update(_ip_layers(rng))
    return sd


# --- (a) the modules ---------------------------------------------------------

@pytest.fixture(scope='module')
def vision():
    model = CLIPVisionModel(TINY_VISION)
    params = _np_tree(jax.jit(lambda k: model.init(
        k, jnp.zeros((1, 32, 32, 3))))(jax.random.PRNGKey(3)))
    port = tm.CLIPVisionModel(tm.TINY_VISION).eval()
    port.load_state_dict(params_to_state_dict(params, TINY_VISION),
                         strict=True)
    return model, params, port.requires_grad_(False)


@pytest.mark.parametrize('output,shape', [('patches', (2, 17, 32)),
                                          ('pooled', (2, 32)),
                                          ('penultimate', (2, 17, 32))])
def test_vision_outputs_match_jax(vision, output, shape):
    """'pooled': post-LN and projection of the CLS token only;
    'penultimate': the hidden states before the last layer, which is not
    run. Observed max|Δ| ≈ 1e-6."""
    model, params, port = vision
    px = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(
        np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(px), output=output))
    with torch.no_grad():
        got = port(torch.from_numpy(px), output=output).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match='output'):
        port(torch.from_numpy(px), output='final')


@pytest.fixture(scope='module')
def ip_unet():
    unet = UNet2DCondition(IP_TINY)
    params = _np_tree(jax.jit(lambda k: unet.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, T, D)),
        None, None, jnp.zeros((1, 4, D))))(jax.random.PRNGKey(0)))
    port = tm.UNet2DCondition(T_IP_TINY).eval()
    port.load_state_dict(params_to_state_dict(params, IP_TINY), strict=True)
    base = tm.UNet2DCondition(tm.TINY_UNET).eval()
    base.load_state_dict({k: v for k, v in port.state_dict().items()
                          if '_ip.' not in k}, strict=True)
    return unet, params, port.requires_grad_(False), base


@pytest.mark.parametrize('scale', [0.0, 1.0, 0.6])
def test_ip_cross_attention_matches_jax(ip_unet, scale):
    """``out + ip_scale·attention(q, k_ip, v_ip)`` in every cross-attention.
    At scale 0 the port equals the base UNet (without the IP layers)
    exactly; at 1 the image tokens move ε. Observed max|Δ| ≈ 3e-6."""
    unet, params, port, base = ip_unet
    rng = np.random.default_rng(0)
    lat = rng.normal(size=(2, 8, 8, 4)).astype(np.float32)
    ctx = rng.normal(size=(2, T, D)).astype(np.float32)
    ip = rng.normal(size=(2, 4, D)).astype(np.float32)
    t = np.array([981.0, 21.0], np.float32)
    want = unet.apply(params, *map(jnp.asarray, (lat, t, ctx)), None, None,
                      jnp.asarray(ip), scale)
    with torch.no_grad():
        got = port(*_t(lat, t, ctx), ip_ctx=torch.from_numpy(ip),
                   ip_scale=scale)
        plain = base(*_t(lat, t, ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    if scale == 0.0:
        assert torch.equal(got, plain)
    else:
        assert (got - plain).abs().max() > 1e-3


@pytest.mark.parametrize('kind', ['pooled', 'penultimate'])
def test_image_projection_heads_match_jax(kind):
    """Both packages' ``build_image_proj`` on the same checkpoint, applied to
    the same embeddings: ``ImageProjection`` (4 tokens) and the perceiver
    ``Resampler`` (3 queries, depth 2, erf-gelu). Observed max|Δ| ≈ 1e-6."""
    rng = np.random.default_rng(5)
    sd = _base_sd(rng, d_img=24) if kind == 'pooled' else _plus(rng,
                                                                embed=24)
    jmod, jparams, jtokens, jkind = jipa.build_image_proj(sd, TINY_UNET)
    mod, tokens, got_kind = ipa.build_image_proj(sd, tm.TINY_UNET)
    assert (tokens, got_kind) == (jtokens, jkind) and got_kind == kind
    x = rng.normal(size=(2, 24) if kind == 'pooled' else (2, 7, 24)).astype(
        np.float32)
    want = np.asarray(jmod.apply(jparams, jnp.asarray(x)))
    with torch.no_grad():
        out = mod(torch.from_numpy(x)).numpy()
    assert out.shape == (2, tokens, D)
    np.testing.assert_allclose(out, want, rtol=0, atol=ATOL)
    # The JAX head's tree, bridged, is the port head's state dict.
    bridged = params_to_state_dict(_np_tree(jparams))
    assert bridged.keys() == mod.state_dict().keys()
    for name, p in mod.state_dict().items():
        assert torch.equal(p, bridged[name]), name


# --- (b) the key layouts ------------------------------------------------------

# config: (JAX's, the port's, its number of cross-attentions).
ORDER_CONFIGS = {
    'sd14': (J_SD14_UNET, tm.SD14_UNET, 16),
    'tiny': (TINY_UNET, tm.TINY_UNET, 4),
    # SDXL: 2·2 + 2·10 down, 3·10 + 3·2 up, 10 mid (the 70 layers of the
    # official ip-adapter_sdxl checkpoints).
    'sdxl': (J_SDXL_UNET, tm.SDXL_UNET, 70),
    'tiny_sdxl': (J_TINY_SDXL_UNET, tm.TINY_SDXL_UNET, 8),
}


@pytest.mark.parametrize('config', list(ORDER_CONFIGS))
def test_attn2_layer_order_matches_jax(config):
    """SD-1.x: 6 down, 9 up, then the mid block last (16 layers, as the
    official ip-adapter_sd15 checkpoint); SDXL's 70 in the same order, with
    every block of a deep transformer; the tiny UNets: 4 and 8."""
    jcfg, tcfg, n = ORDER_CONFIGS[config]
    order = ipa.attn2_layer_order(tcfg)
    assert order == [_jax_name(p) for p in jipa.attn2_layer_order(jcfg)]
    assert len(order) == n
    assert order[-1].startswith('mid_block.attentions.0.transformer_blocks.')
    assert order[-1].endswith('.attn2')
    if config == 'sd14':
        assert order[0] == 'down_blocks.0.attentions.0.transformer_blocks.0' \
            '.attn2'
        assert order[6] == 'up_blocks.1.attentions.0.transformer_blocks.0' \
            '.attn2'
    if config == 'sdxl':
        assert order[0] == 'down_blocks.1.attentions.0.transformer_blocks.0' \
            '.attn2'
        assert order[4] == 'down_blocks.2.attentions.0.transformer_blocks.0' \
            '.attn2'
        assert order[24] == 'up_blocks.0.attentions.0.transformer_blocks.0' \
            '.attn2'
        assert order[-1] == 'mid_block.attentions.0.transformer_blocks.9' \
            '.attn2'


@pytest.mark.parametrize('first,step', [(1, 2), (0, 1)])
def test_convert_ip_layers_matches_jax(first, step):
    """Odd official indices and a dense renumbering map to the same layers;
    the port's ``[out, in]`` weights are JAX's kernels transposed."""
    sd = _ip_layers(np.random.default_rng(1), first=first, step=step)
    want = jipa.convert_ip_layers(sd, TINY_UNET)
    got = ipa.convert_ip_layers(sd, tm.TINY_UNET)
    assert len(got) == 2 * len(want)
    for path, leaves in want.items():
        for leaf, node in leaves.items():
            np.testing.assert_array_equal(
                got[f'{_jax_name(path)}.{leaf}.weight'].numpy(),
                np.asarray(node['kernel']).T)
    short = {k: v for k, v in sd.items()
             if not k.startswith(f'ip_adapter.{first + step}.')}
    for fn, cfg in ((ipa.convert_ip_layers, tm.TINY_UNET),
                    (jipa.convert_ip_layers, TINY_UNET)):
        with pytest.raises(ValueError, match='cross-attention layers'):
            fn(short, cfg)


def test_merge_and_convert_match_jax_on_the_base_layout(ip_unet):
    """``convert_ip_adapter`` + ``merge_ip_weights`` into a base UNet's
    state dict, loaded into the IP UNet, equal JAX's merged tree bridged;
    Plus is refused by ``convert_ip_adapter``; a UNet without the layer
    (mismatched geometry) raises ``KeyError``."""
    rng = np.random.default_rng(2)
    sd = _base_sd(rng)
    jproj, jlayers = jipa.convert_ip_adapter(sd, TINY_UNET)
    proj_sd, layers = ipa.convert_ip_adapter(sd, tm.TINY_UNET)
    for name, w in params_to_state_dict(_np_tree(jproj)).items():
        assert torch.equal(proj_sd[name], w), name
    _, params, _, base = ip_unet
    base_tree = _np_tree({'params': {
        k: v for k, v in params['params'].items()}})
    merged = jipa.merge_ip_weights(base_tree, jlayers)
    port = tm.UNet2DCondition(T_IP_TINY)
    port.load_state_dict(ipa.merge_ip_weights(base.state_dict(), layers),
                         strict=True)
    want = params_to_state_dict(_np_tree(merged), IP_TINY)
    got = port.state_dict()
    for name in layers:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())
    with pytest.raises(ValueError, match='base checkpoints only'):
        ipa.convert_ip_adapter(_plus(rng), tm.TINY_UNET)
    with pytest.raises(KeyError, match='geometry'):
        ipa.merge_ip_weights({}, layers)


def test_build_image_proj_refuses_what_jax_refuses():
    """FaceID (neither ``image_proj.proj.weight`` nor ``latents``) with
    JAX's message; a projection or Resampler of another context width."""
    rng = np.random.default_rng(3)
    faceid = {'image_proj.proj.0.weight': np.zeros((8, 8), np.float32),
              'image_proj.norm.weight': np.ones(8, np.float32)}
    for fn, cfg in ((ipa.build_image_proj, tm.TINY_UNET),
                    (jipa.build_image_proj, TINY_UNET)):
        with pytest.raises(ValueError, match='FaceID checkpoints are not '
                                             'supported'):
            fn(faceid, cfg)
    with pytest.raises(ValueError, match='not a multiple'):
        ipa.build_image_proj(_base_sd(rng, tokens=3, d_ctx=20),
                             tm.TINY_UNET)
    with pytest.raises(ValueError, match='Resampler output dim'):
        ipa.build_image_proj(_plus_sd(rng, d_ctx=24), tm.TINY_UNET)


# --- (c) the loop --------------------------------------------------------------

def _ip_guides(seed, **features):
    rng = np.random.default_rng(seed)
    emb = rng.normal(size=(1, T, D)).astype(np.float32)
    unc = rng.normal(size=(1, T, D)).astype(np.float32)
    tok = rng.normal(size=(1, 4, D)).astype(np.float32)
    ip_unc = rng.normal(size=(1, 4, D)).astype(np.float32)
    jf = {k: (jnp.float32(v) if isinstance(v, float) else v)
          for k, v in features.items()}
    jguide = jp.SimpleGuidance(
        embeddings=jnp.asarray(emb), uncond=jnp.asarray(unc),
        guidance_scale=jnp.float32(7.5), ip_tokens=jnp.asarray(tok),
        ip_uncond=jnp.asarray(ip_unc), **jf)
    tguide = SimpleGuidance(
        embeddings=torch.from_numpy(emb), uncond=torch.from_numpy(unc),
        guidance_scale=7.5, ip_tokens=torch.from_numpy(tok),
        ip_uncond=torch.from_numpy(ip_unc), **features)
    return jguide, tguide


LOOPS = [('cfg', {}, {}), ('scale0', dict(ip_scale=0.0), {}),
         ('pag', dict(pag=True, pag_scale=3.0), dict(pag_layers=('mid',))),
         ('cfg_interval', dict(cfg_interval=True, cfg_from=0.0, cfg_to=0.5),
          {})]


@pytest.mark.parametrize('name,features,settings', LOOPS,
                         ids=[c[0] for c in LOOPS])
def test_pipeline_with_ip_tokens_matches_jax(models, ip_unet, name, features,
                                             settings):
    """PNDM, 4 steps, CFG 7.5, the same noise: the uncond rows take
    ``ip_uncond`` (PAG's perturbed row the cond tokens, the interval's
    one-row evaluations the cond tokens only)."""
    unet, params, port, _ = ip_unet
    jpipe = jp.FlexPipeline(unet.clone(**settings), params, models['vae'],
                            models['vae_params'], scheduler='pndm')
    tpipe = FlexPipeline(port.with_settings(**settings), models['port_vae'],
                         scheduler='pndm')
    jguide, tguide = _ip_guides(9, **features)
    noise = np.random.default_rng(10).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    seen = []
    hook = port.register_forward_pre_hook(
        lambda m, args, kw: seen.append(tuple(kw['ip_ctx'].shape)),
        with_kwargs=True)
    jlat = jpipe(jguide, steps=4, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(3),
                 output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise), output_type='latent').images
    hook.remove()
    rows = {'pag': 3}.get(name, 2)
    assert seen[0] == (rows, 4, D)
    if name == 'cfg_interval':
        assert (1, 4, D) in seen
    _compare(jpipe, tpipe, jlat, tlat)


# --- (d) the Runner ----------------------------------------------------------

def _nested(sd):
    """An official ``.bin``'s layout: ``{'image_proj': {...},
    'ip_adapter': {...}}`` of torch tensors."""
    out = {'image_proj': {}, 'ip_adapter': {}}
    for key, value in sd.items():
        head, rest = key.split('.', 1)
        out[head][rest] = torch.from_numpy(np.ascontiguousarray(value))
    return out


@pytest.fixture(scope='module')
def ip_runners(tmp_path_factory):
    out = tmp_path_factory.mktemp('ip_adapter')
    rng = np.random.default_rng(11)
    paths, sds = {}, dict(base=_base_sd(rng), plus=_plus(rng))
    for kind, sd in sds.items():
        paths[kind] = str(out / f'ip-adapter_{kind}.bin')
        torch.save(_nested(sd), paths[kind])
    return out, paths, sds


@pytest.mark.parametrize('kind', ['base', 'plus'])
def test_runner_gen_with_ip_embed_matches_jax(ip_runners, kind):
    """Both Runners load the same nested ``.bin`` (flattened to dotted
    keys); ``gen(ip_embed=, ip_scale=0.8)`` with JAX's initial noise
    replayed: within one uint8 level. Plus without an encoder takes zero
    hidden states as its uncond input, as JAX."""
    out, paths, _ = ip_runners
    jr, tr = runner_pair(str(out))
    jr.load_ip_adapter(paths[kind])
    tr.load_ip_adapter(paths[kind])
    cfg = tr.pipe.unet.config
    assert cfg.ip_adapter and cfg.ip_tokens == (4 if kind == 'base' else 3)
    assert tr._ip.input_kind == ('pooled' if kind == 'base'
                                 else 'penultimate')
    np.testing.assert_allclose(tr._ip.uncond_tokens.numpy(),
                               np.asarray(jr._ip.uncond_tokens), rtol=0,
                               atol=ATOL)
    rng = np.random.default_rng(12)
    emb = rng.normal(size=(32,) if kind == 'base' else (9, 32)).astype(
        np.float32)
    kw = dict(prompt='a deer', ip_embed=emb, ip_scale=0.8, steps=4,
              init_size=(16, 16), seed=13, save=False)
    want, _ = jr.gen(**kw)
    real = tr.pipe
    tr.pipe = ReplayNoise(real, 13)
    try:
        got, _ = tr.gen(**kw)
    finally:
        tr.pipe = real
    diff = np.asarray(got[0]).astype(np.int16) - np.asarray(want[0])
    assert np.abs(diff).max() <= 1
    with pytest.raises(ValueError, match='ip_image requires'):
        tr.gen(prompt='x', ip_image=Image.new('RGB', (8, 8)), steps=1,
               init_size=(16, 16), save=False)


def test_runner_ip_image_runs_the_image_encoder(ip_runners, vision):
    """With ``image_encoder_dir`` (an HF-named vision tower file) the image
    prompt's tokens are the head applied to the encoder's 'pooled' output
    of the CLIP-preprocessed image at the tower's size, as the JAX modules
    compute them; the same Runner without an adapter refuses an image
    prompt."""
    from flexdiffuse_tpu_torch.weights.safetensors import save_file
    out, paths, sds = ip_runners
    jmodel, jparams, port = vision
    enc = str(out / 'encoder.safetensors')
    save_file({k: v.numpy() for k, v in port.state_dict().items()}, enc)
    _, tr = runner_pair(str(out))
    with pytest.raises(ValueError, match='no IP-Adapter'):
        tr.gen(prompt='x', ip_embed=np.zeros(32, np.float32), steps=1,
               init_size=(16, 16), save=False)
    tr.load_ip_adapter(paths['base'], image_encoder_dir=enc,
                       vision_config=tm.TINY_VISION)
    image = Image.fromarray(np.random.default_rng(14).integers(
        0, 256, (40, 48, 3), np.uint8))
    fields = tr._ip.fields(None, image, 0.5)
    px = clip_preprocess(image, 32)
    pooled = jmodel.apply(jparams, jnp.asarray(px), output='pooled')
    jmod, jp_params, _, _ = jipa.build_image_proj(sds['base'], TINY_UNET)
    want = np.asarray(jmod.apply(jp_params, pooled))
    np.testing.assert_allclose(fields['ip_tokens'].numpy(), want, rtol=0,
                               atol=ATOL)
    assert fields['ip_scale'] == 0.5
    images, _ = tr.gen(prompt='a deer', ip_image=image, steps=2,
                       init_size=(16, 16), seed=1, save=False)
    assert images[0].size == (16, 16)
