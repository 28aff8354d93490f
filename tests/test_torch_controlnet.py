"""PyTorch port: ControlNet (``flexdiffuse_tpu_torch/models/controlnet.py``)
held against the JAX package's on the CPU, fp32, one weight set through
``weights/bridge.py`` (the JAX ``ControlNetModel`` initialised, its zero
convolutions and the conditioning embedding's ``conv_out`` given random
non-zero weights so that the branch has an effect).

(a) The residuals (one per UNet skip state and the mid one) and the UNet
    with ``control=``, in full and in DeepCache 'use' (where only the down
    residuals are added, zipped onto the shallow skips): within ATOL.
(b) A zero-initialised ControlNet is an exact no-op; the port's names are
    diffusers' as the JAX converter reads them; ``normalize`` turns a
    linear ``proj_in``/``proj_out`` into the 1×1 conv.
(c) ``FlexPipeline(controlnet=)`` with ``control_image`` (resized to the
    generation's pixels) matches JAX's loop: latents within 1e-4 and uint8
    images within one level (the golden-loop allowance, ROADMAP Queue 3),
    with DeepCache too; ``controlnet_scale`` 0 gives the uncontrolled
    latents exactly; a control image without a controlnet raises.
(d) ``Runner.load_controlnet`` + ``gen(control_image=)`` match the JAX
    Runner with the same weights and JAX's initial noise replayed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import pipeline as jp
from flexdiffuse_tpu.models import TINY_UNET
from flexdiffuse_tpu.models.controlnet import ControlNetModel as JControlNet
from flexdiffuse_tpu.weights import convert as jconvert
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.models.controlnet import (COND_EMBED_CHANNELS,
                                                     ControlNetModel)
from flexdiffuse_tpu_torch.pipeline import FlexPipeline
from flexdiffuse_tpu_torch.weights import convert, params_to_state_dict
from flexdiffuse_tpu_torch.weights.safetensors import save_file
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_protocol import ReplayNoise, runner_pair
from tests.test_torch_slice import (T, D, _compare, _guides,  # noqa: F401
                                    _np_tree, models)

ATOL = 1e-4
# The tiny VAE halves the image once: a two-entry ramp (one stride-2 conv).
RAMP = (8, 16)


def _live(params, seed=7):
    """The ControlNet's zero-initialised convolutions given random weights
    (the JAX test's ``_perturb_zero_convs``)."""
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed)
    root = params['params']
    nodes = [node for name, node in root.items()
             if name.startswith('zero_conv')]
    nodes.append(root['cond_embed']['conv_out'])
    for node in nodes:
        node['kernel'] = (rng.normal(size=node['kernel'].shape) *
                          0.1).astype(np.float32)
    return params


def _port(params):
    net = ControlNetModel(tm.TINY_UNET, cond_channels=RAMP).eval()
    net.load_state_dict(params_to_state_dict(params, TINY_UNET), strict=True)
    return net.requires_grad_(False)


@pytest.fixture(scope='module')
def cn():
    net = JControlNet(TINY_UNET, cond_channels=RAMP)
    zero = jax.jit(lambda k: net.init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, T, D)),
        jnp.zeros((1, 16, 16, 3))))(jax.random.PRNGKey(5))
    params = _live(zero)
    return dict(jax=net, params=params, zero=jax.tree.map(np.asarray, zero),
                port=_port(params))


def _inputs(b=2, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, 8, 8, 4)).astype(np.float32),
            np.array([981.0, 21.0][:b], np.float32),
            rng.normal(size=(b, T, D)).astype(np.float32),
            rng.uniform(size=(b, 16, 16, 3)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).numpy()


def test_bridge_state_dict_loads_strict(cn):
    """Every port parameter comes from the JAX tree and every leaf lands:
    the parameter counts agree."""
    n_jax = sum(np.size(x) for x in jax.tree.leaves(cn['params']))
    assert n_jax == sum(p.numel() for p in cn['port'].parameters())


@pytest.mark.parametrize('scale', [1.0, 0.7])
def test_residuals_match_jax(cn, scale):
    """TINY_UNET (2 levels, 1 layer each, 1 downsample): conv_in + 2 + 1 = 4
    down residuals and the mid one. Observed max|Δ| ≈ 4e-6."""
    lat, t, ctx, cond = _inputs()
    jdown, jmid = cn['jax'].apply(cn['params'], *map(jnp.asarray,
                                                     (lat, t, ctx, cond)),
                                  scale)
    with torch.no_grad():
        down, mid = cn['port'](*_t(lat, t, ctx, cond), scale)
    assert len(down) == len(jdown) == 4
    assert tuple(down[0].shape) == (2, 32, 8, 8)
    for got, want in zip(down + (mid,), tuple(jdown) + (jmid,)):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize('mode', ['off', 'use'])
def test_unet_with_control_matches_jax(models, cn, mode):
    """The UNet adds the residuals to its skips and mid output ('off'), or
    only the down residuals, zipped onto the shallow skips, around a cache
    saved at the same input ('use'). Observed max|Δ| ≈ 2e-6."""
    lat, t, ctx, cond = _inputs(seed=1)
    jcontrol = cn['jax'].apply(cn['params'], *map(jnp.asarray,
                                                  (lat, t, ctx, cond)))
    japply = models['unet'].apply
    jargs = (models['unet_params'], *map(jnp.asarray, (lat, t, ctx)))
    unet = models['port_unet']
    with torch.no_grad():
        control = cn['port'](*_t(lat, t, ctx, cond))
        if mode == 'off':
            want = japply(*jargs, None, jcontrol)
            got = unet(*_t(lat, t, ctx), control=control)
        else:
            _, jcache = japply(*jargs, cache_mode='save')
            want, _ = japply(*jargs, None, jcontrol, deep_cache=jcache,
                             cache_mode='use')
            _, cache = unet(*_t(lat, t, ctx), cache_mode='save')
            got, _ = unet(*_t(lat, t, ctx), control=control,
                          deep_cache=cache, cache_mode='use')
        plain = unet(*_t(lat, t, ctx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert (got - plain).abs().max() > 1e-3       # the residuals engaged


def test_zero_initialised_controlnet_is_an_exact_noop(models, cn):
    lat, t, ctx, cond = _inputs(seed=2)
    zero = _port(cn['zero'])
    unet = models['port_unet']
    with torch.no_grad():
        base = unet(*_t(lat, t, ctx))
        with_cn = unet(*_t(lat, t, ctx), control=zero(*_t(lat, t, ctx,
                                                          cond)))
    assert torch.equal(base, with_cn)


def test_names_are_diffusers_as_the_jax_converter_reads_them(cn):
    """The port's state dict, read by the JAX ``convert_controlnet`` as a
    diffusers checkpoint, gives back the JAX tree leaf for leaf; a linear
    ``proj_in``/``proj_out`` (use_linear_projection) normalises to the
    port's 1×1 conv."""
    sd = {k: v.numpy() for k, v in cn['port'].state_dict().items()}
    got = jax.tree.map(np.asarray, jconvert.convert_controlnet(sd,
                                                               TINY_UNET))
    want = cn['params']['params']
    flat = lambda tree: {jax.tree_util.keystr(p): v for p, v in
                         jax.tree_util.tree_leaves_with_path(tree)}
    assert flat(got).keys() == flat(want).keys()
    for key, value in flat(got).items():
        np.testing.assert_array_equal(value, flat(want)[key], err_msg=key)
    key = 'down_blocks.0.attentions.0.proj_in.weight'
    linear = dict(sd, **{key: sd[key][:, :, 0, 0]})
    norm = convert.normalize(linear, 'controlnet')
    np.testing.assert_array_equal(norm[key].numpy(), sd[key])
    net = ControlNetModel(tm.TINY_UNET, cond_channels=RAMP)
    net.load_state_dict(norm, strict=True)
    assert COND_EMBED_CHANNELS == (16, 32, 96, 256)


def _pipes(models, cn, **kw):
    jpipe = jp.FlexPipeline(models['unet'], models['unet_params'],
                            models['vae'], models['vae_params'],
                            scheduler='pndm', controlnet=cn['jax'],
                            controlnet_params=cn['params'], **kw)
    tpipe = FlexPipeline(models['port_unet'], models['port_vae'],
                         scheduler='pndm', controlnet=cn['port'], **kw)
    return jpipe, tpipe


def _control_image(seed=3, size=(20, 24)):
    """A PIL control image of another size than the generation's pixels
    (20 wide, 24 high): both pipelines resize it to 16²."""
    rng = np.random.default_rng(seed)
    return Image.fromarray(rng.integers(0, 256, size[::-1] + (3,), np.uint8))


@pytest.mark.parametrize('deepcache,batch', [(0, 1), (0, 2), (2, 1)])
def test_pipeline_with_control_image_matches_jax(models, cn, deepcache,
                                                 batch):
    """PNDM, 4 steps (5 UNet rows), CFG 8, the same initial latents; under
    DeepCache 2 the 'use' rows run the full control branch. Latents within
    1e-4, images within one uint8 level (``_compare``)."""
    jpipe, tpipe = _pipes(models, cn, deepcache=deepcache)
    jguide, tguide = _guides(batch=batch, seed=4)
    noise = np.random.default_rng(5).standard_normal(
        (batch, 8, 8, 4)).astype(np.float32)
    image = _control_image()
    calls = []
    hook = cn['port'].register_forward_pre_hook(
        lambda m, args: calls.append(args[0].shape[0]))
    jlat = jpipe(jguide, steps=4, init_size=(16, 16),
                 noise=jnp.asarray(noise), key=jax.random.PRNGKey(2),
                 control_image=image, output_type='latent').images
    tlat = tpipe(tguide, steps=4, init_size=(16, 16),
                 noise=torch.from_numpy(noise), control_image=image,
                 output_type='latent').images
    hook.remove()
    assert calls == [2 * batch] * 5
    _compare(jpipe, tpipe, jlat, tlat)


def test_controlnet_scale_zero_and_refusal(models, cn):
    """Scale 0: the residuals are zeros and the latents equal the
    uncontrolled run's exactly; a control image without a controlnet
    raises ``ValueError``, as in JAX."""
    _, tpipe = _pipes(models, cn)
    _, tguide = _guides(seed=6)
    noise = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    run = lambda pipe, **kw: pipe(tguide, steps=3, init_size=(16, 16),
                                  noise=noise, output_type='latent',
                                  **kw).images
    base = run(tpipe)
    off = run(tpipe, control_image=_control_image(), controlnet_scale=0.0)
    on = run(tpipe, control_image=_control_image())
    assert torch.equal(off, base)
    assert (on - base).abs().max() > 1e-4
    plain = FlexPipeline(models['port_unet'], models['port_vae'])
    with pytest.raises(ValueError, match='controlnet'):
        run(plain, control_image=np.zeros((16, 16, 3), np.float32))


@pytest.fixture(scope='module')
def runner_with_cn(tmp_path_factory, cn):
    """The JAX/port runner pair (tiny golden weights), each with the same
    ControlNet: the JAX one's pipeline built around it, the port's loaded
    from a diffusers-layout safetensors file by ``load_controlnet``."""
    out = tmp_path_factory.mktemp('controlnet')
    jr, tr = runner_pair(str(out))
    jr.pipe = jp.FlexPipeline(jr.pipe.unet, jr.pipe.unet_params, jr.pipe.vae,
                              jr.pipe.vae_params, scheduler='pndm',
                              controlnet=cn['jax'],
                              controlnet_params=cn['params'])
    path = str(out / 'diffusion_pytorch_model.safetensors')
    save_file({k: v.numpy() for k, v in cn['port'].state_dict().items()},
              path)
    tr.load_controlnet(str(out))
    return jr, tr


def test_runner_gen_with_controlnet_matches_jax(runner_with_cn):
    """``gen(control_image=PIL, controlnet_scale=0.8)``: the loaded
    ControlNet (its ramp and channels read from the checkpoint), in fp32 on
    the CPU, through the Runner; within one uint8 level of JAX's image."""
    jr, tr = runner_with_cn
    net = tr.pipe.controlnet
    assert next(net.parameters()).dtype == torch.float32
    assert len(net.controlnet_cond_embedding.blocks) == 2
    kw = dict(prompt='a deer', control_image=_control_image(8),
              controlnet_scale=0.8, steps=4, init_size=(16, 16), seed=11,
              save=False)
    want, _ = jr.gen(**kw)
    real = tr.pipe
    tr.pipe = ReplayNoise(real, 11)
    try:
        got, _ = tr.gen(**kw)
    finally:
        tr.pipe = real
    diff = np.asarray(got[0]).astype(np.int16) - np.asarray(want[0])
    assert np.abs(diff).max() <= 1


def test_rebuilds_carry_the_controlnet(runner_with_cn):
    """FreeU, ToMe, PAG, DeepCache and the tiling keep the ControlNet, as
    the JAX Runner's ``_rebuild_with_unet``."""
    _, tr = runner_with_cn
    net = tr.pipe.controlnet
    for on, off in (('enable_freeu', 'disable_freeu'),
                    ('enable_pag', 'disable_pag'),
                    ('enable_deepcache', 'disable_deepcache'),
                    ('enable_tome', 'disable_tome'),
                    ('enable_vae_tiling', 'disable_vae_tiling')):
        getattr(tr, on)()
        assert tr.pipe.controlnet is net, on
        getattr(tr, off)()
        assert tr.pipe.controlnet is net, off
