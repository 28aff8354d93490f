"""The SDXL configuration and its cell: the reference's weights against the
port's at the published sizes, the reference against the port's fp32 CPU
path at a tiny SDXL, the per-level kernel counts, the cell's definition,
and a tiny copy of the cell run end to end on the CPU with its control."""
import os

import pytest
import torch

from bench_h100 import build, build_sdxl, harness, seeded, work, work_sdxl
from bench_h100.reference import dpmpp
from bench_h100.reference import sdxl as ref_sdxl
from bench_h100.tests import tiny

CELL = 'sdxl-1024.gen'
TINY_CELL = 'tinyxl.gen'
TINY_TEXT2 = dict(vocab_size=1000, hidden_size=24, num_layers=2,
                  num_heads=4, intermediate_size=48, projection_dim=24,
                  eos_token_id=999)
TINY_UNET = dict(block_channels=[32, 32, 64], layers_per_block=1,
                 attention_levels=[False, True, True],
                 transformer_depth=[0, 1, 2], head_dim=16,
                 cross_attention_dim=32 + 24, norm_groups=8,
                 addition_pooled_dim=24)
# The port's fp32 CPU path and the reference differ by summation order
# only: a few ulps through the tiny UNet, more through three sampler steps
# that divide by α ≈ 0.07 at the first. Dropping the added embedding or the
# pooled input moves ε by 1e-2 or more at these weights.
EPS_TOL = 1e-4
LATENT_TOL = 1e-3


def _config(name='sdxl-1024'):
    return tiny._read(os.path.join(tiny.REPO, 'bench_h100', 'configs',
                                   f'{name}.json'))


def _tiny_config():
    cfg = _config()
    cfg.update(name='tinyxl', dtype='float32', resolution=64)
    cfg['text'].update(tiny.TINY_TEXT)
    cfg['text2'].update(TINY_TEXT2)
    cfg['unet'].update(TINY_UNET)
    cfg['vae'].update(tiny.TINY_VAE)
    return cfg


def _ops(cfg, seed):
    return build_sdxl.reference_ops(cfg, seed, 'cpu')


@pytest.mark.parametrize('part', build_sdxl.PARTS)
def test_reference_weights_exist_in_the_port(part):
    cfg = _config()
    spec = build.port_spec(build_sdxl.factories(cfg)[part])
    ref = build_sdxl.reference_spec(cfg, part)
    build.check_spec(spec, ref, part)
    if part == 'unet':
        assert sum(torch.Size(s).numel() for s in spec.values()) == \
            2_567_463_684
        assert ref['add_embedding.linear_1.weight'] == (1280, 2816)
    if part == 'text2':
        assert ref['text_projection.weight'] == (1280, 1280)


def test_configuration_is_the_ports_sdxl_preset():
    from flexdiffuse_tpu_torch.models import configs
    cfg = _config()
    assert build.port_config(configs.UNetConfig, cfg['unet']) == \
        configs.SDXL_UNET
    assert build.port_config(configs.CLIPTextConfig, cfg['text']) == \
        configs.CLIP_VIT_L14_TEXT
    assert build.port_config(configs.CLIPTextConfig, cfg['text2']) == \
        configs.OPENCLIP_BIGG_TEXT
    assert build.port_config(configs.VAEConfig, cfg['vae']) == \
        configs.SDXL_VAE
    assert cfg['vae']['latent_scale'] == 0.13025 and cfg['reduced'] == []


def test_second_tokenizer_ids():
    from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
    tok = FakeTokenizer(49408)
    for words in (0, 8, 75, 80):
        p = seeded.prompt(seeded.rng(5, 'p'), words)
        assert build_sdxl.token_ids_2(p, 49408) == \
            tok(p, pad_id=0)[0].tolist()


def test_text_towers_against_the_port():
    from flexdiffuse_tpu_torch.models.sdxl import SDXLTextEncoder
    from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
    cfg = _tiny_config()
    enc = SDXLTextEncoder(build_sdxl.build_part(cfg, 'text', 4, 'cpu'),
                          build_sdxl.build_part(cfg, 'text2', 4, 'cpu'),
                          FakeTokenizer(1000))
    prompts = ['a red fox in the snow', '']
    ids = torch.tensor([seeded.token_ids(p, 1000) for p in prompts])
    ids2 = torch.tensor([build_sdxl.token_ids_2(p, 1000) for p in prompts])
    with torch.no_grad():
        want_ctx, want_pooled = enc.encode(prompts)
        ctx, pooled = ref_sdxl.encode(_ops(cfg, 4), cfg, ids, ids2)
    torch.testing.assert_close(ctx, want_ctx, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pooled, want_pooled, rtol=1e-5, atol=1e-5)


def _unet_inputs():
    g = torch.Generator().manual_seed(0)
    return dict(x=torch.randn((2, 16, 16, 4), generator=g),
                t=torch.tensor([981.0, 1.0]),
                ctx=torch.randn((2, 77, 56), generator=g),
                pooled=torch.randn((2, 24), generator=g),
                tids=ref_sdxl.micro_ids(64, 2, 'cpu'))


def test_unet_against_the_port(monkeypatch):
    cfg = _tiny_config()
    port = build_sdxl.build_part(cfg, 'unet', 6, 'cpu')
    ops = _ops(cfg, 6)
    a = _unet_inputs()
    added = {'text_embeds': a['pooled'], 'time_ids': a['tids']}

    def ref(pooled):
        return ref_sdxl.unet_forward(ops, cfg['unet'], a['x'], a['t'],
                                     a['ctx'], pooled, a['tids'])
    with torch.no_grad():
        want = port(a['x'], a['t'], a['ctx'], added_cond=added)
        got = ref(a['pooled'])
        no_pooled = ref(torch.zeros_like(a['pooled']))
        monkeypatch.setattr(ref_sdxl, 'added_embedding',
                            lambda ops, cfg, p, ids, dim: 0.0)
        no_added = ref(a['pooled'])
    torch.testing.assert_close(got, want, rtol=EPS_TOL, atol=EPS_TOL)
    for dropped in (no_pooled, no_added):
        assert float((dropped - want).abs().max()) > 100 * EPS_TOL


def test_three_dpmpp_steps_against_the_port():
    from flexdiffuse_tpu_torch.models.sdxl import (SDXLTextEncoder,
                                                   sdxl_guidance)
    from flexdiffuse_tpu_torch.schedulers import SchedulerConfig
    from flexdiffuse_tpu_torch.sdxl_runner import SDXLRunner
    from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
    cfg = _tiny_config()
    parts = {k: build_sdxl.build_part(cfg, k, 8, 'cpu')
             for k in build_sdxl.PARTS}
    text = SDXLTextEncoder(parts['text'], parts['text2'], FakeTokenizer(1000))
    sc = build.port_config(SchedulerConfig, cfg['scheduler'])
    runner = SDXLRunner.from_models(parts['unet'], parts['vae'], text,
                                    scheduler=sc.kind, scheduler_config=sc)
    noise = torch.randn((1, 16, 16, 4),
                        generator=torch.Generator().manual_seed(2))
    prompt, negative, scale = 'a lantern in the rain at night', 'blurry', 5.0
    with torch.no_grad():
        g = sdxl_guidance(text, prompt, negative, scale, size=(32, 32))
        want = runner.pipe(g, steps=3, init_size=(32, 32), noise=noise,
                           output_type='latent').images
        ops = _ops(cfg, 8)
        ids = lambda p, fn: torch.tensor([fn(p, 1000)])
        ctx, pooled = ref_sdxl.encode(
            ops, cfg, torch.cat([ids(negative, seeded.token_ids),
                                 ids(prompt, seeded.token_ids)]),
            torch.cat([ids(negative, build_sdxl.token_ids_2),
                       ids(prompt, build_sdxl.token_ids_2)]))
        tids = ref_sdxl.micro_ids(32, 2, 'cpu')

        def model(x, t):
            out = ref_sdxl.unet_forward(ops, cfg['unet'], torch.cat([x, x]),
                                        torch.full((2,), float(t)), ctx,
                                        pooled, tids)
            u, c = out.chunk(2)
            return u + scale * (c - u)
        got = dpmpp.sample(model, noise, 3, cfg['scheduler'])
    torch.testing.assert_close(got, want, rtol=LATENT_TOL, atol=LATENT_TOL)


def test_dpmpp_timesteps_are_the_ports():
    from flexdiffuse_tpu_torch.schedulers import SchedulerConfig, make
    cfg = _config()
    sc = build.port_config(SchedulerConfig, cfg['scheduler'])
    port = make(sc.kind, 25, sc).timesteps.numpy()
    ref = dpmpp.timesteps(cfg['scheduler'], 25)
    assert port.tolist() == ref.astype(float).tolist()
    assert ref[0] == 999 and ref[-1] == 40 and len(ref) == 25


def test_kernel_counts_per_call():
    import chip_smoke
    cfg = _config()
    calls = work_sdxl.unet_flash_calls(cfg['unet'], 2, 128, 128)
    assert len(calls) == chip_smoke.K1_SDXL['base'] == 70
    assert calls.count((2, 10, 4096, 64)) == 10
    assert calls.count((2, 20, 1024, 64)) == 60
    assert len(work.unet_group_norms(cfg['unet'], 2, 128, 128)) == \
        chip_smoke.K6_SDXL['base'][0] == 46
    assert len(work.vae_decode_group_norms(cfg['vae'], 1, 128, 128)) == \
        chip_smoke.K6_SDXL['decode'][0] == 30
    # A 1024² row: 6.76 TFLOP, three times SD-2.1's at 768².
    assert work_sdxl.unet_flops(cfg['unet'], 128, 128) / 1e12 == \
        pytest.approx(6.761, rel=1e-3)


def test_cell_definition():
    d = harness.load_definition(CELL, tiny.REPO)
    assert d.workload['traffic'] == 'closed_loop_sdxl'
    assert [m['name'] for m in d.end_to_end] == ['images_per_s',
                                                 'peak_mem_gib', 'setup_s']
    names = sorted(m['name'] for m in d.per_layer)
    # The gen cell's readers where SD's and SDXL's readings are the same;
    # K1's per-level count and the encodes' idle are SDXL's own.
    assert names == sorted(
        [f'{n}.gen' for n in ('mfu', 'unet_ms_per_row',
                              'vae_decode_ms_per_image', 'k6_roofline',
                              'device_idle_pct', 'unet_idle_pct',
                              'loop_idle_pct', 'edge_idle_pct',
                              'client_idle_pct', 'kernel_launch_us',
                              'unet_graph_pct')] +
        ['k1_roofline.xl', 'encode_idle_pct.xl'])
    for m in d.per_layer:
        harness.metric_reader(m['name'], tiny.REPO)


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    """The tiny checkout with a tiny SDXL configuration and cell added."""
    root = tiny.make_root(str(tmp_path_factory.mktemp('benchxl')))
    data = os.path.join(root, 'bench_h100')
    tiny._write(os.path.join(data, 'configs', 'tinyxl.json'), _tiny_config())
    w = tiny._read(os.path.join(data, 'workloads', f'{CELL}.json'))
    w['config'] = 'tinyxl'
    # On the CPU no event follows the last traced call's fd.gen span, so
    # the hull needs two traced calls; one call on each side of them is
    # left for mfu (a tiny call takes about a second under the profiler).
    w['params'].update(size=64, steps=4, trace_start_s=0.1,
                       trace_stop_s=2.6)
    tiny._write(os.path.join(data, 'workloads', f'{TINY_CELL}.json'), w)
    path = os.path.join(root, 'BENCHMARK.json')
    bench = tiny._read(path)
    bench['workloads'].append({'name': TINY_CELL, 'config': 'tinyxl',
                               'traffic': w['mix'], 'chips': 1,
                               'why': 'the CPU tests'})
    for m in bench['end_to_end'] + bench['per_layer']:
        if CELL in m.get('workloads', []):
            m['workloads'].append(TINY_CELL)
    tiny._write(path, bench)
    return root


@pytest.mark.parametrize('trace', [0, 1])
def test_tiny_cell_end_to_end(root, trace):
    rc, last, err = tiny.run_cell(root, TINY_CELL, seconds=4.0, trace=trace)
    assert rc == 0, err[-2000:]
    assert last['correct'] is True, err[-2000:]
    assert last['failed'] == 0 and last['attempted'] >= 1
    # 8-bit rounding alone reads 1/(255·√12) ≈ 0.0011.
    assert last['checks']['image_rms']['value'] < 2e-3
    got = set(last['metrics'])
    if not trace:
        assert got == {'images_per_s', 'peak_mem_gib', 'setup_s'}
        return
    # No CUDA kernel on the CPU: the kernel shares and the device times
    # have nothing to read.
    # No CUDA graph either: every UNet call is eager by 'device'.
    assert got == {'mfu.gen', 'device_idle_pct.gen', 'unet_idle_pct.gen',
                   'loop_idle_pct.gen', 'edge_idle_pct.gen',
                   'client_idle_pct.gen', 'unet_graph_pct.gen',
                   'encode_idle_pct.xl'}, err[-2000:]
    assert last['metrics']['unet_graph_pct.gen']['value'] == 0.0
    assert last['metrics']['mfu.gen']['value'] > 0


def test_fp8_control_fails_where_the_program_passes(root):
    from bench_h100.traffic import RunContext
    from bench_h100.traffic import closed_loop_sdxl
    d = harness.load_definition(TINY_CELL, root)
    outcome = closed_loop_sdxl.run(RunContext(d, 2**31 + 77, 1.0, False,
                                              torch.device('cpu'), root))
    checks = {c.name: c for c in outcome.check(control=True)}
    assert checks['image_rms'].ok
    assert not checks['control_image_rms'].ok
