"""The plain fp32 reference and the seeded inputs against the port's CPU
path at tiny configurations (the reference itself imports nothing of the
port; these tests do, to hold the two together)."""
import ast
import os

import pytest
import torch

from bench_h100 import build, seeded
from bench_h100.reference import ops as ref_ops
from bench_h100.reference import text as ref_text
from bench_h100.reference import train as ref_train
from bench_h100.reference import unet as ref_unet
from bench_h100.reference import vae as ref_vae
from bench_h100.tests import tiny

REF_DIR = os.path.join(tiny.REPO, 'bench_h100', 'reference')


def _cfg(name):
    cfg = tiny._read(os.path.join(tiny.REPO, 'bench_h100', 'configs',
                                  f'{name}.json'))
    cfg.update(dtype='float32')
    cfg['text'].update(tiny.TINY_TEXT)
    cfg['vae'].update(tiny.TINY_VAE)
    cfg['unet'].update(tiny.TINY_UNET, **(
        dict(head_dim=16) if name == 'sd21-768' else dict(num_heads=2)))
    return cfg


def _pair(cfg, part, seed=5):
    port = build.build_part(cfg, part, seed, 'cpu')
    ops = ref_ops.Ops(ref_ops.Weights(
        build.reference_weights(cfg, part, seed, 'cpu')))
    return port, ops


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(REF_DIR):
        if not name.endswith('.py'):
            continue
        with open(os.path.join(REF_DIR, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or '']
            for m in mods:
                top = m.split('.', 1)[0]
                assert top in ('torch', 'numpy', 'math', 'contextlib',
                               'typing', '__future__', 'bench_h100'), m
                assert not m.startswith('bench_h100') or \
                    m.startswith('bench_h100.reference'), (name, m)


@pytest.mark.parametrize('name', ['sd14-512', 'sd21-768'])
def test_text_tower(name):
    cfg = _cfg(name)
    port, ops = _pair(cfg, 'text')
    ids = torch.tensor([seeded.token_ids('a red fox in the snow', 1000),
                        seeded.token_ids('', 1000)])
    with torch.no_grad():
        want = port(ids)
        got = ref_text.encode(ops, cfg['text'], ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('name', ['sd14-512', 'sd21-768'])
def test_unet(name):
    cfg = _cfg(name)
    port, ops = _pair(cfg, 'unet')
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 16, 4), generator=g)
    t = torch.tensor([981.0, 1.0])
    ctx = torch.randn((2, 77, 32), generator=g)
    with torch.no_grad():
        want = port(x, t, ctx)
        got = ref_unet.forward(ops, cfg['unet'], x, t, ctx)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_vae_decode():
    cfg = _cfg('sd14-512')
    port, ops = _pair(cfg, 'vae')
    z = torch.randn((2, 8, 8, 4), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = torch.clamp(port.decode(z / 0.18215) / 2 + 0.5, 0, 1)
        got = ref_vae.decode(ops, cfg['vae'], z)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_spec_matches_the_port():
    cfg = _cfg('sd14-512')
    for part in build.PARTS:
        spec = build.port_spec(build.factories(cfg)[part])
        build.check_spec(spec, build.reference_spec(cfg, part), part)
    with pytest.raises(ValueError):
        build.check_spec({'a.weight': (2, 3)}, {'a.weight': (3, 2)}, 'x')


def test_weights_are_seeded_and_fan_in_scaled():
    spec = {'a.weight': (64, 256), 'a.bias': (64,), 'n.weight': (64,)}
    w1 = seeded.make_weights(spec, 9, 'x', 'cpu', torch.float32)
    w2 = seeded.make_weights(spec, 9, 'x', 'cpu', torch.float32)
    w3 = seeded.make_weights(spec, 10, 'x', 'cpu', torch.float32)
    assert torch.equal(w1['a.weight'], w2['a.weight'])
    assert not torch.equal(w1['a.weight'], w3['a.weight'])
    assert float(w1['a.weight'].std()) == pytest.approx(1 / 16, rel=0.05)
    assert torch.all(w1['a.bias'] == 0) and torch.all(w1['n.weight'] == 1)
    big = seeded.make_weights(spec, 2**31 + 11, 'x', 'cpu', torch.bfloat16)
    assert big['a.weight'].dtype == torch.bfloat16


def test_frozen_copies_match_the_program():
    from flexdiffuse_tpu_torch.serving.api import row_noise
    from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
    assert torch.equal(seeded.row_noise(2**31 + 5, 0, (4, 4, 4), 'cpu'),
                       row_noise(2**31 + 5, 0, (4, 4, 4), 'cpu'))
    tok = FakeTokenizer(49408)
    for words in (8, 75, 80):
        p = seeded.prompt(seeded.rng(3, 'p'), words)
        assert seeded.token_ids(p, 49408) == tok(p)[0].tolist()
    assert seeded.token_ids('', 49408) == tok('')[0].tolist()
    gen = torch.Generator('cpu').manual_seed(77)
    want = torch.randn((2, 3), generator=gen, dtype=torch.float32)
    assert torch.equal(seeded.generator_noise(77, (2, 3), 'cpu'), want)


def test_draws_keep_the_work_fixed_across_seeds():
    a = seeded.spread(seeded.exp_quantiles(50, 0.3), seeded.rng(1, 's'))
    b = seeded.spread(seeded.exp_quantiles(50, 0.3), seeded.rng(2, 's'))
    assert sorted(a) == sorted(b) and a != b
    assert sum(a) == pytest.approx(50 * 0.3, rel=0.05)


def test_lora_targets_and_step_against_the_port():
    from flexdiffuse_tpu_torch.training import train as training
    cfg = _cfg('sd14-512')
    port = build.build_part(cfg, 'unet', 3, 'cpu')
    targets = ref_train.lora_targets(build.port_spec(
        build.factories(cfg)['unet']))
    assert set(targets) == set(training.lora_targets(port))
    factors = training.init_lora(port, rank=4,
                                 generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for f in factors.values():
            f['up'].normal_(generator=torch.Generator().manual_seed(1))
    merged = training.merge_lora_params(port, factors)
    ops = ref_train.LoraOps(ref_ops.Weights(build.reference_weights(
        cfg, 'unet', 3, 'cpu')), {n: {k: v.detach() for k, v in f.items()}
                                  for n, f in factors.items()})
    for name, (o, i) in targets.items():
        torch.testing.assert_close(ops.w(f'{name}.weight', (o, i)),
                                   merged[f'{name}.weight'])


def test_leaf_gap_rule():
    ref = {'a': 1.0, 'b': 2.0, 'c': 0.0, 'd': 3.0}
    # Median 1.5: 'c' is below a thousandth of it and left out; 'a' is
    # measured against the median.
    assert ref_train.leaf_gap({'a': 1.3, 'b': 2.0, 'c': 9.0, 'd': 3.0},
                              ref) == pytest.approx(0.2)
    assert ref_train.leaf_gap({'a': 0.0, 'b': 0.0, 'c': 0.0, 'd': 0.0},
                              ref) == pytest.approx(1.0)


def test_fp8_rounds_to_three_mantissa_bits():
    x = torch.linspace(-3, 3, 101)
    q = ref_ops.fp8(x)
    rel = ((q - x).abs() / x.abs().clamp(min=1e-3))[x.abs() > 0.1]
    assert float(rel.max()) <= 2**-4 + 1e-6
    assert float((q - x).abs().max()) > 0
