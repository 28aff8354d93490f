"""The work counters against hand-computed values."""
import json
import os

import pytest

from bench_h100 import work

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _config(name):
    with open(os.path.join(REPO, 'bench_h100', 'configs',
                           f'{name}.json')) as f:
        return json.load(f)


def test_k1_bound_at_the_main_shape():
    # 4·2·8·4096²·40 = 42.95 GFLOP at 989 TFLOP/s; 4·2·8·4096·40·2 bytes
    # = 21 MB at 3.35 TB/s is less.
    f, n = work.k1_work(2, 8, 4096, 40)
    assert f == 4 * 2 * 8 * 4096**2 * 40
    assert n == 4 * 2 * 8 * 4096 * 40 * 2
    assert work.bound(f, n) * 1e3 == pytest.approx(0.0434, abs=5e-5)


@pytest.mark.parametrize('fn,ms', [(work.k3_work, 0.0869),
                                   (work.k4_work, 0.1303),
                                   (work.k5_work, 0.1737)])
def test_backward_bounds(fn, ms):
    # The kernel table's bounds at (4,8,4096,40): K3 as K1, K4 1.5×,
    # K5 2×.
    assert work.bound(*fn(4, 8, 4096, 40)) * 1e3 == pytest.approx(
        ms, abs=1e-4)


def test_k4_k5_bytes():
    b, h, s, d = 1, 1, 128, 64
    assert work.k4_work(b, h, s, d)[1] == (5 * 2 * d + 8) * s
    assert work.k5_work(b, h, s, d)[1] == (6 * 2 * d + 8) * s


@pytest.mark.parametrize('shape,ms', [((2, 320, 64, 64), 0.00313),
                                      ((2, 1280, 8, 8), 0.000196)])
def test_group_norm_bound_is_bytes(shape, ms):
    b, c, hh, ww = shape
    n = b * c * hh * ww
    assert work.gn_work(*shape) == (10 * n, 4 * n)
    assert work.gn_bound(*shape) * 1e3 == pytest.approx(ms, rel=2e-3)


def test_sd14_calls_per_evaluation():
    u = _config('sd14-512')['unet']
    calls = work.unet_flash_calls(u, 2, 64, 64)
    assert sorted(set(calls)) == [(2, 8, 1024, 80), (2, 8, 4096, 40)]
    assert calls.count((2, 8, 4096, 40)) == 5
    assert calls.count((2, 8, 1024, 80)) == 5
    assert len(work.unet_group_norms(u, 2, 64, 64)) == 61
    v = _config('sd14-512')['vae']
    assert len(work.vae_decode_group_norms(v, 1, 64, 64)) == 30


def test_sd21_calls_per_evaluation():
    u = _config('sd21-768')['unet']
    calls = work.unet_flash_calls(u, 4, 96, 96)
    assert sorted(set(calls)) == [(4, 5, 9216, 64), (4, 10, 2304, 64)]
    assert len(calls) == 10


def test_group_norm_shapes_follow_the_unet():
    u = _config('sd14-512')['unet']
    shapes = work.unet_group_norms(u, 1, 64, 64)
    assert shapes[0] == (1, 320, 64, 64)             # first resnet's norm1
    assert (1, 2560, 8, 8) in shapes                 # mid + skip at 8×8
    assert (1, 640, 64, 64) in shapes                # 320 + 320 skip
    assert shapes[-1] == (1, 320, 64, 64)            # conv_norm_out


def test_model_flops_on_the_meta_device():
    c = _config('sd14-512')
    # About 0.8 TFLOP a 512² UNet row, 2.5 a decode.
    assert work.unet_flops(c['unet'], 64, 64) / 1e12 == pytest.approx(
        0.803, rel=0.01)
    assert work.vae_flops(c['vae'], 64, 64) / 1e12 == pytest.approx(
        2.51, rel=0.01)
    assert work.unet_flops(c['unet'], 64, 64, b=2) == pytest.approx(
        2 * work.unet_flops(c['unet'], 64, 64))


def test_mfu():
    assert work.mfu(989e12, 1.0) == pytest.approx(100.0)
    assert work.mfu(989e12, 4.0) == pytest.approx(25.0)
