"""PyTorch port: the flash-attention path and tile chooser
(``ops/flash_attention.plan``), on the CPU. The chooser decides, from the
shape and the alignment alone and before any launch, whether K1/K3 run on
the Hopper path ('sm90': TMA, wgmma, warp specialisation) or on the kept
mma.sync kernel ('mma'), and with which tiles.
"""
import pytest
import torch

from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.tools import perf_experiment

BF16, F16 = torch.bfloat16, torch.float16

# Every shape the main path gives K1 (generate, CFG batch 2, and compose,
# batch 4) and K3 (training, batch 4) at 512²: d = 40 at 4096 tokens and
# d = 80 at 1024, bf16, contiguous from ops/attention.py.
MAIN_SHAPES = [(2, 8, 4096, 40), (2, 8, 1024, 80), (4, 8, 4096, 40),
               (4, 8, 1024, 80)]


# The Hopper path's tiles by head width (csrc/flash_attention.cu Tiling):
# three consumer warpgroups of 64 q rows and kv tile 64 up to DP = 64, two
# of kv tile 128 above; 3 K/V stages; one producer warpgroup.
NARROW = dict(block_q=192, block_kv=64, stages=3, threads=512)
WIDE = dict(block_q=128, block_kv=128, stages=3, threads=384)


def _tiles(how):
    return dict(block_q=how.block_q, block_kv=how.block_kv,
                stages=how.stages, threads=how.threads)


def _qkv(shape, skv=None, dtype=BF16):
    b, h, sq, d = shape
    kv = (b, h, sq if skv is None else skv, d)
    return (torch.empty(shape, dtype=dtype), torch.empty(kv, dtype=dtype),
            torch.empty(kv, dtype=dtype))


@pytest.mark.parametrize('shape', MAIN_SHAPES)
def test_main_path_shapes_take_the_hopper_path(shape):
    q, k, v = _qkv(shape)
    how = fa.plan(q, k, v, torch.empty_like(q))
    b, h, sq, d = shape
    assert how.path == 'sm90'
    assert how.head_pad == {40: 48, 80: 80}[d]
    assert _tiles(how) == (NARROW if d == 40 else WIDE)
    assert how.grid == (-(-sq // how.block_q), b * h)
    # 4096 tokens: 22 q tiles of 192 rows; 1024: 8 of 128.
    assert how.grid[0] == {40: 22, 80: 8}[d]


@pytest.mark.parametrize('d,head_pad', [(8, 16), (16, 16), (24, 32), (40, 48),
                                        (64, 64), (80, 80), (96, 96),
                                        (104, 112), (120, 128), (128, 128)])
@pytest.mark.parametrize('dtype', [BF16, F16])
def test_every_aligned_width_has_a_compiled_hopper_configuration(
        d, head_pad, dtype):
    """Every d % 8 == 0 takes the Hopper path, in both dtypes, with the
    tiles of its padded width."""
    q, k, v = _qkv((1, 2, 77, d), 100, dtype)
    how = fa.plan(q, k, v)
    assert (how.path, how.head_pad) == ('sm90', head_pad)
    assert _tiles(how) == (NARROW if head_pad <= 64 else WIDE)
    assert how.grid == (1, 2)


@pytest.mark.parametrize('d', [33, 100, 4, 127])
def test_head_dims_tma_cannot_stride_take_the_kept_kernel(d):
    q, k, v = _qkv((1, 3, 200, d), 237)
    how = fa.plan(q, k, v, torch.empty_like(q))
    assert how.path == 'mma'
    assert _tiles(how) == dict(block_q=64, block_kv=64, stages=1,
                               threads=128)
    assert how.head_pad == -(-d // 16) * 16
    assert how.grid == (4, 3)       # ceil(200 / 64) q tiles, B·H


@pytest.mark.parametrize('which', [0, 1, 2, 3])
def test_a_misaligned_pointer_takes_the_kept_kernel(which):
    q, k, v = _qkv((1, 2, 64, 40))
    out = torch.empty_like(q)
    tensors = [q, k, v, out]
    # A view one element in: a 2-byte offset, so not 16-byte aligned.
    base = torch.empty(q.numel() + 1, dtype=BF16)
    tensors[which] = base[1:].view(q.shape)
    assert tensors[which].data_ptr() % 16 != 0
    assert fa.plan(*tensors).path == 'mma'
    with pytest.raises(ValueError):
        fa.plan(*tensors, path='sm90')


@pytest.mark.parametrize('dtype', [BF16, F16])
def test_forced_path_and_configuration(dtype):
    """'mma' forces the kept kernel on inputs the Hopper path takes;
    'sm90' is what the chooser picks there anyway; no other path exists."""
    q, k, v = _qkv((2, 8, 1024, 80), dtype=dtype)
    kept = fa.plan(q, k, v, path='mma')
    assert (kept.path, kept.grid) == ('mma', (16, 16))
    assert fa.plan(q, k, v, path='sm90') == fa.plan(q, k, v)
    assert fa.plan(q, k, v).grid == (8, 16)
    with pytest.raises(ValueError):
        fa.plan(q, k, v, path='tma')


def test_the_chooser_ignores_the_lse_output():
    """K3's o is bit-equal to K1's only on one plan: the chooser sees the
    shape, dtype and alignment, never whether lse is written."""
    for shape in MAIN_SHAPES:
        q, k, v = _qkv(shape)
        assert fa.plan(q, k, v, torch.empty_like(q)) == fa.plan(q, k, v)


def test_cpu_wrappers_count_no_launch_on_any_path():
    perf_experiment.reset_counts()
    q, k, v = (torch.randn((1, 2, 64, 40)) for _ in range(3))
    fa.flash_attention(q, k, v, 0.1)
    fb.flash_attention_lse(q, k, v, 0.1)
    counts = perf_experiment.kernel_counts()
    assert counts == dict(k1=0, k3=0, k4=0, k5=0, k6=0, k1_sm90=0, k1_mma=0,
                          k3_sm90=0, k3_mma=0)
