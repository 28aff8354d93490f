"""PyTorch port: the flash-attention path and tile choosers
(``ops/flash_attention.plan`` for K1/K3, ``ops/flash_backward.plan_backward``
for K4/K5) and the dispatcher's routing rule (``ops/attention.route``), on
the CPU. A chooser decides, from the dtype, the shape and the alignment
alone and before any launch, whether a kernel runs on the Hopper path
('sm90': TMA, wgmma, warp specialisation; bf16 and fp16) or on the kept
mma.sync kernel ('mma'; fp32 too); K1's also says with which tiles. The
routing rule decides from the shapes, the device type and the backend
whether a call reaches the kernels at all.
"""
import pytest
import torch

from flexdiffuse_tpu_torch.ops import attention as attn
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
    q, k, v, dout = (torch.randn((1, 2, 64, 40)) for _ in range(4))
    fa.flash_attention(q, k, v, 0.1)
    o, lse = fb.flash_attention_lse(q, k, v, 0.1)
    dvec = fb.attention_delta(dout, o)
    fb.flash_attention_dq(q, k, v, dout, lse, dvec, 0.1)
    fb.flash_attention_dkv(q, k, v, dout, lse, dvec, 0.1)
    counts = perf_experiment.kernel_counts()
    assert counts == dict(k1=0, k3=0, k4=0, k5=0, k6=0, k1_sm90=0, k1_mma=0,
                          k3_sm90=0, k3_mma=0, k4_sm90=0, k4_mma=0,
                          k5_sm90=0, k5_mma=0, k6_resident=0, k6_stream=0)


BWD_KINDS = ['dq', 'dkv']


def _bwd_tensors(shape, skv=None, dtype=BF16):
    """q, k, v, dO and the outputs of both kernels (dq; dk, dv)."""
    q, k, v = _qkv(shape, skv, dtype)
    return q, k, v, torch.empty_like(q), torch.empty_like(q), \
        torch.empty_like(k), torch.empty_like(v)


def _bwd_plan(kind, tensors, path=None):
    q, k, v, dout, dq, dk, dv = tensors
    outs = (dq,) if kind == 'dq' else (dk, dv)
    return fb.plan_backward(kind, q, k, v, dout, *outs, path=path)


@pytest.mark.parametrize('kind', BWD_KINDS)
@pytest.mark.parametrize('shape', MAIN_SHAPES)
def test_backward_main_path_shapes_take_the_hopper_path(shape, kind):
    """Every shape the training path gives K4/K5 (and K1's) takes the
    Hopper path at its padded head width."""
    how = _bwd_plan(kind, _bwd_tensors(shape))
    assert how == fb.Plan(kind, 'sm90', {40: 48, 80: 80}[shape[-1]])


@pytest.mark.parametrize('d', range(8, 129, 8))
@pytest.mark.parametrize('dtype', [BF16, F16])
@pytest.mark.parametrize('kind', BWD_KINDS)
def test_backward_every_aligned_width_has_a_hopper_configuration(
        kind, dtype, d):
    """Every d % 8 == 0 from 8 to 128 takes the Hopper path in both dtypes
    at its padded width (Sq = 300, Skv = 77)."""
    how = _bwd_plan(kind, _bwd_tensors((2, 3, 300, d), 77, dtype))
    assert (how.path, how.head_pad) == ('sm90', -(-d // 16) * 16)


@pytest.mark.parametrize('kind', BWD_KINDS)
@pytest.mark.parametrize('d', [33, 100, 4, 127])
def test_backward_head_dims_tma_cannot_stride_take_the_kept_kernels(d, kind):
    how = _bwd_plan(kind, _bwd_tensors((1, 3, 200, d), 237))
    assert how == fb.Plan(kind, 'mma', -(-d // 16) * 16)
    with pytest.raises(ValueError):
        _bwd_plan(kind, _bwd_tensors((1, 3, 200, d), 237), path='sm90')


@pytest.mark.parametrize('which', range(7))
def test_backward_misaligned_pointer_takes_the_kept_kernels(which):
    """Any of q, k, v, dO or an output one element off 16-byte alignment:
    both kernels take the kept path (the output of the other kernel does
    not count), and 'sm90' cannot be forced."""
    tensors = list(_bwd_tensors((1, 2, 64, 40)))
    base = torch.empty(tensors[which].numel() + 1, dtype=BF16)
    tensors[which] = base[1:].view(tensors[which].shape)
    assert tensors[which].data_ptr() % 16 != 0
    for kind in BWD_KINDS:
        outs = {'dq': (4,), 'dkv': (5, 6)}[kind]
        expect = 'mma' if which < 4 or which in outs else 'sm90'
        assert _bwd_plan(kind, tensors).path == expect
        if expect == 'mma':
            with pytest.raises(ValueError):
                _bwd_plan(kind, tensors, path='sm90')


@pytest.mark.parametrize('kind', BWD_KINDS)
def test_backward_forced_path_and_configuration(kind):
    """'mma' forces the kept kernel on inputs the Hopper path takes; 'sm90'
    is what the chooser picks there anyway; no other path or kind
    exists."""
    tensors = _bwd_tensors((4, 8, 1024, 80), dtype=F16)
    assert _bwd_plan(kind, tensors, path='mma') == fb.Plan(kind, 'mma', 80)
    assert _bwd_plan(kind, tensors, path='sm90') == _bwd_plan(kind, tensors)
    with pytest.raises(ValueError):
        _bwd_plan(kind, tensors, path='tma')
    with pytest.raises(ValueError):
        fb.plan_backward('dk', *tensors[:4])


@pytest.mark.parametrize('kind', BWD_KINDS + ['fwd'])
@pytest.mark.parametrize('shape', MAIN_SHAPES + [(1, 8, 4096, 40)])
def test_fp32_takes_the_kept_kernels(shape, kind):
    """fp32 q/k/v at the main shapes, aligned and d % 8 == 0: every kernel
    takes its kept path (the Hopper path takes 16 bits), and 'sm90' cannot
    be forced; the same shapes in bf16 take 'sm90'."""
    tensors = _bwd_tensors(shape, dtype=torch.float32)
    plan = (lambda ts, path=None: fa.plan(*ts[:3], path=path)) \
        if kind == 'fwd' else (lambda ts, path=None:
                               _bwd_plan(kind, ts, path))
    assert plan(tensors).path == 'mma'
    with pytest.raises(ValueError):
        plan(tensors, path='sm90')
    assert plan(_bwd_tensors(shape)).path == 'sm90'


# The dispatcher's routing rule (ops/attention.route): shapes, device type
# and backend alone; no dtype, as in the reference.
ELIGIBLE = ((2, 8, 4096, 40), (2, 8, 4096, 40))
CROSS = ((2, 8, 4096, 40), (2, 8, 77, 40))


@pytest.mark.parametrize('device,backend,want', [
    ('cuda', 'auto', 'flash'),
    ('cpu', 'auto', 'plain'),
    ('cuda', 'plain', 'plain'),
    ('cpu', 'plain', 'plain'),
    ('cuda', 'flash', 'flash'),
    ('cpu', 'flash', 'flash'),                   # the wrappers' twins
])
def test_route_by_device_and_backend(device, backend, want):
    assert attn.route(*ELIGIBLE, device, backend) == want


@pytest.mark.parametrize('backend', ['auto', 'plain', 'flash'])
@pytest.mark.parametrize('shapes', [CROSS, ((1, 8, 1000, 40),) * 2,
                                    ((1, 8, 1024, 160),) * 2])
def test_route_ineligible_shapes_run_plain(shapes, backend):
    """Cross attention over 77 tokens, a sequence not divisible by 128, a
    head wider than 128: plain under every backend and device."""
    for device in ('cuda', 'cpu'):
        assert attn.route(*shapes, device, backend) == 'plain'


def test_route_is_what_attention_takes_on_the_cpu(monkeypatch):
    """attention() follows route(): under 'flash' a CPU call reaches the
    kernels' wrappers (K1 without grad), under 'auto' it runs
    plain_attention, and an ineligible shape runs it under 'flash'."""
    taken = []
    monkeypatch.setattr(attn, 'flash_attention',
                        lambda *a: taken.append('k1') or a[0])
    monkeypatch.setattr(attn, 'plain_attention',
                        lambda *a: taken.append('plain') or a[0])
    q = torch.zeros((1, 1, 1024, 8))
    attn.attention(q, q, q)
    attn.attention(q, q, q, backend='flash')
    attn.attention(q[:, :, :77], q, q, backend='flash')
    assert taken == ['plain', 'k1', 'plain']
