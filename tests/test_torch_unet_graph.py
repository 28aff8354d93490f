"""The UNet's CUDA-graph cache (``models/unet_graph.py``): which calls stay
eager and why, first sighting / capture / replay, the weights check, the
LRU bound and the launch counters, on the CPU with a stand-in for the
CUDA graph; and, marked ``cuda``, replays against the eager body on the
card. Run the card's with ``python -m pytest tests/test_torch_unet_graph.py
-m cuda -q --noconftest`` (this file imports no JAX)."""
import contextlib
import copy
import dataclasses
import pickle

import pytest
import torch
from torch import nn

from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.models import unet_graph as ug
from flexdiffuse_tpu_torch.ops import attention as attention_ops
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.pipeline.flex import FlexPipeline
from flexdiffuse_tpu_torch.pipeline.guides import SimpleGuidance

C = tm.TINY_UNET


@dataclasses.dataclass
class FakeGraph:
    """A captured call that replays the body on the static inputs into the
    static output, with the body's host side effects (the launch counters)
    taken back, as a CUDA graph runs no Python."""
    body: object
    static: tuple
    out: torch.Tensor
    replays: int = 0

    def replay(self):
        before = ug.launch_counts()
        self.out.copy_(self.body(*self.static))
        ug.add_launches(ug.launch_delta(before, ug.launch_counts()), -1)
        self.replays += 1


def fake_capture(body, inputs, static, pool):
    out = body(*inputs)
    static_out = body(*static)
    return out, FakeGraph(body, static, static_out), static_out


@pytest.fixture
def unet():
    torch.manual_seed(0)
    return tm.UNet2DCondition(C).eval()


def _inputs(batch=2, side=8, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn((batch, side, side, C.in_channels), generator=g),
            torch.tensor(500.0).expand(batch),
            torch.randn((batch, 7, C.cross_attention_dim), generator=g))


def _fake_cache():
    return ug.GraphCache(capture=fake_capture)


def _run(cache, unet, inputs):
    with torch.no_grad():
        return cache.run(unet, unet._forward, *inputs)


# Each reason a call stays eager, in the order reason() tests them, and how
# a CPU call gets it.
REASONS = {
    'grad': lambda u: (u, {}, torch.enable_grad()),
    'cache_mode': lambda u: (u, {'cache_mode': 'save'}, None),
    'pag': lambda u: (u, {'pag_mask': torch.ones(2)}, None),
    'control': lambda u: (u, {'control': ((), None)}, None),
    'ip': lambda u: (u, {'ip_ctx': torch.zeros(2, 4, 32)}, None),
    'timestep_cond': lambda u: (u, {'timestep_cond': torch.zeros(2, 8)},
                                None),
    # An added_cond that is not SDXL's two tensors.
    'added_cond': lambda u: (u, {'added_cond': {}}, None),
    'tome': lambda u: (u.with_settings(tome=(0.5, 16)), {}, None),
    'freeu': lambda u: (u.with_settings(freeu=(1.5, 1.6, 0.9, 0.2)), {},
                        None),
    'sp': lambda u: (u, {}, attention_ops.sp_scope(object())),
    'device': lambda u: (u, {}, None),
}


@pytest.mark.parametrize('why', sorted(REASONS))
def test_each_reason_keeps_the_call_eager(unet, why, monkeypatch):
    module, kwargs, scope = REASONS[why](unet)
    seen = []
    monkeypatch.setattr(module, '_forward',
                        lambda *a: seen.append(a) or 'x')
    with torch.no_grad(), scope or contextlib.nullcontext():
        assert module(*_inputs(), **kwargs) == 'x'
    assert len(seen) == 1
    # with_settings copies share the cache, so the stats are one.
    assert module.graph_stats is unet.graph_stats
    assert unet.graph_stats == {'captures': 0, 'replays': 0,
                                'eager': {why: 1}}


def test_cpu_unet_stays_eager_and_unchanged(unet):
    inputs = _inputs()
    with torch.no_grad():
        got = [unet(*inputs) for _ in range(3)]
        want = unet._forward(*inputs)
    assert all(torch.equal(g, want) for g in got)
    assert unet.graph_stats == {'captures': 0, 'replays': 0,
                                'eager': {'device': 3}}


def test_first_sighting_eager_second_captures_later_replay(unet):
    cache = _fake_cache()
    a, b = _inputs(seed=1), _inputs(seed=2)
    with torch.no_grad():
        want_a, want_b = unet._forward(*a), unet._forward(*b)
    first = _run(cache, unet, a)
    assert cache.stats == {'captures': 0, 'replays': 0,
                           'eager': {'first': 1}}
    second = _run(cache, unet, b)
    assert cache.stats['captures'] == 1 and cache.stats['replays'] == 0
    third = _run(cache, unet, a)
    fourth = _run(cache, unet, b)
    assert cache.stats['replays'] == 2
    for got, want in ((first, want_a), (second, want_b), (third, want_a),
                      (fourth, want_b)):
        assert torch.equal(got, want)
        assert got.stride() == want.stride()
    # A replay returns a copy: the next replay leaves it as it was (PLMS
    # keeps past ε).
    [entry] = cache._entries.values()
    assert third.data_ptr() != entry.out.data_ptr()
    assert torch.equal(third, want_a)


def _swap_storage(u):
    u.conv_in.weight.data = u.conv_in.weight.data.clone() * 2


def _swap_parameter(u):
    u.conv_in.weight = nn.Parameter(u.conv_in.weight.detach() * 2)


def _swap_slot(u):
    # What torch.func.functional_call does: a plain tensor in the slot.
    u.conv_in._parameters['weight'] = u.conv_in.weight.detach() * 2


def _swap_module(u):
    old = u.conv_out
    new = copy.deepcopy(old)
    with torch.no_grad():
        new.weight.mul_(2)
    u.conv_out = new


@pytest.mark.parametrize('swap', [_swap_storage, _swap_parameter,
                                  _swap_slot, _swap_module],
                         ids=['data', 'parameter', 'slot', 'module'])
def test_a_weight_swap_forces_a_new_capture(unet, swap):
    cache = _fake_cache()
    x = _inputs()
    for _ in range(3):
        _run(cache, unet, x)
    assert (cache.stats['captures'], cache.stats['replays']) == (1, 1)
    swap(unet)
    with torch.no_grad():
        want = unet._forward(*x)
    after = [_run(cache, unet, x) for _ in range(3)]
    assert cache.stats['eager'] == {'first': 1, 'weights': 1}
    assert (cache.stats['captures'], cache.stats['replays']) == (2, 2)
    assert all(torch.equal(got, want) for got in after)


def test_in_place_update_needs_no_capture(unet):
    cache = _fake_cache()
    x = _inputs()
    for _ in range(2):
        _run(cache, unet, x)
    with torch.no_grad():
        unet.conv_out.weight.mul_(2)         # apply_lora merges in place
        want = unet._forward(*x)
    assert torch.equal(_run(cache, unet, x), want)
    assert (cache.stats['captures'], cache.stats['replays']) == (1, 1)


def test_submodule_hook_keeps_the_call_eager(unet):
    cache = _fake_cache()
    x = _inputs()
    calls = []
    handle = unet.conv_in.register_forward_hook(lambda *_: calls.append(1))
    try:
        for _ in range(3):
            _run(cache, unet, x)
    finally:
        handle.remove()
    assert calls == [1, 1, 1]
    assert cache.stats['eager'] == {'hooks': 3}
    _run(cache, unet, x)
    assert cache.stats['eager'] == {'hooks': 3, 'first': 1}


def test_lru_bound(unet, monkeypatch):
    monkeypatch.setattr(ug, 'MAX_GRAPHS', 2)
    cache = _fake_cache()
    for batch in (1, 2, 3):
        _run(cache, unet, _inputs(batch))
    assert len(cache._entries) == 2
    _run(cache, unet, _inputs(1))      # batch 1 was dropped: seen anew
    assert cache.stats['eager'] == {'first': 4}
    _run(cache, unet, _inputs(3))      # batch 3 was kept: captured
    assert cache.stats['captures'] == 1 and len(cache._entries) == 2


def test_replay_credits_the_capture_launches():
    """A stand-in body that counts 10 K1 and 61 K6 launches a call, as the
    SD-1.x UNet does: every call, eager, captured or replayed, moves the
    counters by exactly that."""
    unet = tm.UNet2DCondition(C).eval()

    def body(lat, t, ctx):
        fa.count_launch(fa.flash_attention, 'sm90')
        for _ in range(9):
            fa.count_launch(fa.flash_attention_cm, 'sm90')
        for _ in range(61):
            fa.count_launch(gn.fused_group_norm, 'resident')
        return lat * 2
    cache = _fake_cache()
    x = _inputs()
    fns = (fa.flash_attention, fa.flash_attention_cm, gn.fused_group_norm)
    for i in range(4):
        before = [(f.launches, dict(f.path_launches)) for f in fns]
        with torch.no_grad():
            out = cache.run(unet, body, *x)
        assert torch.equal(out, x[0] * 2)
        moved = [(f.launches - n, f.path_launches[p] - paths[p])
                 for f, (n, paths), p in zip(fns, before,
                                             ('sm90', 'sm90', 'resident'))]
        assert moved == [(1, 1), (9, 9), (61, 61)], i
    assert (cache.stats['captures'], cache.stats['replays']) == (1, 2)


def test_copies_of_the_module_start_with_no_graphs(unet):
    cache = unet._graphs
    cache.eager('first')
    for clone in (copy.deepcopy(unet), pickle.loads(pickle.dumps(unet))):
        assert clone._graphs is not cache
        assert clone.graph_stats == {'captures': 0, 'replays': 0,
                                     'eager': {}}
    # A settings copy shares the weights, so it shares their graphs.
    assert unet.with_settings(approx_gelu=True)._graphs is cache


# --------------------------------------------------------------------------
S = tm.TINY_SDXL_UNET


def _added_inputs(pooled_seed, device='cpu'):
    """A tiny SDXL call: latents, ``t``, the context and ``added_cond`` as
    the pipeline gives it (the pooled rows on the device, the ids a host
    row expanded to the batch)."""
    g = torch.Generator(device).manual_seed(1)
    pooled = torch.Generator(device).manual_seed(pooled_seed)
    ids = torch.tensor([[64.0, 64.0, 0.0, 0.0, 64.0, 64.0]])
    return ((torch.randn((2, 8, 8, S.in_channels), generator=g,
                         device=device),
             torch.tensor(500.0, device=device).expand(2),
             torch.randn((2, 7, S.cross_attention_dim), generator=g,
                         device=device)),
            {'text_embeds': torch.randn((2, S.addition_pooled_dim),
                                        generator=pooled, device=device),
             'time_ids': ids.expand(2, 6)})


def test_sdxl_added_cond_calls_are_captured_and_replayed(monkeypatch):
    """SDXL's calls go to the cache with the pooled embedding and the ids
    as two more inputs: a replay reads them from its static buffers, so a
    call with another pooled embedding replays to that call's ε."""
    torch.manual_seed(0)
    unet = tm.UNet2DCondition(S).eval()
    unet._graphs = _fake_cache()
    # On the CPU every call is eager by 'device'; the rest of reason()
    # stands.
    monkeypatch.setattr(unet._graphs, 'reason',
                        lambda module, *a, argument=None: argument)
    a, b = _added_inputs(2), _added_inputs(3)
    with torch.no_grad():
        want = [unet._forward(*x, added_cond=c) for x, c in (a, b)]
        got = [unet(*x, added_cond=c) for x, c in (a, b, a, b)]
    assert unet.graph_stats == {'captures': 1, 'replays': 2,
                                'eager': {'first': 1}}
    assert not torch.equal(want[0], want[1])
    for g, w in zip(got, want + want):
        assert torch.equal(g, w)


# On the card.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _cuda_unet(seed=0):
    torch.manual_seed(seed)
    return tm.UNet2DCondition(C).to('cuda', torch.bfloat16).eval() \
        .requires_grad_(False)


def _cuda_inputs(batch, seed=1):
    g = torch.Generator('cuda').manual_seed(seed)
    # 32×32 latents: the 1024-token level reaches K1, every GroupNorm K6.
    return (torch.randn((batch, 32, 32, C.in_channels), generator=g,
                        device='cuda'),
            torch.tensor(500.0, device='cuda').expand(batch),
            torch.randn((batch, 7, C.cross_attention_dim), generator=g,
                        device='cuda'))


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [1, 4])
def test_cuda_replay_matches_the_first_eager_call(cuda, batch):
    unet = _cuda_unet()
    x, y = _cuda_inputs(batch, 1), _cuda_inputs(batch, 2)
    counters = lambda: (fa.flash_attention.launches,
                        gn.fused_group_norm.launches)
    k0 = counters()
    with torch.no_grad():
        first = unet(*x)
        k1 = counters()
        captured = unet(*y)
        replayed = [unet(*x), unet(*y), unet(*x)]
        eager_y = unet._forward(*y)
    torch.cuda.synchronize()
    assert unet.graph_stats == {'captures': 1, 'replays': 3,
                                'eager': {'first': 1}}
    assert torch.equal(captured, eager_y)
    for got, want in zip(replayed, (first, eager_y, first)):
        assert torch.equal(got, want)
        assert got.stride() == want.stride()
    # Six calls, each the first one's K1 and K6 launches.
    per_call = [b - a for a, b in zip(k0, k1)]
    assert min(per_call) > 0
    assert [b - a for a, b in zip(k0, counters())] == [6 * n
                                                        for n in per_call]


@pytest.mark.cuda
def test_cuda_pndm_latents_equal_with_and_without_graphs(cuda):
    torch.manual_seed(0)
    vae = tm.AutoencoderKL(tm.TINY_VAE).to('cuda', torch.bfloat16).eval()
    graphed = _cuda_unet()
    eager = copy.deepcopy(graphed)
    # A hook on a submodule keeps every call of this one eager.
    eager.conv_in.register_forward_hook(lambda *_: None)
    g = torch.Generator('cuda').manual_seed(3)
    emb = torch.randn((1, 7, C.cross_attention_dim), generator=g,
                      device='cuda')
    guide = SimpleGuidance(embeddings=emb, uncond=torch.zeros_like(emb),
                           guidance_scale=7.5)
    outs = []
    for unet in (graphed, eager):
        pipe = FlexPipeline(unet, vae, scheduler='pndm')
        outs.append(pipe(guide, steps=3, init_size=(64, 64),
                         generator=torch.Generator('cuda').manual_seed(5),
                         output_type='latent').images)
    assert graphed.graph_stats['replays'] >= 2
    assert graphed.graph_stats['captures'] == 1
    assert eager.graph_stats['captures'] == 0
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
def test_cuda_lora_training_call_stays_eager_with_a_gradient(cuda):
    unet = _cuda_unet()
    factors = tt.init_lora(unet, rank=2)
    for f in factors.values():
        for leaf in f.values():
            leaf.requires_grad_(True)
    x = _cuda_inputs(2)
    with torch.enable_grad():
        eff = tt.merge_lora_params(unet, factors)
        for _ in range(3):
            out = torch.func.functional_call(unet, eff, x)
            assert out.grad_fn is not None
    assert unet.graph_stats == {'captures': 0, 'replays': 0,
                                'eager': {'grad': 3}}


@pytest.mark.cuda
def test_cuda_autocast_and_an_outer_capture_stay_eager(cuda):
    unet = _cuda_unet()
    x = _cuda_inputs(1)
    with torch.no_grad():
        with torch.autocast('cuda', torch.bfloat16):
            unet(*x)
        unet(*x)                                # first sighting, eager
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            unet(*x)
        graph.replay()
    torch.cuda.synchronize()
    assert unet.graph_stats == {'captures': 0, 'replays': 0,
                                'eager': {'autocast': 1, 'first': 1,
                                          'capturing': 1}}


@pytest.mark.cuda
def test_cuda_sdxl_replay_matches_the_eager_call(cuda):
    torch.manual_seed(0)
    unet = tm.UNet2DCondition(S).to('cuda', torch.bfloat16).eval() \
        .requires_grad_(False)
    a, b = _added_inputs(2, 'cuda'), _added_inputs(3, 'cuda')
    # The pipeline's ids are a host row.
    for _, c in (a, b):
        c['time_ids'] = c['time_ids'].cpu()
    with torch.no_grad():
        got = [unet(*x, added_cond=c) for x, c in (a, b, a, b)]
        want = [unet._forward(*x, added_cond=c) for x, c in (a, b)]
    torch.cuda.synchronize()
    assert unet.graph_stats == {'captures': 1, 'replays': 2,
                                'eager': {'first': 1}}
    for g, w in zip(got, want + want):
        assert torch.equal(g, w)
