"""The LoRA train step's CUDA graphs (``training/step_graph.py``): which
calls stay eager and why, first sighting / capture / replay, the
signature, the two-entry bound, the weights check and the K3–K5 launch
credit, on the CPU with a stand-in for the CUDA graph; and, marked
``cuda``, graphed steps against eager ones on the card. Run the card's
with ``python -m pytest tests/test_torch_train_graph.py -m cuda -q
--noconftest`` (this file imports no JAX)."""
import contextlib
import copy
import dataclasses

import pytest
import torch

from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.models import unet_graph as ug
from flexdiffuse_tpu_torch.ops import attention as attention_ops
from flexdiffuse_tpu_torch.ops import flash_attention as fa
from flexdiffuse_tpu_torch.ops import flash_backward as fb
from flexdiffuse_tpu_torch.ops import group_norm as gn
from flexdiffuse_tpu_torch.training import step_graph as sg
from flexdiffuse_tpu_torch.training import train as ttrain
from flexdiffuse_tpu_torch.training.checkpoint import TrainCheckpointer

C = tm.TINY_UNET


@dataclasses.dataclass
class FakeGraph:
    """A captured step that runs the body on the static inputs into the
    static loss, with the body's host side effects (the launch counters)
    taken back, as a CUDA graph runs no Python."""
    body: object
    static: tuple
    out: torch.Tensor

    def replay(self):
        before = ug.launch_counts()
        self.out.copy_(self.body(*self.static))
        ug.add_launches(ug.launch_delta(before, ug.launch_counts()), -1)


class Undo:
    """The state a train step changes in place (the factors, AdamW's state,
    the generators), put back as it was: a capture runs nothing."""

    def __init__(self, tensors, gens):
        self.saved = [(t, t.detach().clone()) for t in tensors]
        self.gens = [(g, g.get_state()) for g in gens]

    def restore(self):
        with torch.no_grad():
            for t, v in self.saved:
                t.copy_(v)
        for g, s in self.gens:
            g.set_state(s)


def fake_capture(state, registered=None):
    """A stand-in for ``cuda_capture``: the call's step runs, then the
    "capture" runs the body once more and ``state()`` (the tensors and
    generators it changes) is put back."""

    def capture(body, inputs, static, pool, generators=()):
        if registered is not None:
            registered.append(generators)
        out = body(*inputs)
        undo = Undo(*state())
        static_out = body(*static)
        undo.restore()
        return out, FakeGraph(body, static, static_out), static_out
    return capture


def _unet(seed=0):
    torch.manual_seed(seed)
    return tm.UNet2DCondition(C)


def _factors(unet, seed=3):
    return tt.init_lora(unet, rank=2,
                        generator=torch.Generator().manual_seed(seed))


def _state(opt, factors, gens):
    """The tensors and generators a LoRA step changes."""
    def read():
        tensors = [f[k] for f in factors.values() for k in ('down', 'up')]
        tensors += [v for st in opt.adamw.state.values()
                    for v in st.values() if torch.is_tensor(v)]
        return tensors, [g for g in gens if g is not None]
    return read


def _batch(k, batch=2, side=8):
    g = torch.Generator().manual_seed(100 + k)
    return (torch.randn((batch, side, side, C.in_channels), generator=g),
            torch.randn((batch, 7, C.cross_attention_dim), generator=g))


def _draws(k, batch=2, side=8):
    g = torch.Generator().manual_seed(200 + k)
    return {'t': torch.randint(0, 1000, (batch,), generator=g),
            'noise': torch.randn((batch, side, side, C.in_channels),
                                 generator=g)}


@pytest.fixture
def on_card(monkeypatch):
    """Every CPU call passes the device test, and no stream is capturing;
    the rest of reason() stands."""
    monkeypatch.setattr(sg, '_on_card', lambda *a: True)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: False)


def _graphed_step(monkeypatch, cfg, gen=None, registered=None, seed=0):
    unet = _unet(seed)
    factors = _factors(unet)
    made = {}
    monkeypatch.setattr(sg, 'cuda_capture', fake_capture(
        lambda: _state(made['opt'], factors, [gen])(), registered))
    step, made['opt'] = tt.make_lora_train_step(unet, factors, cfg)
    return unet, factors, step, made['opt']


def _adam(opt, key):
    return [opt.adamw.state[p][key] for p in opt.params]


# --------------------------------------------------------------------------
# Eager by reason.


def _reason_graph(unet, **kw):
    factors = _factors(unet)
    leaves = [f[k] for f in factors.values() for k in ('down', 'up')]
    return sg.StepGraph(unet, factors, tt.make_optimizer(
        leaves, tt.TrainConfig()), **kw)


def _hook_on(where):
    def attach(unet):
        if where == 'unet':
            return unet.register_forward_pre_hook(lambda *_: None)
        if where == 'submodule':
            return unet.conv_in.register_forward_hook(lambda *_: None)
        return torch.nn.modules.module.register_module_forward_hook(
            lambda *_: None)
    return attach


@pytest.mark.parametrize('why,kw,patch', [
    ('mesh', {'mesh': object()}, None),
    ('grad_accum', {'grad_accum': 2}, None),
    ('capturing', {}, 'capturing'),
    ('hooks', {}, 'unet'),
    ('hooks', {}, 'submodule'),
    ('hooks', {}, 'global'),
], ids=['mesh', 'grad_accum', 'capturing', 'hook_unet', 'hook_submodule',
        'hook_global'])
def test_each_reason_keeps_the_step_eager(on_card, monkeypatch, why, kw,
                                          patch):
    unet = _unet()
    graphs = _reason_graph(unet, **kw)
    inputs = _base_inputs()
    if kw:
        assert graphs.reason(inputs) == why
        return
    assert graphs.reason(inputs) is None
    if patch == 'capturing':
        with monkeypatch.context() as m:
            m.setattr(torch.cuda, 'is_current_stream_capturing',
                      lambda: True)
            assert graphs.reason(inputs) == why
    else:
        handle = _hook_on(patch)(unet)
        try:
            assert graphs.reason(inputs) == why
        finally:
            handle.remove()
    assert graphs.reason(inputs) is None


def test_device_reason_on_the_cpu():
    """A CPU step stays eager by 'device', its AdamW is not capturable and
    its losses are the eager body's."""
    cfg = tt.TrainConfig(learning_rate=1e-3)
    unet = _unet()
    step, opt = tt.make_lora_train_step(unet, _factors(unet), cfg)
    assert not opt.adamw.param_groups[0]['capturable']
    gen = torch.Generator().manual_seed(1)
    losses = [float(step(*_batch(k), generator=gen)) for k in range(3)]
    assert step.graph_stats == {'captures': 0, 'replays': 0,
                                'eager': {'device': 3}}
    assert all(map(torch.isfinite, map(torch.tensor, losses)))


def _lora_leaves(seed=3):
    factors = _factors(_unet(), seed)
    return [f[k] for f in factors.values() for k in ('down', 'up')]


@pytest.mark.parametrize('saved,resumed', [(False, True), (True, False)],
                         ids=['cpu_to_card', 'card_to_cpu'])
def test_a_checkpoint_resumes_across_capturable(tmp_path, saved, resumed):
    """A checkpoint written by a step with a plain AdamW (the CPU, or the
    card before its steps were graphed) resumes into a step with a
    capturable one, and back: the check compares what AdamW computes, and
    the resumed optimizer keeps its own flag with its step counts where
    it reads them."""
    cfg = tt.TrainConfig(learning_rate=1e-3)
    plain = tt.make_optimizer(_lora_leaves(), cfg)
    for p in plain.params:
        p.grad = torch.ones_like(p)
    plain.step()
    writer = plain
    if saved:       # a state as a capturable AdamW writes it
        writer = tt.make_optimizer(_lora_leaves(), cfg, capturable=True)
        writer.load_state_dict(plain.state_dict())
        assert writer.adamw.state_dict()['param_groups'][0]['capturable']
    ckpt = TrainCheckpointer(str(tmp_path))
    tree = lambda opt: {str(i): p for i, p in enumerate(opt.params)}
    ckpt.save(1, {'tree': tree(writer), 'opt_state': writer.state_dict()},
              [])
    opt = tt.make_optimizer(_lora_leaves(seed=4), cfg, capturable=resumed)
    restored = ckpt.restore_latest({'tree': tree(opt),
                                    'opt_state': opt.state_dict()})
    assert restored is not None and restored[1] == 1
    opt.load_state_dict(restored[0]['opt_state'])
    assert all(g['capturable'] is resumed for g in opt.adamw.param_groups)
    for key in ('exp_avg', 'exp_avg_sq', 'step'):
        assert all(map(torch.equal, _adam(opt, key), _adam(plain, key)))
    assert all(opt.adamw.state[p]['step'].device == p.device
               for p in opt.params)


# --------------------------------------------------------------------------
# Capture and replay, with the stand-in.


@pytest.mark.parametrize('remat', ['none', 'dots'])
@pytest.mark.parametrize('draws', ['generator', 'passed'])
def test_graphed_steps_equal_eager_steps(on_card, monkeypatch, remat, draws):
    """Five steps: the first eager, the second captured, then replays;
    losses, factors and AdamW's moments equal those of five eager steps
    (kept eager by a hook) bit for bit."""
    cfg = tt.TrainConfig(learning_rate=1e-3, remat=remat)
    gens = [torch.Generator().manual_seed(7) for _ in range(2)] \
        if draws == 'generator' else [None, None]
    registered = []
    unet, factors, step, opt = _graphed_step(monkeypatch, cfg, gens[0],
                                             registered)
    ref_unet = _unet()
    ref_factors = _factors(ref_unet)
    ref_step, ref_opt = tt.make_lora_train_step(ref_unet, ref_factors, cfg)
    ref_unet.register_forward_pre_hook(lambda *_: None)
    got, want = [], []
    for k in range(5):
        kw = _draws(k) if draws == 'passed' else {}
        got.append(step(*_batch(k), generator=gens[0], **kw))
        want.append(ref_step(*_batch(k), generator=gens[1], **kw))
    assert step.graph_stats == {'captures': 1, 'replays': 3,
                                'eager': {'first': 1}}
    assert ref_step.graph_stats == {'captures': 0, 'replays': 0,
                                    'eager': {'hooks': 5}}
    assert registered == [(gens[0],) if gens[0] is not None else ()]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for name in factors:
        for k in ('down', 'up'):
            assert torch.equal(factors[name][k], ref_factors[name][k])
    for key in ('exp_avg', 'exp_avg_sq', 'step'):
        assert all(map(torch.equal, _adam(opt, key), _adam(ref_opt, key)))
    # A replay returns a copy of the static loss.
    assert got[-1].data_ptr() != got[-2].data_ptr()


def test_spans_of_the_capture_and_the_replay(on_card, monkeypatch):
    cfg = tt.TrainConfig(learning_rate=1e-3)
    _, _, step, _ = _graphed_step(monkeypatch, cfg)
    names = []
    for k in range(3):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            step(*_batch(k), **_draws(k))
        names.append({ev.name() for ev in prof.profiler.kineto_results
                      .events() if ev.name().startswith('fd.')})
    inner = {'fd.lora_merge', 'fd.forward', 'fd.backward', 'fd.optimizer'}
    assert names[0] >= inner | {'fd.train_step'}
    assert not names[0] & {'fd.train_capture', 'fd.train_replay'}
    assert names[1] >= inner | {'fd.train_step', 'fd.train_capture'}
    # The stand-in runs Python in its replay; a CUDA graph does not.
    assert {'fd.train_step', 'fd.train_replay'} <= names[2]
    assert 'fd.train_capture' not in names[2]


def _base_inputs():
    lat, ctx = _batch(0)
    return {'latents': lat, 'context': ctx}


# Each signature field, and a call that changes it.
FIELDS = {
    'shape': lambda x, g, o: ({**x, 'latents': x['latents'][:1]}, g),
    'dtype': lambda x, g, o: ({**x, 'context': x['context'].double()}, g),
    'stride': lambda x, g, o: (
        {**x, 'latents': x['latents'].transpose(1, 2).contiguous()
         .transpose(1, 2)}, g),
    't': lambda x, g, o: ({**x, 't': torch.zeros(2, dtype=torch.long)}, g),
    'noise': lambda x, g, o: ({**x, 'noise': torch.zeros(2, 8, 8, 4)}, g),
    'extra': lambda x, g, o: ({**x, 'extra.time_ids': torch.zeros(2, 6)},
                              g),
    'generator': lambda x, g, o: (x, torch.Generator()),
    'attention': lambda x, g, o: (x, g, attention_ops.backend('plain')),
    'group_norm': lambda x, g, o: (x, g, gn.backend('plain')),
    'tf32': lambda x, g, o: (x, g, _flag(torch.backends.cudnn,
                                         'allow_tf32')),
    'adamw': lambda x, g, o: (x, g, _lr(o)),
}


@contextlib.contextmanager
def _flag(mod, name):
    old = getattr(mod, name)
    setattr(mod, name, not old)
    try:
        yield
    finally:
        setattr(mod, name, old)


@contextlib.contextmanager
def _lr(opt):
    group = opt.adamw.param_groups[0]
    old = group['lr']
    group['lr'] = old * 2
    try:
        yield
    finally:
        group['lr'] = old


def _plain_graph(monkeypatch, unet=None):
    """A StepGraph over a tiny UNet with a body that only reads its
    inputs, and the stand-in capture."""
    unet = unet or _unet()
    factors = _factors(unet)
    leaves = [f[k] for f in factors.values() for k in ('down', 'up')]
    opt = tt.make_optimizer(leaves, tt.TrainConfig())
    monkeypatch.setattr(sg, 'cuda_capture',
                        fake_capture(lambda: ([], [])))
    graphs = sg.StepGraph(unet, factors, opt)
    body = lambda **xs: sum(x.double().sum() for x in xs.values())
    return graphs, body, opt, factors


@pytest.mark.parametrize('field', sorted(FIELDS))
def test_each_signature_field_starts_a_new_entry(on_card, monkeypatch,
                                                 field):
    graphs, body, opt, _ = _plain_graph(monkeypatch)
    base, gen = _base_inputs(), None
    for _ in range(2):
        graphs.run(body, base, gen)
    assert graphs.stats == {'captures': 1, 'replays': 0,
                            'eager': {'first': 1}}
    changed = FIELDS[field](base, gen, opt)
    inputs, g = changed[:2]
    scope = changed[2] if len(changed) > 2 else contextlib.nullcontext()
    with scope:
        first = graphs.run(body, inputs, g)
        assert graphs.stats['eager'] == {'first': 2}
        again = graphs.run(body, inputs, g)
        assert graphs.stats['captures'] == 2
    assert torch.equal(first, body(**inputs)) and torch.equal(first, again)
    graphs.run(body, base, gen)                  # still kept: replayed
    assert graphs.stats['replays'] == 1


def test_two_signatures_at_most(on_card, monkeypatch):
    graphs, body, _, _ = _plain_graph(monkeypatch)
    calls = [{'latents': torch.randn(b, 8, 8, 4),
              'context': torch.randn(b, 7, 32)} for b in (1, 2, 3)]
    for x in calls:
        graphs.run(body, x, None)
    assert len(graphs._entries) == sg.MAX_GRAPHS == 2
    graphs.run(body, calls[0], None)        # dropped: sighted anew
    assert graphs.stats['eager'] == {'first': 4}
    graphs.run(body, calls[2], None)        # kept: captured
    assert graphs.stats['captures'] == 1 and len(graphs._entries) == 2


def _swap_factor_dict(unet, factors, opt):
    name = next(iter(factors))
    factors[name]['up'] = factors[name]['up'].detach().clone() \
        .requires_grad_()


def _swap_factor_data(unet, factors, opt):
    f = next(iter(factors.values()))
    f['down'].data = f['down'].data.clone()


def _swap_unet_weight(unet, factors, opt):
    unet.conv_in.weight.data = unet.conv_in.weight.data.clone()


def _swap_unet_module(unet, factors, opt):
    unet.conv_out = copy.deepcopy(unet.conv_out)


def _move_unet(unet, factors, opt):
    unet.to(torch.float64).to(torch.float32)     # new storages


def _resume_optimizer(unet, factors, opt):
    # A restored checkpoint: AdamW's state as new tensors.
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))


@pytest.mark.parametrize('swap', [
    _swap_factor_dict, _swap_factor_data, _swap_unet_weight,
    _swap_unet_module, _move_unet, _resume_optimizer],
    ids=['factor_dict', 'factor_data', 'unet_weight', 'unet_module',
         'unet_to', 'optimizer_state'])
def test_a_swap_drops_the_graphs(on_card, monkeypatch, swap):
    cfg = tt.TrainConfig(learning_rate=1e-3)
    unet, factors, step, opt = _graphed_step(monkeypatch, cfg)
    for k in range(3):
        step(*_batch(k), **_draws(k))
    assert step.graph_stats == {'captures': 1, 'replays': 1,
                                'eager': {'first': 1}}
    swap(unet, factors, opt)
    for k in range(3):
        step(*_batch(k), **_draws(k))
    assert step.graph_stats == {'captures': 2, 'replays': 2,
                                'eager': {'first': 1, 'weights': 1}}


def test_in_place_updates_keep_the_graphs(on_card, monkeypatch):
    """A checkpoint's ``copy_`` into the factors, or an optimizer state
    loaded over the same tensors, reads the same storages."""
    cfg = tt.TrainConfig(learning_rate=1e-3)
    unet, factors, step, opt = _graphed_step(monkeypatch, cfg)
    for k in range(2):
        step(*_batch(k), **_draws(k))
    with torch.no_grad():
        for f in factors.values():
            f['up'].mul_(0.5)
    opt.load_state_dict(opt.state_dict())
    step(*_batch(2), **_draws(2))
    assert step.graph_stats == {'captures': 1, 'replays': 1,
                                'eager': {'first': 1}}


def test_replay_credits_the_capture_launches(on_card, monkeypatch):
    """A stand-in body that counts a remat 'dots' step of the SD-1.x UNet:
    20 K3, 10 K4, 10 K5 and 6 K6 launches. Every call, eager, captured or
    replayed, moves the counters by exactly that."""
    graphs, _, _, _ = _plain_graph(monkeypatch)

    def body(**xs):
        for fn, n in ((fb.flash_attention_lse, 20),
                      (fb.flash_attention_dq, 10),
                      (fb.flash_attention_dkv, 10)):
            for _ in range(n):
                fa.count_launch(fn, 'sm90')
        for _ in range(6):
            fa.count_launch(gn.fused_group_norm, 'resident')
        return xs['latents'].sum()
    fns = (fb.flash_attention_lse, fb.flash_attention_dq,
           fb.flash_attention_dkv, gn.fused_group_norm)
    paths = ('sm90', 'sm90', 'sm90', 'resident')
    x = _base_inputs()
    for i in range(4):
        before = [(f.launches, f.path_launches[p]) for f, p in zip(fns,
                                                                   paths)]
        graphs.run(body, x, None)
        moved = [(f.launches - n, f.path_launches[p] - k)
                 for f, p, (n, k) in zip(fns, paths, before)]
        assert moved == [(20, 20), (10, 10), (10, 10), (6, 6)], i
    assert (graphs.stats['captures'], graphs.stats['replays']) == (1, 2)


@pytest.mark.parametrize('device', [
    'cpu', pytest.param('cuda', marks=pytest.mark.cuda)])
@pytest.mark.parametrize('remat', ['full', 'dots'])
def test_training_forward_draws_nothing_under_remat(device, remat):
    """The checkpointed region (the UNet forward, and its recompute in the
    backward) draws from no generator: ``t`` and noise are drawn before
    it and the UNet has no dropout. So a graphed step's remat may keep no
    RNG state, and stays exact."""
    if device == 'cuda' and not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    dev = torch.device(device)
    unet = _unet().to(dev)
    factors = _factors(unet)
    cfg = tt.TrainConfig(remat=remat)
    eff = tt.merge_lora_params(unet, factors)
    apply_fn = ttrain._remat_apply(
        lambda *a, **k: torch.func.functional_call(unet, eff, a, k), cfg,
        preserve_rng_state=False)
    lat, ctx = (x.to(dev) for x in _batch(0, side=32 if device == 'cuda'
                                           else 8))
    d = _draws(0, side=lat.shape[1])
    acp = ttrain.schedule_tables(cfg, dev)

    def rng():
        return (torch.get_rng_state(), torch.cuda.get_rng_state(dev)
                if dev.type == 'cuda' else None)
    before = rng()
    with ttrain.compute_context(dev, cache=False):
        loss = tt.diffusion_loss(apply_fn, lat, ctx, acp, cfg,
                                 t=d['t'].to(dev),
                                 noise=d['noise'].to(dev))
    mid = rng()
    loss.backward()
    after = rng()
    for a, b in ((before, mid), (before, after)):
        assert torch.equal(a[0], b[0])
        assert a[1] is None or torch.equal(a[1], b[1])
    assert all(f['down'].grad is not None for f in factors.values())


# --------------------------------------------------------------------------
# On the card.


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (CUDA graphs have no CPU mode)')
    return torch.device('cuda')


def _cuda_step(cfg, seed=0):
    torch.manual_seed(seed)
    unet = tm.UNet2DCondition(C).to('cuda', torch.bfloat16)
    factors = tt.init_lora(unet, rank=2,
                           generator=torch.Generator().manual_seed(3))
    step, opt = tt.make_lora_train_step(unet, factors, cfg)
    return unet, factors, step, opt


def _cuda_batch(k, batch=2, side=32):
    g = torch.Generator('cuda').manual_seed(100 + k)
    return (torch.randn((batch, side, side, C.in_channels), generator=g,
                        device='cuda'),
            torch.randn((batch, 7, C.cross_attention_dim), generator=g,
                        device='cuda'))


@pytest.mark.cuda
@pytest.mark.parametrize('remat', ['none', 'dots'])
@pytest.mark.parametrize('draws', ['generator', 'passed'])
def test_cuda_graphed_steps_equal_eager_steps(cuda, remat, draws):
    """Five graphed LoRA steps (eager, captured, three replays) against
    five eager ones of the same capturable step, kept eager by a hook:
    losses, factors, ``exp_avg`` and ``exp_avg_sq`` bit for bit; the
    launches of each step the same."""
    cfg = tt.TrainConfig(learning_rate=1e-3, remat=remat)
    _, factors, step, opt = _cuda_step(cfg)
    ref_unet, ref_factors, ref_step, ref_opt = _cuda_step(cfg)
    ref_unet.register_forward_pre_hook(lambda *_: None)
    assert opt.adamw.param_groups[0]['capturable']
    gens = [torch.Generator('cuda').manual_seed(7) for _ in range(2)]
    got, want, moved = [], [], []
    for k in range(5):
        kw = {}
        if draws == 'passed':
            d = _draws(k, side=32)
            kw = {'t': d['t'].cuda(), 'noise': d['noise'].cuda()}
        for fn, out, gen in ((step, got, gens[0]),
                             (ref_step, want, gens[1])):
            before = ug.launch_counts()
            out.append(fn(*_cuda_batch(k), generator=gen, **kw))
            moved.append(ug.launch_delta(before, ug.launch_counts()))
    torch.cuda.synchronize()
    assert step.graph_stats == {'captures': 1, 'replays': 3,
                                'eager': {'first': 1}}
    assert ref_step.graph_stats == {'captures': 0, 'replays': 0,
                                    'eager': {'hooks': 5}}
    assert [float(x) for x in got] == [float(x) for x in want]
    for name in factors:
        for k in ('down', 'up'):
            assert torch.equal(factors[name][k], ref_factors[name][k])
    for key in ('exp_avg', 'exp_avg_sq', 'step'):
        assert all(map(torch.equal, _adam(opt, key), _adam(ref_opt, key)))
    assert all(m == moved[0] for m in moved)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())


@pytest.mark.cuda
def test_cuda_accumulating_step_stays_eager(cuda):
    """Eager by 'grad_accum', with the replays' capturable AdamW."""
    cfg = tt.TrainConfig(learning_rate=1e-3, grad_accum=2)
    _, _, step, opt = _cuda_step(cfg)
    assert opt.adamw.param_groups[0]['capturable']
    for k in range(3):
        step(*_cuda_batch(k), generator=torch.Generator('cuda'))
    assert step.graph_stats == {'captures': 0, 'replays': 0,
                                'eager': {'grad_accum': 3}}


@pytest.mark.cuda
def test_cuda_step_resumed_from_a_cpu_checkpoint_is_graphed(cuda):
    """An optimizer state written on the CPU, loaded into a card step:
    AdamW stays capturable, so the step is graphed anew ('first', then a
    capture and a replay), not kept eager by 'device'."""
    cfg = tt.TrainConfig(learning_rate=1e-3)
    unet = _unet()
    cpu_step, cpu_opt = tt.make_lora_train_step(unet, _factors(unet), cfg)
    cpu_step(*_batch(0), generator=torch.Generator().manual_seed(1))
    _, _, step, opt = _cuda_step(cfg)
    opt.load_state_dict(cpu_opt.state_dict())
    assert opt.adamw.param_groups[0]['capturable']
    gen = torch.Generator('cuda').manual_seed(7)
    for k in range(3):
        step(*_cuda_batch(k), generator=gen)
    assert step.graph_stats == {'captures': 1, 'replays': 1,
                                'eager': {'first': 1}}
