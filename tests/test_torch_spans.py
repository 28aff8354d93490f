"""The port's profiler spans (``utils/profiling.span``): a shared no-op with
no profiler running, ``cpu_op`` events (no user annotation, no device
range) under one, and the nesting of ``fd.*`` spans a ``Runner.gen`` call
and a train step leave in a trace, on the CPU at tiny sizes."""
import pytest
import torch

from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch import training as tt
from flexdiffuse_tpu_torch.config import RunConfig
from flexdiffuse_tpu_torch.runner import Runner
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.utils import profiling
from flexdiffuse_tpu_torch.utils.profiling import PhaseTimer, span, spanned
from tests.test_torch_attention import one_torch_thread  # noqa: F401


def _profiled(fn):
    """``(fn()'s result, the trace's kineto events)`` under a CPU
    profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return out, list(prof.profiler.kineto_results.events())


def _spans(events):
    """``[(name, start ns, end ns)]`` of the ``fd.*`` events, by start."""
    out = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in events if ev.name().startswith('fd.')]
    return sorted(out, key=lambda s: s[1])


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(child, parent) -> bool:
    return parent[1] <= child[1] and child[2] <= parent[2]


def _raise(*_args, **_kwargs):
    raise AssertionError('_RecordFunctionFast touched with no profiler')


def test_span_without_profiler_is_the_shared_noop(monkeypatch):
    monkeypatch.setattr(profiling, '_RecordFunctionFast', _raise)
    assert not torch._C._autograd._profiler_enabled()
    a, b = span('fd.a'), span('fd.b')
    assert a is b is profiling._NO_SPAN
    with a, b:                       # nests and enters again
        with span('fd.c'):
            pass

    @spanned('fd.fn')
    def double(x):
        return 2 * x
    assert double(21) == 42 and double.__name__ == 'double'


def test_spans_are_cpu_ops_without_a_device_mirror():
    timer = PhaseTimer()

    def work():
        with span('fd.outer'):
            with timer.phase('inner'):
                torch.ones(8) @ torch.ones(8)
            with torch.profiler.record_function('annotation'):
                torch.ones(4).sum()
    _, events = _profiled(work)
    fd = [ev for ev in events if ev.name().startswith('fd.')]
    assert sorted(ev.name() for ev in fd) == ['fd.inner', 'fd.outer']
    for ev in fd:
        assert not ev.is_user_annotation()
        assert ev.device_type() == torch.autograd.DeviceType.CPU
    # The control: record_function is what the spans must not be.
    ann = [ev for ev in events if ev.name() == 'annotation']
    assert ann and all(ev.is_user_annotation() for ev in ann)
    spans = _spans(events)
    assert _inside(_named(spans, 'fd.inner')[0], _named(spans, 'fd.outer')[0])


def test_span_stays_a_noop_without_the_fast_record(monkeypatch):
    monkeypatch.setattr(profiling, '_RecordFunctionFast', None)

    def work():
        assert span('fd.x') is profiling._NO_SPAN
        with span('fd.x'):
            torch.ones(2).sum()
    _, events = _profiled(work)
    assert _spans(events) == []


def test_phase_timer_keys_unchanged_under_the_profiler():
    timer = PhaseTimer()

    def work():
        for name in ('embeds', 'generate', 'generate'):
            with timer.phase(name):
                pass
    _, events = _profiled(work)
    assert sorted(timer.summary()) == ['embeds', 'generate']
    assert timer.summary()['generate']['count'] == 2
    assert [s[0] for s in _spans(events)] == ['fd.embeds', 'fd.generate',
                                              'fd.generate']


@pytest.fixture(scope='module')
def runner(tmp_path_factory):
    torch.manual_seed(0)
    return Runner.from_models(
        tm.CLIPTextModel(tm.TINY_TEXT).eval(), None,
        tm.UNet2DCondition(tm.TINY_UNET).eval(),
        tm.AutoencoderKL(tm.TINY_VAE).eval(), FakeTokenizer(),
        config=RunConfig(output_dir=str(tmp_path_factory.mktemp('out'))))


def test_runner_gen_span_nesting(runner):
    calls = []
    hook = runner.pipe.unet.register_forward_pre_hook(
        lambda *_: calls.append(1))
    try:
        (images, _), events = _profiled(lambda: runner.gen(
            prompt='a deer', negative_prompt='blurry', steps=3,
            init_size=(16, 16), seed=7, save=True))
    finally:
        hook.remove()
    assert len(images) == 1
    spans = _spans(events)
    [gen] = _named(spans, 'fd.gen')
    assert all(_inside(s, gen) for s in spans)
    [embeds] = _named(spans, 'fd.embeds')
    [generate] = _named(spans, 'fd.generate')
    [denoise] = _named(spans, 'fd.denoise')
    assert embeds[2] <= generate[1] and _inside(denoise, generate)
    encodes = _named(spans, 'fd.encode')
    # The prompt inside 'embeds', the negative prompt after it.
    assert any(_inside(e, embeds) for e in encodes)
    assert any(embeds[2] <= e[1] and e[2] <= generate[1] for e in encodes)
    unets = _named(spans, 'fd.unet')
    assert len(unets) == len(calls) >= 3
    scheds = _named(spans, 'fd.scheduler')
    assert len(scheds) >= 3
    assert all(_inside(s, denoise) for s in unets + scheds)
    edges = [_named(spans, n) for n in ('fd.decode', 'fd.to_host',
                                        'fd.to_pil', 'fd.grid')]
    assert all(len(e) == 1 for e in edges)
    order = [denoise] + [e[0] for e in edges]
    assert all(a[2] <= b[1] for a, b in zip(order, order[1:]))
    assert all(_inside(e[0], generate) for e in edges)
    saves = _named(spans, 'fd.save')      # the image, then the grid
    assert len(saves) == 2 and saves[0][2] <= edges[3][0][1] <= saves[1][1]


@pytest.mark.parametrize('kind', ['lora', 'full'])
def test_train_step_span_nesting(kind):
    torch.manual_seed(0)
    unet = tm.UNet2DCondition(tm.TINY_UNET)
    cfg = tt.TrainConfig(learning_rate=1e-4)
    if kind == 'lora':
        step, _ = tt.make_lora_train_step(unet, tt.init_lora(unet, rank=2),
                                          cfg)
    else:
        step, _ = tt.make_train_step(unet, cfg)
    c = tm.TINY_UNET
    latents = torch.randn(2, 8, 8, c.in_channels)
    context = torch.randn(2, 7, c.cross_attention_dim)
    gen = torch.Generator().manual_seed(1)
    loss, events = _profiled(lambda: step(latents, context, generator=gen))
    assert torch.isfinite(loss)
    spans = _spans(events)
    [outer] = _named(spans, 'fd.train_step')
    phases = ['fd.forward', 'fd.backward', 'fd.optimizer']
    if kind == 'lora':
        phases.insert(0, 'fd.lora_merge')
    got = [s for s in spans if s[0] in phases]
    assert [s[0] for s in got] == phases
    assert all(_inside(s, outer) for s in got)
    assert all(a[2] <= b[1] for a, b in zip(got, got[1:]))
    assert all(_inside(s, got[-3]) for s in _named(spans, 'fd.unet'))
    assert _named(spans, 'fd.unet')
