"""PyTorch port: the command line (``flexdiffuse_tpu_torch/cli.py``,
``python -m flexdiffuse_tpu_torch``), held against the JAX CLI.

* Both parsers parse the same argv to equal namespaces, flag for flag; the
  port leaves out only the JAX parser's ``--compile-cache`` pair and adds
  ``--device``.
* With a recording fake Runner in both, ``generate`` and ``compose`` call
  ``gen``/``compose`` with equal keyword arguments.
* ``train --data-parallel 2`` with fewer cards than ranks raises before
  any model loads; ``edit --pag-layers`` is refused first, as in the JAX
  CLI, and so is ``train`` with ``model_family`` 'sdxl'; without a card
  the model-running commands raise unless given ``--device cpu``.
  ``train``'s textual-inversion flags reach ``train_textual_inversion``
  as in the JAX CLI.
* The scheduler and sampling flags (the tenth slice) reach the Runner as
  they do in the JAX CLI and app, with recording Runners in both packages
  (no model loads): the same scheduler, SchedulerConfig, model geometry
  (``--model-family sd2``), ``enable_*`` calls and ``gen``/``compose``
  keywords. So do the conditioning models' flags (the eleventh slice):
  ``--controlnet``/``--control-image``/``--controlnet-scale``,
  ``--ip-adapter``/``--ip-encoder``/``--ip-image``/``--ip-scale``,
  ``--ip-encoder-arch`` (accepted, unused for SD-1.x) and ``edit``.
* ``convert`` on the tiny HF-layout snapshot writes the caches the JAX
  loader (``load_clip``/``load_sd``, ``cache=True``) reads back, equal to
  the JAX converter's trees leaf for leaf in dtype and value.
* ``download`` without ``huggingface_hub`` (or without the network)
  returns 1 with its message; nothing here contacts a network.
* ``generate``, ``compose``, ``edit`` (on the tiny snapshot made
  8-channel) and ``train`` (LoRA, ``--full``, DreamBooth) run end to end
  on the tiny snapshot, fp32 on the CPU; ``train --data-parallel 2
  --device cpu`` (2 gloo ranks) writes the adapter ``--data-parallel 1``
  writes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from flexdiffuse_tpu import cli as jcli
from flexdiffuse_tpu.models import TINY_UNET as J_TINY_UNET
from flexdiffuse_tpu.models import TINY_VAE as J_TINY_VAE
from flexdiffuse_tpu.weights import convert as jconvert
from flexdiffuse_tpu.weights import load as jload
from flexdiffuse_tpu_torch import cli as tcli
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.interface import app as tapp
from flexdiffuse_tpu_torch.weights import load as tload
from flexdiffuse_tpu_torch.weights import safetensors as tsafetensors
from tests.test_runner_disk_loading import model_root  # noqa: F401
from tests.test_torch_attention import REPO
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_loading import CONFIGS, _dirs

SUBCOMMANDS = ('convert', 'download', 'generate', 'edit', 'compose', 'train',
               'serve', 'serve-api')
JAX_ONLY = {'compile_cache', 'no_compile_cache', 'fn'}
PORT_ONLY = {'device', 'fn'}
JAX_CMD_TRAIN = jcli.cmd_train   # the real one; jax_namespace patches it


def jax_namespace(monkeypatch, argv):
    """The namespace the JAX CLI's ``main`` hands its subcommand."""
    seen = []
    for name in ('cmd_convert', 'cmd_download', 'cmd_generate', 'cmd_edit',
                 'cmd_compose', 'cmd_train', 'cmd_serve', 'cmd_serve_api'):
        monkeypatch.setattr(jcli, name, lambda a: seen.append(a) or 0)
    assert jcli.main(['--no-compile-cache', *argv]) == 0
    return seen[0]


ARGV = {
    'generate_defaults': ['generate'],
    'generate_all': [
        'generate', '--models', 'm', '--sd-model', 'a/b', '--scheduler',
        'ddim', '--clip-skip', '1', '--lora', 'l.safetensors:0.5', '--lora',
        'k', '--embedding', 'e.pt:tok', '--prompt', 'a deer',
        '--negative-prompt', 'blur', '--guide', 'g.png', '--init-image',
        'i.png', '--mask', 'm.png', '--long-prompt', '--weighted',
        '--concepts', 'deer', '--out', 'o', '--height', '256', '--width',
        '384', '--threshold-mult', '0.3', '--threshold-floor', '0.7',
        '--clustered', '0.2', '--linear-start', '0.05', '--linear-end',
        '0.6', '--max-guidance', '0.4', '--header-max', '0.1', '--mode',
        '2', '--no-reuse', '--strength', '0.5', '--steps', '12',
        '--guidance-scale', '7.5', '--samples', '3', '--seed', '9',
        '--debug'],
    'generate_unported': [
        'generate', '--karras', '--v-prediction', '--zero-snr',
        '--timestep-spacing', 'trailing', '--model-family', 'sdxl',
        '--controlnet', 'c', '--ip-adapter', 'a', '--ip-encoder', 'e',
        '--ip-encoder-arch', 'bigg', '--refiner', 'r', '--refine-strength',
        '0.4', '--control-image', 'ci', '--controlnet-scale', '0.5',
        '--ip-image', 'ii', '--ip-scale', '0.3', '--freeu', 'on',
        '--vae-tile', '64', '--deepcache', '2', '--tome', '0.5,1024',
        '--pag-layers', 'mid', '--hires-scale', '2', '--hires-strength',
        '0.4', '--hires-steps', '10', '--cfg-interval', '0.0', '0.6',
        '--guidance-rescale', '0.7', '--pag', '3'],
    'edit': ['edit', '--prompt', 'winter', '--image', 'x.png',
             '--image-guidance-scale', '1.2', '--samples', '2'],
    'compose': ['compose', '--schema', 's.json', '--samples', '2',
                '--strength', '0.5', '--seed', '4', '--debug'],
    'train': ['train', '--data', 'd', '--full', '--rank', '4', '--remat',
              'full', '--grad-accum', '2', '--ema-decay', '0.99',
              '--class-data', 'c', '--class-caption', 'a dog',
              '--prior-weight', '0.5', '--steps', '3', '--batch-size', '2',
              '--lr', '2e-5', '--snr-gamma', '5', '--checkpoint-dir', 'ck',
              '--checkpoint-every', '7', '--seed', '1', '--out', 'o',
              '--v-prediction', '--clip-skip', '1', '--resolution', '256'],
    'train_ti': ['train', '--data', 'd', '--textual-inversion', '<x>',
                 '--init-token', 'cat', '--num-vectors', '2',
                 '--style-templates', '--data-parallel', '2',
                 '--model-family', 'sd2'],
    'serve': ['serve', '--lan', '--port', '1234', '--freeu', '1,2,3,4'],
    'serve_api': ['serve-api', '--port', '99', '--max-batch', '4',
                  '--max-wait-ms', '12.5', '--deterministic'],
    'convert': ['convert', '--models', 'm'],
    'download': ['download'],
}


@pytest.mark.parametrize('case', sorted(ARGV))
def test_parsers_agree(monkeypatch, case):
    argv = ARGV[case]
    want = vars(jax_namespace(monkeypatch, argv))
    got = vars(tcli.build_parser().parse_args(argv))
    assert {k: v for k, v in got.items() if k not in PORT_ONLY} == \
        {k: v for k, v in want.items() if k not in JAX_ONLY}
    if argv[0] not in ('convert', 'download'):
        assert got['device'] == 'cuda'


def test_subcommands_match_and_the_entry_points_run():
    """Both parsers offer the same 8 subcommands; ``python -m`` runs the
    CLI and the UI entry point."""
    subs = lambda p: set(next(a for a in p._actions
                              if a.dest == 'cmd').choices)
    assert subs(tcli.build_parser()) == set(SUBCOMMANDS)
    for mod, want in (('flexdiffuse_tpu_torch.cli', SUBCOMMANDS),
                      ('flexdiffuse_tpu_torch', ('--models', '--device',
                                                 '--lan'))):
        r = subprocess.run([sys.executable, '-m', mod, '--help'], cwd=REPO,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        for word in want:
            assert word in r.stdout


# --- what the commands hand the Runner -------------------------------------

class Recorder:
    """A fake Runner recording ``gen``/``compose`` keyword arguments."""

    output_dir = 'nowhere'

    def __init__(self):
        self.calls = []

    def gen(self, **kw):
        self.calls.append(('gen', kw))
        return [], None

    def compose(self, **kw):
        self.calls.append(('compose', kw))
        return [], None


def _files(tmp_path):
    paths = {}
    for name, seed in (('guide', 1), ('init', 2), ('mask', 3)):
        p = tmp_path / f'{name}.png'
        Image.fromarray(np.random.default_rng(seed).integers(
            0, 256, (24, 20, 3), np.uint8)).save(p)
        paths[name] = str(p)
    schema = tmp_path / 'schema.json'
    schema.write_text(json.dumps({
        'background_prompt': 'a forest', 'style_start_prompt': 'photo',
        'style_end_prompt': 'ink', 'style_blend': [0.2, 0.8],
        'entities': [{'prompt': 'a deer', 'offset': [8, 16],
                      'size': [32, 24], 'blend': 0.7},
                     {'prompt': 'a fox', 'offset': [0, 0],
                      'size': [16, 16], 'blend': 1.0}]}))
    paths['schema'] = str(schema)
    return paths


def _call_both(monkeypatch, argv):
    jrec, trec = Recorder(), Recorder()
    monkeypatch.setattr(jcli, '_runner', lambda args: jrec)
    monkeypatch.setattr(tcli, '_runner', lambda args: trec)
    assert jcli.main(['--no-compile-cache', *argv]) == 0
    assert tcli.main([*argv, '--device', 'cpu']) == 0
    (jkind, jkw), = jrec.calls
    (tkind, tkw), = trec.calls
    assert jkind == tkind
    return jkw, tkw


@pytest.mark.parametrize('case', ['defaults', 'text_guide', 'images'])
def test_generate_calls_gen_alike(monkeypatch, tmp_path, case):
    f = _files(tmp_path)
    argv = {'defaults': ['generate'],
            'text_guide': ['generate', '--prompt', 'a deer', '--guide',
                           'an oil painting', '--seed', '5', '--samples',
                           '2', '--steps', '7', '--weighted', '--mode', '0',
                           '--negative-prompt', 'blurry', '--debug'],
            'images': ['generate', '--prompt', 'x', '--guide', f['guide'],
                       '--init-image', f['init'], '--mask', f['mask'],
                       '--strength', '0.8', '--long-prompt',
                       '--no-reuse']}[case]
    jkw, tkw = _call_both(monkeypatch, argv)
    assert tkw == jkw
    assert tkw['control_image'] is None and tkw['ip_image'] is None


def test_compose_calls_compose_alike(monkeypatch, tmp_path):
    f = _files(tmp_path)
    jkw, tkw = _call_both(monkeypatch, ['compose', '--schema', f['schema'],
                                        '--samples', '2', '--seed', '3',
                                        '--height', '256', '--debug'])
    assert tkw == jkw
    assert len(tkw['entities_df']) == 2


# --- what the port refuses --------------------------------------------------

# Flags that refuse here before any model loads, with their messages: the
# data-parallel ranks need a card each (``--device cuda``, the default),
# and the card count is stubbed to 1.
TOO_FEW_CARDS = [
    (['train', '--data', 'd', '--data-parallel', '2'],
     '2 ranks need 2 CUDA cards, 1 visible'),
]
# train's textual-inversion flags (the thirteenth slice; they named step 12
# before): each reaches train_textual_inversion as in the JAX CLI
# (test_step12_flags_reach_textual_inversion_as_in_jax). DATA is a folder
# of images.
STEP12 = [
    ['train', '--data', 'DATA', '--textual-inversion', '<x>'],
    ['train', '--data', 'DATA', '--textual-inversion', '<x>',
     '--init-token', 'cat'],
    ['train', '--data', 'DATA', '--textual-inversion', '<x>',
     '--num-vectors', '2'],
    ['train', '--data', 'DATA', '--textual-inversion', '<x>',
     '--style-templates'],
]
# The scheduler and sampling flags of the tenth slice: each reaches the
# Runner (or the training config) as in the JAX CLI
# (test_step9_flags_reach_the_runner_as_in_jax).
STEP9 = [
    ['generate', '--karras', '--scheduler', 'euler'],
    ['generate', '--v-prediction'], ['generate', '--zero-snr'],
    ['generate', '--timestep-spacing', 'trailing', '--scheduler', 'ddim'],
    ['generate', '--freeu', 'on'], ['generate', '--vae-tile', '64'],
    ['generate', '--deepcache', '2'], ['generate', '--tome', '0.5'],
    ['generate', '--pag', '3'], ['generate', '--pag-layers', 'mid'],
    ['generate', '--cfg-interval', '0', '0.6'],
    ['generate', '--guidance-rescale', '0.7'],
    ['generate', '--hires-scale', '2'],
    ['generate', '--hires-strength', '0.4'],
    ['generate', '--hires-steps', '10'],
    ['generate', '--model-family', 'sd2'],
    ['generate', '--scheduler', 'euler'], ['generate', '--scheduler', 'lcm'],
    ['compose', '--schema', 'SCHEMA', '--karras', '--scheduler', 'dpmpp'],
    ['compose', '--schema', 'SCHEMA', '--scheduler', 'heun'],
    ['serve', '--freeu', 'on'], ['serve-api', '--deepcache', '2'],
    ['train', '--data', 'd', '--model-family', 'sd2'],
]
# The SDXL flags (the twelfth slice; they named step 11 before): each
# reaches SDXLRunner as in the JAX CLI
# (test_step11_flags_reach_the_sdxl_runner_as_in_jax).
STEP11 = [
    ['generate', '--model-family', 'sdxl'],
    ['generate', '--model-family', 'sdxl', '--refiner', 'r'],
    ['generate', '--model-family', 'sdxl', '--refine-strength', '0.5'],
]
# The conditioning models' flags (the eleventh slice; they named step 10
# before): each reaches the Runner as in the JAX CLI
# (test_step10_flags_reach_the_runner_as_in_jax). IMAGE is a real PNG.
STEP10 = [
    ['generate', '--controlnet', 'c'],
    ['generate', '--controlnet', 'c', '--control-image', 'IMAGE'],
    ['generate', '--controlnet', 'c', '--control-image', 'IMAGE',
     '--controlnet-scale', '0.5'],
    ['generate', '--ip-adapter', 'a'],
    ['generate', '--ip-adapter', 'a', '--ip-encoder', 'e'],
    ['generate', '--ip-adapter', 'a', '--ip-encoder', 'e', '--ip-image',
     'IMAGE', '--ip-scale', '0.3'],
    ['generate', '--ip-encoder-arch', 'bigg'],
    ['edit', '--prompt', 'winter', '--image', 'IMAGE',
     '--image-guidance-scale', '1.2', '--steps', '3', '--seed', '2'],
    ['serve', '--controlnet', 'c', '--ip-adapter', 'a'],
]


@pytest.fixture()
def no_models(monkeypatch):
    """Fail the test if anything would load a model or bind a server."""
    def refuse(*a, **k):
        raise AssertionError('a model was loaded')

    for name in ('_runner', '_train_models'):
        monkeypatch.setattr(tcli, name, refuse)
    monkeypatch.setattr('flexdiffuse_tpu_torch.runner.Runner.__init__',
                        refuse)
    monkeypatch.setattr('flexdiffuse_tpu_torch.interface.server.launch',
                        refuse)
    monkeypatch.setattr('flexdiffuse_tpu_torch.serving.launch', refuse)


@pytest.mark.parametrize('argv,message', TOO_FEW_CARDS,
                         ids=[' '.join(a[:1] + a[-2:])
                              for a, _ in TOO_FEW_CARDS])
def test_data_parallel_refuses_without_cards(no_models, monkeypatch, argv,
                                             message):
    """``--data-parallel N`` runs one rank per card; with fewer cards than
    ranks it raises before anything loads (no quiet drop to fewer ranks or
    to the CPU)."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(RuntimeError, match=message):
        tcli.main(argv)


def test_edit_refuses_pag_layers_first(no_models):
    """As the JAX CLI, before anything loads (the IP2P guidance path has
    no PAG); without ``--pag-layers`` and without a card, ``edit`` asks for
    ``--device cpu`` like every model-running command."""
    with pytest.raises(SystemExit, match='does not apply to edit'):
        tcli.main(['edit', '--prompt', 'x', '--image', '/nonexistent.png',
                   '--pag-layers', 'mid', '--models', '/nonexistent'])
    with pytest.raises(RuntimeError, match='--device cpu'):
        tcli.main(['edit', '--prompt', 'x', '--image', '/nonexistent.png'])
    r = subprocess.run([sys.executable, '-m', 'flexdiffuse_tpu_torch.cli',
                        'edit', '--prompt', 'x', '--image', '/none.png',
                        '--pag-layers', 'mid', '--models', '/nonexistent'],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert 'does not apply to edit' in r.stderr


@pytest.mark.parametrize('argv', [
    ['generate'], ['compose', '--schema', 's.json'],
    ['train', '--data', 'd'], ['serve'], ['serve-api']])
def test_the_card_is_the_default(no_models, argv):
    """No CUDA here: every model-running command raises before loading,
    with no CPU fallback."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='--device cpu'):
        tcli.main(argv)


def test_serve_api_refuses_sdxl_at_start(no_models):
    """``serve-api --model-family sdxl`` (which named step 11 before) is
    refused before anything loads: the serving dispatcher encodes with the
    SD-1.x Runner's encoder, which SDXLRunner has not (nor has the JAX
    API's)."""
    with pytest.raises(SystemExit, match='serve-api does not serve'):
        tcli.main(['serve-api', '--model-family', 'sdxl', '--device', 'cpu'])


def test_train_refuses_sdxl_as_jax(no_models, monkeypatch):
    """``train`` with ``model_family`` 'sdxl': both parsers refuse the
    choice on the command line (exit 2); a namespace that carries it (the
    parsed ``train --data d`` with ``model_family`` set, as a caller of
    ``cmd_train`` hands it) stops the JAX CLI with its SystemExit before
    loading anything, and the port with the same message, before any model
    loads and before the device check."""
    argv = ['train', '--data', 'd', '--model-family', 'sdxl']
    for main in (lambda: jcli.main(['--no-compile-cache', *argv]),
                 lambda: tcli.main([*argv, '--device', 'cpu'])):
        with pytest.raises(SystemExit) as exc:
            main()
        assert exc.value.code == 2
    jargs = jax_namespace(monkeypatch, ['train', '--data', 'd'])
    jargs.model_family = 'sdxl'
    with pytest.raises(SystemExit) as jexc:
        JAX_CMD_TRAIN(jargs)
    assert 'SDXL fine-tuning is not wired into the CLI' in str(jexc.value)
    for extra in (['--device', 'cpu'], []):
        targs = tcli.build_parser().parse_args(['train', '--data', 'd',
                                                *extra])
        targs.model_family = 'sdxl'
        with pytest.raises(SystemExit) as texc:
            tcli.cmd_train(targs)
        assert str(texc.value) == str(jexc.value)


def test_ui_app_refuses_without_the_card_and_unported_flags(no_models):
    with pytest.raises(RuntimeError, match='--device cpu'):
        tapp.main([])


# --- what the tenth slice's flags hand the Runner ---------------------------

_PORT_RUNNER_FN = tcli._runner


class FakeRunner:
    """Either package's Runner as the CLI and the app drive it: records its
    construction (normalised) and every later call; loads nothing."""

    output_dir = 'nowhere'

    def __init__(self, log, defaults, **kw):
        self.log = log
        cfgs = {k: kw.get(f'{k}_config', defaults[k])
                for k in ('text', 'vision', 'unet', 'vae')}
        sc = kw.get('scheduler_config')
        log.append(('init', dict(
            scheduler=kw.get('scheduler', 'pndm'),
            scheduler_config=None if sc is None else dataclasses.asdict(sc),
            clip_skip=kw.get('clip_skip', 0),
            **{k: dataclasses.asdict(v) for k, v in cfgs.items()})))

    def __getattr__(self, name):
        if name.startswith(('enable_', 'disable_', 'apply_', 'load_')):
            return lambda *a, **k: self.log.append((name, a, k))
        raise AttributeError(name)

    def gen(self, **kw):
        self.log.append(('gen', kw))
        return [], None

    def compose(self, **kw):
        self.log.append(('compose', kw))
        return [], None

    def edit(self, **kw):
        self.log.append(('edit', kw))
        return [], None


class _Served:
    def serve_forever(self):
        pass


@pytest.fixture()
def fake_runners(no_models, monkeypatch):
    """Both packages' Runner replaced by FakeRunner and their servers by a
    stub that builds the runner once; the no_models refusals stay for
    everything else. Returns the two logs."""
    from flexdiffuse_tpu import runner as jrunner_mod
    from flexdiffuse_tpu.models import configs as jcfg
    logs = {'jax': [], 'port': []}
    jdef = dict(text=jcfg.CLIP_VIT_L14_TEXT, vision=jcfg.CLIP_VIT_L14_VISION,
                unet=jcfg.SD14_UNET, vae=jcfg.SD14_VAE)
    tdef = dict(text=tm.CLIP_VIT_L14_TEXT, vision=tm.CLIP_VIT_L14_VISION,
                unet=tm.SD14_UNET, vae=tm.SD14_VAE)
    monkeypatch.setattr(jrunner_mod, 'Runner',
                        lambda **kw: FakeRunner(logs['jax'], jdef, **kw))
    monkeypatch.setattr('flexdiffuse_tpu_torch.runner.Runner',
                        lambda **kw: FakeRunner(logs['port'], tdef, **kw))
    monkeypatch.setattr(tcli, '_runner', _PORT_RUNNER_FN)

    def serve(factory, *a, **k):
        factory()
        return _Served()

    for target in ('flexdiffuse_tpu.interface.server.launch',
                   'flexdiffuse_tpu.serving.launch',
                   'flexdiffuse_tpu_torch.interface.server.launch',
                   'flexdiffuse_tpu_torch.serving.launch'):
        monkeypatch.setattr(target, serve)
    return logs


@pytest.mark.parametrize('argv', STEP9, ids=[' '.join(a) for a in STEP9])
def test_step9_flags_reach_the_runner_as_in_jax(fake_runners, monkeypatch,
                                                tmp_path, argv):
    """Each flag that named ROADMAP step 9 before the tenth slice: the
    port's Runner is built and driven exactly as the JAX CLI builds and
    drives its own (scheduler and SchedulerConfig, model geometry,
    ``enable_*`` calls, ``gen``/``compose`` keywords)."""
    argv = [str(_files(tmp_path)['schema']) if a == 'SCHEMA' else a
            for a in argv]
    if argv[0] == 'train':
        return _train_sd2_as_in_jax(monkeypatch, argv)
    assert jcli.main(['--no-compile-cache', *argv]) == 0
    assert tcli.main([*argv, '--device', 'cpu']) == 0
    jlog, tlog = fake_runners['jax'], fake_runners['port']
    assert tlog[0][0] == 'init' and tlog == jlog
    flag = argv[1]
    if flag in ('--karras', '--v-prediction', '--zero-snr',
                '--timestep-spacing'):
        assert tlog[0][1]['scheduler_config'] is not None
    if flag == '--model-family':
        assert tlog[0][1]['text']['hidden_size'] == 1024
        assert tlog[0][1]['unet']['head_dim'] == 64


@pytest.mark.parametrize('argv', STEP10, ids=[' '.join(a) for a in STEP10])
def test_step10_flags_reach_the_runner_as_in_jax(fake_runners, tmp_path,
                                                 argv):
    """The port's Runner is built and driven as the JAX CLI builds and
    drives its own: ``load_controlnet``/``load_ip_adapter`` (with
    ``image_encoder_dir``) in the JAX order, then ``gen`` with the control
    and IP images opened from disk and their scales, or ``edit``."""
    image = _files(tmp_path)['guide']
    argv = [image if a == 'IMAGE' else a for a in argv]
    assert jcli.main(['--no-compile-cache', *argv]) == 0
    assert tcli.main([*argv, '--device', 'cpu']) == 0
    jlog, tlog = fake_runners['jax'], fake_runners['port']
    assert tlog[0][0] == 'init' and tlog == jlog
    names = [entry[0] for entry in tlog]
    if '--controlnet' in argv:
        assert ('load_controlnet', ('c',), {}) in tlog
    if '--ip-adapter' in argv:
        encoder = 'e' if '--ip-encoder' in argv else None
        assert ('load_ip_adapter', ('a',),
                {'image_encoder_dir': encoder}) in tlog
    if argv[0] == 'generate':
        kw = tlog[-1][1]
        assert names[-1] == 'gen'
        assert (kw['control_image'] is not None) == ('--control-image' in
                                                     argv)
        assert (kw['ip_image'] is not None) == ('--ip-image' in argv)
        assert kw['controlnet_scale'] == (0.5 if '--controlnet-scale' in
                                          argv else 1.0)
        assert kw['ip_scale'] == (0.3 if '--ip-scale' in argv else 1.0)
    if argv[0] == 'edit':
        assert names[-1] == 'edit'
        assert tlog[-1][1]['image_guidance_scale'] == 1.2


class _Stop(Exception):
    pass


def ti_calls(monkeypatch, tmp_path, argv):
    """The arguments the JAX CLI and the port hand
    ``train_textual_inversion`` for ``argv`` (DATA: a folder of two
    images), both callees replaced by recorders and no model loaded:
    ``{'jax': {...}, 'port': {...}}``, the models as placeholders."""
    from flexdiffuse_tpu.text.tokenizer import CLIPTokenizer
    data = tmp_path / 'ti_data'
    data.mkdir(exist_ok=True)
    for i in range(2):
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(
            data / f'{i}.png')
    argv = [str(data) if a == 'DATA' else a for a in argv]
    seen = {}
    monkeypatch.setattr('flexdiffuse_tpu.weights.load.load_clip',
                        lambda *a, **k: ('TEXT', 'VISION'))
    monkeypatch.setattr('flexdiffuse_tpu.weights.load.load_sd',
                        lambda *a, **k: ('UNET', 'VAE'))
    monkeypatch.setattr(CLIPTokenizer, 'from_dir',
                        classmethod(lambda cls, d: 'TOKENIZER'))

    def jax_ti(text_model, text_params, tokenizer, unet, unet_params, vae,
               vae_params, paths, placeholder, **kw):
        seen['jax'] = dict(models=(text_params, tokenizer, unet_params,
                                   vae_params), paths=paths,
                           placeholder=placeholder, **kw)

    monkeypatch.setattr('flexdiffuse_tpu.training.train_textual_inversion',
                        jax_ti)
    assert jcli.main(['--no-compile-cache', *argv]) == 0
    encoder = types.SimpleNamespace(text_model='TEXT', tokenizer='TOKENIZER')
    monkeypatch.setattr(tcli, '_train_models',
                        lambda args, device: (encoder, 'UNET', 'VAE'))

    def port_ti(text_model, tokenizer, unet, vae, paths, placeholder, **kw):
        seen['port'] = dict(models=(text_model, tokenizer, unet, vae),
                            paths=paths, placeholder=placeholder, **kw)

    monkeypatch.setattr(
        'flexdiffuse_tpu_torch.training.train_textual_inversion', port_ti)
    assert tcli.main([*argv, '--device', 'cpu']) == 0
    return seen


def assert_ti_calls_agree(seen) -> None:
    """The port's ``train_textual_inversion`` arguments equal the JAX
    CLI's: the same models, images, placeholder, initializer, vector
    count, templates, TrainConfig, steps, batch, resolution and output, and
    ``seed`` for JAX's ``key``."""
    want, got = dict(seen['jax']), dict(seen['port'])
    key, seed = want.pop('key'), got.pop('seed')
    np.testing.assert_array_equal(np.asarray(key),
                                  np.asarray(jax.random.PRNGKey(seed)))
    assert dataclasses.asdict(got.pop('cfg')) == \
        dataclasses.asdict(want.pop('cfg'))
    assert got == want


@pytest.mark.parametrize('argv', STEP12, ids=[' '.join(a[3:]) for a in STEP12])
def test_step12_flags_reach_textual_inversion_as_in_jax(
        no_models, monkeypatch, tmp_path, argv):
    """Each textual-inversion flag that named ROADMAP step 12 before the
    thirteenth slice reaches ``train_textual_inversion`` as in the JAX CLI:
    every image captioned 'x', the embedding written to
    ``embedding.safetensors`` by default, ``seed or 0``."""
    seen = ti_calls(monkeypatch, tmp_path, argv)
    assert_ti_calls_agree(seen)
    got = seen['port']
    assert got['save_path'] == 'embedding.safetensors'
    assert got['seed'] == 0 and len(got['paths']) == 2
    assert got['initializer_token'] == ('cat' if '--init-token' in argv
                                        else '')
    assert got['num_vectors'] == (2 if '--num-vectors' in argv else 1)
    style = '--style-templates' in argv
    assert got['templates'][0] == ('a painting in the style of {}' if style
                                   else 'a photo of a {}')


def _train_sd2_as_in_jax(monkeypatch, argv):
    """``train --model-family sd2``: the JAX CLI loads the OpenCLIP-H text
    tower, SD-2.1's UNet and VAE and trains against v; so does the port."""
    seen = {}

    def jax_load_clip(clip_dir, text_config, vision_config, **kw):
        seen['jax'] = dataclasses.asdict(text_config)
        raise _Stop

    monkeypatch.setattr('flexdiffuse_tpu.weights.load.load_clip',
                        jax_load_clip)
    with pytest.raises(_Stop):
        jcli.main(['--no-compile-cache', *argv])

    def port_models(args, device):
        seen['port'] = {k: dataclasses.asdict(v)
                        for k, v in tcli.family_configs(args).items()}
        return None, None, None

    def train_config(**kw):
        seen['prediction'] = kw['prediction_type']
        raise _Stop

    monkeypatch.setattr(tcli, '_train_models', port_models)
    monkeypatch.setattr('flexdiffuse_tpu_torch.training.TrainConfig',
                        train_config)
    with pytest.raises(_Stop):
        tcli.main([*argv, '--device', 'cpu'])
    from flexdiffuse_tpu.models import configs as jcfg
    assert seen['port']['text'] == seen['jax']
    assert seen['port']['unet'] == dataclasses.asdict(jcfg.SD21_UNET)
    assert seen['port']['vae'] == dataclasses.asdict(jcfg.SD21_VAE)
    assert seen['prediction'] == 'v_prediction'


UI_FLAGS = [['--karras', '--scheduler', 'euler'], ['--v-prediction'],
            ['--model-family', 'sd2'], ['--scheduler', 'unipc']]


@pytest.mark.parametrize('argv', UI_FLAGS, ids=[' '.join(a)
                                                for a in UI_FLAGS])
def test_ui_app_flags_reach_the_runner_as_in_jax(fake_runners, monkeypatch,
                                                 argv):
    """``python -m flexdiffuse_tpu_torch`` builds its Runner as the JAX
    app does for the same flags."""
    from flexdiffuse_tpu.interface import app as japp
    monkeypatch.setattr(sys, 'argv', ['ui', '--no-compile-cache', *argv])
    japp.main()
    tapp.main([*argv, '--device', 'cpu'])
    assert fake_runners['port'] == fake_runners['jax']
    assert len(fake_runners['port']) == 1


# --- download and convert ---------------------------------------------------

def test_download_without_huggingface_hub(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, 'huggingface_hub', None)
    assert tcli.main(['download', '--models', 'nowhere']) == 1
    assert 'huggingface_hub is not installed' in capsys.readouterr().err


def test_download_without_the_network(monkeypatch, capsys, tmp_path):
    """A stand-in ``huggingface_hub`` whose download fails as it does
    offline: 1 and the message (no request leaves the process)."""
    hub = types.ModuleType('huggingface_hub')

    def offline(repo, local_dir):
        raise OSError(f'cannot reach the hub for {repo}')

    hub.snapshot_download = offline
    monkeypatch.setitem(sys.modules, 'huggingface_hub', hub)
    assert tcli.main(['download', '--models', str(tmp_path)]) == 1
    assert 'download failed (OSError)' in capsys.readouterr().err


@pytest.fixture()
def tiny_configs(monkeypatch):
    """The CLI's model geometry set to the tiny snapshot's."""
    monkeypatch.setattr(tcli, 'MODEL_CONFIGS', dict(
        text=CONFIGS['text'][1], vision=CONFIGS['vision'][1],
        unet=tm.TINY_UNET, vae=tm.TINY_VAE))


def _leaves_equal(got, want, path=''):
    assert isinstance(got, dict) == isinstance(want, dict), path
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _leaves_equal(got[k], want[k], f'{path}/{k}')
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, path
    np.testing.assert_array_equal(got, want, err_msg=path)


def test_convert_writes_the_jax_caches(model_root, tiny_configs,  # noqa: F811
                                       monkeypatch):
    sd_dir, clip_dir = _dirs(model_root)
    jtext, jvision = CONFIGS['text'][0], CONFIGS['vision'][0]
    want_clip = jload.load_clip(clip_dir, jtext, jvision, cache=False)
    want_sd = jload.load_sd(sd_dir, J_TINY_UNET, J_TINY_VAE, cache=False)
    assert tcli.main(['convert', '--models', str(model_root)]) == 0
    names = {f'flexdiffuse_tpu_clip_{jload._config_tag(jtext, jvision)}'
             '.msgpack',
             f'flexdiffuse_tpu_sd_{jload._config_tag(J_TINY_UNET, J_TINY_VAE)}'
             '.msgpack'}
    written = {n for d in (clip_dir, sd_dir) for n in os.listdir(d)
               if n.endswith('.msgpack')}
    assert written == names

    def no_rebuild(*a, **k):
        raise AssertionError('the JAX loader converted instead of reading '
                             'the cache')

    for name in ('convert_clip_text', 'convert_clip_vision', 'convert_unet',
                 'convert_vae'):
        monkeypatch.setattr(jconvert, name, no_rebuild)
    got_clip = jload.load_clip(clip_dir, jtext, jvision, cache=True)
    got_sd = jload.load_sd(sd_dir, J_TINY_UNET, J_TINY_VAE, cache=True)
    for got, want in zip(got_clip + got_sd, want_clip + want_sd):
        _leaves_equal(jax.tree.map(np.asarray, got),
                      jax.tree.map(np.asarray, want))


def test_cache_tags_agree_with_jax():
    """The port's tag of each default config equals the JAX loader's."""
    from flexdiffuse_tpu.models import configs as jcfg
    assert tload._config_tag(tm.CLIPTextConfig(), tm.CLIPVisionConfig()) == \
        jload._config_tag(jcfg.CLIPTextConfig(), jcfg.CLIPVisionConfig())
    assert tload._config_tag(tm.SD14_UNET, tm.SD14_VAE) == \
        jload._config_tag(jcfg.UNetConfig(), jcfg.VAEConfig())


# --- end to end on the tiny snapshot, CPU -----------------------------------

def _pngs(d):
    return sorted(n for n in os.listdir(d) if n.endswith('.png'))


def test_generate_end_to_end(model_root, tiny_configs, tmp_path):  # noqa: F811
    out = tmp_path / 'out'
    assert tcli.main(['generate', '--models', str(model_root), '--device',
                      'cpu', '--prompt', 'a deer', '--negative-prompt',
                      'blur', '--steps', '2', '--height', '16', '--width',
                      '16', '--samples', '2', '--seed', '3', '--out',
                      str(out)]) == 0
    names = _pngs(out)
    assert len(names) == 2 and all('_t2i_st2_gs8_se3' in n for n in names)
    assert all(Image.open(out / n).size == (16, 16) for n in names)
    assert len(_pngs(out / 'grids')) == 1


def test_compose_end_to_end(model_root, tiny_configs, tmp_path):  # noqa: F811
    out = tmp_path / 'out'
    schema = tmp_path / 's.json'
    schema.write_text(json.dumps({
        'background_prompt': 'a forest', 'style_start_prompt': '',
        'style_end_prompt': '', 'style_blend': [0.0, 1.0],
        'entities': [{'prompt': 'a deer', 'offset': [0, 0], 'size': [8, 8],
                      'blend': 0.8}]}))
    assert tcli.main(['compose', '--models', str(model_root), '--device',
                      'cpu', '--schema', str(schema), '--steps', '2',
                      '--height', '16', '--width', '16', '--samples', '1',
                      '--seed', '2', '--out', str(out)]) == 0
    names = _pngs(out)
    assert len(names) == 1 and 'ct2i_st2_gs8_se2' in names[0]


def test_edit_end_to_end(model_root, tiny_configs, tmp_path,  # noqa: F811
                         monkeypatch):
    """``edit`` on the tiny snapshot made 8-channel (``--sd-model``
    names it; the UNet's input width comes from its ``unet/config.json``):
    the edited PNGs carry the JAX tag and the input's size. The reference's
    ``preprocess`` would resize the PNG to 512², which the tiny VAE's
    single mid attention cannot take on this CPU: a 16² stand-in."""
    from tests.test_torch_loading import eight_channel_root
    monkeypatch.setattr(
        'flexdiffuse_tpu_torch.runner.preprocess',
        lambda im: np.asarray(im.convert('RGB'), np.float32)[None] / 127.5
        - 1.0)
    root = eight_channel_root(model_root, tmp_path / 'models')
    image = tmp_path / 'in.png'
    Image.fromarray(np.random.default_rng(6).integers(
        0, 256, (16, 16, 3), np.uint8)).save(image)
    out = tmp_path / 'out'
    assert tcli.main(['edit', '--models', str(root), '--device', 'cpu',
                      '--sd-model', 'timbrooks/instruct-pix2pix',
                      '--prompt', 'make it winter', '--image', str(image),
                      '--steps', '2', '--seed', '3', '--samples', '2',
                      '--out', str(out)]) == 0
    names = _pngs(out)
    assert len(names) == 2 and all('edit_st2_gs7_igs150_se3' in n
                                   for n in names)
    assert all(Image.open(out / n).size == (16, 16) for n in names)


@pytest.fixture()
def dataset(tmp_path):
    """Two captioned 16² images and a captionless class folder."""
    rng = np.random.default_rng(0)
    for d, n in (('data', 2), ('class', 2)):
        os.makedirs(tmp_path / d)
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, (16, 16, 3), np.uint8)).save(
                tmp_path / d / f'{i}.png')
            if d == 'data':
                (tmp_path / d / f'{i}.txt').write_text(f'a photo of thing {i}')
    return tmp_path


@pytest.mark.parametrize('mode', ['lora', 'full', 'dreambooth'])
def test_train_end_to_end(model_root, tiny_configs, dataset,  # noqa: F811
                          mode):
    out = dataset / {'lora': 'lora.safetensors', 'full': 'unet.msgpack',
                     'dreambooth': 'db.safetensors'}[mode]
    argv = ['train', '--models', str(model_root), '--device', 'cpu',
            '--data', str(dataset / 'data'), '--resolution', '16',
            '--steps', '2', '--batch-size', '1', '--rank', '2', '--seed', '4',
            '--out', str(out)]
    if mode == 'full':
        argv += ['--full', '--lr', '1e-5']
    if mode == 'dreambooth':
        argv += ['--class-data', str(dataset / 'class'), '--class-caption',
                 'a photo']
    assert tcli.main(argv) == 0
    assert out.exists()
    if mode == 'full':
        sd = tload.load_unet_msgpack(str(out), tm.TINY_UNET)
        ref = tm.UNet2DCondition(tm.TINY_UNET).state_dict()
        assert sorted(sd) == sorted(ref)
    else:
        keys = tsafetensors.load_file(str(out))
        assert keys and all(k.startswith('lora_unet_') for k in keys)


def test_train_data_parallel_on_gloo_equals_one_rank(model_root,  # noqa: F811
                                                    tiny_configs, dataset,
                                                    monkeypatch):
    """``train --data-parallel 2 --device cpu``: two gloo ranks train LoRA
    over a data mesh and rank 0 writes the adapter; its factors equal those
    of ``--data-parallel 1`` (1e-5; observed ≤ 1e-7). The ranks' join and
    collectives get time limits here, so a hang fails the test."""
    import functools

    from flexdiffuse_tpu_torch.parallel import launch
    monkeypatch.setattr(launch, 'spawn', functools.partial(
        launch.spawn, timeout=120, join_timeout=300))
    outs = {}
    for dp in (1, 2):
        outs[dp] = dataset / f'lora_dp{dp}.safetensors'
        argv = ['train', '--models', str(model_root), '--device', 'cpu',
                '--data', str(dataset / 'data'), '--resolution', '16',
                '--steps', '2', '--batch-size', '2', '--rank', '2',
                '--seed', '4', '--data-parallel', str(dp),
                '--out', str(outs[dp])]
        assert tcli.main(argv) == 0
    one, two = (tsafetensors.load_file(str(outs[dp])) for dp in (1, 2))
    assert sorted(one) == sorted(two) and one
    for k in one:
        np.testing.assert_allclose(two[k], one[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    assert any(np.abs(v).max() > 0 for k, v in two.items()
               if 'lora_up' in k)


class FakeSDXLRunner:
    """Either package's SDXLRunner as the CLI drives it: records its
    construction and ``gen``; loads nothing."""

    output_dir = 'nowhere'

    def __init__(self, log, root, clip_root=None, scheduler='dpmpp',
                 output_dir='./outputs', refiner_root=None, **kw):
        self.log = log
        log.append(('init', dict(root=root, clip_root=clip_root,
                                 scheduler=scheduler, output_dir=output_dir,
                                 refiner_root=refiner_root)))

    def gen(self, **kw):
        self.log.append(('gen', kw))
        return [], None


@pytest.mark.parametrize('argv', STEP11, ids=[' '.join(a) for a in STEP11])
def test_step11_flags_reach_the_sdxl_runner_as_in_jax(fake_runners,
                                                      monkeypatch, argv):
    """Each flag that named ROADMAP step 11 before the twelfth slice: the
    port builds an SDXLRunner as the JAX CLI builds its own (snapshot root,
    ``clip_root``, scheduler, output dir, refiner) and hands ``gen`` the
    same keywords (``refine_strength`` instead of the hires ones)."""
    import flexdiffuse_tpu.sdxl_runner as jsr
    from flexdiffuse_tpu_torch import sdxl_runner as tsr
    logs = {'jax': [], 'port': []}
    monkeypatch.setattr(jsr, 'SDXLRunner',
                        lambda *a, **k: FakeSDXLRunner(logs['jax'], *a, **k))
    monkeypatch.setattr(tsr, 'SDXLRunner',
                        lambda *a, **k: FakeSDXLRunner(logs['port'], *a,
                                                       **k))
    assert jcli.main(['--no-compile-cache', *argv]) == 0
    assert tcli.main([*argv, '--device', 'cpu']) == 0
    assert logs['port'] == logs['jax']
    (_, init), (_, gen) = logs['port']
    assert init['refiner_root'] == ('r' if '--refiner' in argv else None)
    assert gen['refine_strength'] == (0.5 if '--refine-strength' in argv
                                      else 0.3)
    assert 'hires_scale' not in gen
