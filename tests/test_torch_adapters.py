"""PyTorch port: LoRA merging and textual inversion, held against the JAX
package on the CPU.

The same safetensors adapter goes through the JAX ``apply_lora`` (into its
param trees) and the port's (into the modules, in place); the merged
weights agree within 1e-6 of each weight's max after ``bridge``, and the
unmapped keys are the same. ``sgm_block_map`` is held to JAX on the real
SDXL geometry. ``Runner.apply_lora`` and ``load_textual_inversion`` run end
to end on the tiny disk snapshot, each followed by one pipeline run against
the JAX Runner's (``_compare``'s rule: latents within 1e-4, uint8 within
one level).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from flexdiffuse_tpu.models import TINY_TEXT as J_TINY_TEXT
from flexdiffuse_tpu.models import TINY_UNET as J_TINY_UNET
from flexdiffuse_tpu.models import CLIPTextModel as JText
from flexdiffuse_tpu.models import UNet2DCondition as JUNet
from flexdiffuse_tpu.models import configs as jcfg
from flexdiffuse_tpu.weights import load as jload
from flexdiffuse_tpu.weights import lora as jlora
from flexdiffuse_tpu.weights import textual_inversion as jti
from flexdiffuse_tpu_torch import models as tm
from flexdiffuse_tpu_torch.models import configs as tcfg
from flexdiffuse_tpu_torch.text.tokenizer import FakeTokenizer
from flexdiffuse_tpu_torch.weights import bridge, convert, load
from flexdiffuse_tpu_torch.weights import lora as tlora
from flexdiffuse_tpu_torch.weights import textual_inversion as tti
from tests.test_runner_disk_loading import model_root  # noqa: F401
from tests.test_torch_attention import one_torch_thread  # noqa: F401
from tests.test_torch_loading import _jax_runner, _port_runner, run_both

C = J_TINY_UNET.block_channels[0]      # 32: the level-0 attention width
MID = J_TINY_UNET.block_channels[-1]   # 64: the mid block
D = J_TINY_TEXT.hidden_size


def _pair(rng, out_dim, in_dim, rank=4):
    return (rng.normal(size=(rank, in_dim)).astype(np.float32) * 0.1,
            rng.normal(size=(out_dim, rank)).astype(np.float32) * 0.1)


def _kohya(name, down, up, alpha=None):
    sd = {f'{name}.lora_down.weight': down, f'{name}.lora_up.weight': up}
    if alpha is not None:
        sd[f'{name}.alpha'] = np.asarray(alpha, np.float32)
    return sd


_B0 = 'down_blocks_0_attentions_0_transformer_blocks_0'


def _adapters():
    """name → (LoRA state dict, scale); the JAX package's test cases
    (tests/test_lora.py) and their neighbours."""
    rng = np.random.default_rng(0)
    out = {}
    q = _pair(rng, C, C)
    ff = _pair(rng, C * 8, C)
    out['kohya_attention'] = ({
        **_kohya(f'lora_unet_{_B0}_attn1_to_q', *q, alpha=4.0),
        **_kohya(f'lora_unet_{_B0}_ff_net_0_proj', *ff)}, 0.7)
    down, up = _pair(rng, C, C)
    out['kohya_proj_in_conv'] = (_kohya(
        'lora_unet_down_blocks_0_attentions_0_proj_in',
        down[:, :, None, None], up[:, :, None, None]), 1.0)
    out['kohya_mid_cross_attention'] = ({
        **_kohya('lora_unet_mid_block_attentions_0_transformer_blocks_0_'
                 'attn2_to_out_0', *_pair(rng, MID, MID), alpha=2.0),
        **_kohya('lora_unet_mid_block_attentions_0_transformer_blocks_0_'
                 'attn2_to_k', *_pair(rng, MID, 32)),
        **_kohya('lora_unet_up_blocks_1_attentions_1_transformer_blocks_0_'
                 'ff_net_2', *_pair(rng, C, C * 4))}, 1.3)
    out['kohya_text_encoder'] = ({
        **_kohya('lora_te_text_model_encoder_layers_1_self_attn_q_proj',
                 *_pair(rng, D, D)),
        **_kohya('lora_te1_text_model_encoder_layers_0_mlp_fc1',
                 *_pair(rng, J_TINY_TEXT.intermediate_size, D), alpha=1.0)},
        1.0)
    rank = 4
    out['peft_conv_adapters'] = ({
        'unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q'
        '.lora_A.weight': _pair(rng, C, C, rank)[0],
        'unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q'
        '.lora_B.weight': _pair(rng, C, C, rank)[1],
        'unet.down_blocks.0.resnets.0.conv1.lora_A.weight':
            rng.normal(size=(rank, C, 3, 3)).astype(np.float32) * 0.1,
        'unet.down_blocks.0.resnets.0.conv1.lora_B.weight':
            rng.normal(size=(C, rank, 1, 1)).astype(np.float32) * 0.1,
        'unet.down_blocks.0.resnets.0.time_emb_proj.lora_A.weight':
            _pair(rng, C, 4 * C, rank)[0],
        'unet.down_blocks.0.resnets.0.time_emb_proj.lora_B.weight':
            _pair(rng, C, 4 * C, rank)[1],
        'unet.down_blocks.0.downsamplers.0.conv.lora_A.weight':
            rng.normal(size=(rank, C, 3, 3)).astype(np.float32) * 0.1,
        'unet.down_blocks.0.downsamplers.0.conv.lora_B.weight':
            rng.normal(size=(C, rank, 1, 1)).astype(np.float32) * 0.1,
        'unet.time_embedding.linear_1.lora_A.weight':
            _pair(rng, 4 * C, C, rank)[0],
        'unet.time_embedding.linear_1.lora_B.weight':
            _pair(rng, 4 * C, C, rank)[1]}, 1.0)
    d, u = _pair(rng, D, D)
    out['peft_text_encoder'] = ({
        'text_encoder.text_model.encoder.layers.0.self_attn.q_proj'
        '.lora_A.weight': d,
        'text_encoder.text_model.encoder.layers.0.self_attn.q_proj'
        '.lora_B.weight': u}, 0.5)
    d, u = _pair(rng, C, C)
    out['old_diffusers_lora_naming'] = ({
        'unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k'
        '.lora.down.weight': d,
        'unet.down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_k'
        '.lora.up.weight': u}, 1.0)
    out['unknown_keys_reported'] = ({
        **_kohya(f'lora_unet_{_B0}_attn2_to_v', *_pair(rng, C, 32)),
        **_kohya('lora_unet_down_blocks_0_resnets_0_conv1',
                 *_pair(rng, C, C)),
        f'lora_unet_{_B0}_attn1_to_k.lora_down.weight':
            _pair(rng, C, C)[0],
        'lora_te_text_model_embeddings_token_embedding.lora_up.weight':
            np.zeros((4, 4), np.float32)}, 1.0)
    return out


ADAPTERS = _adapters()


@pytest.fixture(scope='module')
def base():
    """The JAX tiny UNet and text encoder (PRNGKey(0), as
    tests/test_lora.py) and the port's, loaded from them."""
    k = jax.random.PRNGKey(0)
    up = jax.tree.map(np.asarray, JUNet(J_TINY_UNET).init(
        k, jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)), jnp.zeros((1, 77, 32))))
    tp = jax.tree.map(np.asarray, JText(J_TINY_TEXT).init(
        k, jnp.zeros((1, 77), jnp.int32)))
    return up, tp


def _port_models(base):
    up, tp = base
    unet = tm.UNet2DCondition(tm.TINY_UNET)
    unet.load_state_dict(bridge.params_to_state_dict(up, tm.TINY_UNET))
    text = tm.CLIPTextModel(tm.TINY_TEXT)
    text.load_state_dict(bridge.params_to_state_dict(tp, tm.TINY_TEXT))
    return unet, text


def _close(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        w = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-6 * max(np.abs(w).max(), 1e-30),
                                   err_msg=k)


@pytest.mark.parametrize('name', sorted(ADAPTERS))
def test_apply_lora_matches_jax(tmp_path, base, caplog, name):
    sd, scale = ADAPTERS[name]
    path = str(tmp_path / 'lora.safetensors')
    save_file(sd, path)
    up, tp = base
    jsd = jload.load_state_dict(path)
    jmods, junmapped = jlora.parse_lora(jsd)
    tmods, tunmapped = tlora.parse_lora(load.load_state_dict(path))
    assert sorted(tunmapped) == sorted(junmapped)
    assert len(tmods) == len(jmods)
    ju, jt = jlora.apply_lora(up, tp, jsd, scale=scale)
    unet, text = _port_models(base)
    with caplog.at_level('WARNING'):
        merged = tlora.apply_lora(unet, text, load.load_state_dict(path),
                                  scale=scale)
    assert len(merged) == len(tmods)
    assert ('unsupported' in caplog.text) == bool(junmapped)
    _close(unet.state_dict(), bridge.params_to_state_dict(ju, tm.TINY_UNET))
    _close(text.state_dict(), bridge.params_to_state_dict(jt, tm.TINY_TEXT))
    changed = bridge.params_to_state_dict(up, tm.TINY_UNET)
    assert any(not torch.equal(v, changed[k])
               for k, v in unet.state_dict().items()) or \
        any(t == 'te' for t, _ in tmods)


def test_wrong_base_model_and_nothing_applicable_raise(base):
    rng = np.random.default_rng(3)
    unet, _ = _port_models(base)
    wrong = _kohya('lora_unet_down_blocks_5_attentions_0_transformer_blocks_0'
                   '_attn1_to_q', *_pair(rng, 8, 8))
    with pytest.raises(KeyError, match='does not match'):
        jlora.apply_lora(base[0], None, wrong)
    with pytest.raises(KeyError, match='does not match'):
        tlora.apply_lora(unet, None, wrong)
    locon = _kohya('lora_unet_down_blocks_0_resnets_0_conv1',
                   *_pair(rng, 8, 8))
    for fn, model in ((jlora.apply_lora, base[0]), (tlora.apply_lora, unet)):
        with pytest.raises(ValueError, match='no applicable'):
            fn(model, None, locon)


def test_text_lora_without_a_text_model_is_skipped(base, caplog):
    unet, _ = _port_models(base)
    sd, _ = ADAPTERS['kohya_text_encoder']
    before = {k: v.clone() for k, v in unet.state_dict().items()}
    with caplog.at_level('WARNING'):
        assert tlora.apply_lora(unet, None, sd) == set()
    assert 'skipped' in caplog.text
    assert all(torch.equal(v, before[k])
               for k, v in unet.state_dict().items())


def _port_name(head: str) -> str:
    """A JAX UNet tree head → the port's Transformer2D name."""
    if head == 'mid_attn':
        return 'mid_block.attentions.0'
    side, i, _, j = head.split('_')
    return f'{side}_blocks.{i}.attentions.{j}'


@pytest.mark.parametrize('cfg', ['SDXL_UNET', 'TINY_SDXL_UNET',
                                 'SDXL_REFINER_UNET', 'SD14_UNET'])
def test_sgm_block_map_matches_jax(cfg):
    want = {k: _port_name(v)
            for k, v in jlora.sgm_block_map(getattr(jcfg, cfg)).items()}
    assert tlora.sgm_block_map(getattr(tcfg, cfg)) == want


def test_sgm_block_map_real_sdxl_geometry():
    m = tlora.sgm_block_map(tcfg.SDXL_UNET)
    assert m['input_blocks_4_1'] == 'down_blocks.1.attentions.0'
    assert m['input_blocks_8_1'] == 'down_blocks.2.attentions.1'
    assert m['middle_block_1'] == 'mid_block.attentions.0'
    assert m['output_blocks_5_1'] == 'up_blocks.1.attentions.2'
    assert 'input_blocks_1_1' not in m and 'output_blocks_6_1' not in m


def _jax_path_to_port(target, path):
    if target != 'unet':
        return 'text_model.' + '.'.join(
            [path[0], 'layers', path[1][len('layers_'):], *path[2:]])
    return bridge._lora_module_name('/'.join(path))


def test_sgm_lora_parses_as_jax():
    """SGM-named (kohya SDXL) keys, including ``lora_te2_``, map to the
    same modules as in JAX (tests/test_lora.py:215's adapter)."""
    rng = np.random.default_rng(4)
    cfg = jcfg.TINY_SDXL_UNET
    sd = {**_kohya('lora_unet_input_blocks_3_1_transformer_blocks_1_attn2'
                   '_to_v', *_pair(rng, 64, cfg.cross_attention_dim)),
          **_kohya('lora_unet_output_blocks_0_1_transformer_blocks_0_attn1'
                   '_to_q', *_pair(rng, 64, 64)),
          **_kohya('lora_te2_text_model_encoder_layers_0_mlp_fc1',
                   *_pair(rng, 48, 24))}
    jmods, junmapped = jlora.parse_lora(sd, cfg)
    tmods, tunmapped = tlora.parse_lora(sd, tcfg.TINY_SDXL_UNET)
    assert junmapped == tunmapped == []
    want = {(t, _jax_path_to_port(t, p)): v for (t, p), v in jmods.items()}
    assert sorted(tmods) == sorted(want)
    for k, (d, u, a) in want.items():
        td, tu, ta = tmods[k]
        np.testing.assert_array_equal(td, d)
        np.testing.assert_array_equal(tu, u)
        assert ta == a


@pytest.mark.parametrize('spec', ['style.safetensors', 'style.safetensors:0.5',
                                  'C:/loras/x.safetensors:1.25', 'a:b',
                                  'dir/x.safetensors:-0.3'])
def test_parse_spec_matches_jax(spec):
    assert tlora.parse_spec(spec) == jlora.parse_spec(spec)


# --- on the disk snapshot, through the Runners ---------------------------

@pytest.fixture()
def runners(model_root, tmp_path):  # noqa: F811
    out = str(tmp_path / 'out')
    return _jax_runner(model_root, out), _port_runner(model_root, out)


def _runner_lora(path):
    rng = np.random.default_rng(11)
    save_file({
        **_kohya(f'lora_unet_{_B0}_attn1_to_q', *_pair(rng, C, C),
                 alpha=2.0),
        **_kohya(f'lora_unet_{_B0}_attn2_to_k', *_pair(rng, C, 32)),
        **_kohya('lora_te_text_model_encoder_layers_1_mlp_fc2',
                 *_pair(rng, 32, 64))}, path)


def test_runner_apply_lora_matches_jax(runners, tmp_path):
    jr, tr = runners
    path = str(tmp_path / 'style.safetensors')
    _runner_lora(path)
    jr.apply_lora(path, scale=1.5)
    tr.apply_lora(path, scale=1.5)
    run_both(jr, tr, prompt='a deer', negative_prompt='blur')
    # Stacking a second adapter merges onto the first.
    jr.apply_lora(path, scale=-0.5)
    tr.apply_lora(path, scale=-0.5)
    run_both(jr, tr, prompt='a deer', seed=1)


def test_runner_merges_from_the_stored_weights(model_root, tmp_path):  # noqa: F811,E501
    """A bf16 model: the first merge of a weight starts from the snapshot's
    fp32 values (bf16 would drop most of a small update), a stacked one
    from the merged bf16 weight."""
    path = str(tmp_path / 'style.safetensors')
    _runner_lora(path)
    tr = _port_runner(model_root, str(tmp_path), dtype=torch.bfloat16)
    name = 'down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q'
    mod = dict(tr.pipe.unet.named_modules())[name]
    stored = convert.normalize(load.load_state_dict(
        tr._snapshots['unet']), 'unet')[f'{name}.weight'].float()
    (down, up, a), = [v for (t, n), v in tlora.parse_lora(
        load.load_state_dict(path))[0].items() if n == name]
    delta = torch.from_numpy((0.01 * a * (up.astype(np.float64) @
                                          down.astype(np.float64))
                              ).astype(np.float32))
    from_bf16 = (mod.weight.float() + delta).to(torch.bfloat16)
    tr.apply_lora(path, scale=0.01)
    assert torch.equal(mod.weight, (stored + delta).to(torch.bfloat16))
    assert not torch.equal(mod.weight, from_bf16)
    first = mod.weight.clone()
    tr.apply_lora(path, scale=0.01)
    assert torch.equal(mod.weight, (first.float() + delta).to(torch.bfloat16))


def test_runner_textual_inversion_matches_jax(runners, tmp_path):
    jr, tr = runners
    path = str(tmp_path / 'concept.safetensors')
    save_file({'emb_params': np.random.default_rng(5).normal(
        size=(2, 32)).astype(np.float32)}, path)
    jr.load_textual_inversion(path, token='<cept>')
    tr.load_textual_inversion(path, token='<cept>')
    emb = tr.encoder.text_model.text_model.embeddings.token_embedding
    assert emb.weight.shape == (88, 32) and not emb.weight.requires_grad
    assert tr.encoder.text_model.config.vocab_size == 88
    np.testing.assert_array_equal(tr.encoder.tokenizer('a <cept> deer'),
                                  jr.encoder.tokenizer('a <cept> deer'))
    run_both(jr, tr, prompt='a <cept> deer', negative_prompt='blur')


def _ti_cases():
    t = np.arange(24, dtype=np.float32).reshape(3, 8)
    return {'a1111_flattened': ({'string_to_param.*': t}, None),
            'a1111_nested': ({'string_to_param': {'*': t}}, None),
            'emb_params': ({'emb_params': t}, None),
            'diffusers_single': ({'<concept>': t[0]}, None),
            'token_override': ({'emb_params': t}, '<mine>')}


@pytest.mark.parametrize('case', sorted(_ti_cases()))
def test_extract_embedding_formats_match_jax(case):
    sd, token = _ti_cases()[case]
    as_torch = {k: ({kk: torch.from_numpy(vv) for kk, vv in v.items()}
                    if isinstance(v, dict) else torch.from_numpy(v))
                for k, v in sd.items()}
    jtok, jtable = jti.extract_embedding(sd, token)
    ttok, ttable = tti.extract_embedding(as_torch, token)
    assert ttok == jtok
    np.testing.assert_array_equal(ttable, jtable)


def test_extract_embedding_a1111_pt_file(tmp_path):
    path = str(tmp_path / 'x.pt')
    torch.save({'string_to_param': {'*': torch.ones(2, 8)}, 'name': 'x',
                'step': 3}, path)
    tok, table = tti.extract_embedding(load.load_state_dict(path))
    assert tok is None and table.shape == (2, 8)
    with pytest.raises(ValueError, match='cannot locate'):
        tti.extract_embedding({'a': torch.ones(2), 'b': torch.ones(2)})


def test_add_textual_inversion_grows_the_table_in_place():
    torch.manual_seed(0)
    text = tm.CLIPTextModel(tm.TINY_TEXT).to(torch.bfloat16)
    old = text.text_model.embeddings.token_embedding.weight.clone()
    tok = FakeTokenizer(tm.TINY_TEXT.vocab_size)
    table = np.random.default_rng(0).normal(size=(2, 32)).astype(np.float32)
    got = tti.add_textual_inversion(tok, text, '<sks>', table)
    w = got.text_model.embeddings.token_embedding.weight
    assert got is text and w.dtype == torch.bfloat16 and w.shape == (1002, 32)
    assert torch.equal(w[:1000], old)
    assert torch.equal(w[1000:], torch.from_numpy(table).to(torch.bfloat16))
    assert text.config.vocab_size == 1002 and tok.encode('<sks>') == [1000,
                                                                     1001]
    with pytest.raises(ValueError, match='width'):
        tti.add_textual_inversion(tok, text, '<x>',
                                  np.zeros((1, 24), np.float32))
