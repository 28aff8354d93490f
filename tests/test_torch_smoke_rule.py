"""``chip_smoke.py``'s kernel rule on the CPU: an element whose only excess
over "twice the twin's error + 1e-3·max|ref|" is at most one bf16 ulp of
its reference element (a rounding flip next to a bf16 midpoint) passes and
is counted; any larger excess fails. Also the launches a train step
implies (``step_launches``, the module tree on the meta device with
autograd on) for every training mode the script drives, and the parse of
``tools/ptxas_report.py``.
"""
import pytest
import torch

import chip_smoke
from flexdiffuse_tpu_torch.models import SD14_UNET, SDXL_UNET
from flexdiffuse_tpu_torch.tools import ptxas_report
from tests.test_torch_attention import one_torch_thread  # noqa: F401


def _case():
    ref = torch.tensor([0.75, -3.0, 1.0e-3, 12.5, 0.0])
    tol = 2e-3
    return ref, tol


def test_bf16_ulp():
    x = torch.tensor([1.0, 1.5, -3.0, 0.75, 0.0, 12.5])
    # 8 significant bits: 2^-7 in [1, 2), 2^-6 in [2, 4), ...
    want = torch.tensor([2.0**-7, 2.0**-7, 2.0**-6, 2.0**-8, 0.0, 2.0**-4])
    assert torch.equal(chip_smoke.bf16_ulp(x), want)


def test_inside_the_bar_passes_without_flips():
    ref, tol = _case()
    got = ref + torch.tensor([0.99 * tol, -0.99 * tol, 0.0, 0.5 * tol, 0.0])
    assert chip_smoke.within_rule(got, ref, tol) == (True, 0)


def test_one_flipped_element_passes_and_is_counted():
    """Element 3 (12.5, ulp 2^-4) exceeds the bar by 0.9 ulp."""
    ref, tol = _case()
    got = ref.clone()
    got[3] += tol + 0.9 * 2.0**-4
    assert chip_smoke.within_rule(got, ref, tol) == (True, 1)


def test_a_two_ulp_excess_fails():
    """Element 0 (0.75, ulp 2^-8) exceeds the bar by 2 ulps; the flip at
    element 3 is counted but does not rescue it."""
    ref, tol = _case()
    got = ref.clone()
    got[0] += tol + 2 * 2.0**-8
    got[3] -= tol + 0.5 * 2.0**-4
    assert chip_smoke.within_rule(got, ref, tol) == (False, 1)
    # At a zero reference any excess fails.
    got = ref.clone()
    got[4] = tol * 1.001
    assert chip_smoke.within_rule(got, ref, tol)[0] is False


def test_errs_uses_the_rule():
    ref, tol = _case()
    plain = ref + torch.tensor([tol / 2, 0, 0, 0, 0])   # twin error tol/2
    bar = 2 * (tol / 2) + 1e-3 * 12.5
    got = ref.clone()
    got[3] += bar + 0.5 * 2.0**-4
    r = chip_smoke._errs(got, ref, plain)
    assert r['ok'] and r['flipped'] == 1 and r['max_abs_err'] > r['tol']


W = chip_smoke.want_launches
STEP_CASES = [
    # SD-1.4 at 512², batch 4 (steps 9, 11 and 12): the 10 flash-eligible
    # self-attentions need a gradient (K3, K4, K5; K3 twice under remat
    # 'full'); under LoRA K6 serves the 3 GroupNorms before the first
    # adapted layer, under full fine-tuning none.
    ((SD14_UNET, 'lora', 'none', 4, 64), W(k3=10, k4=10, k5=10, k6=3)),
    ((SD14_UNET, 'full', 'full', 4, 64), W(k3=20, k4=10, k5=10)),
    # Textual inversion: the first self-attention sees no trainable input
    # (the context enters at its cross-attention), so it runs on K1.
    ((SD14_UNET, 'ti', 'none', 4, 64), W(k1=1, k3=9, k4=9, k5=9, k6=3)),
    # SDXL at 1024²: 70 self-attentions, no attention on the first level.
    ((SDXL_UNET, 'lora', 'full', 2, 128), W(k3=140, k4=70, k5=70, k6=14)),
    ((SDXL_UNET, 'full', 'full', 1, 128), W(k3=140, k4=70, k5=70)),
]


@pytest.mark.parametrize('args,want', STEP_CASES,
                         ids=[f'{a[0].cross_attention_dim}-{a[1]}-{a[2]}'
                              for a, _ in STEP_CASES])
def test_step_launches(args, want):
    assert chip_smoke.step_launches(*args) == want


def test_ptxas_report_parses_the_verbose_output():
    report = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1kILi64EEvv' for 'sm_90a'
ptxas info    : Function properties for _Z1kILi64EEvv
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes smem, 400 \
bytes cmem[0]
ptxas info    : (C7512) Potential Performance Loss: wgmma.mma_async \
instructions are serialized for the function '_Z1kILi64EEvv'
ptxas warning : (C7515) Potential Performance Loss: wgmma.mma_async \
ignored in the function '_Z1kILi64EEvv'
ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'
ptxas info    : Used 32 registers, used 0 barriers, 400 bytes cmem[0]
"""
    got = ptxas_report.parse(report)
    assert got['_Z1kILi64EEvv'] == dict(
        registers=168, smem_bytes=1024, stack_bytes=0, spill_stores=8,
        spill_loads=4, warnings=['(C7512) Potential Performance Loss: '
                                 'wgmma.mma_async instructions are '
                                 'serialized',
                                 '(C7515) Potential Performance Loss: '
                                 'wgmma.mma_async ignored'])
    assert got['_Z1jv'] == dict(registers=32, smem_bytes=0, warnings=[])


def test_ptxas_report_counts_sass_opcodes_per_function():
    """``--sass``'s counter: each function of ``cuobjdump -sass``'s output,
    the matching instructions by opcode (two MUFU.EX2.BF16 for one bf16
    pair, as ptxas issues ``ex2.approx.ftz.bf16x2``)."""
    sass = (
        '\n\tcode for sm_90a\n\t\tFunction : _Z1fv\n'
        '        /*0010*/   MUFU.EX2.BF16 R5, R24 ;\n'
        '        /*0020*/   MUFU.EX2.BF16 R6, R24.H1 ;\n'
        '        /*0030*/   MUFU.EX2 R7, R8 ;\n'
        '\t\tFunction : _Z1gv\n'
        '        /*0010*/   FFMA R1, R2, R3, R4 ;\n')
    got = ptxas_report.count_sass(sass, r'MUFU[.][A-Z0-9_.]+')
    assert got == {'_Z1fv': {'MUFU.EX2.BF16': 2, 'MUFU.EX2': 1},
                   '_Z1gv': {}}


@pytest.mark.parametrize('key', sorted(chip_smoke.CM_TREE, key=str),
                         ids=lambda k: '-'.join(map(str, k)))
def test_cm_tree_launches(key):
    """The module tree's launches per CFG evaluation with channel_major on
    and off, as chip_smoke.py step 24 asserts them on the card: SD-1.4 at
    512² sends all 10 self-attentions to the cm entry (5 under DeepCache
    'use'), SDXL base at 1024² its 10 at 4096 tokens (cm_min_seq 4096) and
    60 at 1024 to K1; off, K1 takes them all."""
    got = chip_smoke.cm_tree_launches(*key)
    assert {k: got[k] for k in ('cm', 'k1', 'k6')} == chip_smoke.CM_TREE[key]
    assert got['cm_sm90'] == got['cm'] and got['cm_mma'] == 0
