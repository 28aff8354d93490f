"""``chip_smoke.py``'s kernel rule on the CPU: an element whose only excess
over "twice the twin's error + 1e-3·max|ref|" is at most one bf16 ulp of
its reference element (a rounding flip next to a bf16 midpoint) passes and
is counted; any larger excess fails.
"""
import torch

import chip_smoke
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
