"""Fault 7 at the JAX package's default grid (5 failure points x 6 CIs),
full writes 30.0-34.0 s: the priced recovery of ``chip_smoke.py``'s
Khaos job is > 0 everywhere but at the full writes
``tests/torch_fault7.py`` pins.
"""
import pytest

import torch_fault7 as f7

GRID = (5, 6)


@pytest.fixture(scope="module")
def pricing():
    return f7.Pricing()


@pytest.mark.parametrize("second", range(30, 35))
def test_priced_recovery_is_positive_but_at_the_pinned_full_writes(
        pricing, second):
    points = f7.second(second)
    bad = [fw for fw in points if not pricing.price(fw, GRID) > 0]
    assert bad == [fw for fw in f7.NONPOSITIVE[GRID] if fw in points]
