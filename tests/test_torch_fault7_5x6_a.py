"""Fault 7 at the JAX package's default grid (5 failure points x 6 CIs),
full writes 20.0-24.9 s: the priced recovery of ``chip_smoke.py``'s
Khaos job is > 0 everywhere but at the full writes
``tests/torch_fault7.py`` pins. At the measured full write, the
campaign's matrices equal the sequential deployments'.
"""
import numpy as np
import pytest

import torch_fault7 as f7

GRID = (5, 6)


@pytest.fixture(scope="module")
def pricing():
    return f7.Pricing()


@pytest.mark.parametrize("second", range(20, 25))
def test_priced_recovery_is_positive_but_at_the_pinned_full_writes(
        pricing, second):
    points = f7.second(second)
    bad = [fw for fw in points if not pricing.price(fw, GRID) > 0]
    assert bad == [fw for fw in f7.NONPOSITIVE[GRID] if fw in points]


def test_campaign_matrices_equal_the_sequential_deployments(pricing):
    """At the measured full write, the grid as lanes of one campaign gives
    the (m, z) latency and recovery matrices of one ``SimDeployment`` per
    CI, bit for bit."""
    fw = f7.CALIBRATION["full_write_s"]
    camp, cis, _ = pricing.profile(fw, GRID, engine="numpy")
    seq, cis_seq, _ = pricing.profile(fw, GRID, engine="sequential")
    assert cis == cis_seq and camp.profile.latencies.shape == GRID
    assert camp.phase_log[-1].info["substrate"] == "campaign"
    assert seq.phase_log[-1].info["substrate"] == "sequential"
    np.testing.assert_array_equal(camp.profile.latencies,
                                  seq.profile.latencies)
    np.testing.assert_array_equal(camp.profile.recoveries,
                                  seq.profile.recoveries)
    np.testing.assert_array_equal(camp.m_r._beta, seq.m_r._beta)


def test_the_card_run_that_stopped_reproduces_exactly(pricing):
    """A chip_smoke.py run on an H100 stopped at the check: its
    calibration, replayed here on the NumPy lanes, gives the card's
    recovery matrix (the collapsed cell included) and the card's price to
    the last bit — the torch lane engine on the card and the NumPy lanes
    here agree end to end."""
    cal = f7.CARD_FAILURE_CALIBRATION
    kw = dict(calibration=cal, step_s=f7.CARD_FAILURE_STEP_S)
    rt, _, cost = pricing.profile(cal["full_write_s"], GRID, **kw)
    rec = rt.profile.recoveries
    assert rec.shape == GRID and rec[2, 0] < cost.detect_s + 1.0
    assert (np.delete(rec.ravel(), 2 * GRID[1]) > 80.0).all()
    price = pricing.price(cal["full_write_s"], GRID, **kw)
    assert price == f7.CARD_FAILURE_PRICE < 0
