"""Fault 7 at the card's former grid (2 failure points x 3 CIs), full
writes 20.0-26.9 s: the priced recovery of ``chip_smoke.py``'s Khaos job
is > 0 everywhere but at the full writes ``tests/torch_fault7.py`` pins.
At the measured full write, the campaign's matrices equal the sequential
deployments'.
"""
import numpy as np
import pytest

import torch_fault7 as f7

GRID = (2, 3)


@pytest.fixture(scope="module")
def pricing():
    return f7.Pricing()


@pytest.mark.parametrize("second", range(20, 27))
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
