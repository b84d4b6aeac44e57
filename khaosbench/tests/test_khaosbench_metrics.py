"""The end-to-end arithmetic on synthetic timelines: the 95th percentile
over every event, net progress after a rollback, recovery until the
backlog is back, exactly-once breaks, and the flop count of yi-6b.2l."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from khaosbench import flops, spec, timeline  # noqa: E402
from khaosbench.trace import summarize  # noqa: E402

YI = json.loads((ROOT / "khaosbench/configs/yi-6b.2l.json").read_text())


class Rec:
    """The fields of ``harness.Record`` that the readers use."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_p95_counts_every_event_and_pending_ones_until_the_end():
    arrivals = np.arange(100) * 0.1                   # 10 s of events
    log = [["step", t + 0.05, 10 + i, 1, i + 1]
           for i, t in enumerate(arrivals[:90])]       # 90 done 50 ms late
    rec = Rec(arrivals=arrivals, log=log, cursor0=10, window_s=10.0)
    lat = timeline.event_latencies(log, arrivals, 10, 10.0)
    assert np.allclose(lat[:90], 0.05)
    assert np.allclose(lat[90:], 10.0 - arrivals[90:])
    want = np.percentile(np.concatenate([np.full(90, 0.05),
                                         10.0 - arrivals[90:]]), 95) * 1e3
    assert spec.reader("event_latency_p95_ms")(rec) == pytest.approx(want)


def test_a_replayed_event_counts_at_its_final_processing():
    arrivals = np.array([0.0, 0.0, 0.0, 0.0])
    log = [["step", 1.0, 0, 2, 1], ["step", 2.0, 2, 2, 2],
           ["restore", 2.5, 2, 1],                     # step 2 rolled back
           ["step", 4.0, 2, 2, 2]]
    done = timeline.event_done_times(log, arrivals, 0)
    assert list(done) == [1.0, 1.0, 4.0, 4.0]
    undone = timeline.event_done_times(log[:3], arrivals, 0)
    assert np.isnan(undone[2:]).all()


def test_net_progress_leaves_out_work_a_rollback_threw_away():
    rec = Rec(cursor0=100, cursor_end=160, seq_len=1024, window_s=2.0)
    assert spec.reader("tokens_per_s")(rec) == 60 * 1024 / 2.0


def test_recovery_runs_until_the_backlog_is_back():
    arrivals = np.arange(0.0, 10.0, 0.5)              # 2 events/s
    # caught up (backlog 1) until a failure at 3.2; the restore at 4.0
    # rolls the cursor back to 4
    log = [["step", 0.5 * k + 0.1, k - 1, 1, k] for k in range(1, 7)]
    log.append(["restore", 4.0, 4, 4])
    # backlog 5 at 5.1 and 6.1, back at 1 at 7.1
    log += [["step", 5.1, 4, 2, 5], ["step", 6.1, 6, 2, 6],
            ["step", 7.1, 8, 6, 7]]
    rec = timeline.recovery_times(log, [(3.2, 1)], arrivals, 0, 10.0)
    assert rec == [pytest.approx(3.9)]
    # a failure that never catches up counts until the window's end
    assert timeline.recovery_times(log[:8], [(3.2, 1)], arrivals, 0,
                                   10.0) == [pytest.approx(6.8)]


@pytest.mark.parametrize("case,bad", [
    ("clean", 0), ("skip", 1), ("duplicate", 3), ("restore_cursor", 1),
    ("restore_unknown_step", 2), ("final_cursor", 1)])
def test_exactly_once_breaks_are_counted(case, bad):
    log = [["step", 1, 0, 2, 1], ["step", 2, 2, 2, 2], ["step", 3, 4, 2, 3],
           ["restore", 4, 4, 2], ["step", 5, 4, 2, 3]]
    final = (6, 3)
    if case == "skip":
        log[2][2] = 5
        log[3][2] = 4
    elif case == "duplicate":
        log[1][2] = 0
    elif case == "restore_cursor":
        log[3][2] = 2
        log[4][2] = 2
        final = (4, 3)
    elif case == "restore_unknown_step":
        log[3][3] = 7
        log[4][4] = 8
        final = (6, 8)
    elif case == "final_cursor":
        final = (8, 3)
    assert timeline.cursor_violations(log, 0, 0, *final) == bad


def test_yi_flops_against_a_hand_count():
    # per token: q and o 4096*4096 each, k and v 4096*512 each, SwiGLU
    # 3*4096*11008, two layers, the head 4096*64000
    per_token = 2 * (2 * 4096 * 4096 + 2 * 4096 * 512 + 3 * 4096 * 11008) \
        + 4096 * 64000
    assert flops.matmul_params_per_token(YI) == per_token == 608_174_080
    # causal attention: 2 products x 2 flops x S^2/2 x d, per sequence and
    # layer, x3 for the backward pass
    attn = 3 * 2 * 2 * 1024 * 1024 / 2 * 4096 * 2 * 2
    assert flops.train_step_flops(YI, 2, 1024) == 6 * per_token * 2048 + attn
    assert flops.train_step_flops(YI, 2, 1024) == pytest.approx(7.576e12,
                                                                rel=1e-3)
    # the packed state: params, m and v of 870,338,560 params each
    assert flops.packed_state_elements(YI) == 3 * 870_338_560


def test_trace_reduction_unions_overlaps_and_labels_idle_time():
    device = [("k1", 0, 10), ("k2", 5, 20), ("copy", 40, 50)]
    host = [("khaosbench.step", 0, 30), ("khaosbench.trigger", 25, 60)]
    s = summarize(device, host, 0, 100)
    assert s.busy_s == pytest.approx(30e-6)
    assert s.window_s == pytest.approx(100e-6)
    # the gap 20-40 falls inside both spans: the innermost (trigger) names it
    assert s.idle_by_host == pytest.approx({"trigger": 20e-6,
                                            "other": 50e-6})
    assert s.op_mean_s("k") == pytest.approx(12.5e-6)
    assert s.op_mean_s("absent") is None
    rec = Rec(trace=s)
    assert spec.reader("device_idle_pct")(rec) == pytest.approx(70.0)
