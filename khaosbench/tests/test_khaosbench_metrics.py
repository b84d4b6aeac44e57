"""The end-to-end arithmetic on synthetic timelines: the 95th percentile
over every event, net progress after a rollback, recovery until the
backlog is back, exactly-once breaks; the arrivals a Poisson mix draws,
with its count fixed over the window or in every second; the flop count of yi-6b.2l, and the
counts of both cell configurations pinned; the trace reduction, with the
program's spans beside the benchmark's."""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from khaosbench import flops, spec, timeline  # noqa: E402
from khaosbench.source import arrivals as draw_arrivals  # noqa: E402
from khaosbench.harness import Record  # noqa: E402
from khaosbench.trace import from_profiler, summarize  # noqa: E402

YI = json.loads((ROOT / "khaosbench/configs/yi-6b.2l.json").read_text())
DECODER = spec.model(YI["model"])


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


def test_downtime_runs_until_the_restore_has_ended():
    log = [["step", 0.5 * k + 0.1, k - 1, 1, k] for k in range(1, 7)]
    log += [["restore", 4.0, 4, 4], ["step", 5.1, 4, 2, 5],
            ["restore", 8.5, 6, 5]]
    assert timeline.downtimes(log, [(3.2, 1), (7.9, 0)], 10.0) == [
        pytest.approx(0.8), pytest.approx(0.6)]
    # a failure whose restore never ends in the window counts until its end
    assert timeline.downtimes(log[:6], [(3.2, 1)], 10.0) == [
        pytest.approx(6.8)]


@pytest.mark.parametrize("every", [None, 1.0, 2.5])
def test_a_poisson_mix_offers_every_seed_the_same_counts(every):
    mix = {"source": "poisson", "rate_events_per_s": 4.62}
    if every is not None:
        mix["count_every_s"] = every
    seeds = [7, 2 ** 31 + 11, 3141592601]
    draws = [draw_arrivals(mix, s, 50.0) for s in seeds]
    assert np.array_equal(draws[0], draw_arrivals(mix, seeds[0], 50.0))
    assert not np.array_equal(draws[0], draws[1])
    edges = (np.arange(0.0, 50.0 + 1e-9, every) if every else
             np.array([0.0, 50.0]))
    want = np.diff(np.round(4.62 * edges).astype(int))
    for a in draws:
        assert len(a) == 231 and np.all(np.diff(a) >= 0)
        assert a[0] >= 0.0 and a[-1] <= 50.0
        assert np.array_equal(np.histogram(a, bins=edges)[0], want)


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
    assert DECODER.matmul_params_per_token(YI) == per_token == 608_174_080
    # causal attention: 2 products x 2 flops x S^2/2 x d, per sequence and
    # layer, x3 for the backward pass
    attn = 3 * 2 * 2 * 1024 * 1024 / 2 * 4096 * 2 * 2
    assert DECODER.train_step_flops(YI, 2, 1024) == \
        6 * per_token * 2048 + attn
    assert DECODER.train_step_flops(YI, 2, 1024) == pytest.approx(7.576e12,
                                                                  rel=1e-3)
    # the packed state: params, m and v of 870,338,560 params each
    assert DECODER.packed_state_elements(YI) == 3 * 870_338_560


# (flops a step, int8 encode bytes, packed state elements) at the cells'
# batch and sequence length, as the metrics read them off the record
COUNTS = {"yi-6b.2l": (7_576_322_310_144, 23_519_539_680, 2_611_015_680),
          "olmoe-1b-7b.1l": (4_235_911_495_680, 16_920_376_464,
                             1_878_411_264)}


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_the_counts_of_the_cell_configurations(name):
    cfg = json.loads((ROOT / "khaosbench/configs" / f"{name}.json")
                     .read_text())
    model = spec.model(cfg["model"])
    rec = Record(cfg, cfg["run"]["batch"], cfg["run"]["seq_len"], model)
    step_flops, encode_bytes, packed = COUNTS[name]
    assert rec.flops_per_step == step_flops
    assert rec.int8_encode_bytes == encode_bytes
    assert model.packed_state_elements(cfg) == packed


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


def _event(name, a, b, device="CPU"):
    class Event:
        pass
    e = Event()
    e.name, e.time_range, e.device_type = name, Event(), Event()
    e.time_range.start, e.time_range.end, e.device_type.name = a, b, device
    return e


def test_program_spans_are_host_spans_that_name_idle_gaps():
    """The program's ``repro_torch.*`` spans, like the benchmark's
    ``khaosbench.*`` ones, are host spans: their twins on the device's
    timeline are no work, and an idle gap takes the name of the innermost
    span of either kind over its midpoint, without its prefix."""
    events = [_event("khaosbench.window", 0, 100),
              _event("khaosbench.step", 0, 60),
              _event("khaosbench.step", 0, 60, "CUDA"),
              _event("repro_torch.trainer.step", 0, 58),
              _event("repro_torch.trainer.step", 0, 58, "CUDA"),
              _event("repro_torch.train.grad", 5, 35),
              _event("repro_torch.train.grad", 5, 35, "CUDA"),
              _event("k1", 0, 10, "CUDA"), _event("k2", 30, 40, "CUDA"),
              _event("copy", 70, 80, "CUDA"), _event("aten::mm", 1, 2)]

    class Prof:
        def events(self):
            return events
    s = from_profiler(Prof())
    assert s.busy_s == pytest.approx(30e-6)
    assert s.window_s == pytest.approx(100e-6)
    assert set(s.op_s) == {"k1", "k2", "copy"}
    # 10-30 (20) under train.grad, 40-70 (55) under trainer.step, which
    # started after the harness's step; 80-100 (90) under nothing
    assert s.idle_by_host == pytest.approx({"train.grad": 20e-6,
                                            "trainer.step": 30e-6,
                                            "other": 20e-6})
    assert spec.reader("device_idle_pct")(Rec(trace=s)) == \
        pytest.approx(70.0)
