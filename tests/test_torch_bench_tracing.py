"""``benchmarks/torch_bench_tracing.py``: a benchmark cell with the port's
tracer on.  Its trace reduction counts the same busy time with and without
the program's annotation twins and names a gap after the program span
over it; without program spans it is ``khaosbench.trace``'s.  Its readers
read the window's spans, and read nothing where the run has none.  (The
spans the program records over a job are ``test_torch_timing.py``'s.)"""
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT), str(ROOT / "src")):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from khaosbench import spec, trace  # noqa: E402


def _load():
    """The script by file path, without touching ``sys.path``."""
    found = importlib.util.spec_from_file_location(
        "_bench_torch_bench_tracing",
        ROOT / "benchmarks" / "torch_bench_tracing.py")
    mod = importlib.util.module_from_spec(found)
    found.loader.exec_module(mod)
    return mod


TB = _load()


def _event(name, a, b, device="CPU"):
    return SimpleNamespace(name=name,
                           time_range=SimpleNamespace(start=a, end=b),
                           device_type=SimpleNamespace(name=device))


def _prof(events):
    return SimpleNamespace(events=lambda: events)


BASE = [_event("khaosbench.window", 0, 100),
        _event("khaosbench.step", 0, 60), _event("khaosbench.step", 0, 60,
                                                 "CUDA"),
        _event("k1", 0, 10, "CUDA"), _event("k2", 30, 40, "CUDA"),
        _event("copy", 70, 80, "CUDA"), _event("aten::mm", 1, 2)]
PROGRAM = [_event("repro_torch.trainer.step", 0, 58),
           _event("repro_torch.train.grad", 5, 35),
           _event("repro_torch.train.grad", 5, 35, "CUDA"),
           _event("repro_torch.train.optim", 40, 57),
           _event("repro_torch.train.optim", 40, 57, "CUDA")]


def test_program_twins_are_no_work_and_program_spans_name_the_gaps():
    plain = TB.from_profiler(_prof(BASE))
    spans = TB.from_profiler(_prof(BASE + PROGRAM))
    assert spans.busy_s == plain.busy_s == pytest.approx(30e-6)
    assert spans.window_s == plain.window_s == pytest.approx(100e-6)
    assert sum(spans.idle_by_host.values()) == \
        pytest.approx(sum(plain.idle_by_host.values()))
    rec = SimpleNamespace(trace=spans)
    idle = spec.reader("device_idle_pct")
    assert idle(rec) == idle(SimpleNamespace(trace=plain)) == \
        pytest.approx(70.0)
    # a gap takes the name of the innermost span over its midpoint: 10-30
    # (20) is under train.grad, 40-70 (55) under train.optim, both under
    # the harness's step; 80-100 (90) under nothing
    assert plain.idle_by_host == pytest.approx({"step": 50e-6,
                                                "other": 20e-6})
    assert spans.idle_by_host == pytest.approx({"train.grad": 20e-6,
                                                "train.optim": 30e-6,
                                                "other": 20e-6})
    assert set(spans.op_s) == {"k1", "k2", "copy"}


def test_without_program_spans_the_reduction_is_the_benchmarks():
    ours, theirs = TB.from_profiler(_prof(BASE)), \
        trace.from_profiler(_prof(BASE))
    assert ours == theirs


def _span(i, name, a, b, parent=None, **attrs):
    return {"id": i, "name": name, "start": a, "end": b, "thread": "t",
            "parent": parent, "attrs": attrs}


def test_readers_on_a_synthetic_window():
    spans = [
        _span(1, "trainer.step", -0.5, -0.4, step=1, alloc_retries=9),
        _span(2, "trainer.step", 0.0, 0.1, step=2, alloc_retries=0),
        _span(3, "ckpt.save", 0.1, 0.3, step=2, kind="full",
              bytes_on_link=100),
        _span(4, "ckpt.d2h.first", 0.12, 0.28, 3, step=2, kind="full"),
        _span(5, "ckpt.d2h.background", 0.28, 0.7, 3, step=2, kind="full"),
        _span(6, "trainer.step", 0.3, 0.5, step=3, alloc_retries=2),
        _span(7, "trainer.step", 0.7, 0.8, step=4, alloc_retries=1),
        _span(8, "ckpt.save", 0.8, 0.9, step=4, kind="delta",
              bytes_on_link=3_000_000),
        _span(9, "ckpt.delta.pack", 0.80, 0.82, 8, step=4, kind="delta"),
        _span(10, "ckpt.delta.encode", 0.82, 0.83, 8, step=4, kind="delta"),
        _span(11, "ckpt.delta.stats", 0.83, 0.84, 8, step=4, kind="delta"),
        _span(12, "ckpt.d2h.first", 0.84, 0.85, 8, step=4, kind="delta"),
        _span(13, "ckpt.d2h.wait", 0.85, 0.89, 8, step=4, kind="delta"),
        _span(14, "ckpt.d2h.background", 0.85, 0.89, 8, step=4,
              kind="delta"),
        _span(15, "trainer.step", 0.9, 1.0, step=5, alloc_retries=0)]
    got = TB.readings(SimpleNamespace(spans=spans, trace=None,
                                      traced_step_walls=[]))
    assert got["step_ms.full_d2h"] == pytest.approx(200.0)   # step 3 only
    assert got["step_ms.no_d2h"] == pytest.approx(100.0)     # 2, 4 and 5
    assert got["alloc_retries"] == 3.0                       # not step 1
    assert got["alloc_retries.save"] is None
    assert got["delta_encode_ms"] == pytest.approx(40.0)
    assert got["delta_d2h_ms"] == pytest.approx(50.0)
    assert got["delta_link_mb"] == pytest.approx(3.0)
    assert got["full_first_chunk_ms"] == pytest.approx(160.0)
    assert got["full_blocking_ms"] == pytest.approx(200.0)
    assert got["full_base_ms"] == 0.0
    assert got["full_staged_mb"] is None          # no staged_bytes: no ring
    for name in ("step_idle_ms.grad", "restore_d2h_ms", "restore_copy_ms",
                 "restore_h2d_ms", "landing_pin_ms"):
        assert got[name] is None
    table = TB.span_table(SimpleNamespace(spans=spans))
    assert table["trainer.step"][0] == 4                      # in the window
    assert all(v is None for v in TB.readings(SimpleNamespace()).values())


def _fulls(first: bool):
    """Two full saves (base, then queueing; ``first``: a first chunk in
    between on the first save) and their background D2H with the bytes
    they staged."""
    spans = []
    for k, (t, staged) in enumerate(((0.0, 10_000_000), (1.0, 20_000_000))):
        i = 10 * (k + 1)
        spans += [_span(i, "ckpt.save", t, t + 0.1, step=i, kind="full"),
                  _span(i + 1, "ckpt.full.base", t, t + 0.01, i, step=i,
                        kind="full")]
        if first and k == 0:
            spans.append(_span(i + 2, "ckpt.d2h.first", t + 0.01, t + 0.05,
                               i, step=i, kind="full"))
        spans += [_span(i + 3, "ckpt.d2h.queue", t + 0.05, t + 0.06, i,
                        step=i, kind="full"),
                  _span(i + 4, "ckpt.d2h.background", t + 0.05, t + 0.9,
                        i + 3, step=i, kind="full", staged_bytes=staged)]
    return spans


def test_full_readings_with_and_without_a_first_chunk():
    """A full that only queues has no first chunk: the reading is None
    where no full has one, and the mean over those that do otherwise.  The
    staged bytes are the mean over the fulls' background D2H."""
    def read(spans):
        return TB.readings(SimpleNamespace(spans=spans, trace=None,
                                           traced_step_walls=[]))
    queued, mixed = read(_fulls(first=False)), read(_fulls(first=True))
    assert queued["full_first_chunk_ms"] is None
    assert mixed["full_first_chunk_ms"] == pytest.approx(40.0)
    for got in (queued, mixed):
        assert got["full_staged_mb"] == pytest.approx(15.0)
        assert got["full_base_ms"] == pytest.approx(10.0)
        assert got["full_blocking_ms"] == pytest.approx(100.0)
    # a delta's background D2H is not a full's
    spans = _fulls(first=False) + [
        _span(90, "ckpt.save", 2.0, 2.1, step=90, kind="delta",
              bytes_on_link=5),
        _span(91, "ckpt.d2h.background", 2.0, 2.1, 90, step=90,
              kind="delta", staged_bytes=0)]
    assert read(spans)["full_staged_mb"] == pytest.approx(15.0)
