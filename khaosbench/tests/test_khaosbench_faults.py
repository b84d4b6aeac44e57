"""The rest of a run, past the look for a chip, with the timed path
broken underneath: ``correct`` comes out false for each fault the cells
can have, and true for the sound program.  The chaos mix at the SMOKE
size on the CPU has every check: steps, triggers, restores and replays.
(No cell spans chips, so there is no exchange to leave out.)"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src"), str(ROOT / "khaosbench")]

import run as runner  # noqa: E402
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.kernels.ckpt_delta import ops  # noqa: E402
from repro_torch.models import zoo  # noqa: E402
from smoke_cells import smoke_config, smoke_traffic  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _broken_step(monkeypatch, wrap):
    real = zoo.make_train_step

    def make(*a, **k):
        return wrap(real(*a, **k))
    monkeypatch.setattr(zoo, "make_train_step", make)


def unchanged_state(monkeypatch):
    def wrap(step):
        return lambda state, batch: (state, step(state, batch)[1])
    _broken_step(monkeypatch, wrap)


def half_batch(monkeypatch):
    def wrap(step):
        return lambda state, batch: step(
            state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    _broken_step(monkeypatch, wrap)


def token_altered(monkeypatch):
    real = pipeline._tokens_for_events

    def tokens(offsets, seq_len, vocab, seed):
        out = real(offsets, seq_len, vocab, seed)
        out[0, 3] = (out[0, 3] + 1) % vocab
        return out
    monkeypatch.setattr(pipeline, "_tokens_for_events", tokens)


def payload_altered(monkeypatch):
    real = ops.flat_int8_encode

    def encode(*a):
        q, s, changed = real(*a)
        q = torch.where(q < 127, q + 1, q - 1).to(torch.int8)
        return q, s, changed
    monkeypatch.setattr(ops, "flat_int8_encode", encode)


def restore_altered(monkeypatch):
    real = CheckpointManager.restore

    def restore(self, *a, **k):
        report = real(self, *a, **k)
        leaf = report.state["params"]["final_norm"]["scale"]
        report.state["params"]["final_norm"]["scale"] = leaf + np.float32(1)
        return report
    monkeypatch.setattr(CheckpointManager, "restore", restore)


def event_skipped(monkeypatch):
    real = pipeline.StreamingBatcher.next_batch

    def next_batch(self):
        batch = real(self)
        if batch is not None and batch["first_offset"] == 8:
            self.cursor.offset += 1
            self.stream.consumed += 1
        return batch
    monkeypatch.setattr(pipeline.StreamingBatcher, "next_batch", next_batch)


def _run(cfg_name="yi-6b.2l", traced=False):
    cfg = smoke_config(cfg_name, "float32")
    traffic = smoke_traffic("chaos.ci1", rate_events_per_s=20.0, ci_s=0.2)
    return runner.run_cell(BENCH, "yi6b.chaos.ci1", 2 ** 31 + 99, 4.0, traced,
                           "cpu", cfg=cfg, traffic=traffic)[0]


def test_the_sound_program_is_correct():
    out = _run()
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"tokens_per_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_a_traced_run_reads_the_restore_and_the_catch_up():
    out = _run(traced=True)
    assert out["correct"], out["checks"]
    got = {k: v["value"] for k, v in out["metrics"].items()}
    assert {"backlog_recovery_s", "downtime_s", "ckpt_restore_ms",
            "event_latency_p95_ms"} <= set(got)
    assert 0 < got["downtime_s"] <= got["backlog_recovery_s"]
    assert got["ckpt_restore_ms"] < 1e3 * got["downtime_s"]


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   token_altered, payload_altered,
                                   restore_altered, event_skipped],
                         ids=lambda f: f.__name__)
def test_a_fault_makes_the_run_incorrect(monkeypatch, fault):
    fault(monkeypatch)
    assert not _run()["correct"]


@pytest.mark.parametrize("capacity_factor,correct", [(4.0, True),
                                                     (0.5, False)],
                         ids=["dropless", "pairs_dropped"])
def test_pairs_the_moe_dispatch_drops_make_the_run_incorrect(
        capacity_factor, correct):
    """At four times the mean load an expert has a slot for every token of
    the SMOKE batch; at half of it the dispatch drops pairs, which the
    reference (at the same capacity) follows, so only the count of dropped
    pairs can catch it."""
    cfg = smoke_config("olmoe-1b-7b.1l", "float32")
    cfg["capacity_factor"] = capacity_factor
    traffic = smoke_traffic("stream.ci2", ci_s=0.2)
    out = runner.run_cell(BENCH, "olmoe.stream.ci2", 2 ** 31 + 98, 2.0, False,
                          "cpu", cfg=cfg, traffic=traffic)[0]
    dropped = out["checks"]["moe_pairs_dropped"]["value"]
    assert (dropped == 0) == correct
    assert out["correct"] == correct, out["checks"]


def test_the_program_is_freed_before_the_reference_runs(monkeypatch):
    """The reference runs after the window on a card the program no longer
    holds: no reference to the trainer is left by then."""
    import weakref

    from khaosbench.harness import CellRun

    build, reference = CellRun.build, CellRun.reference
    seen = {}

    def tracked_build(self):
        build(self)
        seen["trainer"] = weakref.ref(self.tr)

    def checked_reference(self, *a, **k):
        seen.setdefault("alive", seen["trainer"]() is not None)
        return reference(self, *a, **k)
    monkeypatch.setattr(CellRun, "build", tracked_build)
    monkeypatch.setattr(CellRun, "reference", checked_reference)
    assert _run()["correct"]
    assert seen["alive"] is False
