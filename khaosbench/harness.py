"""One run of one cell: set-up, the measured window, the optional trace of
part of it, and the checks that decide ``correct``.

The system under test is ``repro_torch``'s ``ResilientTrainer``: its own
loop (``run``), batcher, train step and checkpoint manager.  The harness
hands it the benchmark's weights and stream, and wraps four of its calls
to see them on the wall clock: the step (``step_fn``), the checkpoint
trigger (``_checkpoint``), the restore (``_restore``) and the batcher
(``WaitingBatcher``, where the window closes and failures are injected).

Nothing here knows an architecture.  A configuration names its model
module (``"model"``, found by ``spec.model``), and the module gives the
program's ``ModelConfig``, the parameter tree, the train state, the plain
reference, the counts behind the utilisation metrics and the observers
it wraps around the run with the checks they add (a MoE's count of the
pairs its dispatch dropped).  A new configuration of a known architecture
is its JSON file; a new architecture is its JSON file and its model
module.

Set-up builds the trainer once, replaces its weights with the benchmark's
(made from the seed on the device), and drives it through its own loop:
three steps whose loss, first gradient and parameter change the reference
checks, then (in a cell whose checkpoint interval fits in the window) one
full and one int8 delta trigger, which build and load the codec's kernel
and register the host landing, then one more step.  The window follows on
the same object.  In a traced run the program's own tracer
(``repro_torch.utils.timing``) records its spans over the window, kept in
``Record.spans``; its profiler events name the device's idle gaps beside
the harness's own.
"""
from __future__ import annotations

import contextlib
import gc
import subprocess
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint.pipeline import DeltaLeafSource
from repro_torch.config import CheckpointPlan, OptimizerConfig
from repro_torch.ft.failures import InjectedFailure
from repro_torch.runtime import ResilientTrainer, TrainerConfig

from khaosbench import checks, flops, spec, timeline
from khaosbench.rates import card_rates
from khaosbench.reference import tokens as ref_tokens
from khaosbench.reference.tree import flatten
from khaosbench.source import (WaitingBatcher, WallClockStream, WindowClosed,
                               arrivals)
from khaosbench.trace import TraceSummary, from_profiler
from khaosbench.weights import make_params

CHECK_STEPS = 3            # set-up steps the reference follows
TRACE_FROM_S = 1.0         # the trace starts this far into the window ...
TRACE_S = 5.0              # ... and lasts this long (and past one delta)


class _SetupDone(Exception):
    pass


def data_seed(seed: int) -> int:
    """The stream's seed (the events' content) from the run's seed."""
    return seed % (1 << 32)


def program_tracer():
    """The port's tracer module, or None where the port has none."""
    from repro_torch.utils import timing
    return timing if hasattr(timing, "enable") else None


def card_info(device: torch.device) -> dict:
    if device.type != "cuda":
        return {"name": str(device), "power_limit": "none"}
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
             "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "unknown"
    return {"name": name, "power_limit": out or "unknown"}


@dataclass
class Record:
    """What a run saw, for the metric readers (``metrics/*.py``).  Times
    are seconds on the host's clock from the window's start."""
    cfg: dict
    batch: int
    seq_len: int
    model: Any = None                                # the model module
    setup_s: float = 0.0
    window_s: float = 0.0
    log: list = field(default_factory=list)          # timeline entries
    step_walls: list = field(default_factory=list)   # the job's step_time
    triggers: list = field(default_factory=list)     # window's checkpoints
    restores: list = field(default_factory=list)
    failures: list = field(default_factory=list)     # (t, backlog before)
    arrivals: Optional[np.ndarray] = None
    cursor0: int = 0
    cursor_end: int = 0
    trace: Optional[TraceSummary] = None
    # traced: the program's spans over the window (``Span.as_dict()``,
    # start and end in window seconds); None untraced or without a tracer
    spans: Optional[list] = None
    card: dict = field(default_factory=dict)
    setup_parts: dict = field(default_factory=dict)   # for the log only
    traced_step_walls: list = field(default_factory=list)   # ditto
    observed: dict = field(default_factory=dict)   # observer -> summary

    @property
    def flops_per_step(self) -> float:
        return self.model.train_step_flops(self.cfg, self.batch, self.seq_len)

    @property
    def int8_encode_bytes(self) -> int:
        return flops.int8_encode_bytes(
            self.model.packed_state_elements(self.cfg))

    def rates(self):
        return card_rates(self.card["name"])


class CellRun:
    """One cell, one seed: ``setup()``, ``window()``, ``finish()``."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, seconds: float,
                 trace: bool = False, device="cuda",
                 started: Optional[float] = None, here: Path = spec.HERE):
        self.cfg, self.traffic = cfg, traffic
        self.seed, self.seconds, self.trace = seed, float(seconds), trace
        self.device = torch.device(device)
        self.started = time.perf_counter() if started is None else started
        self.model = spec.model(cfg["model"], here)
        run = cfg["run"]
        self.rec = Record(cfg, run["batch"], run["seq_len"], self.model)
        # triggers fire in the window only where the interval fits in it
        self.warm_triggers = traffic["ci_s"] < self.seconds
        self.fingerprints = bool(traffic["failures"])
        self.phase = "setup"
        self.extra_trigger = False
        self.n_steps = 0
        self.log: list = []              # timeline, absolute host times
        self.fed: list = []              # (tokens, labels) of check steps
        self.program = {"losses": []}
        self.fp: dict = {}               # step -> state fingerprint
        self.restore_mismatch = 0
        self.fail_at: list = []
        self.prof = None
        self.traced = False
        self._spans: dict = {}
        self.observers: list = []

    # -- building ----------------------------------------------------------
    def build(self) -> None:
        cfg, traffic, run = self.cfg, self.traffic, self.cfg["run"]
        self.rec.card = card_info(self.device)
        mc = self.model.port_config(cfg)
        self.opt_cfg = OptimizerConfig(**cfg["optimizer"])
        plan = CheckpointPlan(interval_s=traffic["ci_s"], **traffic["plan"])
        self.stream = WallClockStream(traffic.get("rate_events_per_s", 0.0))
        self.tmp = tempfile.TemporaryDirectory(prefix="khaosbench-")
        tcfg = TrainerConfig(batch=run["batch"], seq_len=run["seq_len"],
                             ckpt_dir=self.tmp.name, detect_s=0.0,
                             restart_s=0.0, plan=plan)
        tr = ResilientTrainer(mc, tcfg, self.stream, self.opt_cfg,
                              seed=data_seed(self.seed), device=self.device)
        theirs = [(n, tuple(x.shape)) for n, x in flatten(tr.state["params"])]
        tr.state = None
        params = make_params(self.model.param_shapes(cfg), self.seed,
                             self.device)
        ours = [(n, tuple(x.shape)) for n, x in flatten(params)]
        if theirs != ours:
            raise ValueError("the program's parameter tree differs from the "
                             "benchmark's")
        tr.state = self.model.initial_state(tr, params)
        self._inner_step, tr.step_fn = tr.step_fn, self._step
        self._inner_ckpt, tr._checkpoint = tr._checkpoint, self._checkpoint
        self._inner_restore, tr._restore = tr._restore, self._restore
        tr.batcher = WaitingBatcher(tr.batcher, self.stream, self._poll,
                                    self._deadline, self._span)
        self.tr = tr
        self.observers = self.model.observers(cfg, self.device)
        for obs in self.observers:
            obs.install()

    # -- spans for the trace --------------------------------------------------
    def _span(self, label: str):
        if self.prof is None or self.traced:
            return contextlib.nullcontext()
        return torch.profiler.record_function("khaosbench." + label)

    def _open(self, label: str) -> None:
        cm = self._span(label)
        cm.__enter__()
        self._spans[label] = cm

    def _close(self, label: str) -> None:
        cm = self._spans.pop(label, None)
        if cm is not None:
            cm.__exit__(None, None, None)

    # -- the wrapped calls --------------------------------------------------
    def _step(self, state, batch):
        self._open("step")
        k = self.n_steps if self.phase == "setup" else CHECK_STEPS
        if k < CHECK_STEPS:
            self.fed.append((batch["tokens"].cpu().numpy(),
                             batch["labels"].cpu().numpy()))
            if k == 0:
                self._p0 = {n: x.clone()
                            for n, x in flatten(state["params"])}
        new_state, metrics = self._inner_step(state, batch)
        if k == 0:
            self.program["grad_norms"] = checks.leaf_norms(
                new_state["opt"]["m"], 1.0 - self.opt_cfg.b1)
        if k == CHECK_STEPS - 1:
            self.program["change_norms"] = {
                n: float(torch.linalg.vector_norm(x - self._p0[n]))
                for n, x in flatten(new_state["params"])}
            del self._p0
        return new_state, metrics

    def _on_step(self, info: dict) -> None:
        now = time.perf_counter()
        self._close("step")
        first, count = self.tr.batcher.taken[-1]
        self.log.append(["step", now, first, count,
                         int(self.tr.state["step"])])
        self.n_steps += 1
        if self.phase == "extra":        # one step, then a trigger is due
            self.tr.policy.mark(self.tr.t - self.tr.policy.interval_s)
            return
        if self.phase == "window":
            wall = self.tr.metrics.series("step_time").latest()
            self.rec.step_walls.append(wall)
            if self.prof is not None and not self.traced:
                self.rec.traced_step_walls.append(wall)
            return
        n = self.n_steps
        self.rec.setup_parts[f"step{n}_s"] = now - self.started
        if n <= CHECK_STEPS:
            self.program["losses"].append(info["loss"])
        if self.trace and n == 1:        # the profiler's own set-up
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
        if self.trace and n == 2:
            self.prof.stop()
            from_profiler(self.prof)
            self.prof = None
        last = CHECK_STEPS + (2 if self.warm_triggers else 0)
        if self.warm_triggers and n in (CHECK_STEPS, CHECK_STEPS + 1):
            self.tr.policy.mark(self.tr.t - self.tr.policy.interval_s)
        if n >= last:
            raise _SetupDone

    def _checkpoint(self) -> float:
        if self.fingerprints:
            self.fp[int(self.tr.state["step"])] = \
                checks.fingerprint(self.tr.state)
        t0 = time.perf_counter()
        with self._span("trigger"):
            blocking = self._inner_ckpt()
        ev = self.tr.events[-1]
        self.extra_trigger = self.phase == "extra"
        if self.phase == "window":
            self.rec.triggers.append({"t": t0, "kind": ev["kind"],
                                      "blocking_s": ev["blocking_s"]})
            self.delta_seen = self.delta_seen or ev["kind"] == "delta"
        return blocking

    def _restore(self, failure_kind: str = "node", host=None) -> None:
        t0 = time.perf_counter()
        with self._span("restore"):
            self._inner_restore(failure_kind, host)
        t1 = time.perf_counter()
        ev = self.tr.events[-1]
        if ev["event"] != "restore":           # nothing to restore from
            self.restore_mismatch += 1
            return
        got = checks.fingerprint(self.tr.state)
        want = self.fp.get(ev["step"])
        self.restore_mismatch += (len(got) if want is None else
                                  sum(a != b for a, b in zip(got, want)))
        self.log.append(["restore", t1, self.tr.batcher.cursor.offset,
                         ev["step"]])
        self.rec.restores.append({"t": t0, "duration_s": ev["duration_s"],
                                  "step": ev["step"]})

    # -- window control (WaitingBatcher's hooks) -------------------------------
    def _activities(self) -> list:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return acts

    def _trace_stop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self._close("window")
        self.prof.stop()
        self.traced = True

    def _poll(self, now: float) -> None:
        if self.phase == "extra" and self.extra_trigger:
            raise WindowClosed
        if self.phase != "window":
            return
        if now >= self.seconds:
            self.closed_at = time.perf_counter()
            raise WindowClosed
        if self.fail_at and now >= self.fail_at[0]:
            self.fail_at.pop(0)
            backlog = (self.stream.base + self.stream.arrived(now)
                       - self.tr.batcher.cursor.offset)
            self.rec.failures.append((time.perf_counter(), backlog))
            raise InjectedFailure(kind=self.traffic["failure_kind"],
                                  t=self.tr.t)
        if not self.trace or self.traced:
            return
        if self.prof is None and now >= TRACE_FROM_S:
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self._open("window")
            self.delta_seen = False
            self.trace_until = now + TRACE_S
        elif self.prof is not None and now >= self.trace_until and (
                self.delta_seen or not self.warm_triggers):
            self._trace_stop()

    def _deadline(self) -> float:
        out = [self.seconds] + self.fail_at[:1]
        if self.trace and not self.traced:
            out.append(TRACE_FROM_S if self.prof is None else self.trace_until)
        return min(out)

    # -- the run ------------------------------------------------------------------
    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        parts = self.rec.setup_parts
        parts["imports_s"] = time.perf_counter() - self.started
        self.build()
        parts["build_s"] = time.perf_counter() - self.started
        try:
            self.tr.run(duration_s=1e15, on_second=self._on_step)
        except _SetupDone:
            pass

    def window(self) -> None:
        tr, rec = self.tr, self.rec
        tr.policy.mark(tr.t)           # the first trigger one interval in
        rec.arrivals = arrivals(self.traffic, self.seed, self.seconds)
        self.fail_at = [f * self.seconds for f in self.traffic["failures"]]
        self.delta_seen = False
        self._sync()
        self.stream.start(rec.arrivals, tr.batcher.cursor.offset)
        rec.cursor0 = tr.batcher.cursor.offset
        rec.setup_s = self.stream.t0 - self.started
        self.phase = "window"
        tracer = program_tracer() if self.trace else None
        if tracer is not None:
            tracer.reset()
            tracer.enable()
        try:
            tr.run(duration_s=1e15, on_second=self._on_step)
        except WindowClosed:
            pass
        finally:
            if tracer is not None:
                tracer.disable()
        self.phase = "closed"
        if self.prof is not None and not self.traced:
            self._trace_stop()
        rec.window_s = self.closed_at - self.stream.t0
        rec.cursor_end = tr.batcher.cursor.offset
        t0 = self.stream.t0
        if tracer is not None:
            rec.spans = [dict(sp.as_dict(), start=sp.start - t0,
                              end=sp.end - t0) for sp in tracer.spans()]
        rec.log = [[e[0], e[1] - t0, *e[2:]] for e in self.log]
        rec.failures = [(t - t0, b) for t, b in rec.failures]
        for r in rec.triggers + rec.restores:
            r["t"] -= t0

    def attempted(self) -> int:
        if self.rec.arrivals is not None:
            return int(len(self.rec.arrivals))
        return sum(e[3] for e in self.rec.log if e[0] == "step" and e[1] >= 0)

    def finish(self) -> tuple[dict, dict]:
        """(device facts, {check: (value, limit)}) once the window is over:
        the peak is read first, the program's outputs are checked, the
        program is freed, then the reference runs."""
        self._sync()
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else 0)
        if self.trace and self.prof is not None:
            self.rec.trace = from_profiler(self.prof)
            self.prof = None
        out = {"cursor_violations": (timeline.cursor_violations(
            self.log, 0, 0, self.tr.batcher.cursor.offset,
            int(self.tr.state["step"])), 0)}
        if self.warm_triggers:
            worst, bad_layout = self._payload()
            out["int8_err_over_bound"] = (worst, 1.0)
            out["payload_layout_mismatch"] = (bad_layout, 0)
        if self.fingerprints:
            missing = len(self.traffic["failures"]) - len(self.rec.restores)
            out["restore_mismatch"] = (self.restore_mismatch + abs(missing), 0)
        out.update(self.observe())
        self.release()
        ref, expected = self.reference()
        gaps = checks.training_gaps(self.program, ref,
                                    self.cfg.get("leaf_groups"))
        for k, limit in self.cfg["limits"].items():
            out[k] = (gaps[k], limit)
        out["token_mismatch"] = (checks.token_mismatches(self.fed, expected),
                                 0)
        self.tmp.cleanup()
        return {"memory_peak_bytes": int(peak)}, out

    def observe(self) -> dict:
        """Each observer's summary, kept on the record, and the checks it
        adds; the observers are taken off the program."""
        out = {}
        for obs in self.observers:
            summary = self.rec.observed[obs.name] = obs.summary()
            obs.uninstall()
            out.update(obs.checks(summary))
        self.observers = []
        return out

    def release(self) -> None:
        """Drop every reference to the program (the trainer, its wrapped
        calls, the stream) and give its memory back to the card."""
        self.tr = self.stream = None
        self._inner_step = self._inner_ckpt = self._inner_restore = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _payload(self) -> tuple[float, int]:
        """The newest int8 delta the window put on the host, decoded against
        its base.  Where the window's newest trigger was a full, one more
        step and trigger after the window make a delta."""
        ckpt = self.tr.ckpt
        if ckpt._memory is None or not isinstance(ckpt._memory[1],
                                                  DeltaLeafSource):
            self.phase, self.extra_trigger = "extra", False
            self.stream.start(None, self.tr.batcher.cursor.offset)
            try:
                self.tr.run(duration_s=1e15, on_second=self._on_step)
            except WindowClosed:
                pass
        snap, base = ckpt._memory[1], ckpt._device_base
        if not isinstance(snap, DeltaLeafSource) or snap.layout is None:
            return float("inf"), 1

        def leaf(x):
            x = getattr(x, "tensor", x)
            return torch.from_numpy(x) if isinstance(x, np.ndarray) else x
        entries = [(e.name, e.offset, e.size, e.shape)
                   for e in snap.layout.entries]
        new = {e[0]: leaf(snap._raw[e[0]]) for e in entries}
        old = {e[0]: leaf(base.leaves[e[0]]) for e in entries}
        return checks.payload_error(entries, snap.flat_payload(), new, old,
                                    self.device)

    def reference(self, precision=None, rows=None) -> tuple[dict, list]:
        """The reference's first CHECK_STEPS steps from the same seed, and
        the batches it fed them (``rows``: only that many rows of each,
        for a planted fault)."""
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        run = self.cfg["run"]
        batches = [ref_tokens.step_batch(data_seed(self.seed), k,
                                         run["batch"], run["seq_len"],
                                         self.cfg["vocab_size"])
                   for k in range(CHECK_STEPS)]
        dev = [(torch.from_numpy(t[:rows]).to(self.device),
                torch.from_numpy(l[:rows]).to(self.device))
               for t, l in batches]
        params = make_params(self.model.param_shapes(self.cfg), self.seed,
                             self.device)
        out = self.model.train_steps(params, self.cfg, self.cfg["optimizer"],
                                     dev, precision)
        return out, batches
