"""Live resilient trainer: the PyTorch data plane the Khaos control plane
supervises (the port of ``repro.runtime.trainer``).

Wires together: streaming batcher (consumer-lag semantics) -> functional
train step -> the unified checkpoint plane (one ``CheckpointManager``
executing a ``CheckpointPlan``: full or delta encoding, host or device
encode placement, memory/local/remote level routing, sync or async commit
— atomically committed WITH the stream cursor for exactly-once) ->
failure injection + failure-kind-aware restore (plus gray-failure
*degradation* windows — straggler / net_delay / backpressure) -> metrics
-> the controller via ``TrainerJobHandle``.

``TrainerJobHandle`` implements the FULL ``JobHandle`` protocol of the
JAX package's ``core.controller``, including ``reconfigure_plan``:
``ResilientTrainer.set_plan`` drains (checkpoint-now under the active
plan), rebuilds the ``CheckpointManager`` from the new plan on the SAME
policy clock and metrics store, and resumes.

Time: the trainer runs on a *virtual clock* driven by measured step wall
times (scaled by ``time_scale``).  ``float(loss)`` synchronises with the
device, so the wall clock read after it covers the whole step.

The trainer runs on the CUDA device unless the caller passes another
``device`` (the tests pass "cpu"); without CUDA and without an explicit
device it raises instead of carrying on on the CPU.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.config import CheckpointPlan, ModelConfig, OptimizerConfig
from repro_torch.config import replace as cfg_replace
from repro_torch.data.pipeline import StreamingBatcher
from repro_torch.data.stream import EventStream
from repro_torch.ft.failures import Degradation, InjectedFailure, jitter_phase
from repro_torch.metrics import MetricsStore
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.utils import timing
from repro_torch.utils.trees import resolve_device, to_tensor, tree_map


def _report_fields(report) -> dict:
    """A save's costs for the event log (an async save's commit fills its
    report later, so its byte counts read 0 here)."""
    return {"blocking_s": report.blocking_s,
            "bytes_on_link": report.bytes_on_link,
            "bytes_written": report.bytes_written}


@dataclass
class TrainerConfig:
    batch: int = 8
    seq_len: int = 64
    ckpt_dir: str = "/tmp/repro_trainer"
    ckpt_interval_s: float = 30.0
    ckpt_async: bool = False
    num_shards: int = 2
    time_scale: float = 1.0        # virtual seconds per wall second of compute
    detect_s: float = 5.0          # simulated detection timeout after a crash
    restart_s: float = 2.0
    # Full mechanism description; when set it wins over the legacy
    # ckpt_interval_s/ckpt_async/num_shards trio above.
    plan: Optional[CheckpointPlan] = None

    def resolved_plan(self) -> CheckpointPlan:
        if self.plan is not None:
            return self.plan
        return CheckpointPlan(interval_s=self.ckpt_interval_s,
                              sync=not self.ckpt_async,
                              num_shards=self.num_shards)


class ResilientTrainer:
    def __init__(self, model_cfg: ModelConfig, tcfg: TrainerConfig,
                 stream: EventStream, opt_cfg: Optional[OptimizerConfig] = None,
                 seed: int = 0, device: Any = None):
        self.device = resolve_device(device)
        self.cfg = model_cfg
        self.tcfg = tcfg
        self.opt_cfg = opt_cfg or OptimizerConfig(total_steps=100_000)
        self.optimizer = make_optimizer(self.opt_cfg)
        self.stream = stream
        self.batcher = StreamingBatcher(stream, tcfg.batch, tcfg.seq_len,
                                        model_cfg.vocab_size, seed=seed)
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, tcfg.resolved_plan(),
                                      device=self.device)
        self.policy = self.ckpt.policy   # the Khaos CI knob lives here
        self.metrics = MetricsStore()
        self.step_fn = zoo.make_train_step(model_cfg, self.optimizer,
                                           self.opt_cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = zoo.init_state(model_cfg, self.optimizer, gen,
                                    self.device)
        self.t = 0.0                       # virtual clock (seconds)
        self.failure_schedule: list[float] = []
        self.degradation_schedule: list[Degradation] = []
        self.events: list[dict] = []
        self.losses: list[float] = []
        self._measured_step_s: Optional[float] = None
        # the state's step on the host, for the trace's step numbers (read
        # from the device only while tracing, when nothing else knows it)
        self._step_no: Optional[int] = None
        self._unhealthy_until = -1.0       # post-restore observation grace
        # active gray-failure windows (mirrors the simulator's dynamics on
        # the virtual clock: ft/failures.py "How degradations act")
        self._dg_step_factor = 1.0         # straggler: virtual step time x
        self._dg_step_until = -np.inf
        self._dg_ck_delay = 0.0            # net_delay to_ckpt_store: extra
        self._dg_ck_jitter = 0.0           # blocking seconds per trigger
        self._dg_ck_t0 = 0.0
        self._dg_ck_until = -np.inf
        self._dg_lat_delay = 0.0           # net_delay to_source: latency
        self._dg_lat_jitter = 0.0          # metric penalty
        self._dg_lat_t0 = 0.0
        self._dg_lat_until = -np.inf
        self._dg_bp_until = -np.inf        # backpressure: triggers held
        self._bp_last_slot = -np.inf
        self.bp_suppressed = 0

    # ------------------------------------------------------------------
    def inject_failure_at(self, t: float, kind: str = "node",
                          host: Optional[int] = None) -> None:
        """Schedule a failure.  ``host`` targets a specific simulated
        host: its node-local checkpoint files (primary shards + held
        replicas) die with it, so the restore that follows is the
        degraded-partial path; host=None keeps the legacy process-loss
        semantics (the node's disk survives)."""
        self.failure_schedule.append((t, kind, host))
        self.failure_schedule.sort(key=lambda f: f[0])

    def inject_degradation_at(self, t: float, kind: str, duration_s: float,
                              severity: float = 0.0, jitter_s: float = 0.0,
                              direction: str = "to_source",
                              host: Optional[int] = None) -> None:
        """Schedule a gray failure (``ft.failures.Degradation`` kinds):
        ``straggler`` inflates virtual step time by ``severity`` for the
        window, ``net_delay``/``to_ckpt_store`` adds blocking seconds to
        every checkpoint trigger, ``net_delay``/``to_source`` inflates the
        latency metric, ``backpressure`` holds triggers past their cadence
        slot (the manager's late-save accounting prices the slip).  The
        job never crashes — that is the point."""
        self.degradation_schedule.append(
            Degradation(t, kind, duration_s, severity, jitter_s, direction,
                        host))
        self.degradation_schedule.sort(key=lambda d: d.t)

    def _begin_degradation(self, d: Degradation) -> None:
        until = d.t + d.duration_s
        if d.kind == "straggler":
            self._dg_step_factor = max(d.severity, 1.0)
            self._dg_step_until = until
        elif d.kind == "net_delay" and d.direction == "to_ckpt_store":
            self._dg_ck_delay, self._dg_ck_jitter = d.severity, d.jitter_s
            self._dg_ck_t0, self._dg_ck_until = d.t, until
        elif d.kind == "net_delay":
            self._dg_lat_delay, self._dg_lat_jitter = d.severity, d.jitter_s
            self._dg_lat_t0, self._dg_lat_until = d.t, until
        else:                              # backpressure
            self._dg_bp_until = until
        self.events.append({"t": self.t, "event": "degradation",
                            "kind": d.kind, "direction": d.direction,
                            "host": d.host, "until": until})

    def healthy(self) -> bool:
        """False during the post-failure grace window, while latency/lag
        samples reflect the recovery rather than the (CI, TR) -> L mapping
        the controller's models were fitted on."""
        return self.t >= self._unhealthy_until

    def set_ci(self, interval_s: float) -> None:
        """Hot CI change (the Khaos actuation; no restart needed here).
        The manager's plan follows so ``current_plan().interval_s`` and
        ``current_ci()`` never disagree."""
        self.policy.set_interval(interval_s, self.t)
        self.ckpt.plan = cfg_replace(self.ckpt.plan, interval_s=interval_s)
        self.events.append({"t": self.t, "event": "reconfigure",
                            "ci": interval_s})

    def drain(self) -> float:
        """Checkpoint-now barrier: quiesce any in-flight async commit, then
        write a cadence-exempt FULL savepoint of state + cursor to every
        configured level (``CheckpointManager.savepoint`` — a regular
        cadence-gated trigger could land memory-only or skip disk levels
        entirely under every-Nth routing).  After drain() returns, nothing
        the job has processed can be lost by a mechanism switch.  Returns
        the blocking seconds (also charged to the virtual clock)."""
        extra = {"pipeline": self.batcher.state_dict(), "t": self.t}
        step = int(self.state["step"].item())
        report = self.ckpt.savepoint(step, self.state, self.t, extra)
        self.events.append({"t": self.t, "event": "checkpoint", "step": step,
                            "kind": "savepoint",
                            "levels": list(report.levels),
                            **_report_fields(report)})
        self.t += report.blocking_s * self.tcfg.time_scale
        return report.blocking_s

    def set_plan(self, plan: CheckpointPlan) -> None:
        """Controlled mechanism switch — the live ``reconfigure_plan``
        actuation (mirrors ``SimJobHandle.reconfigure_plan``'s savepoint +
        restart): drain under the old plan, rebuild the checkpoint plane
        from ``plan``, and resume on the SAME policy clock and metrics
        store.  Checkpoints already on disk remain restorable (the store
        format is plan-independent and the level subdirectories are
        shared), and the drained in-RAM snapshot + delta base carry over
        into the rebuilt manager, so a failure right after the switch
        still recovers the savepoint."""
        old = self.ckpt
        self.drain()
        self.policy.set_interval(plan.interval_s, self.t)
        # rebuild: fresh manager, same policy object -> cadence continuity
        # (the drain's policy.mark anchors the next trigger), same metrics
        # store -> the controller's observation windows span the switch.
        # the manager (not tcfg) is the plan's source of truth after init:
        # mutating the caller-owned TrainerConfig would leak one run's
        # actuations into other trainers built from the same config
        self.ckpt = CheckpointManager(self.tcfg.ckpt_dir, plan,
                                      policy=self.policy,
                                      device=self.device)
        self.ckpt.adopt_runtime_state(old)
        self.events.append({"t": self.t, "event": "set_plan",
                            "plan": plan.name, "ci": plan.interval_s})

    # ------------------------------------------------------------------
    def _checkpoint(self) -> float:
        """Run one checkpoint trigger; returns the blocking duration."""
        extra = {"pipeline": self.batcher.state_dict(), "t": self.t}
        step = self._step_no = int(self.state["step"].item())
        report = self.ckpt.save(step, self.state, self.t, extra)
        self.events.append({"t": self.t, "event": "checkpoint", "step": step,
                            "kind": report.kind,
                            "levels": list(report.levels),
                            **_report_fields(report)})
        return report.blocking_s

    def _restore(self, failure_kind: str = "node",
                 host: Optional[int] = None) -> None:
        with timing.span("trainer.restore"):
            self._restore_state(failure_kind, host)

    def _restore_state(self, failure_kind: str,
                       host: Optional[int]) -> None:
        self.ckpt.on_failure(failure_kind, host=host)
        # samples taken while catching up after the rollback reflect the
        # failure, not steady state — hold healthy() low for a grace window
        self._unhealthy_until = self.t + self.tcfg.detect_s + self.tcfg.restart_s
        try:
            report = self.ckpt.restore(self.state, failure_kind)
        except FileNotFoundError:
            self.events.append({"t": self.t, "event": "restore_fresh"})
            return
        self.state = None              # drop the failed state first
        with timing.span("trainer.restore.h2d"):
            self.state = tree_map(lambda x: to_tensor(x, self.device),
                                  report.state)
        self._step_no = report.step
        self.batcher.restore(report.extra["pipeline"])
        self.events.append({"t": self.t, "event": "restore",
                            "step": report.step, "level": report.level,
                            "kind": report.kind,
                            "degraded": report.degraded,
                            "restored_bytes": report.restored_bytes,
                            "duration_s": report.duration_s})

    # ------------------------------------------------------------------
    def run(self, duration_s: float,
            on_second: Optional[Callable[[dict], None]] = None) -> dict:
        """Run the resilient loop for ``duration_s`` virtual seconds."""
        t_end = self.t + duration_s
        next_metric_t = self.t
        while self.t < t_end:
            try:
                self._run_until_failure(t_end, on_second)
                break
            except InjectedFailure as failure:
                self.events.append({"t": self.t, "event": "failure",
                                    "kind": failure.kind,
                                    "host": failure.host})
                # downtime: detection + restart; lag accrues on the stream
                self.t += self.tcfg.detect_s + self.tcfg.restart_s
                self.stream.produce_until(self.t)
                self._restore(failure.kind, failure.host)
        return self.summary()

    def _run_until_failure(self, t_end: float, on_second) -> None:
        while self.t < t_end:
            if self.failure_schedule and self.t >= self.failure_schedule[0][0]:
                _, kind, host = self.failure_schedule.pop(0)
                raise InjectedFailure(kind=kind, host=host, t=self.t)
            while (self.degradation_schedule
                   and self.t >= self.degradation_schedule[0].t):
                self._begin_degradation(self.degradation_schedule.pop(0))
            if self.t >= self._dg_step_until:
                self._dg_step_factor = 1.0
            self.stream.produce_until(self.t)
            if self.policy.due(self.t):
                if self.t < self._dg_bp_until:
                    # backpressure: the barrier can't complete — hold the
                    # trigger, counting each missed cadence slot once
                    slot = self.policy.next_due(self.t)
                    if slot != self._bp_last_slot:
                        self._bp_last_slot = slot
                        self.bp_suppressed += 1
                        self.events.append({"t": self.t,
                                            "event": "backpressure_skip"})
                else:
                    # only the blocking part (sync write, or async snapshot)
                    # advances the virtual job clock
                    blocking = self._checkpoint()
                    if self.t < self._dg_ck_until:
                        blocking += self._dg_ck_delay + self._dg_ck_jitter \
                            * float(jitter_phase(self.t, self._dg_ck_t0))
                    self.t += blocking * self.tcfg.time_scale
            batch = self.batcher.next_batch()
            if batch is None:
                self.t += 0.05        # idle: stream underrun
                continue
            with self._step_span():
                w0 = time.monotonic()
                with timing.span("trainer.h2d"):
                    bt = {"tokens": torch.from_numpy(batch["tokens"]).to(
                              self.device),
                          "labels": torch.from_numpy(batch["labels"]).to(
                              self.device)}
                self.state, metrics = self.step_fn(self.state, bt)
                with timing.span("trainer.loss_read"):
                    loss = float(metrics["loss"])
                wall = time.monotonic() - w0
            self._measured_step_s = wall
            # a straggler window inflates the virtual step time — the job
            # runs slower without any failure event firing (gray, not dead)
            step_s = wall * self._dg_step_factor
            self.t += step_s * self.tcfg.time_scale
            self.losses.append(loss)
            self.metrics.record("loss", self.t, loss)
            self.metrics.record("step_time", self.t, step_s)
            self.metrics.record("consumer_lag", self.t, self.stream.lag)
            self.metrics.record("arrival_rate", self.t,
                                self.stream.rate_at(self.t))
            lat = self.stream.lag / max(self.tcfg.batch / max(step_s * self.tcfg.time_scale, 1e-6), 1e-9)
            if self.t < self._dg_lat_until:
                lat += self._dg_lat_delay + self._dg_lat_jitter \
                    * float(jitter_phase(self.t, self._dg_lat_t0))
            self.metrics.record("latency", self.t, lat)
            if on_second is not None:
                on_second({"t": self.t, "loss": loss, "lag": self.stream.lag})

    def _step_span(self):
        """The span of one step (the interval ``step_time`` measures),
        numbered by the state's step after it."""
        if self._step_no is not None:
            self._step_no += 1
        if not timing.enabled():
            return timing.OFF
        if self._step_no is None:
            self._step_no = int(self.state["step"]) + 1
        return timing.span("trainer.step", retries_of=self.device,
                           step=self._step_no)

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        self.ckpt.wait()
        return {
            "final_step": int(self.state["step"].item()),
            "final_loss": self.losses[-1] if self.losses else float("nan"),
            "events": self.events,
            "checkpoints": sum(1 for e in self.events if e["event"] == "checkpoint"),
            "failures": sum(1 for e in self.events if e["event"] == "failure"),
            "restores": sum(1 for e in self.events if e["event"] == "restore"),
            "degradations": sum(1 for e in self.events
                                if e["event"] == "degradation"),
            "bp_suppressed": self.bp_suppressed,
            "plan_switches": sum(1 for e in self.events if e["event"] == "set_plan"),
            "measured_step_s": self._measured_step_s,
            "ckpt_stats": self.ckpt.stats(),
        }


# ---------------------------------------------------------------------------
# JobHandle adapter for the Khaos controller (Phase 3, live substrate)
# ---------------------------------------------------------------------------

class TrainerJobHandle:
    """The controller's ``JobHandle`` protocol over the live
    ``ResilientTrainer`` — the full protocol, method for method as the JAX
    package's handle.  ``reconfigure_plan`` is the
    real actuation: drain (checkpoint-now), manager rebuild from the new
    plan, metrics-window continuity."""

    def __init__(self, trainer: ResilientTrainer):
        self.tr = trainer
        self.reconfigurations: list[tuple[float, float]] = []
        self.plan_changes: list[tuple[float, str]] = []

    def now(self) -> float:
        return self.tr.t

    def current_ci(self) -> float:
        return self.tr.policy.interval_s

    def current_plan(self) -> CheckpointPlan:
        return self.tr.ckpt.plan

    def avg_latency(self, window_s: float) -> float:
        return self.tr.metrics.series("latency").mean_over(
            self.tr.t - window_s, self.tr.t)

    def avg_throughput(self, window_s: float) -> float:
        """Trailing-window mean of the arrival rate (the TR the QoS models
        were fitted on), falling back to the instantaneous rate before the
        first step lands a sample."""
        tr_avg = self.tr.metrics.series("arrival_rate").mean_over(
            self.tr.t - window_s, self.tr.t)
        if np.isnan(tr_avg):
            return self.tr.stream.rate_at(self.tr.t)
        return tr_avg

    def healthy(self) -> bool:
        return self.tr.healthy()

    def drain(self) -> None:
        self.tr.drain()

    def reconfigure(self, new_ci: float) -> None:
        """Hot CI swap — no restart on this substrate (DESIGN.md §7.1)."""
        self.reconfigurations.append((self.tr.t, new_ci))
        self.tr.set_ci(new_ci)

    def reconfigure_plan(self, plan: CheckpointPlan) -> None:
        """Mechanism switch: drain + manager rebuild applies mode + CI."""
        self.reconfigurations.append((self.tr.t, plan.interval_s))
        self.plan_changes.append((self.tr.t, plan.name))
        self.tr.set_plan(plan)
