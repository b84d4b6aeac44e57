"""The port's live resilient trainer on the yi-6b SMOKE config, on the
CPU, under a device-placed incremental plan — and against the JAX
package's trainer.

Loss tolerance: float32 (``dtype="float32"``, the point is the algorithm)
with different summation orders in the two frameworks, over a few AdamW
steps from the same carried-over state and the same counter-based
stream: rtol 1e-4 (one f32 step agrees to ~1e-6; the bound leaves room
for the differences to compound over the steps compared).
"""
import jax
import numpy as np
import pytest

from repro.checkpoint import CheckpointManager as JaxManager
from repro.config import CheckpointPlan as JaxPlan
from repro.config import OptimizerConfig as JaxOptimizerConfig
from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jax_smoke
from repro.core import missing_handle_methods as jax_missing_handle_methods
from repro.data.stream import EventStream as JaxEventStream
from repro.data.stream import constant_rate as jax_constant_rate
from repro.runtime import ResilientTrainer as JaxTrainer
from repro.runtime import TrainerConfig as JaxTrainerConfig
from repro_torch.config import CheckpointPlan, OptimizerConfig, replace
from repro_torch.config import KhaosConfig
from repro_torch.configs import get_smoke_config
from repro_torch.core import (Decision, KhaosRuntime, PhaseError,
                              missing_handle_methods)
from repro_torch.data.stream import (EventStream, WorkloadRecording,
                                     constant_rate)
from repro_torch.launch.train import main as launch_train
from repro_torch.models import zoo
from repro_torch.runtime import (ResilientTrainer, TrainerConfig,
                                 TrainerJobHandle)
from repro_torch.sim import SimCostModel
from repro_torch.utils.trees import tree_flatten_with_names

jax.config.update("jax_platform_name", "cpu")

PLAN = dict(interval_s=1.0, mode="incremental", full_every=8,
            encode_placement="device", num_shards=2, codec="zlib")


def _trainer(tmp_path, plan=None, dtype="bfloat16"):
    tcfg = TrainerConfig(batch=4, seq_len=16, ckpt_dir=str(tmp_path),
                         time_scale=20.0, detect_s=1.0, restart_s=1.0,
                         plan=plan or CheckpointPlan(**PLAN))
    cfg = replace(get_smoke_config("yi-6b"), dtype=dtype)
    stream = EventStream(schedule=constant_rate(500.0))
    return ResilientTrainer(cfg, tcfg, stream,
                            OptimizerConfig(total_steps=1000, lr=1e-3),
                            device="cpu")


def _run_until(tr, pred, chunk_s=2.0, limit=60):
    for _ in range(limit):
        if pred(tr):
            return
        tr.run(duration_s=chunk_s)
    raise AssertionError("condition not reached")


def _ckpts(tr, kind):
    return [e for e in tr.events
            if e["event"] == "checkpoint" and e["kind"] == kind]


def test_trainer_checkpoints_fails_restores_and_switches_codec(tmp_path):
    tr = _trainer(tmp_path)
    job = TrainerJobHandle(tr)
    assert missing_handle_methods(job) == []
    assert jax_missing_handle_methods(job) == []
    _run_until(tr, lambda t: _ckpts(t, "delta"))
    assert _ckpts(tr, "full")
    tr.inject_failure_at(tr.t, "task")
    _run_until(tr, lambda t: any(e["event"] == "restore" for e in t.events))
    restore = next(e for e in tr.events if e["event"] == "restore")
    assert restore["kind"] == "full+delta"
    assert restore["level"] == "local"
    assert np.isfinite(tr.losses[-1])

    int8 = CheckpointPlan(**{**PLAN, "delta_codec": "int8"})
    job.reconfigure_plan(int8)
    assert job.current_plan().name == int8.name == "incr8-sync-dev-int8"
    assert job.current_ci() == int8.interval_s
    _run_until(tr, lambda t: t.ckpt.stats()["bytes_by_kind"]["delta"] > 0)
    summary = tr.summary()
    assert summary["plan_switches"] == 1
    assert summary["ckpt_stats"]["plan"] == int8.name
    assert summary["ckpt_stats"]["async_errors"] == []


def test_trainer_checkpoint_restores_through_jax_manager(tmp_path):
    tr = _trainer(tmp_path)
    _run_until(tr, lambda t: _ckpts(t, "delta"))
    tr.ckpt.wait()
    jplan = JaxPlan(**PLAN)
    jgot = JaxManager(str(tmp_path), jplan).restore(
        zoo.state_to_numpy(tr.state), "node")
    tgot = tr.ckpt.restore(tr.state, "node")
    assert jgot.kind == tgot.kind == "full+delta"
    assert jgot.step == tgot.step
    assert jgot.extra == tgot.extra
    ja, ta = dict(tree_flatten_with_names(jgot.state)), \
        dict(tree_flatten_with_names(tgot.state))
    assert ja.keys() == ta.keys()
    for k in ja:
        assert np.asarray(ja[k]).tobytes() == np.asarray(ta[k]).tobytes(), k


def test_losses_match_jax_trainer(tmp_path):
    """The first per-step losses of the two trainers, from the same
    carried-over state and stream, checkpoints off."""
    n = 4
    jcfg = jreplace(jax_smoke("yi-6b"), dtype="float32")
    jtr = JaxTrainer(jcfg, JaxTrainerConfig(batch=4, seq_len=16,
                                            ckpt_dir=str(tmp_path / "jax"),
                                            ckpt_interval_s=1e9,
                                            time_scale=20.0),
                     JaxEventStream(schedule=jax_constant_rate(500.0)),
                     JaxOptimizerConfig(total_steps=1000, lr=1e-3,
                                        warmup_steps=2))
    tr = ResilientTrainer(
        replace(get_smoke_config("yi-6b"), dtype="float32"),
        TrainerConfig(batch=4, seq_len=16, ckpt_dir=str(tmp_path / "port"),
                      ckpt_interval_s=1e9, time_scale=20.0),
        EventStream(schedule=constant_rate(500.0)),
        OptimizerConfig(total_steps=1000, lr=1e-3, warmup_steps=2),
        device="cpu")
    tr.state = zoo.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jtr.state), "cpu")
    _run_until(jtr, lambda t: len(t.losses) >= n)
    _run_until(tr, lambda t: len(t.losses) >= n)
    np.testing.assert_allclose(tr.losses[:n], jtr.losses[:n], rtol=1e-4)


class _AnalyticDeployment:
    """A profiling deployment with known surfaces: latency falls and
    recovery grows with the CI (the shapes Phase 2 measures)."""

    def __init__(self, ci: float):
        self.ci = ci

    def profile_failure(self, failure_time: float, margin: float):
        return 0.05 + 2.0 / self.ci, 4.0 + self.ci + 1e-4 * failure_time


def test_khaos_runtime_drives_the_trainer_through_a_plan_switch(tmp_path):
    """The twin of the JAX package's runtime drill with the runtime
    attached: Phase 1 over a recording, Phase 2 over a per-CI deployment
    factory, Phase 3 polling on every trainer step.  The job runs at a CI
    whose predicted recovery breaks the recovery constraint, so the
    controller searches the two plan variants and switches the live
    trainer to the int8 one (same recovery, less checkpoint overhead)."""
    lossless = CheckpointPlan(**{**PLAN, "interval_s": 60.0})
    int8 = replace(lossless, delta_codec="int8")
    tr = _trainer(tmp_path, plan=lossless)
    rt = KhaosRuntime(KhaosConfig(latency_constraint=1e3,
                                  recovery_constraint=40.0,
                                  optimization_period=2.0, ci_min=5.0,
                                  ci_max=60.0, num_failure_points=3,
                                  num_configs=3),
                      cost=SimCostModel(device_encode_s=0.2,
                                        device_encode_s_int8=0.1),
                      plan_variants=[lossless, int8])
    with pytest.raises(PhaseError):
        rt.attach(TrainerJobHandle(tr))
    times = np.arange(600.0)
    rt.record_steady_state(WorkloadRecording(times, 400.0 + times % 50))
    rt.run_profiling(_AnalyticDeployment)
    rt.attach(TrainerJobHandle(tr))
    assert rt.phase_sequence() == ["steady_state", "profiled", "optimizing"]

    decisions = []
    tr.run(duration_s=6.0, on_second=lambda s: decisions.append(rt.step()))
    made = [d for d in decisions if d is not None]
    assert made and all(d.kind in Decision.KINDS for d in made)
    switch = next(d for d in made if d.new_plan is not None)
    assert switch.kind == "reconfigure"
    assert switch.new_plan.delta_codec == "int8"
    assert switch.predicted_recovery > 40.0
    assert tr.ckpt.plan.name == switch.new_plan.name == \
        replace(int8, interval_s=switch.new_ci).name
    assert tr.summary()["plan_switches"] == 1
    assert any(e["event"] == "set_plan" for e in tr.events)


def test_launch_train_local_khaos_runs_on_the_cpu(tmp_path):
    summary = launch_train(["--arch", "yi-6b", "--local", "--khaos",
                            "--duration", "4", "--device", "cpu",
                            "--ckpt-dir", str(tmp_path)])
    assert summary["final_step"] > 0
    assert np.isfinite(summary["final_loss"])
