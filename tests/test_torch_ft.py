"""The port's fault-tolerance layer (``repro_torch.ft``) against the JAX
package's ``repro.ft``: the heartbeat detector, the failure model's MTBF
and Weibull draws, the closed failure vocabulary, the worst-case injector,
elastic rescale and recovery plans, peer loss and the straggler detector.

Each of ``tests/test_ft.py``'s tests has a twin here that runs the same
inputs and seeds through both packages and asserts the reference's own
check on the port.  Both are NumPy and float64, so every output must equal
the reference's exactly: a difference is a fault, not a tolerance.
"""
import dataclasses

import numpy as np
import pytest

import repro.ft as jft
import repro_torch.ft as tft
from repro.config import MeshConfig as JMesh
from repro_torch.config import MeshConfig as TMesh

BOTH = [pytest.param((tft, TMesh), id="port"),
        pytest.param((jft, JMesh), id="jax")]


def _plain(x):
    """A dataclass (of either package) as nested dicts, for equality."""
    return dataclasses.asdict(x) if dataclasses.is_dataclass(x) else x


def _failure(f):
    return (type(f).__name__, f.kind, f.host, f.t, str(f))


def test_heartbeat_detector():
    out = []
    for ft in (tft, jft):
        det = ft.HeartbeatDetector(num_hosts=4, timeout_s=10.0)
        det.heartbeat_all(0.0)
        det.heartbeat(0, 20.0)
        det.heartbeat(1, 20.0)
        assert det.failed_hosts(25.0) == [2, 3]
        assert not det.healthy(25.0)
        out.append([(t, det.failed_hosts(t), det.healthy(t))
                    for t in (5.0, 10.0, 10.5, 30.0, 30.5)]
                   + [det.detection_delay()])
    assert out[0] == out[1]


def _gaps(ft, **kw):
    fm = ft.FailureModel(**kw)
    gaps, t = [], 0.0
    for _ in range(300):
        nt = fm.next_failure_after(t)
        gaps.append(nt - t)
        t = nt
    return gaps, [fm.sample_kind() for _ in range(50)], \
        [fm.sample_host() for _ in range(50)], fm.cluster_mtbf_s


def test_failure_model_mtbf_statistics():
    port = _gaps(tft, mtbf_node_s=86400.0, num_nodes=64, seed=1)
    ref = _gaps(jft, mtbf_node_s=86400.0, num_nodes=64, seed=1)
    assert abs(np.mean(port[0]) - 86400.0 / 64) / (86400.0 / 64) < 0.2
    assert port == ref                    # every gap, kind and host


def test_failure_vocabulary_is_closed():
    for ft in (tft, jft):
        assert ft.KINDS == ft.CRASH_KINDS + ft.DEGRADATION_KINDS
        with pytest.raises(ValueError, match="unknown failure kind"):
            ft.FailureModel(kinds=(("gremlin", 1.0),))
        with pytest.raises(ValueError, match="unknown crash kind"):
            ft.InjectedFailure(kind="net_delay")   # degradations aren't raised
        with pytest.raises(ValueError, match="unknown crash kind"):
            ft.FailureInjector().worst_case_failure(100.0, 0.0, 60.0, 5.0,
                                                    kind="straggler")
        with pytest.raises(ValueError, match="unknown degradation kind"):
            ft.Degradation(0.0, "node", 60.0)     # crashes aren't windows
        with pytest.raises(ValueError, match="unknown direction"):
            ft.Degradation(0.0, "net_delay", 60.0, direction="sideways")
        with pytest.raises(ValueError, match="duration_s > 0"):
            ft.Degradation(0.0, "backpressure", 0.0)
    assert (tft.KINDS, tft.DIRECTIONS) == (jft.KINDS, jft.DIRECTIONS)
    d = dict(t=3.0, kind="net_delay", duration_s=60.0, severity=0.2,
             jitter_s=0.05, direction="to_ckpt_store", host=2)
    assert _plain(tft.Degradation(**d)) == _plain(jft.Degradation(**d))
    t = np.arange(0.0, 10.0, 0.25)
    assert np.array_equal(tft.jitter_phase(t, 0.5), jft.jitter_phase(t, 0.5))


def test_failure_model_weibull():
    kw = dict(mtbf_node_s=86400.0, num_nodes=64, distribution="weibull",
              weibull_shape=0.7, seed=2)
    fms = tft.FailureModel(**kw), jft.FailureModel(**kw)
    gaps = [[fm.next_failure_after(0.0) for _ in range(500)] for fm in fms]
    assert abs(np.mean(gaps[0]) - 86400.0 / 64) / (86400.0 / 64) < 0.25
    assert gaps[0] == gaps[1]


def test_worst_case_injection_lands_before_ckpt_completion():
    out = []
    for ft in (tft, jft):
        inj = ft.FailureInjector(epsilon_s=1.0)
        # interval 60s, ckpt cost 5s, last ckpt at t=0: completions at
        # 65, 125, ...
        t = inj.worst_case_time(100.0, last_ckpt_t=0.0, interval_s=60.0,
                                ckpt_cost_s=5.0)
        assert abs(t - 124.0) < 1e-9      # 120 + 5 - 1
        out.append([t] + [inj.worst_case_time(r, lc, iv, c)
                          for r, lc, iv, c in ((0.0, 0.0, 60.0, 5.0),
                                               (59.9, 0.0, 60.0, 0.5),
                                               (61.0, 3.0, 29.0, 7.5),
                                               (10.0, 0.0, 0.0, 5.0))]
                   + [inj.log])
    assert out[0] == out[1]


@pytest.mark.parametrize("pkg", BOTH)
def test_rescale_keeps_tp_and_divides_batch(pkg):
    ft, Mesh = pkg
    plan = ft.plan_rescale(Mesh(multi_pod=False, data=16, model=16),
                           hosts_alive=60, chips_per_host=4,
                           global_batch=256)
    assert plan.new.model == 16
    assert plan.new.data <= 15
    assert 256 % plan.new.data == 0
    assert plan.batch_ok
    ref = jft.plan_rescale(JMesh(multi_pod=False, data=16, model=16),
                           hosts_alive=60, chips_per_host=4,
                           global_batch=256)
    assert _plain(plan) == _plain(ref) and plan.changed == ref.changed


@pytest.mark.parametrize("pkg", BOTH)
def test_rescale_multi_pod_degrades_to_single(pkg):
    ft, Mesh = pkg
    plan = ft.plan_rescale(Mesh(multi_pod=True, data=16, model=16, pods=2),
                           hosts_alive=65, chips_per_host=4,
                           global_batch=256)   # 260 chips: 2 pods unevenly
    assert plan.new.num_devices <= 260
    assert plan.new.model == 16
    ref = jft.plan_rescale(JMesh(multi_pod=True, data=16, model=16, pods=2),
                           hosts_alive=65, chips_per_host=4,
                           global_batch=256)
    assert _plain(plan) == _plain(ref)


def test_rescale_raises_below_tp():
    for ft, Mesh in ((tft, TMesh), (jft, JMesh)):
        with pytest.raises(ValueError, match="cannot keep TP=16"):
            ft.plan_rescale(Mesh(data=16, model=16), hosts_alive=3,
                            chips_per_host=4)


def test_rescale_batch_walkdown_terminates_at_data_one():
    """A prime global batch divides nothing: the walk-down ends at
    data=1, where any batch divides."""
    plans = [ft.plan_rescale(Mesh(data=16, model=16), hosts_alive=60,
                             chips_per_host=4, global_batch=977)
             for ft, Mesh in ((tft, TMesh), (jft, JMesh))]
    assert plans[0].new.data == 1 and plans[0].new.model == 16
    assert plans[0].batch_ok
    assert _plain(plans[0]) == _plain(plans[1])
    # every batch from 1 to 300 walks down to the reference's mesh
    for gb in range(1, 301):
        a, b = (ft.plan_rescale(Mesh(data=16, model=16), hosts_alive=60,
                                global_batch=gb)
                for ft, Mesh in ((tft, TMesh), (jft, JMesh)))
        assert _plain(a) == _plain(b), gb


def test_rescale_multi_pod_symmetry_demotion_threshold():
    out = []
    for ft, Mesh in ((tft, TMesh), (jft, JMesh)):
        mesh = Mesh(multi_pod=True, data=16, model=16, pods=2)
        # below 2*model chips the pods cannot stay symmetric: single pod
        demoted = ft.plan_rescale(mesh, hosts_alive=5, chips_per_host=4)
        assert not demoted.new.multi_pod and demoted.new.model == 16
        # exactly 2*model chips is the smallest symmetric multi-pod mesh
        kept = ft.plan_rescale(mesh, hosts_alive=8, chips_per_host=4)
        assert kept.new.multi_pod and kept.new.data == 1
        out.append([_plain(ft.plan_rescale(mesh, hosts_alive=h))
                    for h in range(4, 140)])
    assert out[0] == out[1]


def test_recovery_standby_path_keeps_mesh():
    out = []
    for ft, Mesh in ((tft, TMesh), (jft, JMesh)):
        mesh = Mesh(data=16, model=16)
        rec = ft.plan_recovery(mesh, hosts_lost=2, standbys=4)
        assert rec.mesh == mesh and not rec.rescaled and rec.rescale is None
        assert rec.standbys_used == 2 and rec.standbys_left == 2
        out.append(_plain(rec))
    assert out[0] == out[1]


def test_recovery_exhausted_standbys_rescales_down():
    out = []
    for ft, Mesh in ((tft, TMesh), (jft, JMesh)):
        mesh = Mesh(data=16, model=16)     # 256 chips = 64 hosts
        rec = ft.plan_recovery(mesh, hosts_lost=5, standbys=1,
                               chips_per_host=4, global_batch=256)
        assert rec.rescaled and rec.standbys_left == 0
        assert rec.mesh.num_devices < mesh.num_devices
        assert rec.mesh.model == 16              # TP pinned through recovery
        assert 256 % rec.mesh.data == 0          # batch still shards cleanly
        assert rec.rescale.hosts_alive == 60     # 64 + 1 standby - 5 lost
        with pytest.raises(ValueError):
            ft.plan_recovery(mesh, hosts_lost=-1, standbys=0)
        out.append([_plain(ft.plan_recovery(mesh, hosts_lost=lost,
                                            standbys=sb, global_batch=96))
                    for lost in range(0, 40, 3) for sb in (0, 2, 7)])
    assert out[0] == out[1]


def test_worst_case_failure_is_host_targeted():
    out = []
    for ft in (tft, jft):
        inj = ft.FailureInjector(epsilon_s=1.0)
        f = inj.worst_case_failure(100.0, last_ckpt_t=0.0, interval_s=60.0,
                                   ckpt_cost_s=5.0, kind="node", host=3)
        assert abs(f.t - 124.0) < 1e-9            # the §III-C time
        assert f.kind == "node" and f.host == 3
        assert "host 3" in str(f)
        assert inj.log[-1]["host"] == 3 and inj.log[-1]["kind"] == "node"
        out.append((_failure(f), inj.log))
    assert out[0] == out[1]


def test_peer_loss_kills_host_then_its_ring_peer():
    out = []
    for ft in (tft, jft):
        inj = ft.FailureInjector(epsilon_s=1.0)
        failures = inj.peer_loss(100.0, last_ckpt_t=0.0, interval_s=60.0,
                                 ckpt_cost_s=5.0, host=3, num_hosts=4)
        assert [f.host for f in failures] == [3, 0]   # ring peer of 3 is 0
        assert all(f.kind == "node" for f in failures)
        # the second kill lands inside the window, before any new
        # checkpoint could complete
        assert failures[0].t < failures[1].t <= failures[0].t + 5.0
        assert inj.log[-1]["scenario"] == "peer_loss"
        # degenerate ring: a single host has no peer to lose
        solo = ft.FailureInjector().peer_loss(0.0, 0.0, 60.0, 1.0,
                                              host=0, num_hosts=1)
        assert len(solo) == 1
        short = inj.peer_loss(30.0, 0.0, 4.0, 0.5, host=5, num_hosts=8,
                              replication_factor=2)
        out.append(([_failure(f) for f in failures + solo + short],
                    inj.log))
    assert out[0] == out[1]


def _straggle(ft, num_hosts, slow, blips=(), **kw):
    det = ft.StragglerDetector(num_hosts=num_hosts, **kw)
    rng = np.random.default_rng(0)
    flagged = []
    for t in range(40):
        times = {h: 1.0 + rng.normal(0, 0.02) for h in range(num_hosts)}
        if slow is not None and t >= 10:
            times[slow] = 2.5
        if t in blips:
            times[1] = 3.0
        flagged += det.observe_step(float(t), times)
    return flagged, det.flagged, det.history, dict(det._slow_streak)


def test_straggler_detector_flags_persistent_slow_host():
    port = _straggle(tft, 4, slow=2, slow_factor=1.4, patience=4)
    assert port[0] == [2] and port[1] == {2}
    assert port == _straggle(jft, 4, slow=2, slow_factor=1.4, patience=4)


def test_straggler_detector_two_host_true_median():
    """Even host counts take the true median (the mean of the middle
    pair): against it the slow one of two hosts is caught."""
    out = []
    for ft in (tft, jft):
        det = ft.StragglerDetector(num_hosts=2, slow_factor=1.4, patience=3)
        for t in range(10):
            det.observe_step(float(t), {0: 1.0, 1: 2.5})
        assert det.flagged == {1}
        det.clear(1)
        out.append((det.flagged, det.history, dict(det._slow_streak)))
    assert out[0] == out[1]


def test_straggler_detector_ignores_transient_blips():
    port = _straggle(tft, 4, slow=None, blips=(10, 20), patience=5)
    assert not port[1]
    assert port == _straggle(jft, 4, slow=None, blips=(10, 20), patience=5)
