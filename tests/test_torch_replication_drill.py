"""The port's replication drills (``benchmarks/torch_bench_replication.py``)
against the JAX package's (``benchmarks/bench_replication.py``) on the
same seeded states, and the card drill's plan on a small block state.

Both sides run with ``codec="zlib"``: ``"auto"`` resolves to zstd where
zstandard is installed and to zlib where it is not, and the byte counts
compared here are compressed bytes.  Each side's drills get the same
plans with ``codec="zlib"`` (a ``CheckpointPlan`` subclass whose default
codec is zlib, in place of its package's class for the call).
Tolerance: none — levels, degraded flags, shard counts and byte counts
must be equal, restores bit for bit.
"""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import repro.config
from repro.checkpoint import CheckpointManager as JaxManager
from repro.config import CheckpointPlan as JaxPlan
from repro_torch.checkpoint import CheckpointManager, CheckpointPlan
from repro_torch.config import CheckpointPlan as PortPlan

BENCH = Path(__file__).resolve().parents[1] / "benchmarks"


def _load(name: str):
    """A bench module by file path, without touching ``sys.path``."""
    spec = importlib.util.spec_from_file_location(f"_repl_{name}",
                                                  BENCH / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass(frozen=True)
class _ZlibPlan(JaxPlan):
    codec: str = "zlib"


@dataclasses.dataclass(frozen=True)
class _PortZlibPlan(PortPlan):
    codec: str = "zlib"


@pytest.fixture(scope="module")
def port():
    return _load("torch_bench_replication")


@pytest.fixture(scope="module")
def ref():
    return _load("bench_replication")


@pytest.fixture
def zlib(monkeypatch, port):
    """The reference drills build their plans from ``repro.config`` at
    call time, the port's from the bench module's ``CheckpointPlan``:
    hand both the zlib plan."""
    monkeypatch.setattr(repro.config, "CheckpointPlan", _ZlibPlan)
    monkeypatch.setattr(port, "CheckpointPlan", _PortZlibPlan)


def test_recovery_drill_matches_reference(port, ref, zlib, tmp_path):
    got = port.recovery_drill(str(tmp_path / "port"), verbose=False,
                              device="cpu")
    want = ref.recovery_drill(str(tmp_path / "ref"), verbose=False)
    assert got == want
    assert 0 < got["restored_bytes"] < got["full_state_bytes"]
    assert got["downtime_rep1_s"] < got["downtime_rep0_s"]


def test_peer_loss_drill_matches_reference(port, ref, zlib, tmp_path):
    got = port.peer_loss_drill(str(tmp_path / "port"), verbose=False,
                               device="cpu")
    want = ref.peer_loss_drill(str(tmp_path / "ref"), verbose=False)
    assert got == want
    assert got["degraded"] and got["shards_from_remote"] >= 1


def test_optimizer_dimension_check_runs(port):
    port.optimizer_dimension_check(verbose=False)


def _kill_host_restore(manager, plan, root, state, like, host):
    """Save ``state`` at step 100, kill ``host``, restore: what the
    restore did and the bytes each level holds."""
    mgr = manager(root, plan)
    mgr.save(100, state, timestamp=1.0)
    mgr.on_failure("node", host=host)
    rep = mgr.restore(like, "node")
    local = mgr.stores["local"]
    out = {"level": rep.level, "kind": rep.kind, "step": rep.step,
           "degraded": rep.degraded, "restored_bytes": rep.restored_bytes,
           "bytes": {lv: s.total_bytes(100) for lv, s in mgr.stores.items()}}
    if hasattr(local, "last_restore"):
        out["last_restore"] = dict(local.last_restore)
        out["replica"] = local.replica_stats.as_dict()
    leaves = {k: np.asarray(v.numpy() if hasattr(v, "numpy") else v)
              for k, v in rep.state.items()}
    return out, leaves


@pytest.mark.parametrize("k,host", [(1, 0), (1, 2), (1, 3), (0, 2)])
def test_kill_host_restore_matches_reference(port, ref, tmp_path, k, host):
    """Levels, degraded flags, shard counts and bytes of a kill-host
    restore under k ring replicas, port against reference, on the drill's
    seeded state."""
    kw = dict(levels=("local", "remote"), remote_every=1, num_shards=4,
              replication_factor=k, codec="zlib")
    state = ref._state()
    got, got_leaves = _kill_host_restore(
        lambda d, p: CheckpointManager(d, p, device="cpu"),
        CheckpointPlan(**kw), str(tmp_path / "port"),
        port._state(device="cpu"), port._state(device="cpu"), host)
    want, want_leaves = _kill_host_restore(
        JaxManager, JaxPlan(**kw), str(tmp_path / "ref"), state, state,
        host)
    assert got == want
    assert got["level"] == ("local" if k else "remote")
    for name, a in want_leaves.items():
        assert got_leaves[name].dtype == a.dtype
        assert got_leaves[name].tobytes() == a.tobytes(), name
        assert a.tobytes() == np.asarray(state[name]).tobytes(), name


def test_card_drill_plan_on_a_small_block(port, tmp_path):
    """``card_drill``'s plan (device-encode lossless deltas, k=1, one disk
    level) over one block of the yi-6b smoke config on the CPU: the
    degraded partial restore of the delta is bit-equal and pulls one
    host's shard; the drill removes its directory."""
    from repro_torch.configs import get_smoke_config

    root = tmp_path / "card"
    rec = port.card_drill(str(root), device="cpu",
                          model_cfg=get_smoke_config("yi-6b"),
                          verbose=False)
    cfg = get_smoke_config("yi-6b")
    d, h, f = cfg.d_model, cfg.num_heads, cfg.d_ff
    hd = cfg.resolved_head_dim
    kv = cfg.num_kv_heads
    assert rec["elements"] == 2 * d * h * hd + 2 * d * kv * hd \
        + 3 * d * f + 2 * d
    assert 0 < rec["restored_bytes"] < rec["full_state_bytes"]
    assert rec["measured_fraction"] <= 2 * rec["modeled_fraction"]
    assert rec["shards_from_peer"] == 1 and rec["acks"] >= 4
    assert rec["bytes_written"] == rec["full_state_bytes"] \
        + rec["delta_bytes"]
    assert not root.exists()


def test_card_drill_block_layout_is_the_trainers(port):
    """The drill's state is ``zoo.init_params``' ``layers`` subtree at one
    layer, plus an int64 step."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.utils.trees import tree_flatten_with_names

    cfg = get_smoke_config("yi-6b")
    st = port.block_state(cfg, device="cpu")
    names = {n: tuple(a.shape) for n, a in tree_flatten_with_names(st)}
    assert names["step"] == () and st["step"].dtype == torch.int64
    hd = cfg.resolved_head_dim
    assert names["params/layers/attn/wq"] == (1, cfg.d_model,
                                              cfg.num_heads, hd)
    assert names["params/layers/ffn/w_down"] == (1, cfg.d_ff, cfg.d_model)
    assert sorted(n.split("/", 2)[-1] for n in names if n != "step") == [
        "attn/wk", "attn/wo", "attn/wq", "attn/wv", "ffn/w_down",
        "ffn/w_gate", "ffn/w_up", "ln1/scale", "ln2/scale"]
