"""The port's SGD and int8 gradient compression against the JAX package's:
``sgd`` over one and five steps, ``make_optimizer``'s names, the twins of
``tests/test_optim.py``'s compression tests (the round-trip bound and
error feedback's unbiasedness, over the same seeds), ``compress_tree`` bit
for bit (values exactly half-way between two levels included), and
``compressed_psum`` over a two-rank gloo group of two CPU processes, bit
for bit against the sum built from the JAX package's ``compress_tree`` of
each rank's input."""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JaxOptimizerConfig
from repro.optim import make_optimizer as jax_make_optimizer
from repro.optim import sgd as jax_sgd
from repro.optim.compression import compress_tree as jax_compress
from repro_torch.config import OptimizerConfig
from repro_torch.optim import (compress_tree, compressed_psum,
                               decompress_tree, init_residual,
                               make_optimizer, sgd)
from repro_torch.utils.trees import tree_flatten_with_names

jax.config.update("jax_platform_name", "cpu")
ROOT = Path(__file__).resolve().parents[1]
OPT = dict(lr=0.05, warmup_steps=2, total_steps=20)


def _params(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "blk": {"u": rng.standard_normal((3, 4, 2)).astype(np.float32)}}


def _like(tree, rng):
    return {k: (_like(v, rng) if isinstance(v, dict)
                else rng.standard_normal(v.shape).astype(np.float32))
            for k, v in tree.items()}


def _t(tree):
    return {k: (_t(v) if isinstance(v, dict) else torch.from_numpy(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: (_j(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in tree.items()}


def _flat(tree) -> dict:
    return {n: np.asarray(a) for n, a in tree_flatten_with_names(tree)}


@pytest.mark.parametrize("steps", [1, 5])
def test_sgd_matches_jax(steps):
    rng = np.random.default_rng(steps)
    p0 = _params(rng)
    grads = [_like(p0, rng) for _ in range(steps)]
    topt = sgd(OptimizerConfig(name="sgd", **OPT))
    jopt = jax_sgd(JaxOptimizerConfig(name="sgd", **OPT))
    tp, jp = _t(p0), _j(p0)
    ts, js = topt.init(tp), jopt.init(jp)
    for i, g in enumerate(grads):
        step = i + 1          # past the warmup's zero learning rate
        tp, ts = topt.update(_t(g), ts, tp,
                             torch.tensor(step, dtype=torch.int32))
        jp, js = jopt.update(_j(g), js, jp, jnp.asarray(step, jnp.int32))
    got_p = _flat(tp)
    for name, want in _flat(jax.tree_util.tree_map(np.asarray, jp)).items():
        got = got_p[name]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)
    jm = _flat(jax.tree_util.tree_map(np.asarray, js["mom"]))
    tm_ = _flat(ts["mom"])
    assert sorted(tm_) == sorted(jm)
    for name in jm:
        assert tm_[name].dtype == np.float32
        np.testing.assert_allclose(tm_[name], jm[name], rtol=1e-5,
                                   atol=1e-9, err_msg=name)


def test_sgd_keeps_the_param_dtype_and_f32_momentum():
    opt = make_optimizer(OptimizerConfig(name="sgd", **OPT))
    p = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    st = opt.init(p)
    assert st["mom"]["w"].dtype == torch.float32
    new_p, new_st = opt.update({"w": torch.full((4, 4), 0.5)}, st, p,
                               torch.tensor(3, dtype=torch.int32))
    assert new_p["w"].dtype == torch.bfloat16
    assert new_st["mom"]["w"].dtype == torch.float32
    assert new_p["w"] is not p["w"]


def test_make_optimizer_names_match_jax():
    for name in ("adamw", "sgd"):
        t = make_optimizer(OptimizerConfig(name=name))
        j = jax_make_optimizer(JaxOptimizerConfig(name=name))
        p = {"w": torch.zeros((2, 3))}
        jp = {"w": jnp.zeros((2, 3))}
        assert sorted(t.init(p)) == sorted(j.init(jp))
    with pytest.raises(ValueError, match="unknown optimizer lion"):
        make_optimizer(OptimizerConfig(name="lion"))
    with pytest.raises(ValueError, match="unknown optimizer lion"):
        jax_make_optimizer(JaxOptimizerConfig(name="lion"))


# ---------------------------------------------------------------------------
# compression: twins of tests/test_optim.py
# ---------------------------------------------------------------------------

def test_compression_roundtrip_small_error():
    g_np = np.array(jax.random.normal(jax.random.PRNGKey(0), (256,)) * 0.01)
    g = {"w": torch.from_numpy(g_np)}
    r = init_residual(g)
    q, s, r2 = compress_tree(g, r)
    rec = decompress_tree(q, s)
    err = float(torch.max(torch.abs(rec["w"] - g["w"])))
    assert err <= float(s["w"]) / 2 + 1e-9
    # residual holds exactly the quantization error
    np.testing.assert_allclose(r2["w"].numpy(),
                               (g["w"] - rec["w"]).numpy(), atol=1e-7)


@pytest.mark.parametrize("seed,steps", [
    (0, 3), (1, 5), (7, 8), (42, 13), (123, 17), (500, 20)])
def test_compression_error_feedback_unbiased(seed, steps):
    """With a CONSTANT gradient, error feedback makes the mean of the
    decompressed gradients converge to the true gradient."""
    rng = np.random.default_rng(seed)
    g_true = {"w": torch.from_numpy(rng.standard_normal(64)
                                    .astype(np.float32))}
    r = init_residual(g_true)
    acc = torch.zeros(64)
    for _ in range(steps):
        q, s, r = compress_tree(g_true, r)
        acc = acc + decompress_tree(q, s)["w"]
    mean = acc / steps
    bound = float(torch.max(torch.abs(g_true["w"]))) / 127.0 * \
        (1.0 + 2.0 / steps)
    assert float(torch.max(torch.abs(mean - g_true["w"]))) <= bound + 1e-6


def _compress_inputs(seed: int):
    """Gradients and residuals: seeded normals at several scales, a bf16
    leaf, an all-zero leaf (the 1e-12 scale floor), and two leaves whose
    scaled values fall exactly half-way between two int8 levels (scale 1
    and scale 0.25), where rounding is half to even."""
    rng = np.random.default_rng(seed)
    halves = np.array([127.0, 2.5, -3.5, 0.5, -0.5, 126.5, -126.5, 1.5,
                       -1.5, 0.0], np.float32)
    g = {"a": (rng.standard_normal((33, 7)) * 1e-3).astype(np.float32),
         "b": {"c": (rng.standard_normal((129,)) * 5).astype(np.float32),
               "half": halves,
               "quarter": halves * np.float32(0.25)},
         "z": np.zeros((5, 3), np.float32),
         "h": rng.standard_normal((16, 8)).astype(np.float32)}
    r = {"a": (rng.standard_normal((33, 7)) * 1e-5).astype(np.float32),
         "b": {"c": (rng.standard_normal((129,)) * 1e-2).astype(np.float32),
               "half": np.zeros(10, np.float32),
               "quarter": np.zeros(10, np.float32)},
         "z": np.zeros((5, 3), np.float32),
         "h": (rng.standard_normal((16, 8)) * 1e-3).astype(np.float32)}
    return g, r


def _bf16_leaf(g: dict, framework: str) -> dict:
    """``g`` for ``framework`` with leaf h in bfloat16."""
    out = _t(g) if framework == "torch" else _j(g)
    out["h"] = (out["h"].to(torch.bfloat16) if framework == "torch"
                else out["h"].astype(jnp.bfloat16))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compress_tree_bit_equal_to_jax(seed):
    g, r = _compress_inputs(seed)
    tq, ts, tr = compress_tree(_bf16_leaf(g, "torch"), _t(r))
    jq, js, jr = jax_compress(_bf16_leaf(g, "jax"), _j(r))
    for got, want, kind in ((tq, jq, "q"), (ts, js, "scale"),
                            (tr, jr, "residual")):
        got = _flat(got)
        want = _flat(jax.tree_util.tree_map(np.asarray, want))
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype, (kind, name)
            np.testing.assert_array_equal(got[name], want[name],
                                          err_msg=f"{kind} {name}")
    half = _flat(tq)["b/half"]
    assert half.tolist() == [127, 2, -4, 0, 0, 126, -126, 2, -2, 0]
    assert _flat(tq)["b/quarter"].tolist() == half.tolist()


def test_compressed_psum_without_a_process_group_raises():
    import torch.distributed as dist
    assert not dist.is_initialized()
    g = {"w": torch.ones(4)}
    with pytest.raises(RuntimeError, match="process group"):
        compressed_psum(g, init_residual(g))


_RANK = textwrap.dedent("""
    import sys
    from datetime import timedelta
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.optim import compressed_psum

    rank, d = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", store=dist.FileStore(d + "/store", 2),
                            rank=rank, world_size=2,
                            timeout=timedelta(seconds=60))
    mesh = init_device_mesh("cpu", (2, 1), mesh_dim_names=("pod", "data"))
    z = np.load(d + f"/in{rank}.npz")
    grads = {k: torch.from_numpy(z["g_" + k]) for k in ("a", "c", "half")}
    resid = {k: torch.from_numpy(z["r_" + k]) for k in ("a", "c", "half")}
    out, new_r = compressed_psum(grads, resid, mesh.get_group("pod"))
    np.savez(d + f"/out{rank}.npz",
             **{"o_" + k: v.numpy() for k, v in out.items()},
             **{"n_" + k: v.numpy() for k, v in new_r.items()})
    dist.destroy_process_group()
""")


def test_compressed_psum_over_two_gloo_ranks_matches_jax(tmp_path):
    keys = ("a", "c", "half")
    inputs = []
    for rank in range(2):
        g, r = _compress_inputs(10 + rank)
        g = {"a": g["a"], "c": g["b"]["c"], "half": g["b"]["half"]}
        r = {"a": r["a"], "c": r["b"]["c"], "half": r["b"]["half"]}
        np.savez(tmp_path / f"in{rank}.npz",
                 **{"g_" + k: g[k] for k in keys},
                 **{"r_" + k: r[k] for k in keys})
        inputs.append((g, r))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank),
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for rank in range(2)]
    try:
        errs = [p.communicate(timeout=60)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), errs
    q, s, nr = zip(*[jax_compress(_j(g), _j(r)) for g, r in inputs])
    for k in keys:
        acc = np.asarray(q[0][k]).astype(np.int32) + \
            np.asarray(q[1][k]).astype(np.int32)
        mean = (np.asarray(s[0][k]) + np.asarray(s[1][k])) / np.float32(2)
        want = acc.astype(np.float32) * np.float32(mean)
        for rank in range(2):
            out = np.load(tmp_path / f"out{rank}.npz")
            assert out["o_" + k].dtype == np.float32
            np.testing.assert_array_equal(out["o_" + k], want, err_msg=k)
            np.testing.assert_array_equal(out["n_" + k],
                                          np.asarray(nr[rank][k]), err_msg=k)
