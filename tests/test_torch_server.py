"""The port's serving path: twins of the reference's ``StreamServer`` tests
(``tests/test_trainer.py``), the port's server against the JAX package's
token for token on three families' SMOKE configs in float32, a pin of
the reference's cache growth (ROADMAP section 3, Q5), and the serve
launcher (``repro_torch.launch.serve --local``) against the JAX
launcher's tokens.
"""
import ast

import numpy as np
import pytest
import torch

import torch_models as tm
from repro.runtime.server import ServeRequest as JaxServeRequest
from repro.runtime.server import StreamServer as JaxStreamServer
from repro_torch.configs import get_smoke_config
from repro_torch.models import zoo
from repro_torch.runtime import StreamServer
from repro_torch.runtime.server import ServeRequest


def _requests(cls, cfg, n, S, new, seed):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(0, cfg.vocab_size, S,
                                           dtype=np.int32),
                max_new_tokens=new) for i in range(n)]


def test_stream_server_serves_batch():
    cfg = get_smoke_config("yi-6b")
    params = zoo.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    srv = StreamServer(cfg, params, max_batch=4)
    out = srv.serve_batch(_requests(ServeRequest, cfg, 3, 16, 4, 0))
    assert set(out) == {0, 1, 2}
    for toks in out.values():
        assert toks.shape == (4,)
        assert toks.min() >= 0


def test_stream_server_decode_positions_advance():
    """Every decode step writes a distinct cache slot from the prompt
    length on, greedy decode continues as a fresh prefill over the extended
    prompt would, and a batch that does not fit ``max_seq`` is refused
    before anything is written."""
    cfg = get_smoke_config("yi-6b")
    _, params = tm.params("yi-6b")
    srv = StreamServer(cfg, params, max_batch=2, max_seq=64)
    S, new = 16, 4
    reqs = _requests(ServeRequest, cfg, 2, S, new, 1)
    out = srv.serve_batch(reqs)
    assert srv.last_decode_positions == list(range(S, S + new - 1))
    prefill = zoo.make_prefill_step(cfg)
    for r in reqs:
        toks = out[r.rid]
        ext = np.concatenate([r.prompt, toks[:-1]])[None]
        next_ref, _ = prefill(params, {"tokens": torch.from_numpy(ext)})
        assert int(next_ref[0]) == int(toks[-1])
    with pytest.raises(ValueError, match="max_seq"):
        srv.serve_batch(_requests(ServeRequest, cfg, 1, 62, 8, 2))
    with pytest.raises(ValueError, match="bucket by length"):
        srv.serve_batch([ServeRequest(0, reqs[0].prompt),
                         ServeRequest(1, reqs[0].prompt[:-1])])


@pytest.mark.parametrize("arch", ["yi-6b", "olmoe-1b-7b",
                                  "recurrentgemma-2b"])
def test_stream_server_matches_jax(arch):
    """Dense, moe and hybrid (a ring of window 8, a prompt of 16 that
    fills it, decode that wraps it): the same tokens as the JAX
    package's server, in float32 with carried-over weights."""
    jcfg, tcfg = tm.cfgs(arch, dtype="float32")
    jp, tp = tm.params(arch, dtype="float32")
    jsrv = JaxStreamServer(jcfg, jp, max_batch=3, max_seq=32)
    tsrv = StreamServer(tcfg, tp, max_batch=3, max_seq=32)
    want = jsrv.serve_batch(_requests(JaxServeRequest, jcfg, 3, 16, 6, 3))
    got = tsrv.serve_batch(_requests(ServeRequest, tcfg, 3, 16, 6, 3))
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert tsrv.last_decode_positions == jsrv.last_decode_positions


def test_q5_grow_caches_keeps_only_k_and_v():
    """Q5: ``_grow_caches`` pads k/v by the generation and returns only
    them (an audio prefill's ck/cv would be dropped), and passes the
    hybrid ring and the ssm states through, as the reference's does."""
    cfg = get_smoke_config("whisper-small")
    srv = StreamServer(cfg, {"w": torch.zeros(1)})
    caches = {n: torch.ones((2, 1, 4, 2, 3)) for n in ("k", "v", "ck", "cv")}
    grown = srv._grow_caches(caches, 5)
    assert sorted(grown) == ["k", "v"]
    assert tuple(grown["k"].shape) == (2, 1, 9, 2, 3)
    assert float(grown["v"][:, :, 4:].abs().sum()) == 0
    ring = {"groups": {"attn": {"k": torch.ones(2)}}}
    assert srv._grow_caches(ring, 5) is ring
    assert srv._grow_caches(caches, 0) is caches


def test_serve_launcher_runs_and_gives_the_jax_launchers_tokens(
        monkeypatch, capsys):
    """``launch.serve --arch yi-6b --local --device cpu`` serves its four
    requests; given the JAX launcher's weights (carried over) and both
    at float32, it prints the JAX launcher's tokens."""
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs

    out = tserve.main(["--arch", "yi-6b", "--local", "--device", "cpu"])
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(t) == 8 for t in out.values())
    capsys.readouterr()

    jcfg, tcfg = tm.cfgs("yi-6b", dtype="float32")
    monkeypatch.setattr(jconfigs, "get_smoke_config", lambda arch: jcfg)
    monkeypatch.setattr(tconfigs, "get_smoke_config", lambda arch: tcfg)
    # the JAX launcher's weights: its init_params at PRNGKey(0)
    jparams = tm.np_tree(tm.params("yi-6b", seed=0, dtype="float32")[0])
    monkeypatch.setattr(zoo, "init_params",
                        lambda cfg, gen, dev: zoo.state_from_numpy(jparams,
                                                                   dev))
    monkeypatch.setattr("sys.argv", ["serve", "--arch", "yi-6b", "--local"])
    jserve.main()
    want = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    got = tserve.main(["--arch", "yi-6b", "--local", "--device", "cpu"])
    assert got == want


def test_serve_bench_rehearses_on_the_cpu():
    """``benchmarks/torch_bench_serve.py`` at its SMOKE rows on the CPU:
    every gate of the card's serve phase holds (the host oracles compare
    the CPU with itself here), and the kernels of ``repro_torch.kernels``
    are never called."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import flash_attention, rglru, rwkv6
    from repro_torch.kernels.ckpt_delta import ops

    path = Path(__file__).resolve().parents[1] / "benchmarks" / \
        "torch_bench_serve.py"
    spec = importlib.util.spec_from_file_location("_torch_bench_serve", path)
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    families = (ops, flash_attention, rglru, rwkv6)
    for f in families:
        f.reset_launch_counts()
    res = bench.serve_phase("cpu", rows=bench.SMOKE_ROWS, smoke=True)
    assert bench.gate_failures(res) == []
    assert [r["row"] for r in res["rows"]] == [r[0] for r in bench.ROWS]
    assert {r["family"] for r in res["rows"]} == {
        "dense", "moe", "hybrid", "ssm", "vlm", "audio"}
    assert [r["row"] for r in res["rows"] if "int8_agree" in r] == [
        "serve-yi", "serve-rg"]
    assert len(res["smoke"]) == 10
    for f in families:
        assert all(n == 0 for n in f.launch_counts().values())
