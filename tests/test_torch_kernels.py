"""The port's attention, RG-LRU and WKV-6 kernels (kernels #7-#9:
``repro_torch.kernels.{flash_attention,rglru,rwkv6}``) against the JAX
package's, on the same numpy inputs made from a seed, and the kernel-bench
twin (``benchmarks/torch_bench_kernels.py``) on the CPU.

On the CPU every port wrapper takes its plain PyTorch version; the CUDA
kernels run on the card only (``chip_smoke.py`` holds them against these
plain versions there).  Tolerances are those of ``tests/test_kernels.py``:
float32 2e-4, bfloat16 5e-2 (absolute and relative), 1e-4 for the WKV-6
state carry.  bfloat16 inputs are rounded from the same float32 numpy
arrays on both sides (round to nearest even in both frameworks).
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.kernels.flash_attention.ops import flash_attention as jax_fa
from repro.kernels.flash_attention.ref import attention_ref as jax_attn
from repro.kernels.rglru.ops import rglru_scan as jax_rglru
from repro.kernels.rglru.ref import rglru_ref as jax_rglru_ref
from repro.kernels.rwkv6.ops import wkv6 as jax_wkv6
from repro.kernels.rwkv6.ref import wkv6_ref as jax_wkv6_ref
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru, rwkv6
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     first_keyless_row)
from repro_torch.kernels.rates import card_rates
from repro_torch.kernels.rglru import kernel as rglru_kernel
from repro_torch.kernels.rwkv6 import kernel as wkv6_kernel

ROOT = Path(__file__).resolve().parents[1]
TOL = {"float32": dict(atol=2e-4, rtol=2e-4),
       "bfloat16": dict(atol=5e-2, rtol=5e-2),
       # the reference sweeps no float16; both sides compute in float32
       # and round to float16 once, so they differ by at most one float16
       # ulp, 2^-10 |ref| (<= 1e-3 + 1e-3 |ref|)
       "float16": dict(atol=1e-3, rtol=1e-3)}

jax.config.update("jax_platform_name", "cpu")


def _pair(x: np.ndarray, dtype: str):
    """The same numpy array as a JAX array and a torch tensor of
    ``dtype``."""
    j = jnp.asarray(x).astype(dtype)
    t = torch.from_numpy(np.array(x, copy=True)).to(getattr(torch, dtype))
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, dtype: str = "float32") -> None:
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


def _normal(rng, *shape, scale=1.0) -> np.ndarray:
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return (1.0 / (1.0 + np.exp(-x))).astype(np.float32)


# -- plain versions against the JAX oracles, over the reference's sweeps ----

@pytest.mark.parametrize("B,S,H,K,hd", [
    (1, 128, 4, 4, 64),     # MHA
    (2, 256, 4, 2, 64),     # GQA
    (1, 256, 8, 1, 128),    # MQA
    (1, 512, 2, 2, 256),    # recurrentgemma's head width
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 64), (False, 0)])
def test_attention_ref_matches_jax(B, S, H, K, hd, dtype, causal, window):
    rng = np.random.default_rng(0)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, B, S, n, hd), dtype) for n in (H, K, K))
    want = jax_attn(jq, jk, jv, causal=causal, window=window)
    got = fa.attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_attention_ref_softcap_matches_jax():
    rng = np.random.default_rng(1)
    (jq, tq), (jk, tk), (jv, tv) = (
        _pair(_normal(rng, 1, 128, n, 64), "float32") for n in (4, 2, 2))
    _close(fa.attention_ref(tq, tk, tv, causal=True, softcap=30.0),
           jax_attn(jq, jk, jv, causal=True, softcap=30.0))


@pytest.mark.parametrize("causal", [True, False])
def test_rows_with_no_key_return_the_mean_of_v(causal):
    """Fewer keys than queries under a window: rows q >= Skv + window - 1
    see no key.  The JAX reference fills masked scores with -1e30, so such
    a row softmaxes to a uniform row, the mean of v over all Skv keys; the
    port's plain version agrees on every row.  The Pallas kernel agrees on
    every row that sees a key, and without the causal mask on every row.
    With it, the Pallas kernel skips the tiles it finds fully masked: a
    keyless row whose tiles were all skipped comes out 0, not the mean
    (the port's CUDA kernel follows the reference's oracle)."""
    B, S, Skv, H, K, hd, window = 1, 256, 128, 2, 1, 64, 64
    rng = np.random.default_rng(7)
    q = _normal(rng, B, S, H, hd)
    k, v = _normal(rng, B, Skv, K, hd), _normal(rng, B, Skv, K, hd)
    opts = dict(causal=causal, window=window)
    want = np.asarray(jax_attn(q, k, v, **opts))
    got = fa.attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                           **opts).numpy()
    pallas = np.asarray(jax_fa(q, k, v, block_q=64, block_kv=64,
                               interpret=True, **opts))
    np.testing.assert_allclose(got, want, **TOL["float32"])
    first = first_keyless_row(S, Skv, window=window)
    assert first == Skv + window - 1 < S
    mean = v.mean(axis=1)[:, None, :, :].repeat(H // K, axis=2)
    for out in (got, want):
        np.testing.assert_allclose(out[:, first:], np.broadcast_to(
            mean, out[:, first:].shape), **TOL["float32"])
    np.testing.assert_allclose(pallas[:, :first], want[:, :first],
                               **TOL["float32"])
    if not causal:
        np.testing.assert_allclose(pallas, want, **TOL["float32"])
    else:
        # q tile [192, 256) finds both 64-key tiles fully masked
        assert not np.any(pallas[:, 192:])
        assert np.abs(want[:, 192:]).max() > 0.05


@pytest.mark.parametrize("causal", [True, False])
def test_first_keyless_row_matches_the_mask(causal):
    for S, Skv, window in [(8, 8, 0), (8, 8, 3), (16, 5, 4), (16, 5, 1),
                           (7, 12, 2), (33, 9, 9), (20, 1, 1), (20, 3, 0)]:
        allow = attention_mask(S, Skv, causal=causal, window=window)
        none = (~allow.any(dim=1)).nonzero()
        want = int(none[0]) if len(none) else S
        assert first_keyless_row(S, Skv, window=window) == want, \
            (S, Skv, window)
        # the keyless rows are exactly the rows from that one on
        assert bool((~allow.any(dim=1))[want:].all())


def _rglru_inputs(rng, B, S, D):
    a = _sigmoid(_normal(rng, B, S, D)) * np.float32(0.2) + np.float32(0.79)
    return a, _normal(rng, B, S, D, scale=0.1), _normal(rng, B, D, scale=0.5)


@pytest.mark.parametrize("B,S,D", [(1, 128, 128), (2, 512, 256),
                                   (1, 256, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rglru_ref_matches_jax(B, S, D, dtype):
    a, b, h0 = _rglru_inputs(np.random.default_rng(2), B, S, D)
    (ja, ta), (jb, tb) = _pair(a, dtype), _pair(b, dtype)
    got = rglru.rglru_ref(ta, tb, torch.from_numpy(h0))
    assert got.dtype == torch.float32
    _close(got, jax_rglru_ref(ja, jb, jnp.asarray(h0)), dtype)


def _wkv6_inputs(rng, B, S, H, hs, s0_scale=0.0):
    r, k, v = (_normal(rng, B, S, H, hs, scale=0.5) for _ in range(3))
    w = _sigmoid(_normal(rng, B, S, H, hs)) * np.float32(0.3) \
        + np.float32(0.65)
    u = _normal(rng, H, hs, scale=0.3)
    s0 = _normal(rng, B, H, hs, hs, scale=s0_scale)
    return r, k, v, w, u, s0


@pytest.mark.parametrize("B,S,H,hs", [(1, 128, 2, 16), (2, 256, 2, 32),
                                      (1, 128, 4, 64)])
def test_wkv6_ref_matches_jax(B, S, H, hs):
    xs = _wkv6_inputs(np.random.default_rng(3), B, S, H, hs, s0_scale=0.1)
    y, s = rwkv6.wkv6_ref(*(torch.from_numpy(x) for x in xs))
    yr, sr = jax_wkv6_ref(*(jnp.asarray(x) for x in xs))
    _close(y, yr)
    _close(s, sr)


def test_wkv6_state_carry_matches_two_calls():
    """One call over 256 steps equals two calls of 128, the second from
    the first's final state (the reference's 1e-4), and the JAX oracle."""
    xs = _wkv6_inputs(np.random.default_rng(4), 1, 256, 2, 16)
    r, k, v, w, u, s0 = (torch.from_numpy(x) for x in xs)
    y_all, s_all = rwkv6.wkv6(r, k, v, w, u, s0)
    first, second = slice(0, 128), slice(128, 256)
    _, s1 = rwkv6.wkv6(r[:, first], k[:, first], v[:, first], w[:, first],
                       u, s0)
    y2, s2 = rwkv6.wkv6(r[:, second], k[:, second], v[:, second],
                        w[:, second], u, s1)
    np.testing.assert_allclose(y_all[:, second].numpy(), y2.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(s_all.numpy(), s2.numpy(), atol=1e-4)
    yr, sr = jax_wkv6_ref(*(jnp.asarray(x) for x in xs))
    _close(y_all, yr)
    _close(s2, sr)


# -- one case per kernel against the JAX Pallas kernel in interpret mode ----

@pytest.mark.parametrize("kernel", ["flash_attention", "rglru_scan", "wkv6"])
def test_ops_match_the_pallas_kernel_in_interpret_mode(kernel):
    rng = np.random.default_rng(5)
    if kernel == "flash_attention":
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(_normal(rng, 1, 128, n, 64), "float32") for n in (4, 2, 2))
        opts = dict(causal=True, window=64, softcap=30.0)
        _close(fa.flash_attention(tq, tk, tv, **opts),
               jax_fa(jq, jk, jv, block_q=64, block_kv=64, interpret=True,
                      **opts))
    elif kernel == "rglru_scan":
        a, b, h0 = _rglru_inputs(rng, 1, 128, 128)
        _close(rglru.rglru_scan(*(torch.from_numpy(x) for x in (a, b, h0))),
               jax_rglru(a, b, h0, chunk_t=64, block_d=128, interpret=True))
    else:
        xs = _wkv6_inputs(rng, 1, 128, 2, 16, s0_scale=0.1)
        y, s = rwkv6.wkv6(*(torch.from_numpy(x) for x in xs))
        yr, sr = jax_wkv6(*xs, chunk_t=64, interpret=True)
        _close(y, yr)
        _close(s, sr)


# -- dispatch ---------------------------------------------------------------

def test_ops_on_cpu_take_the_plain_version():
    for family in (fa, rglru, rwkv6):
        family.reset_launch_counts()
    rng = np.random.default_rng(6)
    q, k = (torch.from_numpy(_normal(rng, 1, 70, n, 64)) for n in (4, 2))
    assert torch.equal(fa.flash_attention(q, k, k, causal=False, window=8),
                       fa.attention_ref(q, k, k, causal=False, window=8))
    a, b, h0 = (torch.from_numpy(x) for x in _rglru_inputs(rng, 2, 9, 5))
    assert torch.equal(rglru.rglru_scan(a, b, h0), rglru.rglru_ref(a, b, h0))
    xs = [torch.from_numpy(x) for x in _wkv6_inputs(rng, 1, 7, 2, 32)]
    for got, want in zip(rwkv6.wkv6(*xs), rwkv6.wkv6_ref(*xs)):
        assert torch.equal(got, want)
    counts = {**fa.launch_counts(), **rglru.launch_counts(),
              **rwkv6.launch_counts()}
    assert counts == {"flash_attention": 0, "rglru_scan": 0, "wkv6": 0}
    with pytest.raises(ValueError, match="no flash attention"):
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


@pytest.mark.parametrize("case", ["attention_hd96", "wkv6_hs48",
                                  "attention_float16", "rglru_mixed",
                                  "attention_softcap_2^21"])
def test_unsupported_widths_and_dtypes_raise(case):
    """Off the CPU the ops hold their inputs to what the CUDA kernels are
    built for, before they look at the device: on ``meta`` tensors (no
    card needed) a width, dtype or softcap the kernels do not take
    raises.  On the CPU the same inputs compute (``test_cpu_ops_match_jax_
    at_any_width_and_dtype``)."""
    meta = dict(device="meta")
    if case == "attention_softcap_2^21":
        q = torch.zeros(1, 8, 2, 64, **meta)
        with pytest.raises(ValueError, match="softcap"):
            fa.flash_attention(q, q, q, softcap=2.0 ** 21)
        # the range's ends pass the rule and reach the device check
        for cap in fa_kernel.SOFTCAP_RANGE:
            with pytest.raises(ValueError, match="no flash attention"):
                fa.flash_attention(q, q, q, softcap=cap)
    elif case == "attention_hd96":
        q = torch.zeros(1, 8, 2, 96, **meta)
        with pytest.raises(ValueError, match="head dim 96"):
            fa.flash_attention(q, q, q)
    elif case == "wkv6_hs48":
        x = torch.zeros(1, 4, 2, 48, **meta)
        with pytest.raises(ValueError, match="head size 48"):
            rwkv6.wkv6(x, x, x, x, torch.zeros(2, 48, **meta),
                       torch.zeros(1, 2, 48, 48, **meta))
    elif case == "attention_float16":
        q = torch.zeros(1, 8, 2, 64, dtype=torch.float16, **meta)
        with pytest.raises(TypeError):
            fa.flash_attention(q, q, q)
    else:
        a = torch.zeros(1, 4, 8, **meta)
        with pytest.raises(TypeError):
            rglru.rglru_scan(a, a.to(torch.bfloat16),
                             torch.zeros(1, 8, **meta))


@pytest.mark.parametrize("case", [
    "attention_hd16_causal", "attention_hd16_window_softcap",
    "attention_hd96_causal", "attention_hd96_window_softcap",
    "attention_float16", "rglru_float16", "rglru_f32_a_bf16_b",
    "wkv6_hs8", "wkv6_hs48"])
def test_cpu_ops_match_jax_at_any_width_and_dtype(case):
    """On the CPU the ops take every head width and float dtype the JAX
    ops take (hd 16 is every ``SMOKE`` config's), through their plain
    versions, and agree with the JAX Pallas kernels in interpret mode on
    the same seeded inputs, at the reference's tolerances (float16: one
    float16 ulp, ``TOL``)."""
    rng = np.random.default_rng(8)
    if case.startswith("attention"):
        hd = 64 if case == "attention_float16" else int(
            case.split("_")[1][2:])
        dtype = "float16" if case == "attention_float16" else "float32"
        B, S, H, K = (1, 64, 2, 2) if dtype == "float16" else (1, 128, 4, 2)
        opts = (dict(causal=True, window=32, softcap=30.0)
                if case.endswith("window_softcap") else dict(causal=True))
        (jq, tq), (jk, tk), (jv, tv) = (
            _pair(_normal(rng, B, S, n, hd), dtype) for n in (H, K, K))
        got = fa.flash_attention(tq, tk, tv, **opts)
        assert got.dtype == getattr(torch, dtype)
        _close(got, jax_fa(jq, jk, jv, block_q=64, block_kv=64,
                           interpret=True, **opts), dtype)
    elif case.startswith("rglru"):
        a, b, h0 = _rglru_inputs(rng, 1, 64, 128)
        (ja, ta), (jb, tb) = ((_pair(a, "float16"), _pair(b, "float16"))
                              if case == "rglru_float16" else
                              (_pair(a, "float32"), _pair(b, "bfloat16")))
        got = rglru.rglru_scan(ta, tb, torch.from_numpy(h0))
        assert got.dtype == torch.float32
        _close(got, jax_rglru(ja, jb, jnp.asarray(h0), chunk_t=32,
                              block_d=128, interpret=True))
    else:
        hs = int(case.split("hs")[1])
        xs = _wkv6_inputs(rng, 1, 64, 2, hs, s0_scale=0.1)
        y, st = rwkv6.wkv6(*(torch.from_numpy(x) for x in xs))
        yr, sr = jax_wkv6(*xs, chunk_t=32, interpret=True)
        _close(y, yr)
        _close(st, sr)


def test_kernel_launchers_reject_cpu_tensors_without_building():
    """The CUDA launchers validate before they build or load anything, so
    a CPU tensor is refused here, where there is no nvcc; each family
    builds into its own ``build/``."""
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.flash_attention(q, q, q, causal=True, window=0,
                                  softcap=0.0)
    a = torch.zeros(1, 4, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rglru_kernel.rglru_scan(a, a, torch.zeros(1, 8))
    x = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6_kernel.wkv6(x, x, x, x, torch.zeros(2, 16),
                         torch.zeros(1, 2, 16, 16))
    for mod in (fa_kernel, rglru_kernel, wkv6_kernel):
        assert not mod.LIBRARY.loaded
        here = Path(mod.__file__).resolve().parent
        assert mod.LIBRARY.path().parent == here / "build"
        assert mod.LIBRARY.source.parent == here / "csrc"


# -- configs and the bench twin --------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-2b", "rwkv6-3b",
                                  "grok-1-314b"])
def test_configs_match_jax(arch):
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(jax_config(arch))


def _bench():
    path = ROOT / "benchmarks" / "torch_bench_kernels.py"
    spec = importlib.util.spec_from_file_location("torch_bench_kernels",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bench_kernels_on_cpu_validates_four_rows():
    rows = _bench().bench_kernels(device="cpu")
    assert [r[0] for r in rows] == ["flash_attention", "rglru_scan", "wkv6",
                                    "ckpt_delta"]
    for name, _, derived in rows:
        assert derived.startswith("validated=True"), (name, derived)


def test_card_table_rows_and_bounds():
    """The published widths come from the configs and the contexts from
    each model's publication; the bound counts the allowed (q, k) pairs of
    each mask and takes the peak of the dtype."""
    bench = _bench()
    rows = {(r["row"], str(r["dtype"])): r for r in bench.card_rows()}
    assert len(rows) == len(bench.card_rows()) == 9
    yi = rows[("attn-yi", "torch.bfloat16")]
    assert (yi["H"], yi["K"], yi["hd"], yi["S"]) == (32, 4, 128, 4096)
    for dtype in ("torch.bfloat16", "torch.float32"):
        grok = rows[("attn-grok", dtype)]
        assert (grok["H"], grok["K"], grok["S"], grok["softcap"]) == \
            (48, 8, 8192, 30.0)
        rg = rows[("attn-rg", dtype)]
        assert (rg["H"], rg["K"], rg["hd"], rg["window"], rg["S"]) == \
            (10, 1, 256, 2048, 8192)
    lru_row = rows[("rglru-rg", "torch.float32")]
    assert (lru_row["D"], lru_row["S"]) == (2560, 8192)
    wkv = rows[("wkv6-rwkv", "torch.float32")]
    assert (wkv["H"], wkv["hs"], wkv["S"]) == (40, 64, 4096)

    S = 4096
    assert bench.allowed_pairs(S, S, True, 0) == S * (S + 1) // 2
    assert bench.allowed_pairs(S, S, True, 2048) == \
        2048 * 2049 // 2 + (S - 2048) * 2048
    assert bench.allowed_pairs(S, S, False, 0) == S * S
    rates = card_rates("NVIDIA H100 80GB HBM3")
    flops, nbytes, peak = bench.work(yi)
    assert flops == 4 * 32 * 128 * (S * (S + 1) // 2) and peak == "bf16"
    assert nbytes == 2 * (2 * S * 32 * 128 + 2 * S * 4 * 128)
    b = bench.bound(yi, rates)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(flops / 989e12 * 1e3)
    f32 = bench.bound(rows[("attn-yi", "torch.float32")], rates)
    assert f32["bound_ms"] == pytest.approx(flops / 67e12 * 1e3)
    lru = bench.bound(lru_row, rates)
    assert lru["bound_by"] == "bytes"
    assert lru["bytes"] == 3 * 4 * 2 * 8192 * 2560 + 4 * 2 * 2560
    with pytest.raises(ValueError, match="no published rates"):
        card_rates("NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="CUDA device"):
        bench.card_table("cpu")


def test_wkv6_bound_counts_five_flops_per_state_element():
    """y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i and S_ij <- w_i S_ij +
    k_i v_j: 5 flops per state element and step plus 5 per channel; at
    rwkv6-3b's widths the bytes, not the operations, bound the kernel."""
    bench = _bench()
    row = next(r for r in bench.card_rows() if r["kernel"] == "wkv6")
    B, S, H, hs = row["B"], row["S"], row["H"], row["hs"]
    flops, nbytes, peak = bench.work(row)
    assert flops == 5 * B * S * H * hs * hs + 5 * B * S * H * hs
    assert nbytes == 4 * (5 * B * S * H * hs + H * hs + 2 * B * H * hs * hs)
    assert peak == "fp32"
    b = bench.bound(row, card_rates("NVIDIA H100 80GB HBM3"))
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(nbytes / 3.35e12 * 1e3)


def test_card_tolerance_holds_one_ulp_and_refuses_a_wrong_row():
    """The card table holds bfloat16 attention to 1e-2 + 1e-2 |ref| and
    1e-2 of each row's norm: two roundings of one f32 value (one bf16 ulp
    apart) pass, a 3 % error on one row of small values does not."""
    bench = _bench()
    rng = np.random.default_rng(5)
    ref = (torch.from_numpy(rng.standard_normal((1, 64, 2, 128))
                            .astype(np.float32)) * 0.03).to(torch.bfloat16)
    # every element one ulp larger in magnitude (sign and magnitude bits)
    one_ulp = (ref.view(torch.int16) + 1).view(torch.bfloat16)
    assert bool((one_ulp.abs() > ref.abs()).all())
    assert bench.max_err(one_ulp, ref, torch.bfloat16, bench.CARD_TOL)[1]
    assert bench.row_rel_err(one_ulp, ref) <= bench.ROW_REL
    wrong = ref.clone()
    wrong[0, 40, 1] = (ref[0, 40, 1].to(torch.float32) * 1.03
                       ).to(torch.bfloat16)
    assert bench.max_err(wrong, ref, torch.bfloat16, bench.CARD_TOL)[1]
    assert bench.row_rel_err(wrong, ref) > bench.ROW_REL
    assert bench.TOL[torch.bfloat16] == (5e-2, 5e-2)
