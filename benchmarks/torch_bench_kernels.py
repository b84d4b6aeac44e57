"""E6 of the PyTorch port: kernel micro-benchmarks, the twin of
``bench_kernels.py``.

    PYTHONPATH=src python benchmarks/torch_bench_kernels.py [--device cpu]

``bench_kernels(device)`` gives the reference's four rows at its shapes:

  * ``flash_attention`` (kernel #7): B1 S512 H8 K2 hd64 float32, causal;
  * ``rglru_scan`` (#8): S512 D512;
  * ``wkv6`` (#9): S512 H4 hs32;
  * ``ckpt_delta``: the per-leaf int8 encode (#6) and decode (#4) of a
    2^20-element delta.

Each row has the per-call wall time of the plain version (microseconds,
as the reference times its oracle) and ``validated=``: the port's op (the
CUDA kernel on a CUDA device, the plain version on the CPU) against the
plain version at the reference's tolerance.  Inputs are made with numpy
from a seed: the reference's ``jax.random`` draws cannot be reproduced.

``card_table(device)`` is for a CUDA device only: the rows of
``card_rows()`` at published model widths and contexts (``CONTEXT``;
batch 1 for attention, batch 2 for the recurrences), read from the
port's configs.  Each row holds the kernel's time, the plain version's
and, for attention where one PyTorch call computes the same function,
``scaled_dot_product_attention``'s (CUDA events, in turns: plain, kernel,
library, library, kernel, plain), the least time the card could take
(``work`` / ``card_rates``) and the kernel's error against the plain
version, held to ``CARD_TOL`` (and, for attention, ``ROW_REL``).  The
library call is a yardstick only: the port never calls it.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ckpt_delta
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rglru, rwkv6
from repro_torch.kernels.ckpt_delta import ref as ckpt_ref
from repro_torch.kernels.flash_attention.ref import attention_mask
from repro_torch.kernels.rates import Rates, card_rates
from repro_torch.utils.trees import resolve_device

#: published context of each model, the card table's sequence length
CONTEXT = {
    "yi-6b": 4096,                # base models at 4K (arXiv:2403.04652)
    "grok-1-314b": 8192,          # xai-org/grok-1 README: max length 8,192
    "recurrentgemma-2b": 8192,    # trained on 8192-token sequences
                                  # (arXiv:2404.07839)
    "rwkv6-3b": 4096,             # World v2.1 3B, ctx4096 (arXiv:2404.05892)
}
SEED = 0
REPS = 2                # timed calls per turn
#: tolerances of tests/test_kernels.py, by dtype: (atol, rtol); the
#: reference holds its small-S sweeps to them
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (5e-2, 5e-2)}
#: the card table's tolerances.  A bfloat16 output is the rounding of an
#: f32 value; kernel and plain version agree in f32 to ~1e-6, so they
#: differ by at most one bf16 ulp, <= 2^-7 |ref|: within rtol 1e-2 and,
#: per (b, s, h) row, within ROW_REL of the row's norm.  Far into a long
#: causal row the values are ~0.03, which the elementwise atol alone would
#: not hold; the row norm does.
CARD_TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (1e-2, 1e-2)}
ROW_REL = 1e-2


# ---------------------------------------------------------------------------
# the reference's four rows
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_us(fn: Callable, device: torch.device, n: int = 3) -> float:
    fn()                                   # warm
    _sync(device)
    t0 = time.monotonic()
    for _ in range(n):
        fn()
    _sync(device)
    return (time.monotonic() - t0) / n * 1e6


def bench_kernels(device="cuda") -> list:
    """The reference's rows: (name, plain us per call, derived)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(SEED)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to(dev)

    print("\n=== Kernels: plain wall time + kernel validation "
          f"({dev}) ===")
    rows = []
    B, S, H, K, hd = 1, 512, 8, 2, 64
    q, k, v = normal(B, S, H, hd), normal(B, S, K, hd), normal(B, S, K, hd)
    us = _time_us(lambda: fa.attention_ref(q, k, v, causal=True), dev)
    out = fa.flash_attention(q, k, v, causal=True)
    ok = bool(torch.allclose(out, fa.attention_ref(q, k, v, causal=True),
                             atol=1e-4))
    rows.append(("flash_attention", us,
                 f"validated={ok} (B{B},S{S},H{H},K{K},hd{hd})"))

    D = 512
    a = torch.sigmoid(normal(B, S, D) + 2.0)
    b = normal(B, S, D, scale=0.1)
    h0 = torch.zeros(B, D, device=dev)
    us = _time_us(lambda: rglru.rglru_ref(a, b, h0), dev)
    out = rglru.rglru_scan(a, b, h0)
    ok = bool(torch.allclose(out, rglru.rglru_ref(a, b, h0), atol=1e-4))
    rows.append(("rglru_scan", us, f"validated={ok} (S{S},D{D})"))

    Hh, hs = 4, 32
    r, kk, vv = (normal(B, S, Hh, hs, scale=0.5) for _ in range(3))
    w = torch.sigmoid(normal(B, S, Hh, hs)) * 0.3 + 0.65
    u = normal(Hh, hs, scale=0.3)
    s0 = torch.zeros(B, Hh, hs, hs, device=dev)
    us = _time_us(lambda: rwkv6.wkv6_ref(r, kk, vv, w, u, s0), dev)
    y, _ = rwkv6.wkv6(r, kk, vv, w, u, s0)
    yr, _ = rwkv6.wkv6_ref(r, kk, vv, w, u, s0)
    ok = bool(torch.allclose(y, yr, atol=1e-4))
    rows.append(("wkv6", us, f"validated={ok} (S{S},H{Hh},hs{hs})"))

    n = 1 << 20
    new = normal(n)
    base = new + normal(n, scale=0.01)
    us = _time_us(lambda: ckpt_ref.int8_encode(new, base), dev)
    qq, sc = ckpt_delta.delta_encode(new, base)
    d = ckpt_delta.delta_decode(qq, sc)[:n]
    ok = bool(((new - base) - d).abs().max() < 1e-3)
    rows.append(("ckpt_delta", us, f"validated={ok} (n=2^20, 4x byte cut)"))

    for name, us, derived in rows:
        print(f"{name},{us:.0f},{derived}")
    return rows


# ---------------------------------------------------------------------------
# the card table at published widths
# ---------------------------------------------------------------------------

def card_rows() -> list:
    """The published-width rows, widths from the port's configs."""
    yi, grok, rg, rwkv = (get_config(a) for a in (
        "yi-6b", "grok-1-314b", "recurrentgemma-2b", "rwkv6-3b"))

    def attn(row, cfg, dtype, **mask):
        return {"row": row, "kernel": "flash_attention", "dtype": dtype,
                "B": 1, "S": CONTEXT[cfg.name], "H": cfg.num_heads,
                "K": cfg.num_kv_heads, "hd": cfg.resolved_head_dim,
                "causal": True, "window": mask.get("window", 0),
                "softcap": mask.get("softcap", 0.0)}

    hs = rwkv.rwkv.head_size
    return [
        attn("attn-yi", yi, torch.bfloat16),
        attn("attn-yi", yi, torch.float32),
        *(attn("attn-grok", grok, dtype, softcap=grok.attn_logit_softcap)
          for dtype in (torch.bfloat16, torch.float32)),
        *(attn("attn-rg", rg, dtype, window=rg.recurrent.window_size)
          for dtype in (torch.bfloat16, torch.float32)),
        *({"row": "rglru-rg", "kernel": "rglru_scan", "dtype": dtype,
           "B": 2, "S": CONTEXT[rg.name], "D": rg.recurrent.lru_width}
          for dtype in (torch.float32, torch.bfloat16)),
        {"row": "wkv6-rwkv", "kernel": "wkv6", "dtype": torch.float32,
         "B": 2, "S": CONTEXT[rwkv.name], "H": rwkv.d_model // hs,
         "hs": hs},
    ]


def allowed_pairs(S: int, Skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the attention mask allows: the work the kernel must
    do, whatever tiles it skips or computes in part."""
    return int(attention_mask(S, Skv, causal=causal, window=window).sum())


def work(row: dict) -> tuple[float, float, str]:
    """(float operations, bytes, peak) of one row: each input read once,
    each output written once; ``peak`` names the ``Rates`` field its
    operations run at."""
    size = torch.empty((), dtype=row["dtype"]).element_size()
    B, S = row["B"], row["S"]
    if row["kernel"] == "flash_attention":
        H, K, hd = row["H"], row["K"], row["hd"]
        pairs = allowed_pairs(S, S, row["causal"], row["window"])
        flops = 4.0 * B * H * hd * pairs       # q k^T and p v, 2 each
        nbytes = size * (2 * B * S * H * hd + 2 * B * S * K * hd)
        return flops, nbytes, ("bf16" if row["dtype"] == torch.bfloat16
                               else "fp32")
    if row["kernel"] == "rglru_scan":
        n = B * S * row["D"]
        return 2.0 * n, 2 * n * size + 4 * n + 4 * B * row["D"], "fp32"
    H, hs = row["H"], row["hs"]
    n = B * S * H * hs
    # y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i and S_ij <- w_i S_ij +
    # k_i v_j: an FMA, a multiply and an FMA (5) per state element and
    # step; the bonus term's r*u*k, its sum, v_j*(.) and + y_j are 5 per
    # channel and step
    flops = 5.0 * B * S * H * (hs * hs + hs)
    nbytes = 4 * (5 * n + H * hs + 2 * B * H * hs * hs)
    return flops, nbytes, "fp32"


def bound(row: dict, rates: Rates) -> dict:
    flops, nbytes, peak = work(row)
    b_ms = nbytes / rates.hbm * 1e3
    o_ms = flops / getattr(rates, peak) * 1e3
    return {"bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "flops": flops, "bytes": nbytes}


def _time_ms(fn: Callable) -> float:
    """Mean ms of ``REPS`` calls, CUDA events around each."""
    total = 0.0
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
        del out
    return total / REPS


def turns(kernel: Callable, plain: Callable, library=None) -> tuple:
    """plain, kernel, [library, library,] kernel, plain, each the mean of
    ``REPS`` calls (all warmed first): (kernel ms, plain ms, library ms or
    None)."""
    for fn in (kernel, plain, library):
        if fn is not None:
            out = fn()
            del out
    torch.cuda.synchronize()
    p1, k1 = _time_ms(plain), _time_ms(kernel)
    lib = None
    if library is not None:
        lib = (_time_ms(library) + _time_ms(library)) / 2
    k2, p2 = _time_ms(kernel), _time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def max_err(out: torch.Tensor, ref: torch.Tensor, dtype,
            tol: dict = TOL) -> tuple:
    """(max |out - ref|, within the dtype's tolerance in ``tol``)."""
    atol, rtol = tol[dtype]
    o, r = out.to(torch.float32), ref.to(torch.float32)
    diff = (o - r).abs()
    return float(diff.max()), bool((diff <= atol + rtol * r.abs()).all())


def row_rel_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest ||out - ref|| / ||ref|| over the rows of the last
    dimension (one (b, s, h) row of an attention output)."""
    o, r = out.to(torch.float32), ref.to(torch.float32)
    num = torch.linalg.vector_norm(o - r, dim=-1)
    den = torch.linalg.vector_norm(r, dim=-1).clamp_min(1e-30)
    return float((num / den).max())


def _attention_inputs(row, gen, dev):
    B, S, H, K, hd = (row[x] for x in ("B", "S", "H", "K", "hd"))
    mk = lambda *s: torch.randn(*s, device=dev,                 # noqa: E731
                                generator=gen).to(row["dtype"])
    return mk(B, S, H, hd), mk(B, S, K, hd), mk(B, S, K, hd)


def _card_row(row: dict, gen, dev) -> dict:
    kind, dtype = row["kernel"], row["dtype"]
    out: dict = {}
    if kind == "flash_attention":
        q, k, v = _attention_inputs(row, gen, dev)
        opts = {x: row[x] for x in ("causal", "window", "softcap")}
        kernel = lambda: fa.flash_attention(q, k, v, **opts)  # noqa: E731
        plain = lambda: fa.attention_ref(q, k, v, **opts)     # noqa: E731
        ref, got = plain(), kernel()
        out["max_abs_err"], ok = max_err(got, ref, dtype, CARD_TOL)
        out["row_rel_err"] = row_rel_err(got, ref)
        ok = ok and out["row_rel_err"] <= ROW_REL
        del got
        library = None
        if not row["softcap"]:
            # SDPA's layout (B, H, S, hd), made outside the timed call
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            if row["window"]:
                mask = attention_mask(row["S"], row["S"], causal=True,
                                      window=row["window"], device=dev)
                library = lambda: sdpa(qt, kt, vt, attn_mask=mask,  # noqa
                                       enable_gqa=True)
            else:
                library = lambda: sdpa(qt, kt, vt, is_causal=True,  # noqa
                                       enable_gqa=True)
            out["library_max_abs_err"] = max_err(library().transpose(1, 2),
                                                  ref, dtype)[0]
        del ref
    elif kind == "rglru_scan":
        B, S, D = row["B"], row["S"], row["D"]
        a = (torch.sigmoid(torch.randn(B, S, D, device=dev, generator=gen))
             * 0.2 + 0.79).to(dtype)
        b = (torch.randn(B, S, D, device=dev, generator=gen) * 0.1).to(dtype)
        h0 = torch.randn(B, D, device=dev, generator=gen) * 0.5
        kernel = lambda: rglru.rglru_scan(a, b, h0)           # noqa: E731
        plain = lambda: rglru.rglru_ref(a, b, h0)             # noqa: E731
        kh, ph = kernel(), plain()
        out["max_abs_err"], _ = max_err(kh, ph, dtype, CARD_TOL)
        out["mismatches"] = int((kh.view(torch.int32)
                                 != ph.view(torch.int32)).sum())
        ok = out["mismatches"] == 0                           # bit for bit
        library = None
        del kh, ph
    else:
        B, S, H, hs = row["B"], row["S"], row["H"], row["hs"]
        mk = lambda *s: torch.randn(*s, device=dev,           # noqa: E731
                                    generator=gen)
        r, k, v = (mk(B, S, H, hs) * 0.5 for _ in range(3))
        w = torch.sigmoid(mk(B, S, H, hs)) * 0.3 + 0.65
        u, s0 = mk(H, hs) * 0.3, mk(B, H, hs, hs) * 0.1
        kernel = lambda: rwkv6.wkv6(r, k, v, w, u, s0)        # noqa: E731
        plain = lambda: rwkv6.wkv6_ref(r, k, v, w, u, s0)     # noqa: E731
        (ky, ks), (py, ps) = kernel(), plain()
        ey, oky = max_err(ky, py, dtype, CARD_TOL)
        es, oks = max_err(ks, ps, dtype, CARD_TOL)
        out["max_abs_err"], ok = max(ey, es), oky and oks
        library = None
        del ky, ks, py, ps
    ms, plain_ms, lib_ms = turns(kernel, plain, library)
    out.update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, validated=ok)
    return out


def card_table(device="cuda") -> list:
    """The published-width rows on a CUDA device (see the module
    docstring), bounded by the card's own rates."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the card table times kernels on a CUDA device, "
                         f"not {dev}")
    rates = card_rates(torch.cuda.get_device_name(dev))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = []
    for row in card_rows():
        t0 = time.monotonic()
        res = {**row, "dtype": str(row["dtype"]).replace("torch.", ""),
               **bound(row, rates), **_card_row(row, gen, dev)}
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        res["seconds"] = time.monotonic() - t0
        table.append(res)
        lib = ("none" if res["library_ms"] is None
               else f"{res['library_ms']:.3f}")
        rel = (f", row_rel_err {res['row_rel_err']:.3g}"
               if "row_rel_err" in res else "")
        rate = (f"{res['flops'] / res['ms'] / 1e9:.1f} TFLOP/s"
                if row["kernel"] == "flash_attention" else
                f"{res['bytes'] / res['ms'] / 1e6:.0f} GB/s")
        rate = f" ({rate}, {res['bound_ms'] / res['ms']:.1%} of the bound)"
        print(f"{res['row']} S{res['S']} {res['dtype']}: kernel "
              f"{res['ms']:.3f} ms{rate}, plain {res['plain_ms']:.3f} ms, "
              f"library "
              f"{lib} ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}), "
              f"max_abs_err {res['max_abs_err']:.3g}{rel}, "
              f"validated={res['validated']}", flush=True)
    return table


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {"device": str(dev), "rows": bench_kernels(dev)}
    if dev.type == "cuda":
        out["card"] = torch.cuda.get_device_name(dev)
        out["card_table"] = card_table(dev)
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
