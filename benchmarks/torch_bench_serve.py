"""Serving check of the PyTorch port: prefill, decode through the KV cache
and ``StreamServer`` for every model family, at published widths and
full depth.

    PYTHONPATH=src python benchmarks/torch_bench_serve.py [--device cpu] \
        [--smoke]

Each token-family row (dense, moe, hybrid, ssm, vlm) runs one config of
``repro_torch.configs`` with random weights from a seed (float32 params):

1. the float32 oracle: prefill on the prompt, then decode teacher-forced
   through the caches over a fixed continuation; the prefill's logits and
   each decode step's are held to ``forward_logits`` over prompt +
   continuation at the same position (relative row error, the L2 norm
   of the difference over the reference row's, at most ``ORACLE_REL``).
   An MoE runs its oracle at the capacity factor num_experts / top_k,
   where no token can drop: under GShard capacity the tokens a forward
   drops depend on how many it routes at once (prefill, a 4-token decode
   step and the full forward each drop others), so decode reproduces
   the full forward only where none drops;
2. bf16 serving, the configuration users run: a teacher-forced pass
   (prefill ms, median decode ms a step, top-1 agreement with the
   oracle, every logit finite), then greedy generation through
   ``StreamServer`` (tokens/s; the qwen2-vl row through the prefill and
   decode steps, since the server passes tokens only): tokens in
   [0, vocab_size), device memory peak;
3. the int8 KV cache (yi-6b and recurrentgemma-2b, the reference's
   ``tests/test_int8_kv.py`` archs): decode from ``cache_specs`` zeros
   over the prompt's first ``INT8_STEPS`` tokens with a bf16 and an int8
   K/V cache, and in float32: greedy agreement of int8 with bf16 and of
   bf16 with float32, reported.  The reference's bound (agreement above
   ``INT8_AGREE``) is held where the reference holds it, at the two SMOKE
   configs (B 2, 16 steps), on the device in the SMOKE sweep: at yi-6b's
   full width and depth with random weights the static scale 1/32 gave
   0.570 on an H100 80GB HBM3 at 700 W (recurrentgemma-2b 0.945), its
   logits' top two closer than int8's noise (PERF.md §6).

The whisper row's decode does not reproduce its prefill in the reference
(ROADMAP section 3, Q2), so its oracle is the same prefill + decode on
the host CPU in float32 with the same weights.  The SMOKE sweep runs all
ten archs' SMOKE configs in float32 with the same weights on the device
and on the CPU: the prefill token and ``SMOKE_STEPS`` greedy decode steps
equal, logits within ``SMOKE_REL`` of the row norm, and yi-6b's and
recurrentgemma-2b's int8 agreement above ``INT8_AGREE``.

Where the device is the CPU (``--device cpu``, the tests), the rows are
the SMOKE configs at small shapes and the host oracles compare the CPU
with itself: a rehearsal of the control flow, no measurement.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ShapeConfig, replace
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import zoo
from repro_torch.models.zoo import VLM_VISION_TOKENS
from repro_torch.runtime.server import ServeRequest, StreamServer
from repro_torch.utils.trees import resolve_device, tree_leaves, tree_map

#: (row, arch, prompt tokens, new tokens, batch, encoder frames) at
#: published widths and full depth.  The yi prompt + generation is 1024
#: (the chunked forward); recurrentgemma's prompt is its 2048 window (the ring full, then
#: wrapping); qwen2-vl's first 1024 positions take the stub vision
#: embeddings; whisper's decoder runs 416 + 32 of its 448 positions
#: against 1500 encoder frames.
ROWS = (("serve-yi", "yi-6b", 992, 32, 4, 0),
        ("serve-olmoe", "olmoe-1b-7b", 992, 32, 4, 0),
        ("serve-rg", "recurrentgemma-2b", 2048, 32, 4, 0),
        ("serve-rwkv", "rwkv6-3b", 992, 32, 4, 0),
        ("serve-vl", "qwen2-vl-7b", 2016, 32, 2, 0),
        ("serve-whisper", "whisper-small", 416, 32, 4, 1500))
#: the same rows at SMOKE size, for the CPU (prompt 16 fills the hybrid
#: SMOKE ring of 8; whisper's 16 decoder tokens face 64 frames)
SMOKE_ROWS = (("serve-yi", "yi-6b", 16, 4, 2, 0),
              ("serve-olmoe", "olmoe-1b-7b", 16, 4, 2, 0),
              ("serve-rg", "recurrentgemma-2b", 16, 4, 2, 0),
              ("serve-rwkv", "rwkv6-3b", 16, 4, 2, 0),
              ("serve-vl", "qwen2-vl-7b", 16, 4, 2, 0),
              ("serve-whisper", "whisper-small", 16, 4, 2, 64))
INT8_ARCHS = ("yi-6b", "recurrentgemma-2b")
INT8_STEPS = 64
#: float32 decode against the float32 full forward (or the CPU): they
#: differ in summation order and in the chunked against the direct
#: softmax, ~1e-5 of a row; 1e-3 still fails a computation in bf16
ORACLE_REL = 1e-3
#: the reference's own bound (tests/test_int8_kv.py)
INT8_AGREE = 0.85
SMOKE_STEPS = 4
SMOKE_REL = 1e-4
#: bf16 decode steps of each row run under the profiler (the last ones of
#: the timed pass; its median decode ms is of the steps before them)
TRACED_STEPS = 2
#: the RG-LRU chunk of the reference's rglru_sequence: a sequence longer
#: than it must be a multiple of it
RGLRU_CHUNK = 256


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _rel(got: torch.Tensor, want: torch.Tensor, vocab: int) -> float:
    """Max over rows of ||got - want|| / ||want|| over the real vocab
    (the padded entries hold -1e30 in both)."""
    g = got[..., :vocab].to(torch.float64)
    w = want[..., :vocab].to(torch.float64)
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1)).max())


def grow_kv(caches: dict, extra: int) -> dict:
    """Self-attention K/V (seq axis 2) grown by ``extra`` zero slots for
    the decode writes; every other cache (the whisper encoder's ck/cv,
    the hybrid ring, recurrent states) is kept as it is."""
    if "k" not in caches:
        return caches
    out = dict(caches)
    for n in ("k", "v"):
        out[n] = F.pad(caches[n], (0, 0, 0, 0, 0, extra))
    return out


def _inputs(cfg, prompt: np.ndarray, dev, gen: torch.Generator,
            frames: int = 0) -> dict:
    """Prefill inputs on ``dev``: the prompt as tokens (decoder tokens
    for audio, with ``frames`` encoder frames), and for the vlm the stub
    vision embeddings over the first min(1024, S) positions."""
    B, S = prompt.shape
    toks = torch.as_tensor(prompt, device=dev)
    if cfg.family == "audio":
        return {"frames": 0.02 * torch.randn((B, frames, cfg.d_model),
                                             generator=gen, device=dev),
                "dec_tokens": toks}
    out = {"tokens": toks}
    if cfg.family == "vlm":
        nv = min(VLM_VISION_TOKENS, S)
        out["vision_embeds"] = 0.02 * torch.randn(
            (B, nv, cfg.d_model), generator=gen, device=dev)
    return out


def _extend(cfg, inputs: dict, cont: torch.Tensor) -> dict:
    """The prefill inputs with ``cont`` appended to the token sequence."""
    key = "dec_tokens" if cfg.family == "audio" else "tokens"
    out = dict(inputs)
    out[key] = torch.cat([inputs[key], cont], dim=1)
    return _with_positions(cfg, out)


def _with_positions(cfg, inputs: dict) -> dict:
    """The vlm's M-RoPE positions arange(S) on all three planes."""
    if cfg.family != "vlm":
        return inputs
    B, S = inputs["tokens"].shape
    return dict(inputs, positions=torch.arange(
        S, device=inputs["tokens"].device)[None, None].expand(3, B, S))


@torch.no_grad()
def decode_logits(cfg, params, inputs: dict, cont: torch.Tensor, P: int,
                  new: int, dev, timed: bool = False,
                  traced: int = 0) -> dict:
    """Prefill on ``inputs`` (prompt length P), then ``new`` decode steps
    teacher-forced on ``cont``: the prefill's last logits and each step's
    (new + 1, B, V); if ``timed``, the prefill seconds and each step's
    (the device synchronized around each); the last ``traced`` steps run
    under the profiler instead (``_decode_trace``)."""
    _sync(dev)
    t0 = time.perf_counter()
    pre, _, caches = zoo.forward_logits(params, cfg, inputs, collect_kv=True,
                                        last_token_only=True)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    caches = grow_kv(caches, new)
    B = cont.shape[0]
    rows, step_s = [pre[:, 0]], []

    def step(i):
        nonlocal caches
        pos = torch.full((B,), P + i, dtype=torch.int32, device=dev)
        lg, caches = zoo.forward_decode(params, cfg, caches,
                                        cont[:, i:i + 1], pos)
        rows.append(lg)

    for i in range(new - traced):
        t0 = time.perf_counter()
        step(i)
        if timed:
            _sync(dev)
            step_s.append(time.perf_counter() - t0)
    out = {"prefill_s": prefill_s, "step_s": step_s}
    if traced:
        out["trace"] = _decode_trace(
            lambda: [step(i) for i in range(new - traced, new)], traced, dev)
    out["logits"] = torch.stack(rows)
    return out


def _decode_trace(run, steps: int, dev) -> dict:
    """``run`` (``steps`` decode steps) under ``torch.profiler``: host
    milliseconds a step, the device's kernel milliseconds a step and its
    busy share, kernel launches a step, the top ops by device time.
    Device figures are None off a CUDA device."""
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        _sync(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()

    def dev_us(e) -> float:
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in events
                  if e.device_type.name == "CUDA") / 1e3 if cuda else None
    ops = sorted((e for e in events if e.key.startswith("aten::")),
                 key=dev_us if cuda else (lambda e: e.self_cpu_time_total),
                 reverse=True)
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_ms / steps if cuda else None,
            "device_busy_share": busy_ms / wall_ms if cuda else None,
            "launches_per_step": sum(e.count for e in events
                                     if e.key == "cudaLaunchKernel") / steps,
            "ops_per_step": sum(e.count for e in events
                                if e.key.startswith("aten::")) / steps,
            "top_ops": [(e.key, round(dev_us(e) / 1e3 / steps, 4)
                         if cuda else e.count // steps) for e in ops[:4]]}


@torch.no_grad()
def oracle_full(cfg, params, inputs: dict, cont: torch.Tensor, P: int,
                new: int) -> torch.Tensor:
    """``forward_logits`` over prompt + continuation at positions P - 1 ..
    P + new - 1, (new + 1, B, V).  A hybrid sequence longer than one
    RG-LRU chunk is run to the next multiple of it (causal: the extra
    tokens change no earlier position)."""
    full = _extend(cfg, inputs, cont)
    key = "dec_tokens" if cfg.family == "audio" else "tokens"
    S = full[key].shape[1]
    if cfg.family == "hybrid" and S > RGLRU_CHUNK and S % RGLRU_CHUNK:
        pad = math.ceil(S / RGLRU_CHUNK) * RGLRU_CHUNK - S
        full = _extend(cfg, full, full[key][:, :pad])
    logits, _, _ = zoo.forward_logits(params, cfg, full)
    return logits[:, P - 1:P + new].transpose(0, 1).contiguous()


@torch.no_grad()
def generate(cfg, params, inputs: dict, P: int, new: int, dev) -> torch.Tensor:
    """Greedy generation by the server's loop for inputs it cannot carry
    (vision embeddings, encoder frames): (B, new) tokens."""
    prefill = zoo.make_prefill_step(cfg)
    decode = zoo.make_decode_step(cfg)
    tok, caches = prefill(params, _with_positions(cfg, inputs))
    caches = grow_kv(caches, new - 1)
    outs, cur = [tok], tok[:, None]
    B = tok.shape[0]
    for i in range(new - 1):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=dev)
        cur, caches = decode(params, caches, {"tokens": cur, "pos": pos})
        outs.append(cur[:, 0])
    return torch.stack(outs, dim=1)


@torch.no_grad()
def int8_agreement(cfg, params, prompt: torch.Tensor, steps: int,
                   dev) -> dict:
    """Decode from ``cache_specs`` zeros, teacher-forced on the prompt's
    first ``steps`` tokens, with a bf16 and an int8 K/V cache (bf16
    activations) and in float32 throughout: the greedy agreement of int8
    with bf16 (the reference's measure, ``tests/test_int8_kv.py``) and,
    beside it, of bf16 with float32."""
    B = prompt.shape[0]
    toks = {}
    for name, dt, kv in (("bf16", cfg.dtype, "bfloat16"),
                         ("int8", cfg.dtype, "int8"),
                         ("f32", "float32", "float32")):
        c = replace(cfg, dtype=dt, kv_cache_dtype=kv)
        caches = zoo.zeros_like_specs(zoo.cache_specs(
            c, ShapeConfig("d", "decode", steps, B)), dev)
        out = []
        for t in range(steps):
            pos = torch.full((B,), t, dtype=torch.int32, device=dev)
            lg, caches = zoo.forward_decode(params, c, caches,
                                            prompt[:, t:t + 1], pos)
            out.append(lg[:, :cfg.vocab_size].argmax(-1))
        toks[name] = torch.stack(out, dim=1)
        del caches

    def agree(a, b):
        return float((toks[a] == toks[b]).to(torch.float32).mean())
    return {"int8_vs_bf16": agree("int8", "bf16"),
            "bf16_vs_f32": agree("bf16", "f32")}


def _peak_gb(dev) -> Optional[float]:
    return torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _free(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def serve_row(name: str, cfg, P: int, new: int, B: int, dev, *,
              frames: int = 0, int8: bool = False, seed: int = 0) -> dict:
    """One row: the oracle, bf16 serving and, with ``int8``, the int8
    cache; see the module docstring.  ``frames``: the audio encoder's
    input length.  Frees what it allocated."""
    t_row = time.perf_counter()
    V = cfg.vocab_size
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, V, (B, P), dtype=np.int32)
    cont = torch.as_tensor(rng.integers(0, V, (B, new), dtype=np.int32),
                           device=dev)
    _reset_peak(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = zoo.init_params(cfg, gen, dev)
    inputs = _inputs(cfg, prompt, dev, gen, frames)
    n_params = sum(a.numel() for a in tree_leaves(params))
    cfg32 = replace(cfg, dtype="float32")
    if cfg.moe is not None:
        cfg32 = replace(cfg32, moe=replace(
            cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    row = {"row": name, "arch": cfg.name, "family": cfg.family,
           "layers": cfg.num_layers, "decoder_layers": cfg.num_decoder_layers,
           "params": n_params, "batch": B, "prompt": P, "new": new}
    if cfg.family == "audio":
        row["frames"] = frames

    # 1. the float32 oracle
    t0 = time.perf_counter()
    dec = decode_logits(cfg32, params, _with_positions(cfg, inputs), cont, P,
                        new, dev)["logits"]
    if cfg.family == "audio":
        host = torch.device("cpu")
        hp = tree_map(lambda a: a.to(host), params)
        ref = decode_logits(cfg32, hp, tree_map(lambda a: a.to(host), inputs),
                            cont.to(host), P, new, host)["logits"].to(dev)
        del hp
        row["oracle"] = "host float32"
    else:
        ref = oracle_full(cfg32, params, inputs, cont, P, new)
        row["oracle"] = "forward_logits float32"
    errs = [_rel(dec[i], ref[i], V) for i in range(new + 1)]
    row["oracle_max_rel"] = max(errs)
    row["oracle_prefill_rel"] = errs[0]
    ref_top1 = ref[..., :V].argmax(-1)
    del dec, ref
    row["oracle_s"] = time.perf_counter() - t0
    row["oracle_peak_gb"] = _peak_gb(dev)
    _free(dev)

    # 2. bf16 serving: a teacher-forced pass (top-1 against the oracle,
    # finiteness; it also takes the bf16 path's first-call costs), greedy
    # generation timed end to end, the teacher-forced pass again timed
    # step by step
    _reset_peak(dev)
    pin = _with_positions(cfg, inputs)
    logits = decode_logits(cfg, params, pin, cont, P, new, dev)["logits"]
    row["finite"] = bool(torch.isfinite(logits[..., :V]).all())
    row["top1_vs_f32"] = float((logits[..., :V].argmax(-1) == ref_top1)
                               .to(torch.float32).mean())
    del logits
    _sync(dev)
    t0 = time.perf_counter()
    if cfg.family in ("vlm", "audio"):
        toks = generate(cfg, params, inputs, P, new, dev).cpu().numpy()
        row["served_by"] = "prefill/decode steps"
    else:
        srv = StreamServer(cfg, params, max_batch=B, max_seq=P + new)
        out = srv.serve_batch([ServeRequest(b, prompt[b], new)
                               for b in range(B)])
        toks = np.stack([out[b] for b in range(B)])
        row["served_by"] = "StreamServer"
    serve_s = time.perf_counter() - t0
    row["serve_s"] = serve_s
    row["tokens_per_s"] = B * new / serve_s
    row["tokens_in_vocab"] = bool(toks.shape == (B, new) and toks.min() >= 0
                                  and toks.max() < V)
    tf = decode_logits(cfg, params, pin, cont, P, new, dev, timed=True,
                       traced=min(TRACED_STEPS, new // 2))
    row["prefill_ms"] = tf["prefill_s"] * 1e3
    row["decode_ms"] = float(np.median(tf["step_s"])) * 1e3
    row["decode_trace"] = tf["trace"]
    del tf
    row["peak_gb"] = _peak_gb(dev)

    # 3. the int8 KV cache
    if int8:
        steps = min(INT8_STEPS, P)
        agree = int8_agreement(cfg, params, inputs["tokens"], steps, dev)
        row["int8_agree"] = agree["int8_vs_bf16"]
        row["int8_bf16_vs_f32"] = agree["bf16_vs_f32"]
        row["int8_steps"] = steps
    del params, inputs
    _free(dev)
    row["row_s"] = time.perf_counter() - t_row
    return row


@torch.no_grad()
def _greedy_smoke(cfg, params, inputs: dict, P: int, steps: int, dev):
    pre, _, caches = zoo.forward_logits(params, cfg, inputs, collect_kv=True,
                                        last_token_only=True)
    caches = grow_kv(caches, steps)
    rows = [pre[:, 0]]
    tok = pre[:, 0, :cfg.vocab_size].argmax(-1).to(torch.int32)
    toks = [tok]
    for i in range(steps):
        pos = torch.full((tok.shape[0],), P + i, dtype=torch.int32,
                         device=dev)
        lg, caches = zoo.forward_decode(params, cfg, caches, tok[:, None],
                                        pos)
        tok = lg[:, :cfg.vocab_size].argmax(-1).to(torch.int32)
        rows.append(lg)
        toks.append(tok)
    return torch.stack(rows), torch.stack(toks, dim=1)


def smoke_sweep(dev, B: int = 2, S: int = 16, seed: int = 0) -> list:
    """All ten archs' SMOKE configs in float32, the same weights and
    inputs on ``dev`` and on the host CPU: prefill + ``SMOKE_STEPS``
    greedy decode steps, tokens equal and logits within ``SMOKE_REL``;
    the int8 archs' SMOKE int8 agreement on ``dev``."""
    host = torch.device("cpu")
    out = []
    for arch in ARCH_IDS:
        cfg = replace(get_smoke_config(arch), dtype="float32")
        gen = torch.Generator(device=host).manual_seed(seed)
        hp = zoo.init_params(cfg, gen, host)
        prompt = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (B, S // cfg.dec_ratio if cfg.family == "audio"
                                else S), dtype=np.int32)
        hin = _with_positions(cfg, _inputs(cfg, prompt, host, gen, S))
        P = prompt.shape[1]
        hl, ht = _greedy_smoke(cfg, hp, hin, P, SMOKE_STEPS, host)
        dl, dt = _greedy_smoke(cfg, tree_map(lambda a: a.to(dev), hp),
                               tree_map(lambda a: a.to(dev), hin), P,
                               SMOKE_STEPS, dev)
        errs = [_rel(dl[i].to(host), hl[i], cfg.vocab_size)
                for i in range(SMOKE_STEPS + 1)]
        entry = {"arch": arch, "family": cfg.family,
                 "tokens_equal": bool(torch.equal(dt.to(host), ht)),
                 "max_rel": max(errs)}
        if arch in INT8_ARCHS:
            # the reference's int8 test (tests/test_int8_kv.py): its SMOKE
            # config in bf16, B 2, S 16 steps from cache_specs zeros
            entry["int8_agree"] = int8_agreement(
                get_smoke_config(arch), tree_map(lambda a: a.to(dev), hp),
                torch.as_tensor(prompt, device=dev), S, dev)["int8_vs_bf16"]
        out.append(entry)
    return out


def serve_phase(dev, rows=ROWS, smoke: bool = False) -> dict:
    """Every row, then the SMOKE sweep; ``smoke`` takes the SMOKE configs
    for the rows (the CPU rehearsal)."""
    dev = resolve_device(dev)
    result = {"rows": []}
    for i, (name, arch, P, new, B, frames) in enumerate(rows):
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        result["rows"].append(serve_row(name, cfg, P, new, B, dev,
                                        frames=frames,
                                        int8=arch in INT8_ARCHS, seed=i))
    t0 = time.perf_counter()
    result["smoke"] = smoke_sweep(dev)
    result["smoke_s"] = time.perf_counter() - t0
    return result


def gate_failures(result: dict) -> list:
    """The gates the phase holds, as messages for the ones that fail."""
    bad = []
    for r in result["rows"]:
        if not r["oracle_max_rel"] <= ORACLE_REL:
            bad.append(f"{r['row']}: decode against the {r['oracle']} oracle "
                       f"{r['oracle_max_rel']:.3e} > {ORACLE_REL}")
        if not (r["finite"] and r["tokens_in_vocab"]):
            bad.append(f"{r['row']}: bf16 logits not finite or tokens out "
                       f"of the vocabulary")
    for s in result["smoke"]:
        if not (s["tokens_equal"] and s["max_rel"] <= SMOKE_REL):
            bad.append(f"SMOKE {s['arch']}: device against host tokens equal "
                       f"{s['tokens_equal']}, max rel {s['max_rel']:.3e}")
        if "int8_agree" in s and not s["int8_agree"] > INT8_AGREE:
            bad.append(f"SMOKE {s['arch']}: int8 KV agreement "
                       f"{s['int8_agree']:.3f} <= {INT8_AGREE}")
    return bad


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the rows at their SMOKE configs and sizes")
    args = ap.parse_args()
    res = serve_phase(args.device, rows=SMOKE_ROWS if args.smoke else ROWS,
                      smoke=args.smoke)
    print(json.dumps(res))
    bad = gate_failures(res)
    if bad:
        raise SystemExit("; ".join(bad))


if __name__ == "__main__":
    main()
