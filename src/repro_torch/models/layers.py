"""Model primitives of the port, in plain PyTorch: norms (RMSNorm and
LayerNorm), rotary embeddings (RoPE and Qwen2-VL's M-RoPE), GQA attention
(full, the chunked running-softmax form, single-token decode over a KV
cache, cross-attention), GLU and plain FFNs, the scatter-based top-k MoE,
the RG-LRU and RWKV-6 mixers, embeddings, logits and cross-entropy.

Conventions follow the JAX package's ``repro.models.layers`` exactly, so
params carried over from it apply unchanged:

* activations: (B, S, d) in ``cfg.dtype`` (bf16 by default)
* attention heads: q (B, S, H, hd); k/v (B, S, K, hd); G = H // K
* weights keep the reference layouts: wq (d, H, hd), wk/wv (d, K, hd),
  wo (H, hd, d), w_up/w_gate (d, f), w_down (f, d), embed (V, d),
  unembed (d, V), MoE experts (E, d, f) / (E, f, d)
* softmax / recurrences / norms / the loss accumulate in fp32
* every ``init_*`` returns a params dict; every ``apply`` is functional,
  except ``attention_decode_step``, which writes the new token's K/V into
  the cache it is given (PyTorch's form of the reference's donation)

None of these is a kernel in the reference (XLA compiles them there), so
plain PyTorch is their port: attention goes to the chunked XLA-style path
even for ``attn_impl="pallas"``, the RG-LRU scan is a log-step scan per
chunk (the reference's ``associative_scan``) and WKV-6 a loop over time
(its ``lax.scan``); the CUDA kernels of ``repro_torch.kernels`` are not
called here.  ``scaled_dot_product_attention`` is not used: it is not what
the reference computes.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig

Params = Any


class NullAnnotator:
    """No-op activation-sharding annotator (single-device runs).  The
    layers call ``ann.constrain(x, kind)`` where the reference pins an
    activation's layout, and group the MoE dispatch by
    ``ann.moe_groups``; ``repro_torch.sharding.ActivationAnnotator`` is
    the mesh-aware one."""
    dp_size: int = 1
    moe_groups: int = 1

    def constrain(self, x, kind: str):
        return x


NULL_ANN = NullAnnotator()


class _Groups(NullAnnotator):
    """A no-op annotator that only sets the MoE group count."""

    def __init__(self, groups: int):
        self.moe_groups = groups


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "int8": torch.int8,
           "int32": torch.int32}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return dtype_of(cfg.param_dtype)


def _normal(gen: torch.Generator, shape, std: float, dtype: torch.dtype,
            device) -> torch.Tensor:
    """std * truncated_normal(-3, 3) in f32, cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=gen)
    return (t * std).to(dtype)


def _full(shape, value: float, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dim: Optional[int] = None) -> Params:
    d = dim or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=_pdtype(cfg), device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=_pdtype(cfg), device=device)
    return p


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm or LayerNorm computed in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * \
            p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=64)
def _inv_freq(half: int, theta: float, device: torch.device) -> torch.Tensor:
    """RoPE inverse frequencies, computed in numpy float32 exactly as the
    reference, copied to ``device`` once: a host-to-device copy in every
    layer's call would wait for the device each time and stall decode."""
    inv = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    return torch.from_numpy(np.asarray(inv, np.float32)).to(device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                mrope_sections: Optional[tuple] = None) -> torch.Tensor:
    """positions (B, S), or (3, B, S) for M-RoPE -> angles (B, S,
    head_dim//2).  Under M-RoPE the frequency slots split into (t, h, w)
    sections, each taking its positions from its plane."""
    half = head_dim // 2
    inv_freq = _inv_freq(half, float(theta), positions.device)
    if mrope_sections is None:
        pos = positions.to(torch.float32)
        return pos[..., None] * inv_freq[None, None, :]
    if positions.ndim != 3 or positions.shape[0] != len(mrope_sections):
        raise ValueError("M-RoPE needs positions of shape (3, B, S)")
    parts = []
    start = 0
    for sec_idx, sec in enumerate(mrope_sections):
        pos = positions[sec_idx].to(torch.float32)          # (B, S)
        parts.append(pos[..., None] * inv_freq[None, None, start:start + sec])
        start += sec
    if start != half:
        raise ValueError("mrope sections must sum to head_dim//2")
    return torch.cat(parts, dim=-1)


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, N, hd), angles: (B, S, hd//2) — half-split (llama)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _mrope(cfg: ModelConfig) -> Optional[tuple]:
    return tuple(cfg.mrope_sections) if cfg.mrope_sections else None


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, H, K, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    std = 0.02
    pdt = _pdtype(cfg)
    p = {
        "wq": _normal(gen, (d, H, hd), std, pdt, device),
        "wk": _normal(gen, (d, K, hd), std, pdt, device),
        "wv": _normal(gen, (d, K, hd), std, pdt, device),
        "wo": _normal(gen, (H, hd, d), std / math.sqrt(2 * cfg.num_layers),
                      pdt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=pdt, device=device)
        p["bk"] = torch.zeros((K, hd), dtype=pdt, device=device)
        p["bv"] = torch.zeros((K, hd), dtype=pdt, device=device)
    return p


def _q(p: Params, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    if "bq" in p:
        q = q + p["bq"].to(dt)
    return q


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = _q(p, x)
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(dt))
    if "bk" in p:
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return q, k, v


def _out_proj(p: Params, o: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    return torch.einsum("bsnh,nhd->bsd", o, p["wo"].to(dt))


def _mask_bias(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
               window: int) -> torch.Tensor:
    """(Q, KV) additive fp32 bias: 0 allowed / -1e30 masked."""
    qp = q_pos[:, None]
    kp = k_pos[None, :]
    allow = (kp <= qp) if causal else torch.ones(
        (qp.shape[0], kp.shape[1]), dtype=torch.bool, device=qp.device)
    if window > 0:
        allow = allow & (qp - kp < window)
    zero = torch.zeros((), dtype=torch.float32, device=qp.device)
    return torch.where(allow, zero, zero - 1e30)


def _softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(logits / cap)
    return logits


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   q_offset: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """Reference full attention; q/k/v: (B, S, H, hd) with KV already
    repeated to H heads."""
    B, Sq, H, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqnh,bsnh->bnqs", q, k).to(torch.float32) * scale
    logits = _softcap(logits, softcap)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    logits = logits + _mask_bias(q_pos, k_pos, causal, window)
    w = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bnqs,bsnh->bqnh", w, v)


def _flash_q_block(qi: int, qc, k, v, Cq: int, Ckv: int, causal: bool,
                   window: int, softcap: float) -> torch.Tensor:
    """One q chunk against every kv chunk with a running softmax (fp32
    accumulators); returns (B, H, Cq, hd) in q's dtype."""
    B, _, H, hd = qc.shape
    scale = 1.0 / math.sqrt(hd)
    dev = qc.device
    q_pos = qi * Cq + torch.arange(Cq, device=dev)
    m = torch.full((B, H, Cq), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Cq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Cq, hd), dtype=torch.float32, device=dev)
    for kj in range(k.shape[1] // Ckv):
        kc = k[:, kj * Ckv:(kj + 1) * Ckv]
        vc = v[:, kj * Ckv:(kj + 1) * Ckv]
        k_pos = kj * Ckv + torch.arange(Ckv, device=dev)
        s = torch.einsum("bqnh,bsnh->bnqs", qc, kc).to(torch.float32) * scale
        s = _softcap(s, softcap)
        s = s + _mask_bias(q_pos, k_pos, causal, window)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bnqs,bsnh->bnqh", p.to(qc.dtype),
                          vc).to(torch.float32)
        acc = acc * corr[..., None] + pv
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.to(qc.dtype)


def flash_attention_xla(q, k, v, *, causal: bool, window: int = 0,
                        chunk_q: int = 512, chunk_kv: int = 1024,
                        softcap: float = 0.0) -> torch.Tensor:
    """Memory-bounded chunked attention with a running softmax — the
    reference's ``flash_attention_xla`` as a plain loop.  Each q chunk is
    recomputed in the backward pass (``torch.utils.checkpoint``, the role
    of the reference's ``jax.checkpoint``), so softmax probabilities are
    never kept for more than one block pair.  Never materializes S x S."""
    B, S, H, hd = q.shape
    Cq = min(chunk_q, S)
    Ckv = min(chunk_kv, k.shape[1])
    if S % Cq or k.shape[1] % Ckv:
        raise ValueError("seq not divisible by chunks")
    outs = []
    for qi in range(S // Cq):
        qc = q[:, qi * Cq:(qi + 1) * Cq]
        if torch.is_grad_enabled():
            o = checkpoint(_flash_q_block, qi, qc, k, v, Cq, Ckv, causal,
                           window, softcap, use_reentrant=False)
        else:
            o = _flash_q_block(qi, qc, k, v, Cq, Ckv, causal, window, softcap)
        outs.append(o)
    # (B, H, S, hd) -> (B, S, H, hd)
    return torch.cat(outs, dim=2).transpose(1, 2)


def decode_attention(q, k_cache, v_cache, pos, *, window: int = 0,
                     softcap: float = 0.0) -> torch.Tensor:
    """Single-token decode: q (B, 1, H, hd), caches (B, Smax, K, hd).

    ``pos`` (B,) is the index of the *current* token (its K/V already
    written); entries with k_pos > pos are masked."""
    B, _, H, hd = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, G, hd)
    if k_cache.dtype == torch.int8:
        raise TypeError("dequantize int8 KV before decode_attention")
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache).to(torch.float32) * scale
    s = _softcap(s, softcap)
    k_pos = torch.arange(Smax, device=q.device)[None, :]
    allow = k_pos <= pos[:, None]
    if window > 0:
        allow = allow & (pos[:, None] - k_pos < window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    s = s + torch.where(allow, zero, zero - 1e30)[:, None, None, :]
    w = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgs,bskh->bkgh", w, v_cache)
    return o.reshape(B, 1, H, hd)


def attention_sequence(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                       positions: torch.Tensor, causal: bool = True,
                       window: int = 0, kv_override=None,
                       return_kv: bool = False, ann=NULL_ANN):
    """Attention over a full sequence (train / prefill).  GQA KV is
    repeated up to H heads; the chunked path is taken by the reference's
    rule (``attn_impl`` "xla_chunked"/"pallas", S > attn_chunk_q and both
    chunk sizes dividing the sequence), the full path otherwise.
    ``return_kv`` also returns the *un-repeated* K/V for the KV cache.

    kv_override: (k, v, _) for cross-attention (the whisper decoder): the
    query takes no RoPE, and neither do the given K/V."""
    dt = x.dtype
    if kv_override is None:
        q, k, v = _qkv(p, x, cfg)
        angles = rope_angles(positions, cfg.resolved_head_dim,
                             cfg.rope_theta, _mrope(cfg))
        q = apply_rope(q, angles)
        k = apply_rope(k, angles)
    else:
        q = _q(p, x)
        k, v, _ = kv_override
    kv_out = (k, v)
    G = cfg.num_heads // k.shape[2]
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    q = ann.constrain(q, "heads")
    k = ann.constrain(k, "heads")
    v = ann.constrain(v, "heads")
    S = x.shape[1]
    use_flash = cfg.attn_impl in ("xla_chunked", "pallas") \
        and S > cfg.attn_chunk_q and S % cfg.attn_chunk_q == 0 \
        and k.shape[1] % cfg.attn_chunk_kv == 0
    if use_flash:
        o = flash_attention_xla(q, k, v, causal=causal, window=window,
                                chunk_q=cfg.attn_chunk_q,
                                chunk_kv=cfg.attn_chunk_kv,
                                softcap=cfg.attn_logit_softcap)
    else:
        o = full_attention(q, k, v, causal=causal, window=window,
                           softcap=cfg.attn_logit_softcap)
    out = _out_proj(p, o, dt)
    if return_kv:
        return out, kv_out
    return out


def attention_decode_step(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                          pos: torch.Tensor, k_cache, v_cache,
                          window: int = 0, cross_kv=None):
    """One-token decode. x: (B, 1, d); pos: (B,) current position.

    Returns (out, (k_cache, v_cache)).  The new K/V are written IN PLACE
    into the given caches at ``pos`` (at ``pos % Smax`` when ``window`` >
    0: a ring that holds only the window), so the caches passed in are
    consumed; a position past a full cache raises (the reference drops
    such a write).  An int8 cache takes the static symmetric quantization
    round(k / kv_quant_scale) clipped to +-127.  ``cross_kv`` (ck, cv)
    is cross-attention over a fixed encoder cache: no mask, no write, and
    the query rotated by RoPE at ``pos`` as the reference does."""
    dt = x.dtype
    if cross_kv is not None:
        k, v = cross_kv
        q = _q(p, x)
        B = x.shape[0]
        q_ang = rope_angles(pos[:, None], cfg.resolved_head_dim,
                            cfg.rope_theta, None)
        q = apply_rope(q, q_ang)
        G = cfg.num_heads // cfg.num_kv_heads
        s = torch.einsum("bkgh,bskh->bkgs",
                         q.reshape(B, cfg.num_kv_heads, G, -1),
                         k).to(torch.float32)
        s = s / torch.full((), math.sqrt(cfg.resolved_head_dim),
                           dtype=torch.float32, device=s.device)
        w = torch.softmax(s, -1).to(dt)
        o = torch.einsum("bkgs,bskh->bkgh", w, v).reshape(
            B, 1, cfg.num_heads, -1)
        return _out_proj(p, o, dt), None

    q, k, v = _qkv(p, x, cfg)
    if cfg.mrope_sections:
        mpos = pos[None, :, None].expand((3,) + tuple(pos.shape) + (1,))
        angles = rope_angles(mpos, cfg.resolved_head_dim, cfg.rope_theta,
                             _mrope(cfg))
    else:
        angles = rope_angles(pos[:, None], cfg.resolved_head_dim,
                             cfg.rope_theta, None)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)

    Smax = k_cache.shape[1]
    write_idx = (pos % Smax) if window > 0 else pos
    bidx = torch.arange(x.shape[0], device=x.device)
    if k_cache.dtype == torch.int8:
        # a tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, which is not the IEEE quotient the reference takes
        qs = torch.full((), cfg.kv_quant_scale, dtype=torch.float32,
                        device=x.device)
        k_w = torch.clamp(torch.round(k[:, 0].to(torch.float32) / qs),
                          -127, 127)
        v_w = torch.clamp(torch.round(v[:, 0].to(torch.float32) / qs),
                          -127, 127)
        k_cache[bidx, write_idx] = k_w.to(torch.int8)
        v_cache[bidx, write_idx] = v_w.to(torch.int8)
        qs_dt = qs.to(dt)
        k_full = k_cache.to(dt) * qs_dt
        v_full = v_cache.to(dt) * qs_dt
    else:
        k_cache[bidx, write_idx] = k[:, 0].to(k_cache.dtype)
        v_cache[bidx, write_idx] = v[:, 0].to(v_cache.dtype)
        k_full, v_full = k_cache.to(dt), v_cache.to(dt)
    if window > 0:
        # ring buffer: every slot is attended, unwritten ones included
        o = decode_attention(q, k_full, v_full, torch.full_like(pos, Smax),
                             window=0, softcap=cfg.attn_logit_softcap)
    else:
        o = decode_attention(q, k_full, v_full, pos,
                             softcap=cfg.attn_logit_softcap)
    return _out_proj(p, o, dt), (k_cache, v_cache)


# ---------------------------------------------------------------------------
# FFN (dense)
# ---------------------------------------------------------------------------

def _gated(cfg: ModelConfig) -> bool:
    return cfg.activation in ("swiglu", "geglu")


def init_ffn(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    std = 0.02
    pdt = _pdtype(cfg)
    p = {"w_up": _normal(gen, (d, f), std, pdt, device),
         "w_down": _normal(gen, (f, d), std / math.sqrt(2 * cfg.num_layers),
                           pdt, device)}
    if _gated(cfg):
        p["w_gate"] = _normal(gen, (d, f), std, pdt, device)
    return p


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _act(name: str, g: torch.Tensor) -> torch.Tensor:
    if name in ("swiglu", "silu"):
        return F.silu(g)
    if name in ("geglu", "gelu"):
        return _gelu(g)
    if name == "relu_sq":
        r = F.relu(g)
        return r * r
    raise ValueError(name)


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig,
              ann=NULL_ANN) -> torch.Tensor:
    dt = x.dtype
    up = ann.constrain(x @ p["w_up"].to(dt), "wide")
    if "w_gate" in p:
        h = _act(cfg.activation,
                 ann.constrain(x @ p["w_gate"].to(dt), "wide")) * up
    else:
        h = _act(cfg.activation, up)
    return h @ p["w_down"].to(dt)


# ---------------------------------------------------------------------------
# MoE (scatter-based top-k dispatch, GShard-style capacity)
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    if cfg.moe is None:
        raise ValueError("init_moe needs cfg.moe")
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_ff_expert
    std = 0.02
    pdt = _pdtype(cfg)
    p = {
        "router": _normal(gen, (d, E), std, pdt, device),
        "w_up": _normal(gen, (E, d, f), std, pdt, device),
        "w_down": _normal(gen, (E, f, d), std / math.sqrt(2 * cfg.num_layers),
                          pdt, device),
    }
    if _gated(cfg):
        p["w_gate"] = _normal(gen, (E, d, f), std, pdt, device)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, ties to the
    lower index (a stable descending sort keeps that order on every
    device; ``torch.topk`` does not promise it on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def apply_moe(p: Params, x: torch.Tensor, cfg: ModelConfig, ann=NULL_ANN,
              *, groups: Optional[int] = None):
    """Top-k MoE, GShard-style grouped dispatch with scatter.

    Tokens are split into G groups (``ann.moe_groups``, the data-parallel
    degree; ``groups=`` is shorthand for a no-op annotator with that
    count and cannot be combined with another annotator); each group routes its
    tokens into a capacity-bounded (E, C, d) buffer, the expert FFNs run
    as one batched einsum over E, and the results gather back with the
    top-k gate-weighted combine.  Overflowed tokens drop (GShard
    semantics).  Returns (y, aux_loss)."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    E, k = mo.num_experts, mo.top_k
    dt = x.dtype
    dev = x.device
    if groups is not None:
        if ann is not NULL_ANN:
            raise ValueError("apply_moe takes groups= or ann=, not both")
        ann = _Groups(groups)
    G = max(1, min(ann.moe_groups, T))
    while T % G != 0:
        G -= 1
    Tg = T // G
    xt = x.reshape(G, Tg, d)

    logits = (xt @ p["router"].to(dt)).to(torch.float32)       # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = _top_k(probs, k)                           # (G, Tg, k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    C = int(max(4, math.ceil(k * Tg / E * mo.capacity_factor)))
    C = min(C, k * Tg)

    e_flat = idx.reshape(G, Tg * k)                             # (G, Tg*k)
    onehot = F.one_hot(e_flat, E)                               # (G, Tg*k, E)
    pos_all = torch.cumsum(onehot, dim=1) - 1                   # within expert
    pos = torch.gather(pos_all, 2, e_flat[..., None])[..., 0]
    valid = pos < C
    pos_c = torch.where(valid, pos, torch.full_like(pos, C))    # overflow -> C

    # scatter into (G, E, C+1, d); slot C is the trash slot, the only one
    # that ever takes more than one token.  One scatter per top-k rank.
    e_tk = e_flat.reshape(G, Tg, k)
    p_tk = pos_c.reshape(G, Tg, k)
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, Tg)
    buf = torch.zeros((G, E, C + 1, d), dtype=dt, device=dev)
    for j in range(k):
        buf.index_put_((g_idx, e_tk[..., j], p_tk[..., j]), xt,
                       accumulate=True)
    buf = ann.constrain(buf[:, :, :C], "moe_buf")               # (G, E, C, d)

    up = torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(dt))
    if "w_gate" in p:
        g = _act(cfg.activation,
                 torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(dt)))
        h = g * up
    else:
        h = _act(cfg.activation, up)
    h = ann.constrain(h, "moe_hidden")
    out = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    out = ann.constrain(out, "moe_buf")
    out = torch.cat([out, torch.zeros((G, E, 1, d), dtype=dt, device=dev)],
                    dim=2)

    w_tk = (gate_vals * valid.reshape(G, Tg, k)).to(dt)
    y = torch.zeros((G, Tg, d), dtype=dt, device=dev)
    for j in range(k):
        y = y + out[g_idx, e_tk[..., j], p_tk[..., j]] * w_tk[..., j][..., None]
    y = y.reshape(B, S, d)

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e
    f_e = torch.mean(F.one_hot(idx[..., 0], E).to(torch.float32), dim=(0, 1))
    p_e = probs.mean(dim=(0, 1))
    aux = E * torch.sum(f_e * p_e) * mo.aux_loss_weight
    return y, aux


# ---------------------------------------------------------------------------
# RG-LRU (recurrentgemma) recurrent block
# ---------------------------------------------------------------------------

def init_rglru_block(gen: torch.Generator, cfg: ModelConfig,
                     device) -> Params:
    if cfg.recurrent is None:
        raise ValueError("init_rglru_block needs cfg.recurrent")
    d = cfg.d_model
    lru = cfg.recurrent.lru_width or d
    cw = cfg.recurrent.conv1d_width
    std = 0.02
    pdt = _pdtype(cfg)
    # a_param so that a = sigmoid(lambda)^c lies in [0.9, 0.999]
    a_init = torch.log(torch.expm1(-(1.0 / 8.0) * torch.log(
        torch.linspace(0.9, 0.999, lru, dtype=torch.float32,
                       device=device))))
    return {
        "w_x": _normal(gen, (d, lru), std, pdt, device),
        "w_gate": _normal(gen, (d, lru), std, pdt, device),
        "w_out": _normal(gen, (lru, d), std / math.sqrt(2 * cfg.num_layers),
                         pdt, device),
        "conv_w": _normal(gen, (cw, lru), std, pdt, device),
        "conv_b": torch.zeros((lru,), dtype=pdt, device=device),
        # diagonal input/recurrence gates, as the reference
        "gate_i_w": _normal(gen, (lru,), std, pdt, device),
        "gate_i_b": torch.zeros((lru,), dtype=pdt, device=device),
        "gate_r_w": _normal(gen, (lru,), std, pdt, device),
        "gate_r_b": torch.zeros((lru,), dtype=pdt, device=device),
        "a_param": a_init.to(pdt),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0) at every x (``F.softplus``
    turns linear above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _rglru_gates(p: Params, u: torch.Tensor):
    """u: (..., lru) branch input -> (a, gated_in) fp32."""
    f32 = torch.float32
    uf = u.to(f32)
    gi = torch.sigmoid(uf * p["gate_i_w"].to(f32) + p["gate_i_b"].to(f32))
    gr = torch.sigmoid(uf * p["gate_r_w"].to(f32) + p["gate_r_b"].to(f32))
    log_a = -8.0 * gr * _softplus(p["a_param"].to(f32))
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * gi * uf


def _linear_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan over axis 1 of the affine maps h -> a h + b,
    composed as the reference's ``combine`` ((al, bl), (ar, br)) ->
    (al ar, ar bl + br), in log2(C) doubling steps (Hillis-Steele).  The
    reference's ``associative_scan`` groups the products otherwise, so
    the two agree within float32 rounding, not bit for bit."""
    n = a.shape[1]
    s = 1
    while s < n:
        a_prev, b_prev = a[:, :-s], b[:, :-s]
        a_cur, b_cur = a[:, s:], b[:, s:]
        a = torch.cat([a[:, :s], a_cur * a_prev], dim=1)
        b = torch.cat([b[:, :s], a_cur * b_prev + b_cur], dim=1)
        s *= 2
    return a, b


def rglru_sequence(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   h0: Optional[torch.Tensor] = None, conv_state=None,
                   chunk: int = 256, ann=NULL_ANN):
    """RG-LRU block over a sequence. x: (B, S, d) -> (y, (h_last,
    conv_tail)).  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t u_t), scanned
    per chunk of ``chunk`` steps and carried across chunks."""
    B, S, d = x.shape
    dt = x.dtype
    u = ann.constrain(x @ p["w_x"].to(dt), "wide")             # (B, S, lru)
    gate = ann.constrain(_gelu(x @ p["w_gate"].to(dt)), "wide")
    lru = u.shape[-1]
    cw = cfg.recurrent.conv1d_width

    if conv_state is None:
        conv_state = torch.zeros((B, cw - 1, lru), dtype=dt, device=x.device)
    u_pad = torch.cat([conv_state, u], dim=1)
    conv_w = p["conv_w"].to(dt)
    uc = sum(u_pad[:, i:i + S] * conv_w[i] for i in range(cw)) + \
        p["conv_b"].to(dt)
    new_conv_state = u_pad[:, -(cw - 1):] if cw > 1 else conv_state

    a, b = _rglru_gates(p, uc)                                 # fp32
    h = h0 if h0 is not None else torch.zeros(
        (B, lru), dtype=torch.float32, device=x.device)

    Ck = min(chunk, S)
    nchunks = max(1, S // Ck)
    if S % Ck != 0 and nchunks != 1:
        raise ValueError("seq not divisible by rglru chunk")
    if S % Ck != 0:
        Ck, nchunks = S, 1
    hs = []
    for c in range(nchunks):
        aa, bb = _linear_scan(a[:, c * Ck:(c + 1) * Ck],
                              b[:, c * Ck:(c + 1) * Ck])
        h_seq = aa * h[:, None, :] + bb
        h = h_seq[:, -1, :]
        hs.append(h_seq)
    h_seq = torch.cat(hs, dim=1).to(dt)
    y = (h_seq * gate) @ p["w_out"].to(dt)
    return y, (h, new_conv_state)


def rglru_decode_step(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                      h: torch.Tensor, conv_state: torch.Tensor):
    """One-token RG-LRU step. x: (B, 1, d); h: (B, lru) fp32; conv_state
    (B, cw-1, lru)."""
    dt = x.dtype
    u = x[:, 0] @ p["w_x"].to(dt)                              # (B, lru)
    gate = _gelu(x[:, 0] @ p["w_gate"].to(dt))
    conv_w = p["conv_w"].to(dt)
    hist = torch.cat([conv_state, u[:, None]], dim=1)         # (B, cw, lru)
    uc = torch.einsum("bcl,cl->bl", hist, conv_w) + p["conv_b"].to(dt)
    new_conv_state = hist[:, 1:]
    a, b = _rglru_gates(p, uc)
    h_new = a * h + b
    y = ((h_new.to(dt) * gate) @ p["w_out"].to(dt))[:, None]
    return y, (h_new, new_conv_state)


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) token mix + channel mix
# ---------------------------------------------------------------------------

def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig,
                    device) -> Params:
    if cfg.rwkv is None:
        raise ValueError("init_rwkv_block needs cfg.rwkv")
    d = cfg.d_model
    hs = cfg.rwkv.head_size
    H = d // hs
    dl = cfg.rwkv.decay_lora
    std = 0.02
    pd = _pdtype(cfg)
    out_std = std / math.sqrt(2 * cfg.num_layers)
    return {
        "mu_r": _full((d,), 0.5, pd, device),
        "mu_k": _full((d,), 0.5, pd, device),
        "mu_v": _full((d,), 0.5, pd, device),
        "mu_w": _full((d,), 0.5, pd, device),
        "mu_g": _full((d,), 0.5, pd, device),
        "w_r": _normal(gen, (d, d), std, pd, device),
        "w_k": _normal(gen, (d, d), std, pd, device),
        "w_v": _normal(gen, (d, d), std, pd, device),
        "w_g": _normal(gen, (d, d), std, pd, device),
        "w_o": _normal(gen, (d, d), out_std, pd, device),
        # data-dependent decay LoRA (the Finch feature)
        "w0": _full((d,), -6.0, pd, device),
        "wA": _normal(gen, (d, dl), std, pd, device),
        "wB": _normal(gen, (dl, d), std, pd, device),
        "u_bonus": _normal(gen, (H, hs), std, pd, device),
        "ln_scale": torch.ones((d,), dtype=pd, device=device),
        "ln_bias": torch.zeros((d,), dtype=pd, device=device),
        # channel mix
        "cm_mu_k": _full((d,), 0.5, pd, device),
        "cm_mu_r": _full((d,), 0.5, pd, device),
        "cm_wk": _normal(gen, (d, cfg.d_ff), std, pd, device),
        "cm_wv": _normal(gen, (cfg.d_ff, d), out_std, pd, device),
        "cm_wr": _normal(gen, (d, d), std, pd, device),
    }


def _rwkv_wkv_scan(r, k, v, w, u, s0):
    """WKV-6 recurrence.  r/k/v/w: (B, S, H, hs) fp32; u: (H, hs); s0:
    (B, H, hs, hs).

    y_t[j] = sum_i r_t[i] * (S_t[i,j] + u[i] k_t[i] v_t[j])
    S_{t+1}[i,j] = w_t[i] * S_t[i,j] + k_t[i] v_t[j]

    A loop over time with the reference's statements (its chunking only
    bounds the backward pass's memory)."""
    s = s0
    uu = u[None, :, :, None]
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]        # (B, H, hs, hs)
        ys.append(torch.einsum("bhi,bhij->bhj", r[:, t], s + uu * kv))
        s = w[:, t, :, :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv_time_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  x_prev: Optional[torch.Tensor] = None,
                  state: Optional[torch.Tensor] = None):
    """RWKV-6 time mix over a sequence. x: (B, S, d).  Returns (y,
    (last_x, last_state))."""
    B, S, d = x.shape
    dt = x.dtype
    f32 = torch.float32
    hs = cfg.rwkv.head_size
    H = d // hs
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=dt, device=x.device)
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)       # shifted
    dx = xs - x

    def mix(mu):
        return x + dx * mu.to(dt)

    xr, xk, xv, xw, xg = (mix(p[m]) for m in
                          ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"))
    r = (xr @ p["w_r"].to(dt)).reshape(B, S, H, hs).to(f32)
    k = (xk @ p["w_k"].to(dt)).reshape(B, S, H, hs).to(f32)
    v = (xv @ p["w_v"].to(dt)).reshape(B, S, H, hs).to(f32)
    g = F.silu(xg @ p["w_g"].to(dt))
    dd = torch.tanh(xw.to(f32) @ p["wA"].to(f32)) @ p["wB"].to(f32)
    w = torch.exp(-torch.exp(p["w0"].to(f32) + dd)).reshape(B, S, H, hs)
    if state is None:
        state = torch.zeros((B, H, hs, hs), dtype=f32, device=x.device)
    y, s_last = _rwkv_wkv_scan(r, k, v, w, p["u_bonus"].to(f32), state)
    # per-head groupnorm
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, d)
    yn = yn * p["ln_scale"].to(f32) + p["ln_bias"].to(f32)
    out = (yn.to(dt) * g) @ p["w_o"].to(dt)
    return out, (x[:, -1], s_last)


def rwkv_channel_mix(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                     x_prev: Optional[torch.Tensor] = None):
    B, S, d = x.shape
    dt = x.dtype
    if x_prev is None:
        x_prev = torch.zeros((B, d), dtype=dt, device=x.device)
    xs = torch.cat([x_prev[:, None], x[:, :-1]], dim=1)
    dx = xs - x
    xk = x + dx * p["cm_mu_k"].to(dt)
    xr = x + dx * p["cm_mu_r"].to(dt)
    kk = F.relu(xk @ p["cm_wk"].to(dt))
    vv = (kk * kk) @ p["cm_wv"].to(dt)
    rr = torch.sigmoid(xr @ p["cm_wr"].to(dt))
    return rr * vv, x[:, -1]


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------

def init_embeddings(gen: torch.Generator, cfg: ModelConfig,
                    device) -> Params:
    V, d = cfg.padded_vocab, cfg.d_model
    p = {"embed": _normal(gen, (V, d), 0.02, _pdtype(cfg), device)}
    if not cfg.tie_embeddings:
        p["unembed"] = _normal(gen, (d, V), 0.02, _pdtype(cfg), device)
    return p


def embed_tokens(p: Params, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    # gather, then cast: the same values as the reference's cast-then-
    # gather, without casting the whole (V, d) table every step
    return F.embedding(tokens.long(), p["embed"]).to(_dtype(cfg))


def logits_from_hidden(p: Params, x: torch.Tensor,
                       cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x, p["embed"].to(dt))
    else:
        logits = torch.einsum("bsd,dv->bsv", x, p["unembed"].to(dt))
    if cfg.padded_vocab != cfg.vocab_size:
        iota = torch.arange(cfg.padded_vocab, device=x.device)
        pad_bias = torch.where(iota < cfg.vocab_size, 0.0, -1e30)
        logits = logits + pad_bias.to(dt)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in fp32; the gold logit is taken by a masked
    reduction along the vocab dim, as in the reference."""
    lf = logits.to(torch.float32)
    m = lf.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.sum(torch.exp(lf - m), dim=-1))
    vocab_iota = torch.arange(lf.shape[-1], device=lf.device)
    gold = torch.sum(torch.where(vocab_iota == labels[..., None].long(), lf,
                                 torch.zeros((), device=lf.device)), dim=-1)
    return torch.mean(lse - gold)
