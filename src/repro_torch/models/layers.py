"""Model primitives of the port's dense family, in plain PyTorch: RMSNorm,
rotary embeddings, GQA attention (full and the chunked running-softmax
form), the SwiGLU FFN, embeddings, logits and cross-entropy.

Conventions follow the JAX package's ``repro.models.layers`` exactly, so
params carried over from it apply unchanged:

* activations: (B, S, d) in ``cfg.dtype`` (bf16 by default)
* attention heads: q (B, S, H, hd); k/v (B, S, K, hd); G = H // K
* weights keep the reference layouts: wq (d, H, hd), wk/wv (d, K, hd),
  wo (H, hd, d), w_up/w_gate (d, f), w_down (f, d), embed (V, d),
  unembed (d, V)
* softmax / norms / the loss accumulate in fp32
* every ``init_*`` returns a params dict; every ``apply`` is functional

None of these is a kernel in the reference (XLA compiles them there), so
plain PyTorch is their port.  ``scaled_dot_product_attention`` is not
used: it is not what the reference computes.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig

Params = Any

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


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


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, dim: Optional[int] = None) -> Params:
    d = dim or cfg.d_model
    if cfg.norm_type != "rmsnorm":
        raise NotImplementedError("only rmsnorm is ported")
    return {"scale": torch.ones((d,), dtype=_pdtype(cfg), device=device)}


def apply_norm(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm computed in f32 and cast back to x's dtype."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions (B, S) -> angles (B, S, head_dim//2); the inverse
    frequencies are computed in numpy float32 exactly as the reference."""
    half = head_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(0, half, dtype=np.float32) / half))
    inv_freq = torch.from_numpy(np.asarray(inv_freq, np.float32)).to(
        positions.device)
    pos = positions.to(torch.float32)
    return pos[..., None] * inv_freq[None, None, :]


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, N, hd), angles: (B, S, hd//2) — half-split (llama)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, device) -> Params:
    d, H, K, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    std = 0.02
    pdt = _pdtype(cfg)
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not ported")
    return {
        "wq": _normal(gen, (d, H, hd), std, pdt, device),
        "wk": _normal(gen, (d, K, hd), std, pdt, device),
        "wv": _normal(gen, (d, K, hd), std, pdt, device),
        "wo": _normal(gen, (H, hd, d), std / math.sqrt(2 * cfg.num_layers),
                      pdt, device),
    }


def _qkv(p: Params, x: torch.Tensor, cfg: ModelConfig):
    dt = x.dtype
    q = torch.einsum("bsd,dnh->bsnh", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dnh->bsnh", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dnh->bsnh", x, p["wv"].to(dt))
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


def attention_sequence(p: Params, x: torch.Tensor, cfg: ModelConfig, *,
                       positions: torch.Tensor, causal: bool = True,
                       window: int = 0) -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill).  GQA KV is
    repeated up to H heads; the chunked path is taken by the reference's
    rule (``attn_impl`` "xla_chunked"/"pallas", S > attn_chunk_q and both
    chunk sizes dividing the sequence), the full path otherwise."""
    dt = x.dtype
    q, k, v = _qkv(p, x, cfg)
    angles = rope_angles(positions, cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(q, angles)
    k = apply_rope(k, angles)
    G = cfg.num_heads // k.shape[2]
    if G > 1:
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
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
    return _out_proj(p, o, dt)


# ---------------------------------------------------------------------------
# FFN (dense, gated)
# ---------------------------------------------------------------------------

def init_ffn(gen: torch.Generator, cfg: ModelConfig, device,
             d_ff: Optional[int] = None) -> Params:
    d = cfg.d_model
    f = d_ff or cfg.d_ff
    std = 0.02
    pdt = _pdtype(cfg)
    if cfg.activation != "swiglu":
        raise NotImplementedError("only the swiglu FFN is ported")
    return {"w_up": _normal(gen, (d, f), std, pdt, device),
            "w_down": _normal(gen, (f, d),
                              std / math.sqrt(2 * cfg.num_layers), pdt,
                              device),
            "w_gate": _normal(gen, (d, f), std, pdt, device)}


def apply_ffn(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    up = x @ p["w_up"].to(dt)
    gate = F.silu(x @ p["w_gate"].to(dt))
    return (gate * up) @ p["w_down"].to(dt)


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
