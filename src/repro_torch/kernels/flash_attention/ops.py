"""Dispatching wrapper of flash attention:
``flash_attention(q, k, v, *, causal, window, softcap)``.

A CPU tensor takes the plain PyTorch version (``ref.py``) right after the
shape checks, at any head width and in any float dtype, as the JAX op
takes them.  Any other tensor is held to what the CUDA kernel is built
for, head width in ``HEAD_DIMS``, q, k, v of one dtype of ``DTYPES`` and
a softcap of 0 or in ``SOFTCAP_RANGE`` (so a ``meta`` tensor shows the
rule without a card), and then a CUDA tensor launches the kernel
(``kernel.py``), with no fallback: a kernel that cannot build or launch
raises; any other device raises.  The TPU kernel's tiling arguments
(``block_q``, ``block_kv``) are not part of this API: the kernel picks
its own tiles.  Each launch of the kernel adds one to
``flash_attention.launches`` (``launch_counts``/``reset_launch_counts``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.flash_attention import kernel as _k
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = tuple(_k.DTYPES)
HEAD_DIMS = _k.HEAD_DIMS
SOFTCAP_RANGE = _k.SOFTCAP_RANGE


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q (B, S, H, hd); k, v (B, Skv, K, hd) with K | H (GQA) ->
    (B, S, H, hd) in q's dtype, float32 accumulation."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: want (B,S,H,hd), (B,Skv,K,hd) "
                         f"twice")
    B, S, H, hd = q.shape
    K = k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or K == 0 or H % K:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} are "
                         f"not a GQA pair")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap)
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one of {list(DTYPES)}")
    cap = ctypes.c_float(softcap or 0.0).value   # as the kernel gets it
    lo, hi = SOFTCAP_RANGE
    if cap > 0.0 and not lo <= cap <= hi:
        raise ValueError(f"softcap {softcap} outside [{lo:g}, {hi:g}], the "
                         f"range whose quotient the kernel computes exactly")
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention implementation for device "
                         f"{q.device}")
    o = _k.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=causal, window=window, softcap=softcap)
    flash_attention.launches += 1
    return o


flash_attention.launches = 0


def launch_counts() -> dict:
    return {"flash_attention": flash_attention.launches}


def reset_launch_counts() -> None:
    flash_attention.launches = 0


__all__ = ["flash_attention", "attention_ref", "launch_counts",
           "reset_launch_counts"]
