"""Plain PyTorch version of the RG-LRU scan kernel: the sequential loop.

    h_t = a_t * h_{t-1} + b_t        over the time axis, f32 carry

It is the oracle of ``repro/kernels/rglru/ref.py`` (a ``lax.scan``) as a
Python loop over time.  Each step is one multiply and one add, each its
own PyTorch operation and so each rounded to float32: the CUDA kernel
(``csrc/rglru.cu``) does the same two roundings (``__fmul_rn`` then
``__fadd_rn``) and equals this version bit for bit.
"""
from __future__ import annotations

import torch


def rglru_ref(a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor) -> torch.Tensor:
    """a, b (B, S, D) of any float dtype, h0 (B, D) -> h (B, S, D) f32."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    h = h0.to(torch.float32)
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out
