"""The precision of a reference's contractions: float32 (the reference
itself) or, for the control, float8 e4m3 in the program's place.  A
model's reference sends every contraction through ``Precision.einsum``
and every activation the program holds in its compute dtype through
``Precision.act``."""
from __future__ import annotations

import torch


class Precision:
    """float32 throughout (the reference)."""

    name = "float32"

    def einsum(self, eq: str, a: torch.Tensor, b: torch.Tensor):
        return torch.einsum(eq, a, b)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation where the program holds it in its compute dtype
        (the residual stream, norm outputs, the attention and FFN
        hidden states)."""
        return x


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale per tensor (amax to
    448, the largest e4m3 value), back in float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    s = 448.0 / amax
    return (x * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class _FP8Einsum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, eq, a, b):
        qa, qb = fake_fp8(a), fake_fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.eq = eq
        return torch.einsum(eq, qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        with torch.enable_grad():
            a = qa.detach().requires_grad_(True)
            b = qb.detach().requires_grad_(True)
            out = torch.einsum(ctx.eq, a, b)
        ga, gb = torch.autograd.grad(out, (a, b), fake_fp8(g))
        return None, ga, gb


class FP8(Precision):
    """The precision below bfloat16, for the control: every contraction's
    operands, forward and backward, in float8 e4m3 with a per-tensor
    scale (products accumulated in float32), and every activation the
    program holds in bfloat16 rounded to float8 e4m3 (its gradient passed
    straight through)."""

    name = "fp8_e4m3"

    def einsum(self, eq, a, b):
        return _FP8Einsum.apply(eq, a, b)

    def act(self, x):
        return x + (fake_fp8(x) - x).detach()
