"""The MoE dispatch's per-expert load, read from the program's own routing.

The port's ``apply_moe`` picks each token's experts with
``layers._top_k`` and keeps at most C (token, rank) pairs an expert, in
token-major order; the rest are dropped.  ``ExpertLoads`` wraps that call
for one run and counts, on the device and without a sync, each expert's
load in each call: the pairs dropped, summed over the calls, and each
call's largest load.  The recomputation of a layer in the backward pass
is a call like the forward's, so a dropped pair counts twice there.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import layers

_TOP_K = layers._top_k          # the program's own, unwrapped


def capacity(cfg: dict, tokens: int) -> int:
    """The slots an expert has for ``tokens`` tokens (the port's rule)."""
    k, E = cfg["num_experts_per_tok"], cfg["num_experts"]
    return min(max(4, math.ceil(k * tokens / E * cfg["capacity_factor"])),
               k * tokens)


class ExpertLoads:
    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)
        self.call_max: list = []
        self.capacity = 0

    def install(self) -> None:
        layers._top_k = self._top_k

    def uninstall(self) -> None:
        layers._top_k = _TOP_K

    def _top_k(self, probs: torch.Tensor, k: int):
        vals, idx = _TOP_K(probs, k)
        with torch.no_grad():
            groups, tokens, experts = probs.shape
            flat = idx.reshape(groups, -1)
            load = torch.zeros((groups, experts), dtype=torch.int64,
                               device=idx.device)
            load.scatter_add_(1, flat, torch.ones_like(flat))
            self.capacity = capacity(self.cfg, tokens)
            self.call_max.append(load.max())
            self.dropped.add_((load - self.capacity).clamp_min(0).sum())
        return vals, idx

    def summary(self) -> dict:
        """Pairs dropped, slots an expert, and the calls' largest loads:
        the largest and the median."""
        if not self.call_max:
            return {"calls": 0, "dropped": int(self.dropped)}
        loads = torch.stack(self.call_max).cpu()
        return {"calls": len(self.call_max), "dropped": int(self.dropped),
                "capacity": self.capacity, "max_load": int(loads.max()),
                "median_call_max": float(loads.float().median())}
