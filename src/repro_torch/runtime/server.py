"""Batched streaming inference server: prefill + decode loop over request
batches pulled from an event stream, with per-request latency metrics.

The serving path shares the model zoo's prefill/decode step factories.
The server runs where its params live (their device); prompts go there,
the caches stay there, and the generated tokens come back to the host
once a batch, after its last decode step.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.metrics import MetricsStore
from repro_torch.models import zoo
from repro_torch.utils.trees import tree_leaves


@dataclass
class ServeRequest:
    rid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 8


class StreamServer:
    def __init__(self, cfg: ModelConfig, params, max_batch: int = 4,
                 max_seq: int = 128, metrics_maxlen: int = 4096):
        self.cfg = cfg
        self.params = params
        self.device = tree_leaves(params)[0].device
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prefill = zoo.make_prefill_step(cfg)
        self.decode = zoo.make_decode_step(cfg)
        # bounded: a long-lived server must not grow per-batch series forever
        self.metrics = MetricsStore(maxlen=metrics_maxlen)
        self._t = 0.0
        self.last_decode_positions: list[int] = []

    def _grow_caches(self, caches, extra: int):
        """Extend full-attention K/V caches (dense/moe/vlm: stacked
        (L, B, S, K, hd) with the seq axis at 2) by ``extra`` slots so
        decode steps have somewhere to write.  Ring (hybrid window) and
        state (ssm) caches are fixed-size by design and pass through.
        Only ``k``/``v`` are returned, as the reference returns them."""
        if extra <= 0 or not (isinstance(caches, dict) and "k" in caches):
            return caches
        pad = (0, 0, 0, 0, 0, extra)
        return {"k": F.pad(caches["k"], pad), "v": F.pad(caches["v"], pad)}

    def serve_batch(self, requests: list[ServeRequest]) -> dict[int, np.ndarray]:
        """Prefill a batch of equal-length prompts, then decode greedily."""
        if not 0 < len(requests) <= self.max_batch:
            raise ValueError(f"a batch takes 1 to {self.max_batch} requests, "
                             f"not {len(requests)}")
        S = len(requests[0].prompt)
        if any(len(r.prompt) != S for r in requests):
            raise ValueError("bucket by length: prompts of a batch differ")
        max_new = max(r.max_new_tokens for r in requests)
        if S + max_new > self.max_seq:
            raise ValueError(f"prompt ({S}) + generation ({max_new}) exceeds "
                             f"max_seq ({self.max_seq})")
        tokens = torch.as_tensor(np.stack([r.prompt for r in requests]),
                                 device=self.device)
        next_tok, caches = self.prefill(self.params, {"tokens": tokens})
        # prefill caches hold exactly S positions; generated tokens land at
        # S, S+1, ... — grow the caches before the first decode write (a
        # write past the cache would raise here; JAX drops it silently)
        caches = self._grow_caches(caches, max_new - 1)
        outs = [next_tok]
        cur = next_tok[:, None]
        self.last_decode_positions = []
        for i in range(max_new - 1):
            # step i writes the token generated at position S + i and
            # rotates its query to that absolute position
            p = S + i
            self.last_decode_positions.append(p)
            pos = torch.full((len(requests),), p, dtype=torch.int32,
                             device=self.device)
            cur, caches = self.decode(self.params, caches,
                                      {"tokens": cur, "pos": pos})
            outs.append(cur[:, 0])
        toks = torch.stack(outs, dim=1).cpu().numpy()
        self.metrics.record("served", self._t, len(requests))
        self._t += 1.0
        return {r.rid: np.array(toks[b, : r.max_new_tokens])
                for b, r in enumerate(requests)}
