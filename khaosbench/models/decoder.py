"""The ``decoder`` model module: a llama-style dense decoder or a top-k
mixture-of-experts decoder (a configuration with ``num_experts``), run by
the port's ``dense`` and ``moe`` families.

A configuration names its model module by ``"model"``; the harness finds
``khaosbench/models/<model>.py`` by that name and asks it, and nothing
else, what is particular to the architecture:

* ``port_config(cfg)``: the program's ``ModelConfig``;
* ``param_shapes(cfg)``: the parameter tree the benchmark draws and
  checks the program's against, nested dicts of (shape, init std);
* ``initial_state(trainer, params)``: the train state the harness installs;
* ``train_steps(params, cfg, opt, batches, precision)``: the plain
  float32 reference's first steps (``precision`` the control's);
* ``train_step_flops(cfg, batch, seq_len)`` and
  ``packed_state_elements(cfg)``: the counts behind ``step_mfu`` and
  ``flat_int8_encode_roofline``;
* ``observers(cfg, device)``: objects wrapped around the run (``install``,
  ``uninstall``, ``summary``, ``checks``), each adding checks that decide
  ``correct``;
* ``smoke(cfg)``: the keys that shrink the configuration for CPU tests.
"""
from __future__ import annotations

import dataclasses
import importlib
import math

import torch

from repro_torch.models import layers

from khaosbench import flops
from khaosbench.reference import decoder as ref


def port_config(cfg: dict):
    """The port's preset with the file's depth, norm epsilon, precisions
    and (for a MoE) capacity factor; every other width the file states
    must match the preset."""
    port = getattr(importlib.import_module(
        "repro_torch.configs." + cfg["port"]["module"]),
        cfg["port"].get("object", "CONFIG"))
    run = cfg["run"]
    mc = dataclasses.replace(
        port, num_layers=cfg["num_hidden_layers"],
        norm_eps=cfg["rms_norm_eps"], dtype=run["dtype"],
        param_dtype=run["param_dtype"], remat_policy=run["remat_policy"])
    if mc.moe is not None:
        mc = dataclasses.replace(mc, moe=dataclasses.replace(
            mc.moe, capacity_factor=cfg["capacity_factor"]))
    got = {"family": mc.family, "hidden_size": mc.d_model,
           "num_attention_heads": mc.num_heads,
           "num_key_value_heads": mc.num_kv_heads,
           "head_dim": mc.resolved_head_dim, "vocab_size": mc.vocab_size,
           "vocab_pad_multiple": mc.vocab_pad_multiple,
           "rope_theta": mc.rope_theta, "hidden_act": mc.activation,
           "tie_word_embeddings": mc.tie_embeddings,
           "attention_bias": mc.qkv_bias,
           "softcap": mc.attn_logit_softcap, "norm": mc.norm_type}
    want = {"family": cfg["port"]["family"],
            "hidden_size": cfg["hidden_size"],
            "num_attention_heads": cfg["num_attention_heads"],
            "num_key_value_heads": cfg["num_key_value_heads"],
            "head_dim": ref.head_dim(cfg),
            "vocab_size": cfg["vocab_size"],
            "vocab_pad_multiple": cfg["vocab_pad_multiple"],
            "rope_theta": cfg["rope_theta"], "hidden_act": "swiglu",
            "tie_word_embeddings": cfg["tie_word_embeddings"],
            "attention_bias": cfg["attention_bias"], "softcap": 0.0,
            "norm": "rmsnorm"}
    if ref.is_moe(cfg):
        got.update(num_experts=mc.moe.num_experts,
                   num_experts_per_tok=mc.moe.top_k,
                   intermediate_size=mc.moe.d_ff_expert,
                   router_aux_loss_coef=mc.moe.aux_loss_weight,
                   capacity_factor=mc.moe.capacity_factor,
                   router_jitter=mc.moe.router_jitter)
        want.update({k: cfg[k] for k in (
            "num_experts", "num_experts_per_tok", "intermediate_size",
            "router_aux_loss_coef", "capacity_factor")}, router_jitter=0.0)
    else:
        got["intermediate_size"] = mc.d_ff
        want["intermediate_size"] = cfg["intermediate_size"]
    differ = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
    if differ:
        raise ValueError(f"the port's preset differs from the file: {differ}")
    return mc


param_shapes = ref.param_shapes
train_steps = ref.train_steps


def initial_state(trainer, params: dict) -> dict:
    """The params, the trainer's optimizer state for them, step 0."""
    return {"params": params, "opt": trainer.optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=trainer.device)}


# -- counts from the widths ------------------------------------------------
def matmul_params_per_token(cfg: dict) -> int:
    """Weights that multiply each token once in the forward pass: the
    attention projections, the FFN (for a MoE: the router and the top-k
    experts a token is routed to) and the output head.  The embedding is
    a lookup and counts nothing."""
    d, hd = cfg["hidden_size"], ref.head_dim(cfg)
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = d * H * hd * 2 + d * K * hd * 2
    f = cfg["intermediate_size"]
    if ref.is_moe(cfg):
        ffn = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d * f
    else:
        ffn = 3 * d * f
    return cfg["num_hidden_layers"] * (attn + ffn) + d * cfg["vocab_size"]


def train_step_flops(cfg: dict, batch: int, seq_len: int) -> float:
    """Model flops of one training step: 6 per weight and token, plus
    causal attention (QK^T and PV, 2 flops a multiply-add, half the
    square) times 3 for the forward and backward passes.  Recomputation
    is not counted."""
    tokens = batch * seq_len
    dense = 6.0 * matmul_params_per_token(cfg) * tokens
    attn_fwd = 2 * 2 * seq_len * seq_len / 2 \
        * cfg["num_attention_heads"] * ref.head_dim(cfg)
    return dense + 3.0 * attn_fwd * batch * cfg["num_hidden_layers"]


def packed_state_elements(cfg: dict) -> int:
    """The checkpointed float32 state: the params and AdamW's m and v."""
    return 3 * flops.packed_elements(param_shapes(cfg))


# -- the MoE dispatch's per-expert load --------------------------------------
def capacity(cfg: dict, tokens: int) -> int:
    """The slots an expert has for ``tokens`` tokens (the port's rule)."""
    k, E = cfg["num_experts_per_tok"], cfg["num_experts"]
    return min(max(4, math.ceil(k * tokens / E * cfg["capacity_factor"])),
               k * tokens)


class ExpertLoads:
    """The MoE dispatch's per-expert load, read from the program's own
    routing.  The port's ``apply_moe`` picks each token's experts with
    ``layers._top_k`` and keeps at most C (token, rank) pairs an expert, in
    token-major order; the rest are dropped.  This wraps that call for one
    run and counts, on the device and without a sync, each expert's load
    in each call: the pairs dropped, summed over the calls, and each call's
    largest load.  The recomputation of a layer in the backward pass is a
    call like the forward's, so a dropped pair counts twice there."""

    name = "expert_loads"

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.dropped = torch.zeros((), dtype=torch.int64, device=device)
        self.call_max: list = []
        self.capacity = 0
        self._real = None

    def install(self) -> None:
        self._real, layers._top_k = layers._top_k, self._top_k

    def uninstall(self) -> None:
        layers._top_k = self._real

    def _top_k(self, probs: torch.Tensor, k: int):
        vals, idx = self._real(probs, k)
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

    def checks(self, summary: dict) -> dict:
        """Every pair routed is computed: the published model is dropless."""
        return {"moe_pairs_dropped": (summary["dropped"], 0)}


def observers(cfg: dict, device) -> list:
    return [ExpertLoads(cfg, device)] if ref.is_moe(cfg) else []


def smoke(cfg: dict) -> dict:
    """The port's SMOKE preset's widths in place of the published ones."""
    if ref.is_moe(cfg):
        small = {"hidden_size": 64, "num_attention_heads": 4,
                 "num_key_value_heads": 4, "intermediate_size": 64,
                 "vocab_size": 512, "num_experts": 8,
                 "num_experts_per_tok": 2, "rope_theta": 10000.0}
    else:
        small = {"hidden_size": 64, "num_attention_heads": 4,
                 "num_key_value_heads": 1, "intermediate_size": 128,
                 "vocab_size": 512, "rope_theta": 10000.0}
    return {**small, "port": dict(cfg["port"], object="SMOKE")}
