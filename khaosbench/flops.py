"""Operations and bytes counted from a configuration's widths alone, for
the utilisation and roofline metrics (never read from the program)."""
from __future__ import annotations

from khaosbench.reference.codec import GROUP
from khaosbench.reference.model import (flatten, head_dim, is_moe,
                                        param_shapes)


def matmul_params_per_token(cfg: dict) -> int:
    """Weights that multiply each token once in the forward pass: the
    attention projections, the FFN (for a MoE: the router and the top-k
    experts a token is routed to) and the output head.  The embedding is
    a lookup and counts nothing."""
    d, hd = cfg["hidden_size"], head_dim(cfg)
    H, K = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    attn = d * H * hd * 2 + d * K * hd * 2
    f = cfg["intermediate_size"]
    if is_moe(cfg):
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
        * cfg["num_attention_heads"] * head_dim(cfg)
    return dense + 3.0 * attn_fwd * batch * cfg["num_hidden_layers"]


def packed_state_elements(cfg: dict) -> int:
    """Elements of the checkpointed float32 state (params, AdamW's m and
    v), each leaf padded to whole GROUPs, as the delta codec packs it."""
    per = sum(-(-_numel(shape) // GROUP) * GROUP
              for _, (shape, _) in flatten(param_shapes(cfg)))
    return 3 * per


def int8_encode_bytes(cfg: dict) -> int:
    """Bytes the fused int8 delta encode must move: the new and the base
    state read (4 B each), q written (1 B), and per group a float32 scale
    and an int32 count of changed elements."""
    n = packed_state_elements(cfg)
    return 9 * n + 8 * (n // GROUP)


def _numel(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out
