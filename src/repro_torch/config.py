"""Configuration dataclasses of the port: a copy of the JAX package's
``repro.config`` (model, shapes, mesh, sharding, optimizer, checkpoint
plan and legacy checkpoint block, the Khaos knobs and the job config).

Defaults are identical to the reference, so plan names, model widths and
optimizer hyper-parameters mean the same thing in both frameworks.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Sequence


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    # router
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01
    # capacity factor used by the dense (einsum) dispatch path
    capacity_factor: float = 1.25


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (recurrentgemma) block parameters."""
    lru_width: int = 0            # 0 -> d_model
    conv1d_width: int = 4
    block_pattern: Sequence[str] = ("recurrent", "recurrent", "attention")
    window_size: int = 2048       # local attention window for hybrid archs


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64
    gate_lora: int = 160


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | hybrid | moe | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads
    # attention
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: Optional[Sequence[int]] = None   # qwen2-vl M-RoPE
    attn_logit_softcap: float = 0.0
    # ffn
    activation: str = "swiglu"   # swiglu | geglu | gelu | relu_sq
    # norm
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    norm_eps: float = 1e-6
    # families
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # enc-dec (whisper)
    is_encoder_decoder: bool = False
    num_decoder_layers: int = 0
    dec_ratio: int = 4           # decoder_len = seq_len // dec_ratio for enc-dec shapes
    # vlm / audio frontends are STUBS: input_specs() provides embeddings
    frontend: Optional[str] = None   # None | "vision_patch" | "audio_frames"
    tie_embeddings: bool = False
    # numerics / impl
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attn_impl: str = "xla_chunked"   # xla | xla_chunked | pallas
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 1024
    remat_policy: str = "minimal"  # none | minimal | full
    scan_layers: bool = True
    vocab_pad_multiple: int = 256
    kv_cache_dtype: str = "bfloat16"   # bfloat16 | int8 (beyond-paper decode lever)
    kv_quant_scale: float = 1.0 / 32.0  # static symmetric scale for int8 KV

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """True when per-token decode cost is O(1)/O(window): ssm + hybrid."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks + norms), matches zoo init."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        emb = v * d
        out = 0 if self.tie_embeddings else v * d
        def attn_params(bias: bool) -> int:
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            b = (self.num_heads * hd + 2 * self.num_kv_heads * hd) if bias else 0
            return q + kv + o + b
        def ffn_params(dff: int) -> int:
            gated = self.activation in ("swiglu", "geglu")
            return d * dff * (3 if gated else 2)
        per_layer = 2 * d  # two rmsnorm scales
        if self.family == "moe":
            assert self.moe is not None
            per_layer += attn_params(self.qkv_bias)
            per_layer += d * self.moe.num_experts  # router
            per_layer += self.moe.num_experts * ffn_params(self.moe.d_ff_expert) // 1
        elif self.family == "ssm":
            assert self.rwkv is not None
            nh = d // self.rwkv.head_size
            # time-mix: r,k,v,g,o projections + decay/gate LoRAs + per-head params
            per_layer += 5 * d * d                     # r,k,v,g,o time-mix projections
            per_layer += d * d                         # channel-mix receptance
            per_layer += 2 * d * self.rwkv.decay_lora  # decay LoRA (wA, wB)
            per_layer += 12 * d + nh * self.rwkv.head_size  # mu/ln vectors + bonus
            per_layer += ffn_params(self.d_ff)
        elif self.family == "hybrid":
            assert self.recurrent is not None
            lru = self.recurrent.lru_width or d
            pat = self.recurrent.block_pattern
            n_rec = sum(1 for b in pat if b == "recurrent")
            n_att = len(pat) - n_rec
            rec = (2 * d * lru + lru * d                       # in/out proj (x,gate) .. out
                   + self.recurrent.conv1d_width * lru + lru   # conv1d + bias
                   + 2 * lru)                                  # a_param, input gate params
            att = attn_params(False)
            frac_rec = n_rec / len(pat)
            per_layer += int(frac_rec * rec + (1 - frac_rec) * att)
            per_layer += ffn_params(self.d_ff)
        else:  # dense / vlm / audio decoder
            per_layer += attn_params(self.qkv_bias)
            per_layer += ffn_params(self.d_ff)
        total = emb + out + self.num_layers * per_layer + d
        if self.is_encoder_decoder:
            # num_layers counts the ENCODER stack above; decoder layers add
            # self-attn + cross-attn + ffn + 3 norms each.
            dec_layer = (2 * attn_params(False) + ffn_params(self.d_ff) + 3 * d)
            total += self.num_decoder_layers * dec_layer + d
        return int(total)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        if self.family != "moe":
            return self.param_count()
        assert self.moe is not None
        full = self.param_count()
        d = self.d_model
        gated = self.activation in ("swiglu", "geglu")
        per_expert = d * self.moe.d_ff_expert * (3 if gated else 2)
        inactive = self.num_layers * (self.moe.num_experts - self.moe.top_k) * per_expert
        return int(full - inactive)


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    mode: str          # train | prefill | decode
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def applicable_shapes(model: ModelConfig) -> list[ShapeConfig]:
    """The assigned shape cells that are well-defined for this arch:
    long_500k needs sub-quadratic attention, so ssm/hybrid only."""
    shapes = [TRAIN_4K, PREFILL_32K, DECODE_32K]
    if model.supports_long_context:
        shapes.append(LONG_500K)
    return shapes


# ---------------------------------------------------------------------------
# Mesh / distribution
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    data: int = 16
    model: int = 16
    pods: int = 2

    @property
    def shape(self) -> tuple[int, ...]:
        return (self.pods, self.data, self.model) if self.multi_pod else (self.data, self.model)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def num_devices(self) -> int:
        n = self.data * self.model
        return n * self.pods if self.multi_pod else n


@dataclass(frozen=True)
class ShardingConfig:
    """Per-job sharding policy knobs."""
    fsdp: bool = True                  # shard non-TP weight dim over 'data'
    fsdp_min_params: int = 3_000_000_000   # enable fsdp only for models above this
    expert_axis: str = "auto"          # auto | model | data | none
    decode_kv_seq_shard: bool = True   # flash-decoding style KV-seq sharding on 'model'
    seq_shard_hidden: bool = False     # Megatron-SP: shard hidden (B,S,d) seq over 'model'
    moe_megatron: bool = False         # experts: shard d_ff over (data x model) combined
                                       # instead of d over data
    gradient_accum: int = 1
    compress_cross_pod_grads: bool = False   # error-feedback int8 on 'pod' all-reduce


# ---------------------------------------------------------------------------
# Training / checkpoint / Khaos controller
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # adam m/v dtype (bf16 halves optimizer HBM)
    warmup_steps: int = 100
    schedule: str = "cosine"       # constant | cosine
    total_steps: int = 10_000


@dataclass(frozen=True)
class CheckpointPlan:
    """Complete description of the checkpoint *mechanism* + cadence.

    This is the unit the Khaos optimizer searches over: not just the
    interval (the paper's CI) but the whole plane configuration — full vs
    incremental encoding, sync vs async commit, and which storage levels
    participate.  ``checkpoint.manager.CheckpointManager`` executes a plan;
    ``sim.costmodel`` prices one; ``core.ci_optimizer.optimize_plan``
    searches the cross-product of CI grid x plan variants.
    """
    interval_s: float = 60.0          # CI — the Khaos-controlled cadence knob
    mode: str = "full"                # full | incremental
    full_every: int = 8               # full snapshot every N triggers (incremental)
    delta_codec: str = "lossless"     # lossless | int8 (ckpt_delta codec)
    encode_placement: str = "host"    # host | device: where the delta encode
                                      # runs.  "device" moves the ckpt_delta
                                      # kernels in front of D2H, so only the
                                      # encoded payload (delta+sparse residual,
                                      # or int8 q+scales — ~4x fewer bytes)
                                      # crosses the device->host link
    codec: str = "auto"               # auto | zstd | zlib (auto: zstd if installed)
    levels: Sequence[str] = ("local",)   # subset of {memory, local, remote}
    local_every: int = 1              # write local level every N triggers
    remote_every: int = 8             # write remote level every N triggers
    sync: bool = True                 # sync commit vs background-thread commit
    busy_policy: str = "skip"         # async: skip | block when a write is in flight
    num_shards: int = 4
    keep: int = 3
    replication_factor: int = 1       # k ring-neighbor peers each host pushes
                                      # its level-2 shard replicas to.  k>=1
                                      # makes node-local checkpoints survive a
                                      # single node loss (the level-2 survival
                                      # rule is DERIVED from this, not
                                      # assumed); k=0 opts out — a node
                                      # failure then degrades to remote
    chunk_bytes: int = 4 << 20        # D2H transfer granularity of the pipelined
                                      # snapshot (first chunk = the blocking sync)
    eager_snapshot: bool = False      # materialize EVERY device leaf before
                                      # save() returns: required when the train
                                      # step donates its input buffers
                                      # (donate_argnums) — deferred chunk
                                      # transfer relies on JAX immutability,
                                      # and a donated buffer is re-used the
                                      # moment the next step runs

    def __post_init__(self) -> None:
        assert self.mode in ("full", "incremental"), self.mode
        assert self.delta_codec in ("lossless", "int8"), self.delta_codec
        assert self.encode_placement in ("host", "device"), \
            self.encode_placement
        # device encode holds references to the live device buffers between
        # the trigger and the D2H of the encoded chunks — that relies on JAX
        # immutability, which donated buffers (the eager_snapshot case)
        # break by re-using device memory on the next step
        assert not (self.encode_placement == "device" and self.eager_snapshot), \
            "encode_placement='device' requires non-donated (immutable) " \
            "device buffers; eager_snapshot marks a donating step"
        assert self.busy_policy in ("skip", "block"), self.busy_policy
        unknown = set(self.levels) - {"memory", "local", "remote"}
        assert not unknown, f"unknown checkpoint levels {unknown}"
        assert self.levels, "a plan needs at least one level"
        assert min(self.full_every, self.local_every, self.remote_every) >= 1, \
            "cadences are every-Nth-trigger counts and must be >= 1"
        assert self.chunk_bytes >= 1, "chunk_bytes must be positive"
        assert self.replication_factor >= 0, \
            "replication_factor is a peer count and cannot be negative"

    def is_full_trigger(self, trigger_index: int) -> bool:
        return self.mode == "full" or trigger_index % self.full_every == 0

    def levels_due(self, trigger_index: int) -> list:
        """The (level, kind) writes trigger number ``trigger_index``
        performs: memory on every trigger, local at ``local_every`` (delta
        between fulls in incremental mode), remote at ``remote_every``
        (always a full).  The single source of routing truth — executed by
        ``checkpoint.manager.CheckpointManager`` and priced by
        ``sim.costmodel``."""
        full = self.is_full_trigger(trigger_index)
        out = []
        for level in self.levels:
            if level == "memory":
                out.append(("memory", "full"))
            elif level == "local" and trigger_index % self.local_every == 0:
                out.append(("local", "full" if full else "delta"))
            elif level == "remote" and trigger_index % self.remote_every == 0:
                out.append(("remote", "full"))
        return out

    @property
    def disk_levels(self) -> tuple[str, ...]:
        return tuple(l for l in self.levels if l in ("local", "remote"))

    @property
    def effective_replication(self) -> int:
        """Replicas each shard actually gets: a ring of H hosts has only
        H-1 distinct peers, so k is clamped to ``num_shards - 1`` (one
        shard per simulated host on this substrate)."""
        return max(0, min(self.replication_factor, self.num_shards - 1))

    @property
    def delta_encoding(self) -> str:
        """The older name of ``delta_codec`` (read-only)."""
        return self.delta_codec

    @property
    def name(self) -> str:
        """Short human tag, e.g. 'incr8-async-dev-int8-mlr' — used in
        Decisions, benchmark tables and event logs.  Codec/placement parts
        appear only when they differ from the host-lossless default, so
        pre-existing plan names are unchanged."""
        parts = ["full" if self.mode == "full" else f"incr{self.full_every}"]
        parts.append("sync" if self.sync else "async")
        if self.mode == "incremental":
            if self.encode_placement == "device":
                parts.append("dev")
            if self.delta_codec == "int8":
                parts.append("int8")
        if tuple(self.levels) != ("local",):
            parts.append("".join(l[0] for l in self.levels))
        if self.replication_factor != 1:
            parts.append(f"rep{self.replication_factor}")
        return "-".join(parts)


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "/tmp/repro_ckpt"
    interval_seconds: float = 60.0      # the Khaos-controlled knob
    mode: str = "sync"                  # sync | async
    levels: Sequence[str] = ("local",)  # subset of {memory, local, remote}
    incremental: bool = False           # delta+int8 encode vs last full ckpt
    full_every: int = 8                 # full checkpoint every N incrementals
    keep: int = 3

    def to_plan(self) -> CheckpointPlan:
        """Lower the legacy job-config block onto the unified plan."""
        return CheckpointPlan(
            interval_s=self.interval_seconds,
            mode="incremental" if self.incremental else "full",
            full_every=self.full_every,
            delta_codec="int8" if self.incremental else "lossless",
            levels=tuple(self.levels),
            sync=self.mode != "async",
            keep=self.keep)


@dataclass(frozen=True)
class KhaosConfig:
    """The paper's knobs (§III)."""
    # Phase 1
    record_seconds: float = 600.0
    smoothing_window: int = 30          # averaging window for W(t)
    num_failure_points: int = 5         # m
    failure_point_mode: str = "throughput"   # throughput (prose) | time (Eq.4 literal)
    # Phase 2
    ci_min: float = 10.0
    ci_max: float = 120.0
    num_configs: int = 6                # z = |C|
    profile_margin_seconds: float = 90.0  # replay window around each injection
    # Phase 3
    latency_constraint: float = 1.0     # l_const (seconds, end-to-end)
    recovery_constraint: float = 240.0  # r_const (seconds)
    optimization_period: float = 60.0   # seconds between optimization cycles
    forecast_horizon: int = 5           # multi-step-ahead TSF steps
    defer_drop_fraction: float = 0.10   # ">10% decrease -> defer"
    proactive: bool = False             # pre-act on forecasted violations:
                                        # when the TSF predicts the rate
                                        # rising enough to break a QoS
                                        # constraint within the horizon,
                                        # re-optimize at the PREDICTED peak
                                        # instead of waiting for the breach
    proactive_rise_fraction: float = 0.05   # minimum forecasted rise
                                        # (fraction of the current rate)
                                        # before pre-acting — symmetric
                                        # guard to defer_drop_fraction
    rescale_history: int = 5            # k pairwise fractional differences for p
    reconfig_cooldown: float = 120.0
    model_degree: int = 2               # polynomial degree for M_L / M_R
    ridge_lambda: float = 1e-3


@dataclass(frozen=True)
class JobConfig:
    model: ModelConfig
    shape: ShapeConfig
    mesh: MeshConfig = MeshConfig()
    sharding: ShardingConfig = ShardingConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    checkpoint: CheckpointConfig = CheckpointConfig()
    khaos: KhaosConfig = KhaosConfig()
    seed: int = 0

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), default=str, indent=2)


def replace(cfg, **kw):
    """dataclasses.replace that works through our frozen configs."""
    return dataclasses.replace(cfg, **kw)
