"""Sharding rules: the logical parameter/activation layout of one job ->
partition specs -> ``torch.distributed.tensor`` placements on a
``DeviceMesh``.

Policy (the JAX package's ``repro.sharding``, rule for rule):
  * batch dims shard over the data-parallel axes — ('pod', 'data') on the
    multi-pod mesh, ('data',) on a single pod;
  * the tensor-parallel 'model' axis shards attention heads, ffn hidden,
    vocab;
  * FSDP (ZeRO-3 style) shards the non-TP weight dim over 'data' for
    models above ``fsdp_min_params``;
  * MoE experts shard over 'model' when divisible (olmoe 64e), otherwise
    experts keep TP-sharded ffn dims (grok 8e);
  * KV caches: batch -> data axes, kv-heads -> 'model' when divisible,
    otherwise the cache *sequence* dim shards over 'model'.

Every rule degrades to replication when a dim is not divisible by the
axis size.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim
(None, an axis name, or a tuple of axis names), compared entry for entry
with the reference's.  ``placements(spec, mesh)`` turns it into one
``Shard``/``Replicate`` per mesh dimension, in mesh-dimension order; a
tensor dim sharded over a tuple of axes becomes ``Shard(d)`` on each of
those mesh dims (the tuples the rules build list their axes in mesh
order, so the layout is the reference's major-to-minor one).  The rules
take a ``DeviceMesh`` or the abstract stand-in of
``repro_torch.launch.mesh.make_abstract_mesh``.  ``*_shardings`` return
trees of ``NamedPlacements`` leaves (the spec and its placements; the
role of the reference's ``NamedSharding``), which need only the mesh's
axis names.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.config import ModelConfig, ShardingConfig
from repro_torch.utils.trees import tree_map_with_names

Axis = Optional[Any]   # None | str | tuple[str, ...]


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of axis
    names (``P()`` replicates a tensor of any rank)."""

    def __new__(cls, *entries: Axis):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` or an abstract mesh."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(_axis_names(mesh), mesh.shape))


def _axis_size(mesh, axis: Axis) -> int:
    if axis is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axis, tuple):
        return int(np.prod([sizes[a] for a in axis]))
    return int(sizes[axis])


def _place(shape: Sequence[int], prefs: Sequence[tuple[int, Axis]],
           mesh) -> P:
    """Assign axes to dims in priority order, skipping non-divisible dims."""
    spec: list = [None] * len(shape)
    used: set = set()
    for dim, axis in prefs:
        if axis is None or dim >= len(shape):
            continue
        names = axis if isinstance(axis, tuple) else (axis,)
        if any(n in used for n in names):
            continue
        if spec[dim] is not None:
            continue
        if shape[dim] % _axis_size(mesh, axis) != 0:
            continue
        spec[dim] = axis
        used.update(names)
    return P(*spec)


def placements(spec: Sequence[Axis], mesh) -> tuple:
    """``Shard``/``Replicate`` for each mesh dimension, in mesh order."""
    on: dict = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            on[name] = d
    return tuple(Shard(on[n]) if n in on else Replicate()
                 for n in _axis_names(mesh))


@dataclass(frozen=True)
class NamedPlacements:
    """A leaf of the ``*_shardings`` trees: its spec and the placements
    ``distribute_tensor(t, mesh, leaf.placements)`` takes."""
    spec: PartitionSpec
    placements: tuple


class ShardingRules:
    """Resolves partition specs for params, inputs and caches of one job,
    and their placements on the mesh."""

    def __init__(self, cfg: ModelConfig, mesh, scfg: ShardingConfig):
        self.cfg = cfg
        self.mesh = mesh
        self.scfg = scfg
        axes = _axis_names(mesh)
        self.dp: Axis = tuple(a for a in ("pod", "data") if a in axes) or None
        if isinstance(self.dp, tuple) and len(self.dp) == 1:
            self.dp = self.dp[0]
        self.tp: Axis = "model" if "model" in axes else None
        use_fsdp = scfg.fsdp and cfg.param_count() >= scfg.fsdp_min_params
        if use_fsdp and "data" in axes:
            # ZeRO-3 over every data-parallel axis
            self.fsdp = ("pod", "data") if "pod" in axes else "data"
        else:
            self.fsdp = None

    # -- parameters ----------------------------------------------------------
    def param_spec(self, name: str, shape: Sequence[int]) -> P:
        leaf = name.split("/")[-1]
        in_moe = "/moe/" in f"/{name}/"
        mesh, fsdp, tp = self.mesh, self.fsdp, self.tp

        def tail(base_rank: int, prefs):
            """Rules are defined on the trailing base_rank dims; leading
            (layer-stacked) dims stay unsharded."""
            off = len(shape) - base_rank
            if off < 0:
                raise ValueError(f"{name}: rank {len(shape)} < {base_rank}")
            return _place(shape, [(d + off, a) for d, a in prefs], mesh)

        if leaf in ("embed",):              # (V, d)
            return tail(2, [(0, tp), (1, fsdp)])
        if leaf in ("unembed",):            # (d, V)
            return tail(2, [(1, tp), (0, fsdp)])
        if leaf in ("wq", "wk", "wv"):      # (d, N, h)
            # heads shard over TP when divisible; otherwise attention
            # weights replicate (no head-dim sharding)
            return tail(3, [(1, tp), (0, fsdp)])
        if leaf in ("bq", "bk", "bv"):      # (N, h)
            return tail(2, [(0, tp)])
        if leaf == "wo":                    # (N, h, d)
            return tail(3, [(0, tp), (1, tp), (2, fsdp)])
        if leaf == "router":                # (d, E)
            return tail(2, [(0, fsdp)])
        if leaf in ("w_up", "w_gate") and in_moe:      # (E, d, f)
            ea = self._expert_axis(shape[-3])
            if self.scfg.moe_megatron and ea is None:
                # Megatron MLP inside each expert: f column-parallel over
                # the combined (fsdp x tp) axis, d unsharded
                return tail(3, [(2, self._ftp())])
            return tail(3, [(0, ea), (2, tp), (1, fsdp)])
        if leaf == "w_down" and in_moe:                # (E, f, d)
            ea = self._expert_axis(shape[-3])
            if self.scfg.moe_megatron and ea is None:
                return tail(3, [(1, self._ftp())])     # row-parallel
            return tail(3, [(0, ea), (1, tp), (2, fsdp)])
        if leaf in ("w_up", "w_gate", "w_x", "cm_wk", "cm_wr",
                    "w_r", "w_k", "w_v", "w_g", "wA"):  # (d, f)
            return tail(2, [(1, tp), (0, fsdp)])
        if leaf in ("w_down", "w_out", "cm_wv", "w_o", "wB"):   # (f, d)
            return tail(2, [(0, tp), (1, fsdp)])
        # everything else (norms, biases, conv, gates, mu, LoRA vectors)
        # is small: replicate
        return P()

    def _ftp(self) -> Axis:
        """Combined (fsdp..., tp) axis tuple for maximal weight sharding."""
        parts: list = []
        if self.fsdp is not None:
            parts.extend(self.fsdp if isinstance(self.fsdp, tuple)
                         else (self.fsdp,))
        if self.tp is not None:
            parts.append(self.tp)
        if not parts:
            return None
        return tuple(parts) if len(parts) > 1 else parts[0]

    def _expert_axis(self, n_experts: int) -> Axis:
        mode = self.scfg.expert_axis
        if mode == "none":
            return None
        if mode == "auto":
            mode = "model"
        axis = {"model": self.tp,
                "data": "data" if "data" in _axis_names(self.mesh)
                else None}[mode]
        if axis is not None and n_experts % _axis_size(self.mesh, axis) == 0:
            return axis
        return None

    # -- inputs / activations -------------------------------------------------
    def input_spec(self, name: str, shape: Sequence[int]) -> P:
        leaf = name.split("/")[-1]
        mesh, dp = self.mesh, self.dp
        if leaf in ("tokens", "labels", "dec_tokens"):      # (B, S)
            return _place(shape, [(0, dp)], mesh)
        if leaf == "positions":                             # (3, B, S)
            return _place(shape, [(1, dp)], mesh)
        if leaf in ("frames", "vision_embeds"):             # (B, S, d)
            return _place(shape, [(0, dp)], mesh)
        if leaf == "pos":                                   # (B,)
            return _place(shape, [(0, dp)], mesh)
        return P()

    # -- caches ---------------------------------------------------------------
    def cache_spec(self, name: str, shape: Sequence[int]) -> P:
        leaf = name.split("/")[-1]
        mesh, dp, tp = self.mesh, self.dp, self.tp
        seq = tp if self.scfg.decode_kv_seq_shard else None

        def tail(base_rank: int, prefs):
            off = len(shape) - base_rank
            return _place(shape, [(d + off, a) for d, a in prefs], mesh)

        if leaf in ("k", "v", "ck", "cv"):       # (B, S, K, h)
            return tail(4, [(0, dp), (2, tp), (1, seq)])
        if leaf == "tm_s":                       # (B, H, hs, hs)
            return tail(4, [(0, dp), (1, tp), (2, tp)])
        if leaf in ("tm_x", "cm_x"):             # (B, d)
            return tail(2, [(0, dp), (1, tp)])
        if leaf == "h":                          # (B, lru)
            return tail(2, [(0, dp), (1, tp)])
        if leaf == "conv":                       # (B, cw-1, lru)
            return tail(3, [(0, dp), (2, tp)])
        return P()

    # -- tree-level helpers ----------------------------------------------------
    def _named(self, spec: P) -> NamedPlacements:
        return NamedPlacements(spec, placements(spec, self.mesh))

    def params_shardings(self, params_tree):
        return tree_map_with_names(
            lambda n, l: self._named(self.param_spec(n, l.shape)),
            params_tree)

    def state_spec(self, name: str, shape: Sequence[int]) -> P:
        """A train-state leaf's spec: ``step`` replicates; the optimizer's
        moments (``opt/<m|v|mom>/...``) mirror the param layout."""
        if name == "step":
            return P()
        parts = name.split("/")
        if parts[0] == "params":
            core = "/".join(parts[1:])
        elif parts[0] == "opt":
            core = "/".join(parts[2:])
        else:
            core = name
        return self.param_spec(core, shape)

    def state_shardings(self, state_tree):
        """TrainState {params, opt, step}: opt m/v mirror the param layout."""
        return tree_map_with_names(
            lambda n, l: self._named(self.state_spec(n, l.shape)),
            state_tree)

    def batch_shardings(self, batch_tree):
        return tree_map_with_names(
            lambda n, l: self._named(self.input_spec(n, l.shape)),
            batch_tree)

    def cache_shardings(self, cache_tree):
        return tree_map_with_names(
            lambda n, l: self._named(self.cache_spec(n, l.shape)),
            cache_tree)

    def replicated(self) -> NamedPlacements:
        return self._named(P())

    def dp_vector(self, shape: Sequence[int]) -> NamedPlacements:
        return self._named(_place(shape, [(0, self.dp)], self.mesh))

    # -- activation annotations ------------------------------------------------
    def act_spec(self, kind: str, shape: Sequence[int]) -> P:
        mesh, dp, tp = self.mesh, self.dp, self.tp
        if kind == "hidden":       # (B, S, d)
            if self.scfg.seq_shard_hidden:
                # Megatron sequence parallelism: residual-stream
                # activations shard their SEQ dim over 'model'
                return _place(shape, [(0, dp), (1, tp)], mesh)
            return _place(shape, [(0, dp)], mesh)
        if kind in ("heads",):     # (B, S, N, hd)
            return _place(shape, [(0, dp), (2, tp)], mesh)
        if kind in ("wide",):      # (B, S, f) — ffn/lru hidden
            return _place(shape, [(0, dp), (2, tp)], mesh)
        if kind == "logits":       # (B, S, V)
            return _place(shape, [(0, dp), (2, tp)], mesh)
        if kind == "moe_buf":      # (G, E, C, d)
            return _place(shape, [(0, dp),
                                  (1, self._expert_axis(shape[1]))], mesh)
        if kind == "moe_hidden":   # (G, E, C, f)
            return _place(shape, [(0, dp), (1, self._expert_axis(shape[1])),
                                  (3, tp)], mesh)
        return P()

    @property
    def dp_size(self) -> int:
        return _axis_size(self.mesh, self.dp)

    def annotator(self) -> "ActivationAnnotator":
        return ActivationAnnotator(self)


class ActivationAnnotator:
    """Threaded through the model code as ``ann``: sets the MoE group
    count to the data-parallel degree and pins activation layouts.  A
    ``DTensor`` is redistributed to ``act_spec``'s placements; a plain
    tensor (the port's model runs on plain tensors) is returned as it
    is."""

    def __init__(self, rules: ShardingRules):
        self.rules = rules
        self.dp_size = rules.dp_size
        self.moe_groups = rules.dp_size

    def constrain(self, x, kind: str):
        if not isinstance(x, DTensor):
            return x
        spec = self.rules.act_spec(kind, tuple(x.shape))
        return x.redistribute(x.device_mesh,
                              placements(spec, x.device_mesh))
