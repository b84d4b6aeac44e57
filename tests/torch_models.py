"""Shared by ``tests/test_torch_{zoo,decode,model_numerics,server}.py``:
the JAX package's model zoo and the port's, side by side on the SMOKE
configs.

Weights come from the JAX package's ``init_params`` (jitted, once per
arch, seed and dtype in a process) and are carried over leaf for leaf
with ``zoo.state_from_numpy``; inputs are made from a seed with numpy and
handed to both frameworks.  ``RTOL``/``ATOL`` are the tolerances of
``tests/test_torch_model.py``: float32 in both frameworks, with different
summation orders (XLA:CPU against PyTorch's CPU kernels), on values of
order 1.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jax_smoke
from repro.models import zoo as jzoo
from repro_torch.config import replace
from repro_torch.configs import get_smoke_config
from repro_torch.models import zoo

jax.config.update("jax_platform_name", "cpu")

RTOL, ATOL = 1e-5, 2e-5


def cfgs(arch: str, **kw):
    """(the JAX package's SMOKE config, the port's), both with ``kw``."""
    return (jreplace(jax_smoke(arch), **kw),
            replace(get_smoke_config(arch), **kw))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@lru_cache(maxsize=None)
def _jax_params_np(arch: str, seed: int, kw: tuple):
    jcfg, _ = cfgs(arch, **dict(kw))
    init = jax.jit(lambda key: jzoo.init_params(jcfg, key))
    return np_tree(init(jax.random.PRNGKey(seed)))


def params(arch: str, seed: int = 0, **kw):
    """(JAX params, the port's copy on the CPU) of ``arch``'s SMOKE config
    with ``kw`` (e.g. dtype="float32")."""
    tree = _jax_params_np(arch, seed, tuple(sorted(kw.items())))
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            zoo.state_from_numpy(tree, "cpu"))


def batch(cfg, mode: str, B: int, S: int, seed: int = 0) -> dict:
    """Numpy inputs of ``zoo.input_specs`` for (mode, B, S): token ids in
    [0, vocab_size), frames and vision embeddings 0.02 * N(0, 1), M-RoPE
    positions arange(S) on all three planes, vision embeddings over the
    first S // 2 positions (as ``tests/test_arch_smoke.py`` makes them)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "audio":
        Sd = S // cfg.dec_ratio
        out["frames"] = (0.02 * rng.standard_normal(
            (B, S, cfg.d_model))).astype(np.float32)
        out["dec_tokens"] = rng.integers(0, cfg.vocab_size, (B, Sd),
                                         dtype=np.int32)
        if mode == "train":
            out["labels"] = rng.integers(0, cfg.vocab_size, (B, Sd),
                                         dtype=np.int32)
        return out
    out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    if mode == "train":
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S),
                                     dtype=np.int32)
    if cfg.family == "vlm":
        out["vision_embeds"] = (0.02 * rng.standard_normal(
            (B, S // 2, cfg.d_model))).astype(np.float32)
        out["positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    return out


def to_jax(b: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in b.items()}


def to_torch(b: dict, device="cpu") -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in b.items()}


def t2np(tree):
    """A tree of tensors -> numpy (float32 for bf16 leaves)."""
    from repro_torch.utils.trees import tree_map

    def one(t):
        if t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.detach().cpu().numpy()
    return tree_map(one, tree)


def names_of(tree) -> list:
    """Sorted slash-joined leaf names, in both frameworks' order."""
    from repro_torch.utils.trees import tree_flatten_with_names
    return [n for n, _ in tree_flatten_with_names(tree)]


def assert_trees_close(got, want, rtol=RTOL, atol=ATOL, what=""):
    """Two trees (port tensors or numpy / JAX arrays) with the same leaf
    names, equal in shape and within tolerance."""
    from repro_torch.utils.trees import tree_flatten_with_names
    g = dict(tree_flatten_with_names(t2np(got) if _is_torch(got) else got))
    w = {n: np.asarray(a) for n, a in
         tree_flatten_with_names(np_tree(want))}
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for n in w:
        assert g[n].shape == w[n].shape, (what, n, g[n].shape, w[n].shape)
        np.testing.assert_allclose(np.asarray(g[n], np.float64),
                                   np.asarray(w[n], np.float64), rtol=rtol,
                                   atol=atol, err_msg=f"{what} {n}")


def _is_torch(tree) -> bool:
    from repro_torch.utils.trees import tree_leaves
    leaves = tree_leaves(tree)
    return bool(leaves) and isinstance(leaves[0], torch.Tensor)


def grow_caches_np(caches: dict, family: str, extra: int) -> dict:
    """Numpy prefill caches with ``extra`` zero slots appended to the
    self-attention K/V (dense, moe, vlm, audio: seq axis 2); the hybrid
    ring and the ssm states are fixed-size and pass through."""
    if family in ("hybrid", "ssm"):
        return caches
    out = dict(caches)
    for k in ("k", "v"):
        a = caches[k]
        pad = [(0, 0)] * a.ndim
        pad[2] = (0, extra)
        out[k] = np.pad(a, pad)
    return out
