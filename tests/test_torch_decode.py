"""Decode of the port: the twin of the reference's decode-equals-prefill
test, the int8 KV-cache twins (``tests/test_int8_kv.py``) and the port's
int8 decode against the JAX package's in float32, and pins of four
behaviours of the reference that the port reproduces, not fixes (ROADMAP
section 3, Q1-Q4):

* Q1: hybrid ring decode attends to every one of the W slots, unwritten
  zero slots included;
* Q2: audio decode rotates the cross-attention query by RoPE at ``pos``,
  which prefill does not, so decode does not reproduce prefill;
* Q3: the audio ``cache_specs`` swaps the two caches' lengths against
  what prefill returns;
* Q4: prefill returns caches in the activation dtype under an int8
  ``kv_cache_dtype``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_models as tm
from repro.config import ShapeConfig as JaxShapeConfig
from repro.models import zoo as jzoo
from repro_torch.config import ShapeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import zoo

B, S = 2, 16
F32 = dict(dtype="float32")


def _decode_from_zeros(tcfg, tp, tokens: np.ndarray, seq: int):
    """Teacher-forced decode of ``tokens`` (B, T) from ``cache_specs``
    zeros at seq ``seq``: (tokens (B, T), logits (T, B, V))."""
    caches = zoo.zeros_like_specs(
        zoo.cache_specs(tcfg, ShapeConfig("d", "decode", seq, B)), "cpu")
    toks, logits = [], []
    for t in range(tokens.shape[1]):
        lg, caches = zoo.forward_decode(
            tp, tcfg, caches, torch.from_numpy(tokens[:, t:t + 1]),
            torch.full((B,), t, dtype=torch.int32))
        logits.append(lg.to(torch.float32).numpy())
        toks.append(lg.argmax(-1).numpy()[:, None])
    return np.concatenate(toks, axis=1), np.stack(logits)


def _jax_decode_from_zeros(jcfg, jp, tokens: np.ndarray, seq: int):
    caches = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype),
        jzoo.cache_specs(jcfg, JaxShapeConfig("d", "decode", seq, B)))
    step = jax.jit(lambda p, c, t, q: jzoo.forward_decode(p, jcfg, c, t, q))
    logits = []
    for t in range(tokens.shape[1]):
        lg, caches = step(jp, caches, jnp.asarray(tokens[:, t:t + 1]),
                          jnp.full((B,), t, jnp.int32))
        logits.append(np.asarray(lg, np.float32))
    return np.stack(logits), caches


def test_decode_matches_prefill_dense():
    """Twin of ``tests/test_arch_smoke.py::test_decode_matches_prefill_dense``
    (bf16): step-by-step decode from empty caches reproduces prefill's
    next-token prediction."""
    cfg = get_smoke_config("yi-6b")
    _, tp = tm.params("yi-6b", seed=3)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(3), (B, S), 0,
                                           cfg.vocab_size), np.int32)
    next_ref, _ = zoo.make_prefill_step(cfg)(
        tp, {"tokens": torch.from_numpy(tokens)})
    L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    caches = {"k": torch.zeros((L, B, S, K, hd), dtype=torch.bfloat16),
              "v": torch.zeros((L, B, S, K, hd), dtype=torch.bfloat16)}
    decode = zoo.make_decode_step(cfg)
    for t in range(S):
        tok, caches = decode(tp, caches,
                             {"tokens": torch.from_numpy(tokens[:, t:t + 1]),
                              "pos": torch.full((B,), t, dtype=torch.int32)})
    np.testing.assert_array_equal(tok[:, 0].numpy(), next_ref.numpy())


@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-2b"])
def test_int8_kv_decode_close_to_bf16(arch):
    """Twin of ``tests/test_int8_kv.py``: greedy tokens of int8-KV decode
    agree with bf16-KV decode on > 85 % of the steps."""
    cfg16 = get_smoke_config(arch)
    cfg8 = dataclasses.replace(cfg16, kv_cache_dtype="int8")
    _, tp = tm.params(arch)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (B, S), 0,
                                           cfg16.vocab_size), np.int32)
    t16, _ = _decode_from_zeros(cfg16, tp, tokens, S)
    t8, _ = _decode_from_zeros(cfg8, tp, tokens, S)
    assert np.mean(t16 == t8) > 0.85


def test_int8_cache_specs_dtype():
    cfg = dataclasses.replace(get_smoke_config("yi-6b"),
                              kv_cache_dtype="int8")
    specs = zoo.cache_specs(cfg, ShapeConfig("d", "decode", 32, 2))
    assert specs["k"].dtype == torch.int8
    assert specs["v"].dtype == torch.int8


@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-2b"])
def test_int8_decode_matches_jax(arch):
    """int8 KV decode (static scale 1/32) against the JAX package's, in
    float32: logits of every step within tolerance and the int8 caches
    equal level for level."""
    jcfg, tcfg = tm.cfgs(arch, dtype="float32", kv_cache_dtype="int8")
    jp, tp = tm.params(arch, **F32)
    tokens = tm.batch(tcfg, "prefill", B, S, seed=4)["tokens"]
    tcaches = zoo.zeros_like_specs(
        zoo.cache_specs(tcfg, ShapeConfig("d", "decode", S, B)), "cpu")
    tlogits = []
    for t in range(S):
        lg, tcaches = zoo.forward_decode(
            tp, tcfg, tcaches, torch.from_numpy(tokens[:, t:t + 1]),
            torch.full((B,), t, dtype=torch.int32))
        tlogits.append(lg.numpy())
    jlogits, jcaches = _jax_decode_from_zeros(jcfg, jp, tokens, S)
    np.testing.assert_allclose(np.stack(tlogits), jlogits, rtol=tm.RTOL,
                               atol=tm.ATOL)
    from repro_torch.utils.trees import tree_flatten_with_names
    want = dict(tree_flatten_with_names(tm.np_tree(jcaches)))
    for name, leaf in tree_flatten_with_names(tcaches):
        if leaf.dtype == torch.int8:
            assert want[name].dtype == np.int8
            np.testing.assert_array_equal(leaf.numpy(), want[name],
                                          err_msg=name)


def test_q1_hybrid_ring_decode_attends_unwritten_slots():
    """Q1: decode from zero caches (ring of W = 8 slots, 4 written) equals
    the JAX package's, and so differs from prefill of the same tokens:
    the zero K/V slots take softmax weight."""
    jcfg, tcfg = tm.cfgs("recurrentgemma-2b", **F32)
    jp, tp = tm.params("recurrentgemma-2b", **F32)
    T = 4
    assert T < tcfg.recurrent.window_size
    tokens = tm.batch(tcfg, "prefill", B, T, seed=5)["tokens"]
    _, tlogits = _decode_from_zeros(tcfg, tp, tokens, T)
    jlogits, _ = _jax_decode_from_zeros(jcfg, jp, tokens, T)
    np.testing.assert_allclose(tlogits, jlogits, rtol=tm.RTOL, atol=tm.ATOL)
    full, _, _ = zoo.forward_logits(tp, tcfg, {"tokens":
                                               torch.from_numpy(tokens)})
    gap = np.abs(tlogits[-1] - full[:, -1].numpy()).max()
    assert gap > 1e-3, gap


def test_q2_audio_decode_matches_jax_not_prefill():
    """Q2: whisper's decode step after prefill equals the JAX package's,
    and differs from the prefill forward over one more token (decode
    rotates the cross-attention query by RoPE, prefill does not)."""
    jcfg, tcfg = tm.cfgs("whisper-small", **F32)
    jp, tp = tm.params("whisper-small", **F32)
    Se = 32
    b = tm.batch(tcfg, "prefill", B, Se, seed=6)
    Sd = b["dec_tokens"].shape[1]
    jtok, jcaches = jax.jit(jzoo.make_prefill_step(jcfg))(jp, tm.to_jax(b))
    grown = tm.grow_caches_np(tm.np_tree(jcaches), "audio", 1)
    tok = np.asarray(jtok)[:, None]
    pos = np.full((B,), Sd, np.int32)
    jlog, _ = jzoo.forward_decode(
        jp, jcfg, jax.tree_util.tree_map(jnp.asarray, grown),
        jnp.asarray(tok), jnp.asarray(pos))
    tlog, _ = zoo.forward_decode(tp, tcfg, zoo.state_from_numpy(grown, "cpu"),
                                 torch.from_numpy(tok), torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=tm.RTOL,
                               atol=tm.ATOL)
    ext = dict(b, dec_tokens=np.concatenate([b["dec_tokens"], tok], axis=1))
    full, _, _ = zoo.forward_logits(tp, tcfg, tm.to_torch(ext))
    gap = np.abs(tlog.numpy() - full[:, -1].numpy()).max()
    assert gap > 1e-3, gap


def test_q3_audio_cache_specs_swap_the_lengths_prefill_returns():
    """Q3: at whisper-smoke, B 2, S 16, prefill returns k/v of the decoder
    length (4) and ck/cv of the encoder length (16); ``cache_specs`` gives
    k/v 16 and ck/cv 4, in both packages."""
    jcfg, tcfg = tm.cfgs("whisper-small", **F32)
    _, tp = tm.params("whisper-small", **F32)
    b = tm.batch(tcfg, "prefill", B, S, seed=7)
    _, caches = zoo.make_prefill_step(tcfg)(tp, tm.to_torch(b))
    assert tuple(caches["k"].shape) == (2, B, 4, 4, 16)
    assert tuple(caches["ck"].shape) == (2, B, 16, 4, 16)
    spec = zoo.cache_specs(tcfg, ShapeConfig("d", "decode", S, B))
    jspec = jzoo.cache_specs(jcfg, JaxShapeConfig("d", "decode", S, B))
    for name in ("k", "v", "ck", "cv"):
        assert tuple(spec[name].shape) == tuple(jspec[name].shape)
    assert tuple(spec["k"].shape) == (2, B, 16, 4, 16)
    assert tuple(spec["ck"].shape) == (2, B, 4, 4, 16)


@pytest.mark.parametrize("arch", ["yi-6b", "recurrentgemma-2b"])
def test_q4_prefill_caches_keep_the_activation_dtype_under_int8(arch):
    """Q4: ``kv_cache_dtype="int8"`` is not applied by prefill; its caches
    come in the activation dtype in both packages."""
    jcfg, tcfg = tm.cfgs(arch, kv_cache_dtype="int8")
    jp, tp = tm.params(arch)
    b = tm.batch(tcfg, "prefill", B, S, seed=8)
    _, caches = zoo.make_prefill_step(tcfg)(tp, tm.to_torch(b))
    _, jcaches = jax.jit(jzoo.make_prefill_step(jcfg))(jp, tm.to_jax(b))
    from repro_torch.utils.trees import tree_flatten_with_names
    from repro.utils.trees import tree_flatten_with_names as jax_names
    got = {n: str(a.dtype).replace("torch.", "")
           for n, a in tree_flatten_with_names(caches)}
    want = {n: str(a.dtype) for n, a in jax_names(jcaches)}
    assert got == want
    kv = [d for n, d in got.items() if n.split("/")[-1] in ("k", "v")]
    assert kv and set(kv) == {"bfloat16"}
