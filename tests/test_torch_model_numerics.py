"""Model-layer numerics of the port: twins of the reference's
``tests/test_model_numerics.py`` (chunked attention against full, the
RG-LRU and WKV-6 layers against the port's plain kernel versions
``kernels/{rglru,rwkv6}/ref.py``, MoE grouping and capacity drops, M-RoPE),
and each layer against the JAX package's on the same inputs in float32
(rtol 1e-5 / atol 2e-5, ``tests/torch_models.py``): ``apply_moe``,
``rglru_sequence``/``rglru_decode_step``, ``rwkv_time_mix``/
``rwkv_channel_mix``, ``decode_attention`` and ``attention_decode_step``
(full cache, ring, int8, cross-attention).

The port's RG-LRU scan is a log-step (Hillis-Steele) scan per chunk and
the reference's an ``associative_scan``: they group the products
differently, so they agree within float32 rounding, not bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_models as tm
from repro.config import ModelConfig as JaxModelConfig
from repro.config import MoEConfig as JaxMoEConfig
from repro.config import RecurrentConfig as JaxRecurrentConfig
from repro.config import RWKVConfig as JaxRWKVConfig
from repro.models import layers as JL
from repro_torch.config import ModelConfig, MoEConfig, RecurrentConfig, \
    RWKVConfig
from repro_torch.kernels.rglru.ref import rglru_ref
from repro_torch.kernels.rwkv6.ref import wkv6_ref
from repro_torch.models import layers as L


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np_params(p) -> dict:
    return {k: np.asarray(v) for k, v in p.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tm.RTOL, atol=tm.ATOL)


def _rng(seed):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# twins of tests/test_model_numerics.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 48])
def test_flash_xla_matches_full_attention(window):
    rng = _rng(0)
    B, S, H, hd = 2, 256, 4, 64
    q, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hd))
                                .astype(np.float32)) for _ in range(3))
    full = L.full_attention(q, k, v, causal=True, window=window)
    fl = L.flash_attention_xla(q, k, v, causal=True, window=window,
                               chunk_q=64, chunk_kv=64)
    np.testing.assert_allclose(fl.numpy(), full.numpy(), atol=2e-5,
                               rtol=2e-5)


def _hybrid_cfg(d=32, **kw):
    return ModelConfig(name="t", family="hybrid", num_layers=3, d_model=d,
                       num_heads=2, num_kv_heads=1, d_ff=2 * d,
                       vocab_size=128, recurrent=RecurrentConfig(lru_width=d),
                       dtype="float32", **kw)


def test_rglru_sequence_matches_kernel_ref():
    """The layer's recurrence equals the plain kernel version given the
    same gates."""
    cfg = _hybrid_cfg()
    p = L.init_rglru_block(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.from_numpy(0.5 * _rng(1).standard_normal((2, 64, 32))
                         .astype(np.float32))
    y, (h_last, conv) = L.rglru_sequence(p, x, cfg, chunk=16)
    u = x @ p["w_x"]
    cw = cfg.recurrent.conv1d_width
    u_pad = torch.cat([torch.zeros((2, cw - 1, 32)), u], dim=1)
    uc = sum(u_pad[:, i:i + 64] * p["conv_w"][i] for i in range(cw)) + \
        p["conv_b"]
    a, b = L._rglru_gates(p, uc)
    h_ref = rglru_ref(a, b, torch.zeros((2, 32)))
    gate = L._gelu(x @ p["w_gate"])
    y_ref = (h_ref * gate) @ p["w_out"]
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=1e-4)
    np.testing.assert_allclose(h_last.numpy(), h_ref[:, -1].numpy(),
                               atol=1e-4)


def test_rglru_decode_steps_match_sequence():
    cfg = _hybrid_cfg(d=16)
    p = L.init_rglru_block(torch.Generator().manual_seed(2), cfg, "cpu")
    x = torch.from_numpy(0.5 * _rng(3).standard_normal((1, 12, 16))
                         .astype(np.float32))
    y_seq, (h_seq, _) = L.rglru_sequence(p, x, cfg, chunk=4)
    h = torch.zeros((1, 16))
    conv = torch.zeros((1, cfg.recurrent.conv1d_width - 1, 16))
    ys = []
    for t in range(12):
        y_t, (h, conv) = L.rglru_decode_step(p, x[:, t:t + 1], cfg, h=h,
                                             conv_state=conv)
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_seq.numpy(),
                               atol=1e-4)
    np.testing.assert_allclose(h.numpy(), h_seq.numpy(), atol=1e-4)


def _ssm_cfg(cls_model=ModelConfig, cls_rwkv=RWKVConfig):
    return cls_model(name="t", family="ssm", num_layers=2, d_model=32,
                     num_heads=2, num_kv_heads=2, d_ff=64, vocab_size=128,
                     rwkv=cls_rwkv(head_size=16, decay_lora=8),
                     dtype="float32", norm_type="layernorm")


def test_rwkv_time_mix_matches_kernel_ref():
    """The time mix's output shape, finiteness and carried last x (the
    reference's test), and its WKV-6 recurrence equal to the plain kernel
    version on the same r, k, v, w, u and carried state."""
    cfg = _ssm_cfg()
    p = L.init_rwkv_block(torch.Generator().manual_seed(4), cfg, "cpu")
    x = torch.from_numpy(0.5 * _rng(5).standard_normal((1, 20, 32))
                         .astype(np.float32))
    y, (x_last, s_last) = L.rwkv_time_mix(p, x, cfg)
    assert y.shape == x.shape
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(x_last.numpy(), x[:, -1].numpy())
    rng = _rng(6)
    B, S, H, hs = 2, 20, 2, 16
    r, k, v = (torch.from_numpy(rng.standard_normal((B, S, H, hs))
                                .astype(np.float32)) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.5, 1.0, (B, S, H, hs))
                         .astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((H, hs)).astype(np.float32))
    s0 = torch.from_numpy(rng.standard_normal((B, H, hs, hs))
                          .astype(np.float32))
    y1, s1 = L._rwkv_wkv_scan(r, k, v, w, u, s0)
    y2, s2 = wkv6_ref(r, k, v, w, u, s0)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(s1.numpy(), s2.numpy(), atol=1e-5, rtol=1e-5)


def _moe_cfg(cls_model, cls_moe, d, E, f, cf, act="swiglu"):
    return cls_model(name="t", family="moe", num_layers=2, d_model=d,
                     num_heads=2, num_kv_heads=2, d_ff=2 * d,
                     vocab_size=128, activation=act,
                     moe=cls_moe(num_experts=E, top_k=2, d_ff_expert=f,
                                 capacity_factor=cf), dtype="float32")


def test_moe_group_count_changes_only_capacity_drops():
    """With ample capacity the grouped dispatch output does not depend on
    the number of groups."""
    cfg = _moe_cfg(ModelConfig, MoEConfig, 32, 4, 64, 8.0)
    p = L.init_moe(torch.Generator().manual_seed(6), cfg, "cpu")
    x = torch.from_numpy(0.5 * _rng(7).standard_normal((4, 8, 32))
                         .astype(np.float32))
    y1, _ = L.apply_moe(p, x, cfg, groups=1)
    y4, _ = L.apply_moe(p, x, cfg, groups=4)
    np.testing.assert_allclose(y1.numpy(), y4.numpy(), atol=1e-5)


def test_moe_capacity_drops_tokens():
    cfg = _moe_cfg(ModelConfig, MoEConfig, 16, 2, 32, 0.1)
    p = L.init_moe(torch.Generator().manual_seed(8), cfg, "cpu")
    x = torch.from_numpy(_rng(9).standard_normal((2, 64, 16))
                         .astype(np.float32))
    y, _ = L.apply_moe(p, x, cfg)
    zero_rows = np.mean(np.all(y.numpy() == 0, axis=-1))
    assert zero_rows > 0.3


def test_mrope_sections_positional_structure():
    pos = torch.stack([torch.arange(8)[None] * m for m in (1, 2, 3)])
    angles = L.rope_angles(pos, head_dim=16, theta=100.0,
                           mrope_sections=(3, 3, 2))
    assert angles.shape == (1, 8, 8)
    assert not np.allclose(angles[0, :, 0].numpy(), angles[0, :, 3].numpy())
    want = JL.rope_angles(jnp.asarray(pos.numpy()), head_dim=16, theta=100.0,
                          mrope_sections=(3, 3, 2))
    np.testing.assert_array_equal(angles.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# each layer against the JAX package's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups,cf,act", [(1, 1.25, "swiglu"),
                                           (4, 1.25, "gelu"),
                                           (2, 0.5, "relu_sq")])
def test_apply_moe_matches_jax(groups, cf, act):
    """Routing, capacity drops, the scatter and the gate-weighted gather,
    and the aux loss, grouped and not, gated and plain FFNs."""
    jcfg = _moe_cfg(JaxModelConfig, JaxMoEConfig, 32, 8, 48, cf, act)
    tcfg = _moe_cfg(ModelConfig, MoEConfig, 32, 8, 48, cf, act)
    jp = JL.init_moe(jax.random.PRNGKey(10), jcfg)
    x = 0.5 * _rng(11).standard_normal((4, 12, 32)).astype(np.float32)

    class Ann(JL.NullAnnotator):
        moe_groups = groups

    jy, jaux = JL.apply_moe(jp, jnp.asarray(x), jcfg, ann=Ann())
    ty, taux = L.apply_moe({k: _t(v) for k, v in _np_params(jp).items()},
                           _t(x), tcfg, groups=groups)
    _close(ty.numpy(), jy)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=tm.RTOL)
    if cf < 1:
        assert np.mean(np.all(ty.numpy() == 0, axis=-1)) > 0


def test_rglru_layers_match_jax():
    """``rglru_sequence`` from a carried state (h0, conv) over two chunks
    of the reference's 256, then ``rglru_decode_step``."""
    jcfg = JaxModelConfig(name="t", family="hybrid", num_layers=3,
                          d_model=32, num_heads=2, num_kv_heads=1, d_ff=64,
                          vocab_size=128,
                          recurrent=JaxRecurrentConfig(lru_width=32),
                          dtype="float32")
    tcfg = _hybrid_cfg()
    jp = JL.init_rglru_block(jax.random.PRNGKey(12), jcfg)
    tp = {k: _t(v) for k, v in _np_params(jp).items()}
    rng = _rng(13)
    x = (0.5 * rng.standard_normal((2, 512, 32))).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((2, 32))).astype(np.float32)
    conv = (0.5 * rng.standard_normal((2, 3, 32))).astype(np.float32)
    jy, (jh, jconv) = JL.rglru_sequence(jp, jnp.asarray(x), jcfg,
                                        h0=jnp.asarray(h0),
                                        conv_state=jnp.asarray(conv))
    ty, (th, tconv) = L.rglru_sequence(tp, _t(x), tcfg, h0=_t(h0),
                                       conv_state=_t(conv))
    _close(ty.numpy(), jy)
    _close(th.numpy(), jh)
    _close(tconv.numpy(), jconv)
    x1 = x[:, :1]
    jy1, (jh1, jc1) = JL.rglru_decode_step(jp, jnp.asarray(x1), jcfg, h=jh,
                                           conv_state=jconv)
    ty1, (th1, tc1) = L.rglru_decode_step(tp, _t(x1), tcfg, h=th,
                                          conv_state=tconv)
    _close(ty1.numpy(), jy1)
    _close(th1.numpy(), jh1)
    _close(tc1.numpy(), jc1)


def test_rwkv_layers_match_jax():
    """``rwkv_time_mix`` and ``rwkv_channel_mix`` from fresh and carried
    states (x_prev, the WKV state), over a sequence and one token."""
    jcfg = _ssm_cfg(JaxModelConfig, JaxRWKVConfig)
    tcfg = _ssm_cfg()
    jp = JL.init_rwkv_block(jax.random.PRNGKey(14), jcfg)
    tp = {k: _t(v) for k, v in _np_params(jp).items()}
    x = (0.5 * _rng(15).standard_normal((2, 20, 32))).astype(np.float32)
    jy, (jx, js) = JL.rwkv_time_mix(jp, jnp.asarray(x), jcfg)
    ty, (tx, ts) = L.rwkv_time_mix(tp, _t(x), tcfg)
    _close(ty.numpy(), jy)
    _close(ts.numpy(), js)
    x1 = x[:, :1]
    jy, (_, js1) = JL.rwkv_time_mix(jp, jnp.asarray(x1), jcfg, x_prev=jx,
                                    state=js)
    ty, (_, ts1) = L.rwkv_time_mix(tp, _t(x1), tcfg, x_prev=tx, state=ts)
    _close(ty.numpy(), jy)
    _close(ts1.numpy(), js1)
    for x_prev in (None, x[:, 0]):
        jy, jxl = JL.rwkv_channel_mix(
            jp, jnp.asarray(x), jcfg,
            x_prev=None if x_prev is None else jnp.asarray(x_prev))
        ty, txl = L.rwkv_channel_mix(
            tp, _t(x), tcfg, x_prev=None if x_prev is None else _t(x_prev))
        _close(ty.numpy(), jy)
        _close(txl.numpy(), jxl)


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 30.0)])
def test_decode_attention_matches_jax(window, softcap):
    rng = _rng(16)
    B, Smax, H, K, hd = 2, 12, 4, 2, 16
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.array([3, 9], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(pos),
                               window=window, softcap=softcap)
    got = L.decode_attention(_t(q), _t(kc), _t(vc), _t(pos), window=window,
                             softcap=softcap)
    _close(got.numpy(), want)


def _attn_cfgs(**kw):
    args = dict(name="t", family="dense", num_layers=2, d_model=32,
                num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                dtype="float32", **kw)
    return JaxModelConfig(**args), ModelConfig(**args)


@pytest.mark.parametrize("case", ["full", "ring", "int8", "cross", "mrope"])
def test_attention_decode_step_matches_jax(case):
    """One decode step over a full cache, a ring (window 6 over a cache of
    6, positions past it wrap), an int8 cache, cross-attention over a
    fixed encoder cache, and M-RoPE with QKV bias."""
    kw = {"mrope": dict(mrope_sections=(1, 2, 1), qkv_bias=True),
          "int8": dict(kv_cache_dtype="int8")}.get(case, {})
    jcfg, tcfg = _attn_cfgs(**kw)
    jp = JL.init_attention(jax.random.PRNGKey(17), jcfg)
    npp = _np_params(jp)
    rng = _rng(18)
    if "bq" in npp:       # nonzero biases, so the test sees them
        for k in ("bq", "bk", "bv"):
            npp[k] = (0.1 * rng.standard_normal(npp[k].shape)).astype(
                np.float32)
        jp = {k: jnp.asarray(v) for k, v in npp.items()}
    tp = {k: _t(v) for k, v in npp.items()}
    B, Smax, K, hd = 2, 6, 2, 8
    x = rng.standard_normal((B, 1, 32)).astype(np.float32)
    window = 6 if case == "ring" else 0
    pos = np.array([4, 13], np.int32) if case == "ring" else \
        np.array([2, 5], np.int32)
    if case == "int8":
        kc, vc = (rng.integers(-127, 128, (B, Smax, K, hd)).astype(np.int8)
                  for _ in range(2))
    else:
        kc, vc = (rng.standard_normal((B, Smax, K, hd)).astype(np.float32)
                  for _ in range(2))
    if case == "cross":
        jo, jnew = JL.attention_decode_step(
            jp, jnp.asarray(x), jcfg, pos=jnp.asarray(pos), k_cache=None,
            v_cache=None, cross_kv=(jnp.asarray(kc), jnp.asarray(vc)))
        to, tnew = L.attention_decode_step(
            tp, _t(x), tcfg, pos=_t(pos), k_cache=None, v_cache=None,
            cross_kv=(_t(kc), _t(vc)))
        assert jnew is None and tnew is None
        _close(to.numpy(), jo)
        return
    jo, (jk, jv) = JL.attention_decode_step(
        jp, jnp.asarray(x), jcfg, pos=jnp.asarray(pos),
        k_cache=jnp.asarray(kc), v_cache=jnp.asarray(vc), window=window)
    tk, tv = _t(kc), _t(vc)
    to, (tk2, tv2) = L.attention_decode_step(
        tp, _t(x), tcfg, pos=_t(pos), k_cache=tk, v_cache=tv, window=window)
    _close(to.numpy(), jo)
    assert tk2 is tk and tv2 is tv          # written in place
    if case == "int8":
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        _close(tk.numpy(), jk)
        _close(tv.numpy(), jv)
    if case == "full":
        with pytest.raises(IndexError):      # JAX drops such a write
            L.attention_decode_step(tp, _t(x), tcfg,
                                    pos=torch.tensor([2, Smax]), k_cache=tk,
                                    v_cache=tv)
