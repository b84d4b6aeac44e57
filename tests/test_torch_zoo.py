"""The port's model zoo against the JAX package's, on all ten archs' SMOKE
configs (six families): parameter names, shapes and dtypes, the training
forward (logits and the MoE aux loss), input and cache specs, prefill and
one decode step, in float32 (``tests/torch_models.py``: weights carried
over, rtol 1e-5 / atol 2e-5, tokens equal); the bf16 twin of the
reference's ``test_smoke_train_prefill_decode``; and the train step of
the moe and hybrid families against the JAX one in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_models as tm
from repro.config import OptimizerConfig as JaxOptimizerConfig
from repro.config import ShapeConfig as JaxShapeConfig
from repro.configs import ARCH_IDS as JAX_ARCH_IDS
from repro.models import zoo as jzoo
from repro.optim import make_optimizer as jax_make_optimizer
from repro.utils.trees import tree_flatten_with_names as jax_names
from repro_torch.config import OptimizerConfig, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_smoke_config, list_archs
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.utils.trees import tree_flatten_with_names, tree_leaves

B, S = 2, 16
F32 = dict(dtype="float32")


def test_registry_is_the_references():
    assert ARCH_IDS == JAX_ARCH_IDS == list_archs()
    families = {get_smoke_config(a).family for a in ARCH_IDS}
    assert families == {"dense", "moe", "hybrid", "ssm", "vlm", "audio"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_params_names_shapes_dtypes_match_jax(arch):
    jcfg, tcfg = tm.cfgs(arch)
    want = jax.eval_shape(lambda k: jzoo.init_params(jcfg, k),
                          jax.random.PRNGKey(0))
    got = zoo.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jn = [(n, tuple(a.shape), str(a.dtype)) for n, a in jax_names(want)]
    tn = [(n, tuple(a.shape), str(a.dtype).replace("torch.", ""))
          for n, a in tree_flatten_with_names(got)]
    assert tn == jn


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_logits_and_aux_match_jax(arch):
    jcfg, tcfg = tm.cfgs(arch, **F32)
    jp, tp = tm.params(arch, **F32)
    b = tm.batch(tcfg, "train", B, S, seed=1)
    jl, jaux, _ = jax.jit(lambda p, x: jzoo.forward_logits(p, jcfg, x))(
        jp, tm.to_jax(b))
    tl, taux, caches = zoo.forward_logits(tp, tcfg, tm.to_torch(b))
    assert caches is None
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=tm.RTOL, atol=tm.ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=tm.RTOL,
                               atol=1e-9)
    if tcfg.family == "moe":
        assert float(taux) > 0


def _spec_list(tree, framework: str) -> list:
    flat = jax_names(tree) if framework == "jax" else \
        tree_flatten_with_names(tree)
    return [(n, tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for n, a in flat]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_and_cache_specs_match_jax(arch):
    jcfg, tcfg = tm.cfgs(arch, kv_cache_dtype="int8")
    for mode, seq in (("train", 64), ("prefill", 64), ("decode", 48)):
        jshape = JaxShapeConfig("s", mode, seq, 4)
        tshape = ShapeConfig("s", mode, seq, 4)
        tspec = zoo.input_specs(tcfg, tshape)
        assert all(t.device.type == "meta" for t in tree_leaves(tspec))
        assert _spec_list(tspec, "torch") == \
            _spec_list(jzoo.input_specs(jcfg, jshape), "jax")
        if mode == "decode":
            cspec = zoo.cache_specs(tcfg, tshape)
            assert all(t.device.type == "meta" for t in tree_leaves(cspec))
            assert _spec_list(cspec, "torch") == \
                _spec_list(jzoo.cache_specs(jcfg, jshape), "jax")
        else:
            with pytest.raises(ValueError, match="decode"):
                zoo.cache_specs(tcfg, tshape)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_then_decode_match_jax(arch):
    """Prefill's token and caches, then one decode step through the grown
    caches (logits, token, every cache leaf), against the JAX package."""
    jcfg, tcfg = tm.cfgs(arch, **F32)
    jp, tp = tm.params(arch, **F32)
    b = tm.batch(tcfg, "prefill", B, S, seed=2)
    jtok, jcaches = jax.jit(jzoo.make_prefill_step(jcfg))(jp, tm.to_jax(b))
    ttok, tcaches = zoo.make_prefill_step(tcfg)(tp, tm.to_torch(b))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    assert ttok.dtype == torch.int32 and ttok.shape == (B,)
    tm.assert_trees_close(tcaches, jcaches, what="prefill caches")

    seq = S // tcfg.dec_ratio if tcfg.family == "audio" else S
    grown = tm.grow_caches_np(tm.np_tree(jcaches), tcfg.family, 1)
    tok = np.asarray(jtok)[:, None]
    pos = np.full((B,), seq, np.int32)
    jlog, jnew = jax.jit(lambda p, c, t, q: jzoo.forward_decode(
        p, jcfg, c, t, q))(jp, jax.tree_util.tree_map(jnp.asarray, grown),
                           jnp.asarray(tok), jnp.asarray(pos))
    tcache_in = zoo.state_from_numpy(grown, "cpu")
    tlog, tnew = zoo.forward_decode(tp, tcfg, tcache_in,
                                    torch.from_numpy(tok),
                                    torch.from_numpy(pos))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               rtol=tm.RTOL, atol=tm.ATOL)
    np.testing.assert_array_equal(tlog.argmax(-1).numpy(),
                                  np.asarray(jlog).argmax(-1))
    tm.assert_trees_close(tnew, jnew, what="decoded caches")
    # the step consumed its caches: it wrote into the tensors it was given
    for a, c in zip(tree_leaves(tnew), tree_leaves(tcache_in)):
        assert a.data_ptr() == c.data_ptr()


def _finite(tree) -> bool:
    return all(bool(torch.isfinite(t.to(torch.float32)).all())
               for t in tree_leaves(tree))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_train_prefill_decode_bf16(arch):
    """The port's twin of ``test_smoke_train_prefill_decode``: a bf16
    train step, prefill and one decode step, shapes and finiteness."""
    cfg = get_smoke_config(arch)
    opt_cfg = OptimizerConfig(total_steps=10)
    opt = make_optimizer(opt_cfg)
    state = zoo.init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    b = tm.to_torch(tm.batch(cfg, "train", B, S))
    state2, metrics = zoo.make_train_step(cfg, opt, opt_cfg)(state, b)
    assert np.isfinite(float(metrics["loss"]))
    assert int(state2["step"]) == 1
    assert _finite(state2["params"])

    pre = {k: v for k, v in b.items() if k != "labels"}
    next_tok, caches = zoo.make_prefill_step(cfg)(state["params"], pre)
    assert next_tok.shape == (B,)
    assert int(next_tok.max()) < cfg.padded_vocab
    last = (S // cfg.dec_ratio - 1) if cfg.family == "audio" else (S - 1)
    tok2, caches2 = zoo.make_decode_step(cfg)(
        state["params"], caches,
        {"tokens": next_tok[:, None],
         "pos": torch.full((B,), last, dtype=torch.int32)})
    assert tok2.shape == (B, 1)
    assert _finite(caches2)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "recurrentgemma-2b"])
def test_train_step_matches_jax(arch):
    """One AdamW step of the moe family (ce + the aux loss) and of the
    hybrid family (RG-LRU scan and ring attention) against the JAX one,
    in float32 from the same carried-over state and batch."""
    jcfg, tcfg = tm.cfgs(arch, **F32)
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    jopt_cfg, topt_cfg = JaxOptimizerConfig(**ocfg), OptimizerConfig(**ocfg)
    jopt = jax_make_optimizer(jopt_cfg)
    jp, _ = tm.params(arch, **F32)
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = zoo.state_from_numpy(tm.np_tree(jstate), "cpu")
    b = tm.batch(tcfg, "train", B, S, seed=3)
    jstate, jm = jax.jit(jzoo.make_train_step(jcfg, jopt, jopt_cfg))(
        jstate, tm.to_jax(b))
    tstate, tmet = zoo.make_train_step(tcfg, make_optimizer(topt_cfg),
                                       topt_cfg)(tstate, tm.to_torch(b))
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jm[key]),
                                   rtol=tm.RTOL, atol=1e-9, err_msg=key)
    if tcfg.family == "moe":
        assert float(tmet["aux"]) > 0
    jflat = dict(jax_names(jstate))
    for name, leaf in tree_flatten_with_names(tstate):
        want = np.asarray(jflat[name])
        if name.startswith("opt/"):
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                       atol=1e-9, err_msg=name)
        else:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=0, atol=1e-6,
                                       err_msg=name)
