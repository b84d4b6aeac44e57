"""The port's dense model and optimizer against the JAX package's, on the
yi-6b SMOKE config in float32 (the point here is the algorithm; bf16
rounds at other places in the two frameworks).

Params are initialized by the JAX package and carried over leaf for leaf
with ``zoo.state_from_numpy``; batches come from the same counter-based
stream.  Tolerances: float32 with different summation orders (XLA:CPU vs
PyTorch's CPU matmuls and reductions) — logits and the loss agree to
rtol 1e-5 / atol 2e-5 (values of order 1), and one AdamW update to 1e-5 on
the moments; the parameters after an update to atol 1e-6 (at most a few
f32 ulps of the O(0.02) weights, far below the 1e-3 learning rate).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import OptimizerConfig as JaxOptimizerConfig
from repro.config import replace as jreplace
from repro.configs import get_smoke_config as jax_smoke
from repro.data.pipeline import _tokens_for_events
from repro.models import zoo as jzoo
from repro.optim import make_optimizer as jax_make_optimizer
from repro.utils.trees import tree_flatten_with_names as jax_names
from repro_torch.config import OptimizerConfig, replace
from repro_torch.configs import get_smoke_config
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.utils.trees import tree_flatten_with_names

jax.config.update("jax_platform_name", "cpu")

CHUNKED = dict(dtype="float32", attn_chunk_q=8, attn_chunk_kv=16)


def _cfgs(**kw):
    return (jreplace(jax_smoke("yi-6b"), **kw),
            replace(get_smoke_config("yi-6b"), **kw))


def _batch(seq, batch=2, vocab=512, first=0):
    toks = _tokens_for_events(np.arange(first, first + batch), seq + 1,
                              vocab, 0)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _to_port(np_tree):
    return zoo.state_from_numpy(np_tree, "cpu")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_leaf_names_and_shapes_match_jax():
    jcfg, tcfg = _cfgs(dtype="float32")
    jopt = jax_make_optimizer(JaxOptimizerConfig())
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(0))
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    topt = make_optimizer(OptimizerConfig())
    tstate = zoo.init_state(tcfg, topt, torch.Generator().manual_seed(0),
                            "cpu")
    jn = [(n, tuple(l.shape), str(l.dtype)) for n, l in jax_names(jstate)]
    tn = [(n, tuple(l.shape), str(l.dtype).replace("torch.", ""))
          for n, l in tree_flatten_with_names(tstate)]
    assert tn == jn
    # the carried-over state flattens to the same names too
    carried = _to_port(_np(jstate))
    assert [n for n, _ in tree_flatten_with_names(carried)] == \
        [n for n, _, _ in jn]


@pytest.mark.parametrize("seq,path", [(32, "chunked"), (8, "full")])
def test_logits_and_loss_match_jax(seq, path):
    jcfg, tcfg = _cfgs(**CHUNKED)
    # S > attn_chunk_q takes the chunked running-softmax path
    assert (seq > tcfg.attn_chunk_q) == (path == "chunked")
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(1))
    b = _batch(seq)
    jlogits, _, _ = jzoo.forward_logits(
        jparams, jcfg, {k: jnp.asarray(v) for k, v in b.items()})
    tparams = _to_port(_np(jparams))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tlogits, taux, _ = zoo.forward_logits(tparams, tcfg, tb)
    assert float(taux) == 0.0
    np.testing.assert_allclose(tlogits.detach().numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=2e-5)
    jloss, _ = jzoo.make_loss_fn(jcfg)(jparams, {k: jnp.asarray(v)
                                                 for k, v in b.items()})
    tloss, _ = zoo.make_loss_fn(tcfg)(tparams, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)


def test_train_step_matches_jax():
    """Two updates (the first has lr 0 under warmup, the second moves the
    params) from the same carried-over state and batches."""
    jcfg, tcfg = _cfgs(**CHUNKED)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=100)
    jopt_cfg = JaxOptimizerConfig(**ocfg)
    topt_cfg = OptimizerConfig(**ocfg)
    jopt = jax_make_optimizer(jopt_cfg)
    jparams = jzoo.init_params(jcfg, jax.random.PRNGKey(2))
    jstate = {"params": jparams, "opt": jopt.init(jparams),
              "step": jnp.zeros((), jnp.int32)}
    tstate = _to_port(_np(jstate))
    jstep = jax.jit(jzoo.make_train_step(jcfg, jopt, jopt_cfg))
    tstep = zoo.make_train_step(tcfg, make_optimizer(topt_cfg), topt_cfg)
    for k in range(2):
        b = _batch(32, first=2 * k)
        jstate, jm = jstep(jstate, {kk: jnp.asarray(v) for kk, v in b.items()})
        tstate, tm = tstep(tstate, {kk: torch.from_numpy(v)
                                    for kk, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(tstate["step"]) == int(jstate["step"]) == 2
    jflat = dict(jax_names(jstate))
    for name, leaf in tree_flatten_with_names(tstate):
        want = np.asarray(jflat[name])
        got = leaf.numpy()
        if name.startswith("opt/"):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9,
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                       err_msg=name)


def test_state_numpy_round_trip_is_exact():
    _, tcfg = _cfgs(dtype="float32")
    opt = make_optimizer(OptimizerConfig())
    state = zoo.init_state(tcfg, opt, torch.Generator().manual_seed(3), "cpu")
    back = _to_port(zoo.state_to_numpy(state))
    for (n, a), (m, b) in zip(tree_flatten_with_names(state),
                              tree_flatten_with_names(back)):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b)
        assert a.data_ptr() != b.data_ptr()        # a copy, never aliased
