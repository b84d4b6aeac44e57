"""Gradient accumulation, remat and ``state_specs`` of the port's zoo
against the JAX package's.

* ``make_train_step(accum=2)`` against the JAX one at the SMOKE configs
  of the dense, moe, vlm ((3, B, S) position ids) and audio (frames)
  families, in float32, with ``accum_dtype`` float32 and bfloat16;
* remat "full" and "minimal" give gradients bit-equal to "none" for each
  family on the CPU, keep fewer tensors alive in that order, and leave
  the no-grad forward untouched;
* ``state_specs`` has the names, shapes and dtypes of the JAX package's
  for all ten archs at their published configs.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_models as tm
from repro.config import OptimizerConfig as JaxOptimizerConfig
from repro.configs import get_config as jax_get_config
from repro.models import zoo as jzoo
from repro.optim import make_optimizer as jax_make_optimizer
from repro.utils.trees import tree_flatten_with_names as jax_names
from repro_torch.config import OptimizerConfig, replace
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.utils.trees import (tree_flatten_with_names, tree_leaves,
                                     tree_structure, tree_unflatten)

F32 = dict(dtype="float32")
ACCUM_ARCHS = ["yi-6b", "olmoe-1b-7b", "qwen2-vl-7b", "whisper-small"]
FAMILY_ARCHS = ["yi-6b", "olmoe-1b-7b", "recurrentgemma-2b", "rwkv6-3b",
                "qwen2-vl-7b", "whisper-small"]
OCFG = dict(lr=1e-3, warmup_steps=0, total_steps=100)


def _run_accum(arch: str, accum_dtype: str, **ocfg):
    jcfg, tcfg = tm.cfgs(arch, **F32)
    kw = dict(OCFG, **ocfg)
    jopt_cfg, topt_cfg = JaxOptimizerConfig(**kw), OptimizerConfig(**kw)
    jopt = jax_make_optimizer(jopt_cfg)
    jp, tp = tm.params(arch, **F32)
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = zoo.state_from_numpy(tm.np_tree(jstate), "cpu")
    b = tm.batch(tcfg, "train", 4, 16, seed=5)
    jstep = jzoo.make_train_step(jcfg, jopt, jopt_cfg, accum=2,
                                 accum_dtype=accum_dtype)
    jstate, jm = jax.jit(jstep)(jstate, tm.to_jax(b))
    tstep = zoo.make_train_step(tcfg, make_optimizer(topt_cfg), topt_cfg,
                                accum=2, accum_dtype=accum_dtype)
    tstate, tmet = tstep(tstate, tm.to_torch(b))
    return tstate, tmet, jstate, jm, (tcfg, tp, b)


def _check_metrics(tmet, jm, rtol):
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jm[key]),
                                   rtol=rtol, atol=1e-9, err_msg=key)
    assert float(tmet["aux"]) == 0.0
    assert float(tmet["loss"]) == float(tmet["ce"])


@pytest.mark.parametrize("arch", ACCUM_ARCHS)
def test_accumulated_train_step_matches_jax(arch):
    """Two microbatches of two (the vlm's (3, B, S) positions and the
    audio frames split too), float32 sums: the metrics (ce the mean
    loss, aux 0), the AdamW moments (0.1 g and 0.05 g^2 at step 0) and
    the params, from the same carried-over state and batch, at the
    tolerances of ``test_torch_zoo.py``'s train-step test."""
    tstate, tmet, jstate, jm, _ = _run_accum(arch, "float32")
    _check_metrics(tmet, jm, tm.RTOL)
    jflat = dict(jax_names(jstate))
    for name, leaf in tree_flatten_with_names(tstate):
        want = np.asarray(jflat[name])
        if name.startswith("opt/"):
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                       atol=1e-9, err_msg=name)
        else:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=0, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("arch", ACCUM_ARCHS)
def test_bf16_accumulated_train_step_matches_jax(arch):
    """``accum_dtype="bfloat16"``: each microbatch gradient is rounded
    to bf16 and summed in bf16 in both frameworks.  Where their float32
    gradients (equal within ~1e-6) straddle a bf16 rounding edge the
    sums differ by a rounding, so each element of the first moment m =
    0.1 g is held within the bound of that arithmetic: two roundings of
    at most 2^-8 of |g0|, |g1| and |g0 + g1| each, halved by the mean,
    computed from the port's own float32 microbatch gradients (no
    clipping: ``grad_clip`` 1e9), plus the float32 test's tolerance.
    The params (step 0: learning rate 0) stay equal."""
    tstate, tmet, jstate, jm, (cfg, params, b) = _run_accum(
        arch, "bfloat16", grad_clip=1e9)
    _check_metrics(tmet, jm, 2.0 ** -7)
    half = {k: torch.from_numpy(np.ascontiguousarray(
        v[:2] if k != "positions" else v[:, :2])) for k, v in b.items()}
    rest = {k: torch.from_numpy(np.ascontiguousarray(
        v[2:] if k != "positions" else v[:, 2:])) for k, v in b.items()}
    _, g0 = _grads(cfg, params, half)
    _, g1 = _grads(cfg, params, rest)
    names = [n for n, _ in tree_flatten_with_names(params)]
    got = dict(tree_flatten_with_names(tstate["opt"]["m"]))
    want = dict(jax_names(jstate["opt"]["m"]))
    for n, a, c in zip(names, g0, g1):
        a, c = a.numpy().astype(np.float64), c.numpy().astype(np.float64)
        bound = 0.1 * 2.0 ** -7 * (np.abs(a) + np.abs(c) + np.abs(a + c)) / 2
        w = np.asarray(want[n], np.float64)
        err = np.abs(got[n].numpy().astype(np.float64) - w)
        assert np.all(err <= bound + 1e-5 * np.abs(w) + 1e-9), n
    jflat = dict(jax_names(jstate["params"]))
    for name, leaf in tree_flatten_with_names(tstate["params"]):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(jflat[name]),
                                   rtol=0, atol=1e-6, err_msg=name)


def test_accumulation_of_one_batch_equals_the_plain_step():
    """accum=2 and accum=1 on the same batch: the same loss and gradient
    norm (different summation orders), the accumulated metrics' form."""
    cfg = replace(get_smoke_config("yi-6b"), **F32)
    ocfg = OptimizerConfig(name="sgd", lr=0.1, warmup_steps=1,
                           schedule="constant")
    opt = make_optimizer(ocfg)
    state = zoo.init_state(cfg, opt, torch.Generator().manual_seed(1), "cpu")
    b = tm.to_torch(tm.batch(cfg, "train", 4, 16, seed=2))
    _, m1 = zoo.make_train_step(cfg, opt, ocfg)(state, b)
    _, m2 = zoo.make_train_step(cfg, opt, ocfg, accum=2)(state, b)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m2[key]), float(m1[key]),
                                   rtol=1e-5, err_msg=key)
    assert float(m2["aux"]) == 0.0 and float(m2["ce"]) == float(m2["loss"])


def test_unsplittable_leaf_raises():
    cfg = replace(get_smoke_config("yi-6b"), **F32)
    ocfg = OptimizerConfig()
    opt = make_optimizer(ocfg)
    state = zoo.init_state(cfg, opt, torch.Generator().manual_seed(0), "cpu")
    b = tm.to_torch(tm.batch(cfg, "train", 4, 16))
    b["extra"] = torch.zeros((3, 5))
    with pytest.raises(ValueError, match=r"cannot microbatch leaf of shape "
                                         r"\(3, 5\)"):
        zoo.make_train_step(cfg, opt, ocfg, accum=2)(state, b)


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

def _remat_cfg(arch: str, policy: str, flash: bool = False):
    kw = dict(dtype="float32", remat_policy=policy)
    if flash:    # the chunked attention path, itself checkpointed per block
        kw.update(attn_chunk_q=4, attn_chunk_kv=8)
    return replace(get_smoke_config(arch), **kw)


def _grads(cfg, params, batch):
    treedef = tree_structure(params)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    loss, _ = zoo.make_loss_fn(cfg)(tree_unflatten(treedef, leaves), batch)
    return loss, torch.autograd.grad(loss, leaves)


REMAT_CASES = [(a, False) for a in FAMILY_ARCHS] + [("yi-6b", True)]


@pytest.mark.parametrize("arch,flash", REMAT_CASES)
def test_remat_gradients_bit_equal_to_none(arch, flash):
    params = zoo.init_params(_remat_cfg(arch, "none"),
                             torch.Generator().manual_seed(3), "cpu")
    b = tm.to_torch(tm.batch(_remat_cfg(arch, "none"), "train", 2, 16,
                             seed=4))
    loss0, g0 = _grads(_remat_cfg(arch, "none", flash), params, b)
    for policy in ("full", "minimal"):
        loss, g = _grads(_remat_cfg(arch, policy, flash), params, b)
        assert torch.equal(loss, loss0), policy
        for a, c in zip(g, g0):
            assert torch.equal(a, c), policy


class _LiveOutputs(TorchDispatchMode):
    """Records a weak reference to the storage of every op's output."""

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor) and t.device.type == "cpu":
                self.refs.append(weakref.ref(t.untyped_storage()))
        return out


def _kept_after_forward(cfg, params, batch) -> int:
    """The activations the autograd graph keeps for the backward pass:
    distinct storages made by the forward that are still alive once only
    the loss is held (params and inputs excluded).  A count of
    ``saved_tensors_hooks`` packs cannot tell the policies apart: the
    non-reentrant checkpoint's own hooks take every save inside a region,
    and the selective policy keeps its tensors in its own cache."""
    treedef = tree_structure(params)
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    own = {t.untyped_storage().data_ptr() for t in leaves} | \
        {t.untyped_storage().data_ptr() for t in batch.values()}
    mode = _LiveOutputs()
    with mode:
        loss, _ = zoo.make_loss_fn(cfg)(tree_unflatten(treedef, leaves),
                                        batch)
    gc.collect()
    alive = {r().data_ptr() for r in mode.refs if r() is not None} - own
    del loss
    return len(alive)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_keeps_fewer_tensors_full_minimal_none(arch):
    params = zoo.init_params(_remat_cfg(arch, "none"),
                             torch.Generator().manual_seed(3), "cpu")
    b = tm.to_torch(tm.batch(_remat_cfg(arch, "none"), "train", 2, 16,
                             seed=4))
    kept = {p: _kept_after_forward(_remat_cfg(arch, p), params, b)
            for p in ("full", "minimal", "none")}
    assert kept["full"] < kept["minimal"] < kept["none"], kept


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_no_grad_forward_is_the_same_whatever_the_policy(arch, monkeypatch):
    """Under ``torch.no_grad`` (prefill, serving) no checkpoint wraps a
    layer and the logits are bit-equal across policies."""
    params = zoo.init_params(_remat_cfg(arch, "none"),
                             torch.Generator().manual_seed(5), "cpu")
    b = tm.to_torch(tm.batch(_remat_cfg(arch, "none"), "prefill", 2, 16,
                             seed=6))

    def refuse(*a, **k):
        raise AssertionError("checkpoint called under no_grad")

    monkeypatch.setattr(zoo, "checkpoint", refuse)
    outs = {}
    with torch.no_grad():
        for policy in ("none", "full", "minimal"):
            outs[policy] = zoo.forward_logits(
                params, _remat_cfg(arch, policy), b)[0]
    assert torch.equal(outs["full"], outs["none"])
    assert torch.equal(outs["minimal"], outs["none"])


# ---------------------------------------------------------------------------
# state_specs
# ---------------------------------------------------------------------------

OPTIMIZERS = [("adamw", "float32"), ("adamw", "bfloat16"),
              ("sgd", "float32")]


@pytest.fixture(scope="module")
def jax_param_specs():
    """The JAX package's params of each full config, by ``eval_shape``
    (no allocation), once per arch."""
    cache = {}

    def get(arch):
        if arch not in cache:
            cfg = jax_get_config(arch)
            cache[arch] = jax.eval_shape(
                lambda k: jzoo.init_params(cfg, k), jax.random.PRNGKey(0))
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_state_specs_match_jax(arch, jax_param_specs):
    params = jax_param_specs(arch)
    for name, sdt in OPTIMIZERS:
        jopt = jax_make_optimizer(JaxOptimizerConfig(name=name,
                                                     state_dtype=sdt))
        want = {"params": params, "opt": jax.eval_shape(jopt.init, params),
                "step": jax.ShapeDtypeStruct((), jnp.int32)}
        got = zoo.state_specs(get_config(arch), make_optimizer(
            OptimizerConfig(name=name, state_dtype=sdt)))
        jn = [(n, tuple(a.shape), str(a.dtype)) for n, a in jax_names(want)]
        tn = [(n, tuple(a.shape), str(a.dtype).replace("torch.", ""))
              for n, a in tree_flatten_with_names(got)]
        assert tn == jn, (name, sdt)
        assert all(a.device.type == "meta" for a in tree_leaves(got))
