"""The port's sharding rules and meshes against the JAX package's.

* twins of the spec tests of ``tests/test_distribution.py`` and
  ``tests/test_sharding_levers.py``, on the port's abstract mesh;
* every param spec of ``state_specs``, input spec of ``input_specs`` and
  cache spec of ``cache_specs`` of every arch at its published config,
  on both production meshes, under the default ``ShardingConfig`` and
  each of its levers, equal to the JAX package's entry for entry;
* ``placements`` on real ``DeviceMesh``es of a ``fake`` process group
  (one process standing in for 256 or 512 ranks): the local shard shapes
  the specs imply;
* the ``ann=`` hook: olmoe's forward and train step with an annotator of
  data-parallel degree 4 against the JAX one with a stub annotator;
* the twin of ``test_real_compile_on_8_fake_devices``: the reference's
  tiny dense config on a (4, 2) fake-group mesh, its state and batch
  placements, and ``make_train_step(accum=2, ann=rules.annotator())`` on
  real CPU tensors against the JAX step.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.testing._internal.distributed.fake_pg import FakeStore

import torch_models as tm
from repro.config import ModelConfig as JaxModelConfig
from repro.config import OptimizerConfig as JaxOptimizerConfig
from repro.config import ShapeConfig as JaxShapeConfig
from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import applicable_shapes as jax_applicable_shapes
from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_abstract_mesh as jax_abstract_mesh
from repro.models import layers as JL
from repro.models import zoo as jzoo
from repro.optim import make_optimizer as jax_make_optimizer
from repro.sharding import ShardingRules as JaxShardingRules
from repro.utils.trees import tree_flatten_with_names as jax_names
from repro_torch.config import (ModelConfig, OptimizerConfig, ShapeConfig,
                                ShardingConfig, applicable_shapes)
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import (make_abstract_mesh, make_mesh,
                                     make_production_mesh, make_test_mesh)
from repro_torch.models import zoo
from repro_torch.optim import make_optimizer
from repro_torch.sharding import P, ShardingRules, placements
from repro_torch.utils.trees import tree_flatten_with_names, tree_leaves

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


def _rules(arch="yi-6b", multi=False, **scfg):
    mesh = make_abstract_mesh(*MESHES["multi" if multi else "pod"])
    return ShardingRules(get_config(arch), mesh, ShardingConfig(**scfg))


# ---------------------------------------------------------------------------
# twins of tests/test_distribution.py's spec tests
# ---------------------------------------------------------------------------

def test_tp_sharding_of_core_weights():
    r = _rules(fsdp=False)
    assert r.param_spec("layers/attn/wq", (32, 4096, 32, 128)) == \
        P(None, None, "model", None)
    assert r.param_spec("layers/ffn/w_up", (32, 4096, 11008)) == \
        P(None, None, "model")
    assert r.param_spec("layers/ffn/w_down", (32, 11008, 4096)) == \
        P(None, "model", None)
    assert r.param_spec("emb/embed", (64000, 4096)) == P("model", None)


def test_kv_heads_replicated_when_not_divisible():
    r = _rules(fsdp=False)
    # yi-6b: 4 kv heads % 16 != 0 -> replicated (no head-dim sharding)
    assert r.param_spec("layers/attn/wk", (32, 4096, 4, 128)) == \
        P(None, None, None, None)


def test_fsdp_adds_data_axis():
    r = _rules(fsdp=True, fsdp_min_params=0)
    assert r.param_spec("layers/ffn/w_up", (32, 4096, 11008)) == \
        P(None, "data", "model")


def test_fsdp_spans_pod_axis_on_multipod():
    r = _rules(arch="grok-1-314b", multi=True, fsdp=True, fsdp_min_params=0)
    spec = r.param_spec("layers/moe/w_up", (64, 8, 6144, 32768))
    # experts (8) not divisible by tp: d over (pod,data), f over model
    assert spec == P(None, None, ("pod", "data"), "model")


def test_moe_expert_axis_when_divisible():
    r = _rules(arch="olmoe-1b-7b", fsdp=False)
    assert r.param_spec("layers/moe/w_up", (16, 64, 2048, 1024)) == \
        P(None, "model", None, None)   # 64 experts / 16


def test_norms_replicated():
    assert _rules().param_spec("layers/ln1/scale", (32, 4096)) == P()


def test_kv_cache_seq_sharding_fallback():
    r = _rules()
    # yi decode: kv heads 4 % 16 -> shard the 32k seq dim instead
    assert r.cache_spec("k", (32, 128, 32768, 4, 128)) == \
        P(None, "data", "model", None, None)
    # codeqwen: 32 kv heads divisible -> heads shard
    assert _rules("codeqwen1.5-7b").cache_spec(
        "k", (32, 128, 32768, 32, 128)) == P(None, "data", None, "model",
                                             None)


def test_batch_replicates_when_not_divisible():
    r = _rules()
    assert r.input_spec("tokens", (1, 524288)) == P(None, None)
    assert r.input_spec("tokens", (256, 4096)) == P("data", None)


def test_act_specs():
    r = _rules()
    assert r.act_spec("hidden", (256, 4096, 4096)) == P("data", None, None)
    assert r.act_spec("wide", (256, 4096, 11008)) == P("data", None, "model")


# ---------------------------------------------------------------------------
# twins of tests/test_sharding_levers.py's spec tests
# ---------------------------------------------------------------------------

def test_sp_shards_hidden_seq_dim():
    r = _rules(seq_shard_hidden=True)
    assert r.act_spec("hidden", (256, 4096, 4096)) == \
        P("data", "model", None)
    # long_500k decode: seq dim 1 not divisible -> falls back cleanly
    assert r.act_spec("hidden", (1, 1, 2560)) == P(None, None, None)


def test_sp_off_by_default():
    assert _rules().act_spec("hidden", (256, 4096, 4096)) == \
        P("data", None, None)


def test_moe_megatron_expert_ffn_sharding():
    r = _rules("grok-1-314b", fsdp_min_params=0, moe_megatron=True)
    up = r.param_spec("layers/moe/w_up", (64, 8, 6144, 32768))
    down = r.param_spec("layers/moe/w_down", (64, 8, 32768, 6144))
    assert up == P(None, None, None, ("data", "model"))
    assert down == P(None, None, ("data", "model"), None)


def test_moe_megatron_ignored_when_experts_divide():
    r = _rules("olmoe-1b-7b", fsdp=False, moe_megatron=True)
    assert r.param_spec("layers/moe/w_up", (16, 64, 2048, 1024)) == \
        P(None, "model", None, None)


# ---------------------------------------------------------------------------
# every spec of every arch against the JAX package's
# ---------------------------------------------------------------------------

LEVERS = [{}, {"fsdp": False}, {"fsdp_min_params": 0},
          {"expert_axis": "model"}, {"expert_axis": "data"},
          {"expert_axis": "none"}, {"decode_kv_seq_shard": False},
          {"seq_shard_hidden": True}, {"moe_megatron": True},
          {"moe_megatron": True, "fsdp_min_params": 0},
          {"gradient_accum": 4}, {"compress_cross_pod_grads": True}]
ACT_SHAPES = {"hidden": [(256, 4096, 4096), (1, 1, 2560), (32, 2048, 896)],
              "heads": [(256, 4096, 32, 128), (8, 64, 28, 128)],
              "wide": [(256, 4096, 11008), (3, 7, 2560)],
              "logits": [(256, 4096, 64000), (2, 1, 151936)],
              "moe_buf": [(16, 64, 80, 2048), (32, 8, 40, 6144)],
              "moe_hidden": [(16, 64, 80, 1024), (32, 8, 40, 32768)],
              "other": [(4, 4)]}


@pytest.fixture(scope="module")
def jax_state_specs():
    """The JAX package's AdamW train state of each full config, by
    ``eval_shape``, once per arch."""
    cache = {}
    opt = jax_make_optimizer(JaxOptimizerConfig())

    def get(arch):
        if arch not in cache:
            cache[arch] = jzoo.state_specs(jax_get_config(arch), opt)
        return cache[arch]
    return get


def _entries(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_spec_matches_jax(arch, jax_state_specs):
    tstate = zoo.state_specs(get_config(arch), make_optimizer(
        OptimizerConfig()))
    jstate = jax_state_specs(arch)
    tcfg, jcfg = get_config(arch), jax_get_config(arch)
    checked = 0
    for mesh_name, (shape, axes) in MESHES.items():
        tmesh = make_abstract_mesh(shape, axes)
        jmesh = jax_abstract_mesh(shape, axes)
        for lever in LEVERS:
            tr = ShardingRules(tcfg, tmesh, ShardingConfig(**lever))
            jr = JaxShardingRules(jcfg, jmesh, JaxShardingConfig(**lever))
            assert tr.dp == jr.dp and tr.tp == jr.tp and tr.fsdp == jr.fsdp
            assert tr.dp_size == jr.dp_size
            what = (mesh_name, lever)
            want = dict(jax_names(jr.state_shardings(jstate)))
            got = dict(tree_flatten_with_names(tr.state_shardings(tstate)))
            assert sorted(got) == sorted(want)
            for name, leaf in tree_flatten_with_names(tstate):
                spec = tr.state_spec(name, tuple(leaf.shape))
                assert _entries(spec) == _entries(want[name].spec), \
                    (what, name)
                assert got[name].spec == spec
                assert got[name].placements == placements(spec, tmesh)
                checked += 1
            for tshape, jshape in zip(applicable_shapes(tcfg),
                                      jax_applicable_shapes(jcfg)):
                ti, ji = zoo.input_specs(tcfg, tshape), \
                    jzoo.input_specs(jcfg, jshape)
                jin = dict(jax_names(jr.batch_shardings(ji)))
                for name, leaf in tree_flatten_with_names(ti):
                    assert _entries(tr.input_spec(name, tuple(leaf.shape))) \
                        == _entries(jin[name].spec), (what, name)
                    checked += 1
                if tshape.mode != "decode":
                    continue
                tc_ = zoo.cache_specs(tcfg, tshape)
                jc_ = dict(jax_names(jr.cache_shardings(
                    jzoo.cache_specs(jcfg, jshape))))
                assert sorted(n for n, _ in tree_flatten_with_names(tc_)) \
                    == sorted(jc_)
                for name, leaf in tree_flatten_with_names(tc_):
                    assert _entries(tr.cache_spec(name, tuple(leaf.shape))) \
                        == _entries(jc_[name].spec), (what, name)
                    checked += 1
                assert _entries(tr.dp_vector((tshape.global_batch,)).spec) \
                    == _entries(jr.dp_vector((tshape.global_batch,)).spec)
            for kind, shapes in ACT_SHAPES.items():
                for s in shapes:
                    assert _entries(tr.act_spec(kind, s)) == \
                        _entries(jr.act_spec(kind, s)), (what, kind, s)
            assert tr.replicated().placements == \
                tuple(Replicate() for _ in axes)
    assert checked > 0


# ---------------------------------------------------------------------------
# placements on real DeviceMeshes of a fake process group
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_group():
    """A ``fake`` process group of ``n`` ranks in this process; destroyed
    after the test."""
    def start(n: int):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _expected_placements(jspec, axes) -> tuple:
    """A JAX ``PartitionSpec`` as one placement per mesh dim (this test's
    own reading, independent of the port's ``placements``)."""
    out = []
    for name in axes:
        dims = [d for d, e in enumerate(jspec) if e is not None
                and name in (e if isinstance(e, tuple) else (e,))]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


PLACEMENT_CASES = [
    ("pod", "yi-6b", {"fsdp_min_params": 0}, "params/layers/ffn/w_up",
     (2, 64, 32)),
    ("pod", "yi-6b", {"fsdp_min_params": 0}, "params/layers/attn/wq",
     (2, 32, 16, 8)),
    ("pod", "yi-6b", {}, "params/emb/embed", (64, 48)),
    ("pod", "olmoe-1b-7b", {"fsdp": False}, "opt/m/layers/moe/w_up",
     (2, 32, 8, 4)),
    ("pod", "yi-6b", {}, "params/layers/ln1/scale", (2, 8)),
    ("multi", "grok-1-314b", {"fsdp_min_params": 0},
     "params/layers/moe/w_up", (2, 8, 64, 32)),
    ("multi", "grok-1-314b", {"moe_megatron": True,
                              "fsdp_min_params": 0},
     "opt/v/layers/moe/w_down", (2, 8, 1024, 8)),
]


@pytest.mark.parametrize("mesh_name,arch,lever,name,shape", PLACEMENT_CASES)
def test_placements_shard_like_the_spec(fake_group, mesh_name, arch, lever,
                                        name, shape):
    mshape, axes = MESHES[mesh_name]
    fake_group(math.prod(mshape))
    mesh = make_test_mesh(*mshape[-2:], pods=mshape[0] if len(mshape) == 3
                          else 0, device_type="cpu")
    assert mesh.mesh_dim_names == axes and tuple(mesh.shape) == mshape
    rules = ShardingRules(get_config(arch), mesh, ShardingConfig(**lever))
    jr = JaxShardingRules(jax_get_config(arch), jax_abstract_mesh(
        mshape, axes), JaxShardingConfig(**lever))
    spec = rules.state_spec(name, shape)
    want = dict(jax_names(jr.state_shardings(
        {name.split("/")[0]: _nest(name.split("/")[1:], shape)})))[name]
    assert _entries(spec) == _entries(want.spec)
    pl = placements(spec, mesh)
    assert pl == _expected_placements(want.spec, axes)
    assert any(isinstance(p, Shard) for p in pl) or spec == P()
    sizes = dict(zip(axes, mshape))
    local = []
    for d, n in enumerate(shape):
        e = spec[d] if d < len(spec) else None
        div = math.prod(sizes[a] for a in (e if isinstance(e, tuple)
                                           else (e,))) if e else 1
        local.append(n // div)
    dt = distribute_tensor(torch.zeros(shape), mesh, pl)
    assert tuple(dt.to_local().shape) == tuple(local)
    assert tuple(dt.shape) == shape


def _nest(path: list, shape):
    leaf = jax.ShapeDtypeStruct(shape, jnp.float32)
    for key in reversed(path):
        leaf = {key: leaf}
    return leaf


def test_meshes_refuse_a_world_size_that_is_not_the_mesh(fake_group):
    from repro_torch.config import MeshConfig
    with pytest.raises(RuntimeError, match="process group"):
        make_test_mesh(2, 2, device_type="cpu")
    fake_group(8)
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh(device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        make_test_mesh(2, 2, device_type="cpu")
    mesh = make_mesh(MeshConfig(data=4, model=2), device_type="cpu")
    assert mesh.mesh_dim_names == ("data", "model")
    assert tuple(mesh.shape) == (4, 2)


def test_abstract_mesh_is_the_references():
    m = make_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    j = jax_abstract_mesh((2, 16, 16), ("pod", "data", "model"))
    assert m.axis_names == tuple(j.axis_names)
    assert m.shape == dict(j.shape)
    with pytest.raises(ValueError):
        make_abstract_mesh((2, 2), ("data",))


# ---------------------------------------------------------------------------
# the ann= hook
# ---------------------------------------------------------------------------

class _JaxStubAnn(JL.NullAnnotator):
    dp_size = 4
    moe_groups = 4


def test_ann_hook_groups_the_moe_like_jax():
    """olmoe's SMOKE forward (logits and aux loss) and one AdamW step
    with the port's annotator of data-parallel degree 4 (an abstract
    (4, 2) mesh; plain tensors pass ``constrain`` unchanged) against the
    JAX package's with a stub annotator of 4 MoE groups."""
    arch = "olmoe-1b-7b"
    jcfg, tcfg = tm.cfgs(arch, dtype="float32")
    rules = ShardingRules(tcfg, make_abstract_mesh((4, 2),
                                                   ("data", "model")),
                          ShardingConfig())
    ann = rules.annotator()
    assert ann.moe_groups == 4 and ann.dp_size == 4
    jp, tp = tm.params(arch, dtype="float32")
    b = tm.batch(tcfg, "train", 4, 16, seed=7)
    jl, jaux, _ = jax.jit(lambda p, x: jzoo.forward_logits(
        p, jcfg, x, ann=_JaxStubAnn()))(jp, tm.to_jax(b))
    tl, taux, _ = zoo.forward_logits(tp, tcfg, tm.to_torch(b), ann=ann)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=tm.RTOL, atol=tm.ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=tm.RTOL)
    # the grouping is what the annotator changes: one group differs
    l1, aux1, _ = zoo.forward_logits(tp, tcfg, tm.to_torch(b))
    assert float(aux1) != float(taux)

    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=100)
    jopt_cfg, topt_cfg = JaxOptimizerConfig(**ocfg), OptimizerConfig(**ocfg)
    jopt = jax_make_optimizer(jopt_cfg)
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = zoo.state_from_numpy(tm.np_tree(jstate), "cpu")
    jstate, jm = jax.jit(jzoo.make_train_step(
        jcfg, jopt, jopt_cfg, ann=_JaxStubAnn()))(jstate, tm.to_jax(b))
    tstate, tmet = zoo.make_train_step(tcfg, make_optimizer(topt_cfg),
                                       topt_cfg, ann=ann)(
        tstate, tm.to_torch(b))
    _check_step(tstate, tmet, jstate, jm)


def _check_step(tstate, tmet, jstate, jm):
    for key in ("loss", "ce", "aux", "grad_norm"):
        np.testing.assert_allclose(float(tmet[key]), float(jm[key]),
                                   rtol=tm.RTOL, atol=1e-9, err_msg=key)
    jflat = dict(jax_names(jstate))
    for name, leaf in tree_flatten_with_names(tstate):
        want = np.asarray(jflat[name])
        if name.startswith("opt/"):
            np.testing.assert_allclose(leaf.numpy(), want, rtol=1e-5,
                                       atol=1e-9, err_msg=name)
        else:
            np.testing.assert_allclose(leaf.numpy(), want, rtol=0, atol=1e-6,
                                       err_msg=name)


def test_moe_groups_keyword_is_shorthand_for_an_annotator():
    from repro_torch.models import layers as L
    cfg = get_config("olmoe-1b-7b")
    with pytest.raises(ValueError, match="groups= or ann="):
        L.apply_moe({}, torch.zeros((1, 2, cfg.d_model)), cfg,
                    ann=_rules("olmoe-1b-7b").annotator(), groups=2)


def test_constrain_redistributes_a_dtensor(fake_group):
    fake_group(8)
    mesh = make_test_mesh(4, 2, device_type="cpu")
    rules = ShardingRules(get_config("yi-6b"), mesh, ShardingConfig())
    ann = rules.annotator()
    x = torch.zeros((8, 6, 4))
    assert ann.constrain(x, "hidden") is x
    dx = distribute_tensor(torch.zeros((8, 6, 4)), mesh,
                           (Replicate(), Replicate()))
    out = ann.constrain(dx, "hidden")
    assert out.placements == (Shard(0), Replicate())
    assert tuple(out.to_local().shape) == (2, 6, 4)


# ---------------------------------------------------------------------------
# twin of tests/test_distribution.py::test_real_compile_on_8_fake_devices
# ---------------------------------------------------------------------------

TINY = dict(name="t", family="dense", num_layers=2, d_model=128, num_heads=4,
            num_kv_heads=2, d_ff=256, vocab_size=512)


def test_sharded_train_step_on_8_fake_ranks(fake_group):
    """The reference's tiny dense config on a (4, 2) ("data", "model")
    mesh of a fake group of eight ranks: the state and batch placements
    are the JAX package's specs on the abstract (4, 2) mesh, and the
    accumulated train step with the rules' annotator runs on real CPU
    tensors and matches the JAX step (float32; a dense model's result
    does not depend on the annotator, so JAX runs with ``NULL_ANN``)."""
    fake_group(8)
    mesh = make_test_mesh(4, 2, device_type="cpu")
    tcfg, jcfg = ModelConfig(**TINY), JaxModelConfig(**TINY)
    shape = ShapeConfig("t", "train", 64, 8)
    jshape = JaxShapeConfig("t", "train", 64, 8)
    topt_cfg, jopt_cfg = OptimizerConfig(), JaxOptimizerConfig()
    opt, jopt = make_optimizer(topt_cfg), jax_make_optimizer(jopt_cfg)
    rules = ShardingRules(tcfg, mesh, ShardingConfig(fsdp_min_params=0))
    jrules = JaxShardingRules(jcfg, jax_abstract_mesh((4, 2), ("data",
                                                               "model")),
                              JaxShardingConfig(fsdp_min_params=0))
    ann = rules.annotator()
    assert ann.dp_size == 4

    for got, want in (
            (rules.state_shardings(zoo.state_specs(tcfg, opt)),
             jrules.state_shardings(jzoo.state_specs(jcfg, jopt))),
            (rules.batch_shardings(zoo.input_specs(tcfg, shape)),
             jrules.batch_shardings(jzoo.input_specs(jcfg, jshape)))):
        got = dict(tree_flatten_with_names(got))
        want = dict(jax_names(want))
        assert sorted(got) == sorted(want)
        for name, w in want.items():
            assert got[name].placements == _expected_placements(
                w.spec, ("data", "model")), name
    assert any(isinstance(p, Shard) for leaf in tree_leaves(
        rules.state_shardings(zoo.state_specs(tcfg, opt)))
        for p in leaf.placements)

    f32 = dict(TINY, dtype="float32")
    tcfg, jcfg = ModelConfig(**f32), JaxModelConfig(**f32)
    jp = jax.jit(lambda k: jzoo.init_params(jcfg, k))(jax.random.PRNGKey(0))
    jstate = {"params": jp, "opt": jopt.init(jp),
              "step": jnp.zeros((), jnp.int32)}
    tstate = zoo.state_from_numpy(tm.np_tree(jstate), "cpu")
    rng = np.random.default_rng(0)
    b = {"tokens": rng.integers(0, 512, (8, 64), dtype=np.int32),
         "labels": rng.integers(0, 512, (8, 64), dtype=np.int32)}
    jstate, jm = jax.jit(jzoo.make_train_step(jcfg, jopt, jopt_cfg,
                                              accum=2))(jstate, tm.to_jax(b))
    tstate, tmet = zoo.make_train_step(tcfg, opt, topt_cfg, accum=2,
                                       ann=ann)(tstate, tm.to_torch(b))
    _check_step(tstate, tmet, jstate, jm)
