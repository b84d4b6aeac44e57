"""The port's roofline (``repro_torch.roofline``) against the JAX
package's ``repro.roofline``.

* ``ModelConfig.active_param_count`` and ``model_flops`` for all ten
  configs x the four assigned shapes: equal to the reference as integers
  (both are integer arithmetic on the same configs);
* ``roofline_terms`` dict-equal to the reference's on the same costs, with
  ``repro.roofline``'s three constants monkeypatched to the port's H100
  constants inside the test (the JAX package is not edited);
* ``count_step`` on hand-built matmul chains on ``meta`` tensors: flops
  exactly the sum of 2·m·k·n, bytes exactly the inputs and outputs of
  each product (views move nothing), both over ``n_dev``;
* ``collective_costs`` on a hand-counted two-weight model.
"""
import math

import pytest
import torch

import repro.roofline as jax_roofline
from repro.config import ALL_SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro_torch import roofline
from repro_torch.config import ALL_SHAPES, ModelConfig, ShardingConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_abstract_mesh
from repro_torch.sharding import ShardingRules


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert isinstance(cfg.active_param_count(), int)
    for shape, jshape in zip(ALL_SHAPES, JAX_SHAPES):
        assert shape.name == jshape.name
        got = roofline.model_flops(cfg, shape)
        want = jax_roofline.model_flops(jcfg, jshape)
        assert got == want and float(got).is_integer(), (arch, shape.name)
    if cfg.family == "moe":
        assert cfg.active_param_count() < cfg.param_count()


def test_the_constants_are_one_h100_sxm():
    assert roofline.PEAK_FLOPS == 989e12
    assert roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9


COSTS = [(1e12, 1e9, 1e6, {"all-reduce": 1e6}),
         (1e9, 5e12, 2e9, {"all-gather": 1.5e9, "all-reduce": 5e8}),
         (1e9, 1e9, 4e11, {"all-to-all": 4e11}),
         (0.0, 0.0, 0.0, {})]


@pytest.mark.parametrize("flops,nbytes,coll,by_type", COSTS)
def test_roofline_terms_equal_the_reference(monkeypatch, flops, nbytes,
                                            coll, by_type):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(jax_roofline, name, getattr(roofline, name))
    got = roofline.roofline_terms(roofline.StepCosts(flops, nbytes, coll,
                                                     dict(by_type)))
    want = jax_roofline.roofline_terms(jax_roofline.HloCosts(
        flops, nbytes, coll, dict(by_type)))
    assert got == want


def test_step_costs_add_like_hlo_costs():
    a, b = roofline.StepCosts(1, 2, 3, {"x": 1.0}), \
        roofline.StepCosts(4, 5, 6, {"x": 2.0, "y": 3.0})
    ja, jb = jax_roofline.HloCosts(1, 2, 3, {"x": 1.0}), \
        jax_roofline.HloCosts(4, 5, 6, {"x": 2.0, "y": 3.0})
    a.add(b, 3.0)
    ja.add(jb, 3.0)
    assert (a.flops, a.bytes, a.collective_bytes, a.by_type) == \
        (ja.flops, ja.bytes, ja.collective_bytes, ja.by_type)


CHAINS = [[(64, 32), (32, 48)],
          [(7, 5), (5, 11), (11, 3)],
          [(128, 256), (256, 64), (64, 64), (64, 512)]]


@pytest.mark.parametrize("dims", CHAINS)
@pytest.mark.parametrize("n_dev", [1, 8])
def test_count_step_counts_a_matmul_chain(dims, n_dev):
    """x @ W1 @ W2 ...: flops = sum of 2·m·k·n; bytes = each product's
    operands and result (f32); the transposes are views (no bytes)."""
    mats = [_meta(*s) for s in dims]

    def chain(*ms):
        x = ms[0]
        for w in ms[1:]:
            x = x @ w.t().t()
        return x
    costs = roofline.count_step(chain, *mats, n_dev=n_dev)
    flops = nbytes = 0
    m, k = dims[0]
    for k2, n in dims[1:]:
        assert k2 == k
        flops += 2 * m * k * n
        nbytes += 4 * (m * k + k * n + m * n)
        k = n
    assert costs.flops == flops / n_dev
    assert costs.bytes == nbytes / n_dev
    assert costs.collective_bytes == 0 and costs.by_type == {}


def test_count_step_counts_batched_products_and_einsum():
    a, b = _meta(4, 8, 16, dtype=torch.bfloat16), \
        _meta(4, 16, 32, dtype=torch.bfloat16)
    w = _meta(16, 5, 6, dtype=torch.bfloat16)

    def fn(a, b, w):
        return torch.bmm(a, b), torch.einsum("bsd,dnh->bsnh", a, w)
    costs = roofline.count_step(fn, a, b, w)
    assert costs.flops == 2 * 4 * 8 * 16 * 32 + 2 * 4 * 8 * 16 * 5 * 6


def test_trace_excludes_constants_and_keeps_the_peak():
    """An op reading a host tensor is a constant brought in (no bytes);
    the peak counts the storages the step makes, its outputs excluded."""
    x = _meta(1000)
    table = torch.ones(10)

    def fn(x):
        table.to("meta")                # a constant: skipped
        y = x * 2.0                     # 4000 B, freed below
        z = y + 1.0                     # 4000 B, the output
        del y
        return z
    t = roofline.trace_step(fn, x)
    assert t.bytes == 4 * 1000 * 4
    assert t.output_bytes == 4000
    assert t.peak_bytes == 4000          # y alone, z being the output


def test_collective_costs_of_a_hand_counted_model():
    """A tiny dense config on a (4, 2) mesh with FSDP on: the FSDP
    gathers, the reduce-scatters and the TP all-reduces, counted by
    hand from the placements."""
    cfg = ModelConfig(name="t", family="dense", num_layers=2, d_model=128,
                      num_heads=4, num_kv_heads=2, d_ff=256, vocab_size=512)
    mesh = make_abstract_mesh((4, 2), ("data", "model"))
    rules = ShardingRules(cfg, mesh, ShardingConfig(fsdp_min_params=0))
    from repro_torch.models import zoo
    from repro_torch.config import ShapeConfig
    params = zoo.init_params(cfg, torch.Generator(), "meta")
    batch = zoo.input_specs(cfg, ShapeConfig("t", "train", 64, 8))
    c = roofline.collective_costs(rules, params, batch, mode="train",
                                  accum=2)
    # local (fsdp 4 x tp 2) shard elements of the sharded weights
    shard = (512 * 128 * 2 + 2 * (128 * 4 * 32 + 2 * 128 * 2 * 32
                                  + 4 * 32 * 128 + 3 * 128 * 256)) // 8
    assert c.by_type["all-gather"] == 2 * 2 * 4 * shard       # fwd+bwd, x2
    assert c.by_type["reduce-scatter"] == 2 * 4 * shard * 4
    tokens = 8 // 2 // 4 * 64                 # a microbatch's rows per rank
    act = tokens * 128 * 2                    # bf16 (tokens, d)
    norms = (2 * 2 * 128 + 128) * 4           # replicated: all-reduced
    # per microbatch: wo and w_down fwd+bwd per layer, the embedding's
    # lookup, the logits' backward
    tp = (2 * 2 * 2 + 1 + 1) * act
    assert c.by_type["all-reduce"] == 2 * (norms + tp)
    assert c.collective_bytes == math.fsum(c.by_type.values())
    dec = roofline.collective_costs(rules, params, batch, mode="prefill")
    assert "reduce-scatter" not in dec.by_type
    assert dec.by_type["all-gather"] == 4 * shard
