"""The port's job configuration against the JAX package's: the assigned
shapes and ``applicable_shapes`` for every arch, the ``ShardingConfig`` /
``CheckpointConfig`` / ``JobConfig`` defaults, ``CheckpointConfig.to_plan``
field for field, and ``JobConfig.to_json`` string for string."""
import dataclasses

import pytest

from repro import config as jc
from repro.configs import get_config as jax_get_config
from repro_torch import config as tc
from repro_torch.configs import ARCH_IDS, get_config

SHAPE_NAMES = ("TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K")


def _fields(obj) -> list:
    return [(f.name, getattr(obj, f.name)) for f in dataclasses.fields(obj)]


def test_shapes_are_the_references():
    for name in SHAPE_NAMES:
        assert _fields(getattr(tc, name)) == _fields(getattr(jc, name))
    assert [_fields(s) for s in tc.ALL_SHAPES] == \
        [_fields(s) for s in jc.ALL_SHAPES]
    assert sorted(tc.SHAPES_BY_NAME) == sorted(jc.SHAPES_BY_NAME)
    for name, s in tc.SHAPES_BY_NAME.items():
        assert _fields(s) == _fields(jc.SHAPES_BY_NAME[name])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_applicable_shapes_match_jax(arch):
    got = [s.name for s in tc.applicable_shapes(get_config(arch))]
    want = [s.name for s in jc.applicable_shapes(jax_get_config(arch))]
    assert got == want
    assert ("long_500k" in got) == (get_config(arch).family
                                    in ("ssm", "hybrid"))


@pytest.mark.parametrize("name", ["ShardingConfig", "CheckpointConfig",
                                  "MeshConfig", "OptimizerConfig",
                                  "KhaosConfig"])
def test_defaults_match_jax(name):
    got, want = getattr(tc, name)(), getattr(jc, name)()
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert _fields(got) == _fields(want)


def test_job_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(tc.JobConfig)] == \
        [f.name for f in dataclasses.fields(jc.JobConfig)]
    job = tc.JobConfig(model=get_config("yi-6b"), shape=tc.TRAIN_4K)
    assert job.seed == 0 and job.sharding == tc.ShardingConfig()


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("incremental", [False, True])
def test_checkpoint_config_to_plan_matches_jax(mode, incremental):
    kw = dict(directory="ckpt", interval_seconds=45.0, mode=mode,
              levels=("memory", "local", "remote"), incremental=incremental,
              full_every=4, keep=2)
    got = tc.CheckpointConfig(**kw).to_plan()
    want = jc.CheckpointConfig(**kw).to_plan()
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert _fields(got) == _fields(want)
    assert got.name == want.name
    assert got.mode == ("incremental" if incremental else "full")
    assert got.sync == (mode == "sync")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_job_config_to_json_matches_jax(arch):
    for tshape, jshape in zip(tc.applicable_shapes(get_config(arch)),
                              jc.applicable_shapes(jax_get_config(arch))):
        got = tc.JobConfig(model=get_config(arch), shape=tshape,
                           sharding=tc.ShardingConfig(gradient_accum=4),
                           seed=3).to_json()
        want = jc.JobConfig(model=jax_get_config(arch), shape=jshape,
                            sharding=jc.ShardingConfig(gradient_accum=4),
                            seed=3).to_json()
        assert got == want
