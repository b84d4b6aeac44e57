"""The port's delta codec (``repro_torch.kernels.ckpt_delta``) against the
JAX package's, on the same numpy inputs made from a seed.

On the CPU every port wrapper takes its plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode and its numpy ``ref.py``.
Tolerance: none — the codec is IEEE float32 subtraction, addition, true
division, round-half-to-even and bit operations, so every output (d, r,
q, scales, decodes, per-leaf counts) must agree BIT FOR BIT.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import DeltaLeafSource as JaxDeltaLeafSource
from repro.checkpoint import DeviceDeltaBase as JaxDeviceDeltaBase
from repro.checkpoint import FlatLayout as JaxFlatLayout
from repro.kernels.ckpt_delta import ops as jops
from repro.kernels.ckpt_delta import ref as jref
from repro_torch.checkpoint.pipeline import (DeltaLeafSource,
                                             DeviceDeltaBase, FlatLayout)
from repro_torch.kernels.ckpt_delta import kernel as tkernel
from repro_torch.kernels.ckpt_delta import ops as tops
from repro_torch.kernels.ckpt_delta import ref as tref

GROUP = 1024

jax.config.update("jax_platform_name", "cpu")


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def _bits(x) -> np.ndarray:
    a = np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)
    return a.view(np.uint32) if a.dtype in (np.float32, np.int32) else a


def _case(name: str):
    """(sizes, new leaves, base leaves) for one layout case."""
    rng = np.random.default_rng({"awkward": 7, "padded": 8,
                                 "residual": 9}[name])
    if name == "awkward":            # odd, tiny and one-group leaves
        sizes = [3000, 256, 1, 5000, GROUP]
    elif name == "padded":           # 11 groups, none a block multiple
        sizes = [11 * GROUP - 5]
    else:                            # residual-bearing: large rel. moves
        sizes = [2 * GROUP, 700]
    base = [rng.standard_normal((s,)).astype(np.float32) for s in sizes]
    new = [b + rng.uniform(-1e-2, 1e-2, b.shape).astype(np.float32)
           for b in base]
    if name == "awkward":
        new[1] = base[1].copy()      # one unchanged leaf
    if name == "residual":
        # sign flips and >2x moves make base + (new - base) round away
        new[0][::7] = -3.7 * base[0][::7]
        new[1][::5] = base[1][::5] * 1e4
    return sizes, new, base


CASES = ["awkward", "padded", "residual"]


@pytest.mark.parametrize("case", CASES)
def test_flat_encodes_match_jax_bit_for_bit(case):
    sizes, new, base = _case(case)
    nl = len(sizes)
    layout = JaxFlatLayout([(f"l{i}", (s,)) for i, s in enumerate(sizes)])
    tlayout = FlatLayout([(f"l{i}", (s,)) for i, s in enumerate(sizes)])
    assert np.array_equal(tlayout.group_leaf, layout.group_leaf)
    nf_ref, bf_ref = jref.pack_flat_ref(new), jref.pack_flat_ref(base)
    nf = tops.pack_flat([_t(x) for x in new])
    bf = tops.pack_flat([_t(x) for x in base])
    assert np.array_equal(_bits(nf), _bits(nf_ref))
    gl = tlayout.group_leaf_device("cpu")

    d, r, lc, lz = tops.flat_lossless_encode(nf, bf, gl, nl)
    jd, jr, jlc, jlz = jops.flat_lossless_encode(
        jnp.asarray(nf_ref), jnp.asarray(bf_ref), layout.group_leaf_device(),
        num_leaves=nl, interpret=True)
    rd, rr, rlc, rlz = jref.flat_lossless_encode_ref(nf_ref, bf_ref,
                                                     layout.group_leaf, nl)
    for port, jx, oracle in ((d, jd, rd), (r, jr, rr), (lc, jlc, rlc),
                             (lz, jlz, rlz)):
        assert np.array_equal(_bits(port), _bits(np.asarray(jx)))
        assert np.array_equal(_bits(port), _bits(oracle.astype(
            np.asarray(jx).dtype)))
    if case == "residual":
        assert int(lz.sum()) > 0          # the residual path is exercised
    if case == "awkward":
        assert int(lc[1]) == 0 and bool(lc[[0, 2, 3, 4]].all())

    q, s, lc2 = tops.flat_int8_encode(nf, bf, gl, nl)
    jq, js, jlc2 = jops.flat_int8_encode(
        jnp.asarray(nf_ref), jnp.asarray(bf_ref), layout.group_leaf_device(),
        num_leaves=nl, interpret=True)
    rq, rs, _ = jref.flat_int8_encode_ref(nf_ref, bf_ref, layout.group_leaf,
                                          nl)
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(q.numpy(), rq)
    assert np.array_equal(_bits(s), _bits(np.asarray(js)))
    assert np.array_equal(_bits(s), _bits(rs))
    assert np.array_equal(lc2.numpy(), np.asarray(jlc2))


@pytest.mark.parametrize("case", CASES)
def test_decodes_match_jax_bit_for_bit(case):
    _, new, base = _case(case)
    nf = jref.pack_flat_ref(new)
    bf = jref.pack_flat_ref(base)
    d, r = jref.lossless_encode_ref(nf, bf)
    out = tops.lossless_decode(_t(bf), _t(d), _t(r.view(np.int32)))
    jout = jops.lossless_decode(jnp.asarray(bf), jnp.asarray(d),
                                jnp.asarray(r), interpret=True)
    assert np.array_equal(_bits(out), _bits(np.asarray(jout)))
    assert np.array_equal(_bits(out), _bits(nf))          # original bits
    q, s = jref.encode_ref(nf - bf)
    dq = tops.delta_decode(_t(q), _t(s))
    jdq = jops.delta_decode(jnp.asarray(q), jnp.asarray(s), interpret=True)
    assert np.array_equal(_bits(dq), _bits(np.asarray(jdq)))
    assert np.array_equal(_bits(dq), _bits(jref.decode_ref(q, s)))


def test_decode_pads_awkward_lengths():
    """The wrappers take any length (a per-leaf decode): inputs are
    zero-padded to whole groups and the lossless output sliced back."""
    rng = np.random.default_rng(3)
    base = rng.standard_normal(1500).astype(np.float32)
    new = (base * 1.5).astype(np.float32)
    d, r = jref.lossless_encode_ref(new, base)
    out = tops.lossless_decode(_t(base), _t(d), _t(r.view(np.int32)))
    assert out.shape == (1500,)
    assert np.array_equal(_bits(out), _bits(new))
    q, s = jref.encode_ref(new - base)                # padded payload
    got = tops.delta_decode(_t(q[:1500]), _t(s))
    assert got.shape == (2 * GROUP,)
    assert np.array_equal(_bits(got), _bits(jref.decode_ref(q, s)))


def _sources(codec, s0, s1):
    """The port's and the JAX package's device delta sources for the same
    state pair (port tensors on the CPU, JAX arrays on its CPU device)."""
    tsrc = DeltaLeafSource({k: _t(v) for k, v in s1.items()},
                           DeviceDeltaBase({k: _t(v) for k, v in s0.items()}),
                           codec=codec)
    jsrc = JaxDeltaLeafSource(
        {k: jnp.asarray(v) for k, v in s1.items()},
        JaxDeviceDeltaBase({k: jnp.asarray(v) for k, v in s0.items()}),
        codec=codec)
    return tsrc, jsrc


def _payload_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    for k in a:
        if isinstance(a[k], str) or isinstance(b[k], str):
            if a[k] != b[k]:
                return False
        elif not np.array_equal(_bits(a[k]), _bits(b[k])):
            return False
    return True


def test_all_zero_residual_skips_transfer_like_jax():
    rng = np.random.default_rng(11)
    base_w = rng.standard_normal((8 * GROUP,)).astype(np.float32)
    s0 = {"w": base_w}
    s1 = {"w": base_w + np.float32(1e-4)}
    tsrc, jsrc = _sources("lossless", s0, s1)
    tp, jp = tsrc.flat_payload(), jsrc.flat_payload()
    assert tp["r"] == "zero" and jp["r"] == "zero"
    assert _payload_equal(tp, jp)
    assert tsrc.bytes_on_link() == jsrc.bytes_on_link() == 8 * GROUP * 4


@pytest.mark.parametrize("codec", ["lossless", "int8"])
def test_all_unchanged_state_moves_no_payload_like_jax(codec):
    rng = np.random.default_rng(2)
    s0 = {"a": rng.standard_normal(3000).astype(np.float32),
          "b": rng.standard_normal((4, 5)).astype(np.float32)}
    tsrc, jsrc = _sources(codec, s0, s0)
    assert tsrc.flat_payload() == {} and jsrc.flat_payload() == {}
    assert tsrc.zero_names == jsrc.zero_names == ("a", "b")
    assert tsrc.bytes_on_link() == jsrc.bytes_on_link() == 0


@pytest.mark.parametrize("codec", ["lossless", "int8"])
def test_delta_sources_match_jax(codec):
    _, new, base = _case("residual")
    s0 = {f"l{i}": b for i, b in enumerate(base)}
    s1 = {f"l{i}": n for i, n in enumerate(new)}
    tsrc, jsrc = _sources(codec, s0, s1)
    assert tsrc.layout.to_manifest() == jsrc.layout.to_manifest()
    assert _payload_equal(tsrc.flat_payload(), jsrc.flat_payload())
    assert tsrc.zero_names == jsrc.zero_names
    assert tsrc.bytes_on_link() == jsrc.bytes_on_link()


def test_int8_roundtrip_error_within_group_bound():
    """|err| <= max|delta_group| / 254 per element (scale = amax/127,
    round to nearest)."""
    rng = np.random.default_rng(5)
    base = rng.standard_normal(4 * GROUP).astype(np.float32)
    new = (base + rng.uniform(-0.01, 0.01, base.shape)).astype(np.float32)
    q, s, _ = tref.int8_encode_groups(_t(new), _t(base))
    got = tops.delta_decode(q, s).numpy()
    delta = new - base
    amax = np.abs(delta.reshape(-1, GROUP)).max(axis=1)
    bound = np.repeat(np.maximum(amax, 1e-12) / 254.0, GROUP)
    assert (np.abs(got - delta) <= bound + 1e-9).all()


def test_wrappers_take_plain_version_only_for_cpu_tensors():
    tops.reset_launch_counts()
    x = torch.zeros(GROUP)
    gl = torch.zeros(1, dtype=torch.int64)
    tops.flat_lossless_encode(x, x, gl, 1)
    tops.flat_int8_encode(x, x, gl, 1)
    tops.lossless_decode(x, x, torch.zeros(GROUP, dtype=torch.int32))
    tops.delta_decode(torch.zeros(GROUP, dtype=torch.int8), torch.ones(1))
    # the plain versions ran: no kernel launch was counted
    assert set(tops.launch_counts().values()) == {0}
    with pytest.raises(ValueError, match="no ckpt_delta implementation"):
        tops.flat_lossless_encode(x.to("meta"), x.to("meta"), gl, 1)


def test_kernel_launchers_reject_cpu_tensors_without_building():
    """The CUDA launchers validate before they build or load anything, so
    a CPU tensor is refused here, where there is no nvcc."""
    x = torch.zeros(GROUP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.lossless_encode_groups(x, x)
    with pytest.raises(ValueError, match="multiple of GROUP"):
        tkernel.int8_encode_groups(torch.zeros(GROUP + 1), x)
    assert tkernel._lib is None
    assert tkernel.library_path().parent == tkernel.BUILD_DIR
