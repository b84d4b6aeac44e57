"""The port's delta codec (``repro_torch.kernels.ckpt_delta``) against the
JAX package's, on the same numpy inputs made from a seed.

On the CPU every port wrapper takes its plain PyTorch version; the JAX
side runs its Pallas kernels in interpret mode and its numpy ``ref.py``.
Tolerance: none — the codec is IEEE float32 subtraction, addition, true
division, round-half-to-even and bit operations, so every output (d, r,
q, scales, decodes, per-leaf counts) must agree BIT FOR BIT with the
numpy oracle.  One exception, against the interpret-mode Pallas kernels
only: XLA:CPU compiles the int8 scale's ``amax / 127.0`` as a multiply by
the reciprocal, which differs from the IEEE quotient by one ulp for some
amax (4.5 % of random ones), so there an int8 scale may differ from the
port's (and the oracle's) by one ulp and a q by one step in that group;
every other output is still bit-equal.
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


# -- per-leaf encodes (kernels #5 and #6) ------------------------------------

LEAF_CASES = {"one": (1,), "group_minus_1": (GROUP - 1,),
              "group_plus_1": (GROUP + 1,), "three_groups_7": (3 * GROUP + 7,),
              "multi_dim": (3, 5, 70), "unchanged": (2 * GROUP,)}


def _leaf_pair(case: str):
    shape = LEAF_CASES[case]
    rng = np.random.default_rng(sorted(LEAF_CASES).index(case))
    base = rng.standard_normal(shape).astype(np.float32)
    if case == "unchanged":
        return base.copy(), base
    new = (base + rng.uniform(-1e-2, 1e-2, shape)).astype(np.float32)
    flat = new.reshape(-1)
    flat[::7] = -3.7 * base.reshape(-1)[::7]      # residual-bearing moves
    flat[3::11] = base.reshape(-1)[3::11]         # unchanged elements
    return new, base


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_per_leaf_lossless_encode_matches_jax(case):
    new, base = _leaf_pair(case)
    d, r, changed, nnz = tops.lossless_encode_leaf(_t(new), _t(base))
    jd, jr, jchanged, jnnz = jops.lossless_encode_leaf(
        jnp.asarray(new), jnp.asarray(base), interpret=True)
    od, orr = jref.lossless_encode_ref(jref.pack_flat_ref([new]),
                                       jref.pack_flat_ref([base]))
    for port, jx, oracle in ((d, jd, od), (r, jr, orr)):
        assert port.shape == (-(-new.size // GROUP) * GROUP,)
        assert np.array_equal(_bits(port), _bits(np.asarray(jx)))
        assert np.array_equal(_bits(port), _bits(oracle))
    assert bool(changed) == bool(jchanged) == (case != "unchanged")
    assert int(nnz) == int(jnnz) == int(np.count_nonzero(orr))
    if case != "unchanged" and new.size > 7:
        assert int(nnz) > 0                  # the residual path is exercised
    pd, pr = tref.lossless_encode(_t(jref.pack_flat_ref([new])),
                                  _t(jref.pack_flat_ref([base])))
    assert np.array_equal(_bits(pd), _bits(od))
    assert np.array_equal(_bits(pr), _bits(orr))
    jd2, jr2 = jops.lossless_encode(jnp.asarray(new), jnp.asarray(base),
                                    interpret=True)
    d2, r2 = tops.lossless_encode(_t(new), _t(base))
    assert np.array_equal(_bits(d2), _bits(np.asarray(jd2)))
    assert np.array_equal(_bits(r2), _bits(np.asarray(jr2)))


@pytest.mark.parametrize("case", sorted(LEAF_CASES))
def test_per_leaf_int8_encode_matches_jax(case):
    new, base = _leaf_pair(case)
    q, s, changed = tops.int8_encode_leaf(_t(new), _t(base))
    jq, js, jchanged = jops.int8_encode_leaf(jnp.asarray(new),
                                             jnp.asarray(base),
                                             interpret=True)
    oq, os_ = jref.encode_ref(new - base)
    # the numpy oracle: bit for bit
    assert np.array_equal(q.numpy(), oq)
    assert np.array_equal(_bits(s), _bits(os_))
    assert bool(changed) == bool(jchanged) == (case != "unchanged")
    # the interpret-mode kernel: scales within one ulp (reciprocal
    # multiply), q equal wherever the scale is, within one step elsewhere
    js, jq = np.asarray(js), np.asarray(jq)
    assert _ulps(s.numpy(), js).max() <= 1
    same = np.repeat(_bits(s) == _bits(js), GROUP)
    assert np.array_equal(q.numpy()[same], jq[same])
    assert np.abs(q.numpy().astype(np.int16) - jq.astype(np.int16)).max() <= 1
    pq, ps = tref.int8_encode(_t(jref.pack_flat_ref([new])),
                              _t(jref.pack_flat_ref([base])))
    assert np.array_equal(pq.numpy(), oq)
    assert np.array_equal(_bits(ps), _bits(os_))
    q2, s2 = tops.delta_encode(_t(new), _t(base))
    jq2, js2 = jops.delta_encode(jnp.asarray(new), jnp.asarray(base),
                                 interpret=True)
    assert np.array_equal(q2.numpy(), q.numpy())
    assert np.array_equal(_bits(s2), _bits(s))
    assert _ulps(s2.numpy(), np.asarray(js2)).max() <= 1


def test_int8_scale_follows_the_ieee_quotient():
    """A group whose amax (bits 1092078281, 9.487008) is one where
    ``amax * (1/127)`` and the IEEE ``amax / 127`` differ by one ulp: the
    port's scale is the oracle's IEEE quotient, and the interpret-mode
    kernel's stays within the one ulp the tolerance above allows."""
    new = np.zeros(GROUP, np.float32)
    new[17] = np.array(1092078281, np.int32).view(np.float32)
    base = np.zeros(GROUP, np.float32)
    _, s = tops.delta_encode(_t(new), _t(base))
    _, os_ = jref.encode_ref(new - base)
    _, js = jops.delta_encode(jnp.asarray(new), jnp.asarray(base),
                              interpret=True)
    assert _bits(s)[0] == _bits(os_)[0] == \
        _bits(np.float32(new[17]) / np.float32(127.0))
    assert _ulps(s.numpy(), np.asarray(js)).max() <= 1


def test_per_leaf_wrappers_count_no_launch_on_the_cpu():
    tops.reset_launch_counts()
    x = torch.ones(5, 7)
    tops.lossless_encode_leaf(x, x)
    tops.int8_encode_leaf(x, x)
    counts = tops.launch_counts()
    assert counts["lossless_encode"] == counts["delta_encode"] == 0
    assert set(counts) == {"flat_lossless_encode", "flat_int8_encode",
                           "lossless_decode", "delta_decode",
                           "lossless_encode", "delta_encode"}
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.lossless_encode(torch.zeros(GROUP), torch.zeros(GROUP))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tkernel.int8_encode(torch.zeros(GROUP), torch.zeros(GROUP))
    assert tkernel._lib is None
