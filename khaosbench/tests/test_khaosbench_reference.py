"""The float32 reference against the port at the SMOKE sizes on the CPU
(the trainer's first steps, and the int8 codec's payload decoded), and
the control: the reference in float8 in the program's place fails the
configured limits.  The benchmark's weights at the SMOKE sizes are pinned
by a checksum."""
import hashlib
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from khaosbench import spec  # noqa: E402
from khaosbench.control import readings  # noqa: E402
from khaosbench.reference.codec import worst_error_over_bound  # noqa: E402
from khaosbench.reference.tree import flatten  # noqa: E402
from khaosbench.weights import make_params  # noqa: E402
from smoke_cells import smoke_config  # noqa: E402

CONFIGS = ["yi-6b.2l", "olmoe-1b-7b.1l"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_follows_the_port_in_float32(name):
    r = readings(smoke_config(name, "float32"), 2 ** 31 + 5, "cpu")
    p = r["program"]
    assert p["token_mismatch"] == 0
    assert p["loss_gap"] < 1e-5
    assert p["grad_norm_gap"] < 1e-4 and p["change_norm_gap"] < 1e-4


# sha256 over each leaf's name and float32 bytes, in the tree's order, of
# the weights made from seed 7 on the CPU at the SMOKE sizes
SMOKE_WEIGHTS = {
    "yi-6b.2l":
        "b12d244652be35ae61d2cdd9fed45e5931f760e64b7b79827df4fa2ee7f09ecf",
    "olmoe-1b-7b.1l":
        "97939208f0c2470bdbcd80464f5edaf0fbb4ffe6d527f50647d9f1f22849e3cc"}


@pytest.mark.parametrize("name", sorted(SMOKE_WEIGHTS))
def test_smoke_weights_are_unchanged(name):
    cfg = smoke_config(name)
    params = make_params(spec.model(cfg["model"]).param_shapes(cfg), 7, "cpu")
    h = hashlib.sha256()
    for leaf, x in flatten(params):
        h.update(leaf.encode())
        h.update(x.numpy().tobytes())
    assert h.hexdigest() == SMOKE_WEIGHTS[name]


CELL_CONFIGS = [c["name"] for c in json.loads(
    (ROOT / "BENCHMARK.json").read_text())["configs"]]


@pytest.mark.parametrize("name", CELL_CONFIGS)
def test_control_in_float8_fails_the_limits(name):
    limits = json.loads((ROOT / "khaosbench" / "configs"
                         / f"{name}.json").read_text())["limits"]
    r = readings(smoke_config(name, "bfloat16"), 7, "cpu")
    assert any(r["control"][k] > lim for k, lim in limits.items()), r


def test_port_int8_payload_decodes_within_the_codec_bound():
    from repro_torch.kernels.ckpt_delta.ops import flat_int8_encode

    g = torch.Generator().manual_seed(0)
    base = torch.randn(8 * 1024, generator=g)
    new = base + 1e-3 * torch.randn(8 * 1024, generator=g)
    new[5000:6000] = base[5000:6000]                # an unchanged group
    q, s, _ = flat_int8_encode(new, base, torch.zeros(8, dtype=torch.long),
                               1)
    assert worst_error_over_bound(new, base, q, s) <= 1.0
    bad = q.clone()
    bad[17] = bad[17] + (1 if bad[17] < 127 else -1)
    assert worst_error_over_bound(new, base, bad, s) > 1.0
