"""The port's Phase-2 launcher (``repro_torch.launch.profile_run``) against
the JAX package's ``repro.launch.profile_run``: the same JSON, bit for
bit, from the torch lane engine (CPU) and from the ``--sequential``
oracle path; its default ``--out`` is not the JAX
package's ``experiments/profiling.json``, and ``--device`` defaults to
cuda."""
import json
import sys

import pytest

ARGS = ["--ci", "10,60", "--record-seconds", "3600"]


def _reference(monkeypatch, tmp_path, *extra) -> tuple:
    from repro.launch import profile_run

    path = tmp_path / "reference.json"
    monkeypatch.setattr(sys, "argv", ["profile_run", *ARGS, *extra,
                                      "--out", str(path)])
    profile_run.main()
    return json.loads(path.read_text()), path.read_bytes()


def test_batched_launcher_matches_the_reference(monkeypatch, tmp_path):
    from repro_torch.launch import profile_run

    want, want_bytes = _reference(monkeypatch, tmp_path)
    path = tmp_path / "port.json"
    got = profile_run.main([*ARGS, "--device", "cpu", "--out", str(path)])
    assert json.loads(path.read_text()) == got == want
    assert path.read_bytes() == want_bytes
    assert got["phases"] == ["steady_state", "profiled"]
    assert len(got["recoveries"]) == 5 and len(got["recoveries"][0]) == 2


def test_sequential_launcher_matches_the_reference(monkeypatch, tmp_path):
    from repro_torch.launch import profile_run

    want, want_bytes = _reference(monkeypatch, tmp_path, "--sequential")
    path = tmp_path / "port.json"
    got = profile_run.main([*ARGS, "--sequential", "--out", str(path)])
    assert got == want and path.read_bytes() == want_bytes


def test_default_out_is_the_port_own(monkeypatch, tmp_path):
    from repro_torch.launch import profile_run

    assert profile_run.DEFAULT_OUT != "experiments/profiling.json"
    monkeypatch.chdir(tmp_path)
    profile_run.main(["--ci", "30", "--failure-points", "2",
                      "--record-seconds", "1800", "--sequential"])
    assert (tmp_path / "experiments" / "profiling_torch.json").is_file()
    assert not (tmp_path / "experiments" / "profiling.json").exists()


def test_device_defaults_to_cuda(monkeypatch, tmp_path):
    """The batched grid asks for the CUDA device unless told otherwise."""
    from repro_torch.launch import profile_run

    asked = []

    def resolve(device):
        asked.append(device)
        raise SystemExit(0)

    monkeypatch.setattr("repro_torch.sim.device.resolve_device", resolve)
    with pytest.raises(SystemExit):
        profile_run.main([*ARGS, "--out", str(tmp_path / "p.json")])
    assert asked == ["cuda"]
