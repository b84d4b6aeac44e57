"""The production paths of the port's launchers (``launch/train.py`` and
``launch/serve.py`` without ``--local``): on a ``fake`` process group of
256 (or 512) ranks they build the step as the dry run's ``build_cell``
does and print its dry-run record; with no group, or a group of the wrong
size, they exit non-zero with the mesh's own message; ``--local`` is
unchanged."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch.distributed as dist

from repro_torch.launch import dryrun, serve, train

ROOT = Path(__file__).resolve().parents[1]


def _printed_record(out: str, mode: str) -> dict:
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith(f"{mode} step: ")]
    return json.loads(line[len(f"{mode} step: "):])


def test_train_production_path_prints_the_record(capsys):
    with dryrun.fake_group(256):
        rec = train.main(["--arch", "whisper-small", "--device", "cpu"])
    assert not dist.is_initialized()
    assert _printed_record(capsys.readouterr().out, "train") == rec
    assert (rec["arch"], rec["shape"], rec["mesh"]) == \
        ("whisper-small", "train_4k", "16x16")
    assert rec["plan"] == dryrun.default_plan("whisper-small", "train_4k", 16)
    for key in ("arg_gb_per_dev", "temp_gb_per_dev", "output_gb_per_dev",
                "alias_gb_per_dev", "hbm_gb_per_dev", "bound_step_s"):
        assert rec[key] > 0, key
    assert rec["fits_80gb"] is True


@pytest.mark.parametrize("multi", [False, True])
def test_serve_production_path_is_the_dry_run_cell(multi, capsys):
    argv = ["--arch", "yi-6b", "--device", "cpu"] + \
        (["--multi-pod"] if multi else [])
    with dryrun.fake_group(512 if multi else 256):
        rec = serve.main(argv)
        want = dryrun.run_cell("yi-6b", "decode_32k", multi)
    assert _printed_record(capsys.readouterr().out, "decode") == rec
    assert rec.pop("trace_s") >= 0 and want.pop("trace_s") >= 0
    assert rec == want
    assert rec["mesh"] == ("2x16x16" if multi else "16x16")


def test_no_group_exits_with_the_mesh_message():
    assert not dist.is_initialized()
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", "yi-6b", "--device", "cpu"])
    assert "needs an initialised process group of 256 ranks" in \
        str(e.value.code)
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT")}
    env["PYTHONPATH"] = str(ROOT / "src")
    for mod in ("train", "serve"):
        proc = subprocess.run(
            [sys.executable, "-m", f"repro_torch.launch.{mod}", "--arch",
             "yi-6b", "--multi-pod", "--device", "cpu"],
            capture_output=True, text=True, env=env, timeout=120)
        assert proc.returncode == 1, (mod, proc.stderr[-2000:])
        assert "needs an initialised process group of 512 ranks" in \
            proc.stderr, proc.stderr[-2000:]


def test_a_group_of_the_wrong_size_is_not_shrunk_to():
    with dryrun.fake_group(8):
        for main in (train.main, serve.main):
            with pytest.raises(SystemExit) as e:
                main(["--arch", "yi-6b", "--device", "cpu"])
            assert "needs 256 ranks; the process group has 8" in \
                str(e.value.code)


def test_local_paths_are_unchanged(tmp_path):
    out = serve.main(["--arch", "yi-6b", "--local", "--device", "cpu"])
    assert sorted(out) == [0, 1, 2, 3]
    assert all(len(v) == 8 for v in out.values())
    summary = train.main(["--arch", "yi-6b", "--local", "--device", "cpu",
                          "--duration", "5", "--ckpt-dir",
                          str(tmp_path / "ckpt")])
    assert summary["final_step"] > 0
