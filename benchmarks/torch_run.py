"""Benchmark runner of the PyTorch port — the twin of ``run.py``.

    PYTHONPATH=src python benchmarks/torch_run.py --smoke [--device cpu]

``--smoke`` runs the seven drill twins of ``run.py --smoke``, in its order,
each on the port (the lane engine and the states on the CUDA device
unless ``--device`` names another):

  1. ``torch_bench_ckpt.smoke``: the E5 checkpoint bench on tiny states
     (device-placement delta encodes included, a micro trainer on an
     ``encode_placement="device"`` plan), its ``bench_ckpt/3`` artifact
     validated and loaded by ``SimCostModel.from_calibration``;
  2. ``torch_bench_proactive.smoke``: the proactive-control drill (a
     forecast-driven plan switch before the peak, an anomaly-triggered
     ``reprofile`` re-entry in the phase log);
  3. ``torch_bench_campaign.device_section(smoke=True)``: the torch lane
     engine's throughput point and its parity matrix against the NumPy
     lanes (no divergent lane);
  4. ``torch_bench_recovery.smoke``: reduced E4 through the scalar and the
     lane engine, the ``bench_sim/3`` artifact (embedding 2 and 3)
     validated;
  5. ``torch_bench_replication.smoke``: the k=1 kill-host drill (degraded
     partial restore bit-exact, ``restored_bytes < full_state_bytes``),
     rep0 degrading to remote, the peer-loss worst case, and the
     optimizer's ``replication_factor`` dimension;
  6. ``torch_bench_runtime.smoke``: all three Khaos phases on a 4-lane
     controller-in-the-loop campaign and a micro trainer's plan switch;
  7. ``torch_bench_fleet.smoke``: a 3-job fleet (one cold admit, one
     transfer admit, one firehose rejected), its ``bench_fleet/1``
     artifact validated.

It exits with 1 on the first ``ValueError``/``AssertionError``.  The full
mode of ``run.py`` is not twinned yet: E1/E2 (``bench_tables.py``),
``bench_khaos_training.py`` and ``bench_dryrun.py`` have no port.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import tempfile
import time
from typing import Any, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def _sibling(name: str):
    """A benchmark module beside this one (loaded by path once)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[name] = mod
    return sys.modules[name]


def smoke(tmpdir: str, device: Any = None,
          device_sec: Optional[dict] = None) -> dict:
    """The seven drills, in ``run.py --smoke``'s order, with their scratch
    directories under ``tmpdir``.  ``device_sec`` (an E12 "device" section
    measured by the caller, e.g. at full size) replaces drill 3 and is the
    section drill 4's artifact embeds.  Returns each drill's result and
    seconds."""
    out: dict = {"seconds": {}}

    def drill(name: str, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        out["seconds"][name] = time.perf_counter() - t0
        return out[name]

    drill("ckpt", lambda: _sibling("torch_bench_ckpt").smoke(
        os.path.join(tmpdir, "ckpt"), device=device))
    proactive = drill("proactive", lambda: _sibling(
        "torch_bench_proactive").smoke(device=device))
    if device_sec is None:
        device_sec = drill("campaign", lambda: _sibling(
            "torch_bench_campaign").device_section(smoke=True,
                                                   device=device))
    drill("recovery", lambda: _sibling("torch_bench_recovery").smoke(
        os.path.join(tmpdir, "sim"), proactive=proactive,
        device_sec=device_sec, device=device))
    drill("replication", lambda: _sibling("torch_bench_replication").smoke(
        tmpdir, device=device))
    drill("runtime", lambda: _sibling("torch_bench_runtime").smoke(
        os.path.join(tmpdir, "runtime"), device=device))
    drill("fleet", lambda: _sibling("torch_bench_fleet").smoke(
        os.path.join(tmpdir, "fleet"), engine="device", device=device))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the seven drill twins (the only mode ported)")
    ap.add_argument("--device", default=None,
                    help="torch device of the drills (default: cuda)")
    args = ap.parse_args()
    if not args.smoke:
        ap.error("only --smoke is ported: E1/E2, bench_khaos_training and "
                 "bench_dryrun have no twins yet")
    t0 = time.monotonic()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            out = smoke(tmp, device=args.device)
    except (ValueError, AssertionError) as e:
        print(f"SMOKE FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    secs = ", ".join(f"{k} {v:.1f}s" for k, v in out["seconds"].items())
    print(f"smoke done in {time.monotonic() - t0:.0f}s ({secs})")


if __name__ == "__main__":
    main()
