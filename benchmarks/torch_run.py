"""Benchmark runner of the PyTorch port — the twin of ``run.py``.

    PYTHONPATH=src python benchmarks/torch_run.py [--quick | --smoke] \\
        [--device cpu]

Without ``--smoke`` it runs ``run.py``'s full mode, section by section in
its order, each on the port (the lane engines and the states on the CUDA
device unless ``--device`` names another):

  E1   ``torch_bench_tables.bench_iot_vehicles``: Table II (IoT-Vehicles
       analogue), Khaos against the static CIs over a simulated day;
  E2   ``torch_bench_tables.bench_ysb``: Table III (YSB analogue);
       ``--quick`` gives E1/E2 one repetition, else the median of three;
  E10  ``torch_bench_proactive.main``: the proactive vs reactive
       head-to-head on one campaign;
  E12  ``torch_bench_campaign.main``: the torch lane engine against the
       NumPy lanes (throughput, parity, the exhaustive sweep);
  E4   ``torch_bench_recovery.main``: recovery and latency vs CI through
       the scalar oracle and the lanes, the 432-lane grid, and the
       ``bench_sim/3`` artifact embedding E10 and E12
       (``BENCH_sim_torch.json``);
  the replication drill (``torch_bench_replication.main``);
  E11  ``torch_bench_fleet.main``: the 8-job fleet (``BENCH_fleet_torch.json``);
  E9   ``torch_bench_khaos_training.main``: Khaos on a training job;
  E5   ``torch_bench_ckpt.main``: the checkpoint bench and its calibration
       artifact (``BENCH_ckpt_torch.json``);
  E6   ``torch_bench_kernels.main``: the kernel bench;
  E7   ``torch_bench_dryrun.main``: the dry-run and roofline table of
       ``experiments/dryrun_torch.json`` (``python -m
       repro_torch.launch.dryrun`` writes it; without it the section says
       how to make it).

Artifacts land in the working directory.

``--smoke`` runs the seven drill twins of ``run.py --smoke``, in its
order:

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

Either mode exits with 1 on the first ``ValueError``/``AssertionError``.
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import tempfile
import time
from typing import Any, Optional, Sequence

HERE = os.path.dirname(os.path.abspath(__file__))


def _sibling(name: str):
    """A benchmark module beside this one (loaded by path once)."""
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(HERE, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        # registered before it runs: a dataclass looks its module up
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
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


def full(repeats: int = 3, device: Any = None) -> dict:
    """``run.py``'s full mode, in its order (see the module docstring).
    Returns each section's result and seconds."""
    out: dict = {"seconds": {}}

    def section(name: str, fn):
        t0 = time.perf_counter()
        out[name] = fn()
        out["seconds"][name] = time.perf_counter() - t0
        return out[name]

    tables = _sibling("torch_bench_tables")
    section("E1", lambda: tables.bench_iot_vehicles(repeats=repeats,
                                                    device=device))
    section("E2", lambda: tables.bench_ysb(repeats=repeats, device=device))
    proactive = section("E10", lambda: _sibling(
        "torch_bench_proactive").main(device=device))
    device_sec = section("E12", lambda: _sibling(
        "torch_bench_campaign").main(device=device))
    section("E4", lambda: _sibling("torch_bench_recovery").main(
        proactive=proactive, device_sec=device_sec, device=device))
    section("replication", lambda: _sibling(
        "torch_bench_replication").main(device=device))
    section("E11", lambda: _sibling("torch_bench_fleet").main(device=device))
    section("E9", lambda: _sibling("torch_bench_khaos_training").main(
        device=device))
    section("E5", lambda: _sibling("torch_bench_ckpt").main(device=device))
    section("E6", lambda: _sibling("torch_bench_kernels").main(
        ["--device", str(device or "cuda")]))
    section("E7", lambda: _sibling("torch_bench_dryrun").main())
    return out


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one repetition for E1/E2 (default: median of 3)")
    ap.add_argument("--smoke", action="store_true",
                    help="the seven drill twins of run.py --smoke")
    ap.add_argument("--device", default=None,
                    help="torch device of the benches (default: cuda)")
    args = ap.parse_args(argv)
    t0 = time.monotonic()
    mode = "smoke" if args.smoke else "full run"
    try:
        if args.smoke:
            with tempfile.TemporaryDirectory() as tmp:
                out = smoke(tmp, device=args.device)
        else:
            out = full(repeats=1 if args.quick else 3, device=args.device)
    except (ValueError, AssertionError) as e:
        print(f"{mode.upper()} FAILED: {e}", file=sys.stderr)
        sys.exit(1)
    secs = ", ".join(f"{k} {v:.1f}s" for k, v in out["seconds"].items())
    print(f"{mode} done in {time.monotonic() - t0:.0f}s ({secs})")


if __name__ == "__main__":
    main()
