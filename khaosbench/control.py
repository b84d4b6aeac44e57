"""Readings that set the limits of the training checks: for each seed, the
program's first three steps (through the trainer's own loop and feed, as
in every run's set-up), the control (the float32 reference put in the
program's place in the precision below the configuration's bfloat16:
float8 e4m3) and a planted fault (the reference on half of each batch,
the mean taken over the rest), each against the float32 reference.

    python3 khaosbench/control.py --config yi-6b.2l --seeds 1 2 3 ...

(``--config`` names a file of ``khaosbench/configs/``, in a cell or not).

prints one JSON line per seed: {"seed", "program", "control",
"half_batch": {gap: value}}, and with ``--leaves`` the per-leaf gaps of
the program and the control.  The program's largest gaps over a dozen
seeds are the lower readings, the control's and the fault's smallest the
upper ones.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cfg: dict, seed: int, device: str, leaves: bool = False,
             fault: bool = True) -> dict:
    from khaosbench import checks
    from khaosbench.harness import CellRun
    from khaosbench.reference.precision import FP8

    quiet = {"source": "saturated", "ci_s": 1e9, "failures": [],
             "failure_kind": "task",
             "plan": {"mode": "full", "levels": ["memory"]}}
    run = CellRun(cfg, quiet, seed, 1.0, device=device)
    run.setup()
    run.observe()
    run.release()
    ref, expected = run.reference()
    fp8, _ = run.reference(FP8())
    groups = cfg.get("leaf_groups")
    out = {"seed": seed,
           "program": {**checks.training_gaps(run.program, ref, groups),
                       "token_mismatch": checks.token_mismatches(
                           run.fed, expected)},
           "control": checks.training_gaps(fp8, ref, groups),
           **run.rec.observed}
    if fault:
        half, _ = run.reference(rows=cfg["run"]["batch"] // 2)
        out["half_batch"] = checks.training_gaps(half, ref, groups)
    if leaves:
        g = ref["grad_norms"]
        out["leaves"] = {
            side: {k: checks.leaf_gaps(res[f"{k}_norms"], ref[f"{k}_norms"],
                                       g) for k in ("grad", "change")}
            for side, res in (("program", run.program), ("control", fp8))}
        out["reference_grad_norms"] = g
    run.tmp.cleanup()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    p.add_argument("--leaves", action="store_true")
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    cfg = json.loads((ROOT / "khaosbench" / "configs"
                      / f"{args.config}.json").read_text())
    for seed in args.seeds:
        print(json.dumps(readings(cfg, seed, args.device, args.leaves)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
