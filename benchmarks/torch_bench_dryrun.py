"""E7/E8 of the port: summarize the multi-pod dry-run and roofline
records of ``python -m repro_torch.launch.dryrun``
(``experiments/dryrun_torch.json``) — the twin of ``bench_dryrun.py``,
which formats the same table from the JAX package's record.

    PYTHONPATH=src python benchmarks/torch_bench_dryrun.py

The terms are the port's model of an H100 mesh (``repro_torch.roofline``):
traced flops, eager per-op HBM bytes and the collectives of the rules'
placements; a cell fits when its per-device estimate is within one H100's
80 GB.
"""
from __future__ import annotations

import json
import os

DEFAULT_PATH = "experiments/dryrun_torch.json"


def bench_dryrun(path: str = DEFAULT_PATH):
    if not os.path.exists(path):
        print(f"\n=== Dry-run summary: {path} not found ===")
        print("run: PYTHONPATH=src python -m repro_torch.launch.dryrun "
              f"--arch all --shape all --mesh both --out {path}")
        return []
    with open(path) as f:
        records = json.load(f)
    runs = [r for r in records if "skipped" not in r]
    skips = [r for r in records if "skipped" in r]
    print(f"\n=== Multi-pod dry-run: {len(runs)} traced cells, "
          f"{len(skips)} documented skips ===")
    hdr = (f"{'arch':>18s} {'shape':>11s} {'mesh':>8s} {'HBM/dev':>8s} "
           f"{'t_comp':>9s} {'t_mem':>9s} {'t_coll':>9s} {'dominant':>10s} "
           f"{'useful':>7s}")
    print(hdr)
    for r in runs:
        print(f"{r['arch']:>18s} {r['shape']:>11s} {r['mesh']:>8s} "
              f"{r['hbm_gb_per_dev']:7.2f}G "
              f"{r['t_compute_s']*1e3:8.1f}ms {r['t_memory_s']*1e3:8.1f}ms "
              f"{r['t_collective_s']*1e3:8.1f}ms {r['dominant']:>10s} "
              f"{100*r['useful_flops_ratio']:6.1f}%")
    for r in skips:
        print(f"{r['arch']:>18s} {r['shape']:>11s}      SKIP ({r['skipped']})")
    n_fit = sum(1 for r in runs if r.get("fits_80gb"))
    print(f"fits 80GB H100 HBM: {n_fit}/{len(runs)} cells")
    return runs


def main(path: str = DEFAULT_PATH):
    return bench_dryrun(path)


if __name__ == "__main__":
    main()
