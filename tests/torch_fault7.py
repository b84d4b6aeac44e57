"""Fault 7's sweep (ROADMAP §3), shared by ``tests/test_torch_fault7_*.py``.

``chip_smoke.py``'s Khaos phase prices the job's recovery from QoS models
fitted to a profiled (failure point x CI) grid and stops when the price
is not > 0.  Given the calibration, the pricing is deterministic, so the
tests replay it on the CPU through ``chip_smoke``'s own functions (the
grid as lanes of one campaign, ``run_profiling_campaign`` over
``BatchedDeployment``) for every calibrated full write from 20 to 34 s in
0.1 s steps, at the grid the card ran before (2 failure points x 3 CIs)
and at the JAX package's defaults it runs now (5 x 6).  The full writes
whose price is not > 0 are pinned below: fault 7 is open while the 5 x 6
list is not empty.

As a script it sweeps the same full writes at other median step times:

    PYTHONPATH=src python tests/torch_fault7.py --steps 0.095 0.098
"""
import argparse
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

#: the calibration ``chip_smoke.py`` printed on an H100 80GB HBM3 (700 W),
#: and the trainer's median step there (batch 2)
CALIBRATION = {
    "schema": "bench_ckpt/3", "state_bytes": 10444062724,
    "full_write_s": 27.20688843100001, "restore_s": 71.43035221299999,
    "delta_fraction": 0.7040415721920497,
    "delta_int8_fraction": 0.0011523929102791263,
    "delta_encode_s_per_byte": 6.127883534530074e-11,
    "snapshot_full_copy_s": 0.004376117999981943,
    "async_blocking_s": 0.0032494189999852097,
    "device": {
        "lossless": {"pack_s": 0.007319359000007353,
                     "encode_s": 0.4004025329999905,
                     "per_leaf_encode_s": 0.44726991400000315,
                     "bytes_on_link": 10444062720,
                     "link_fraction": 0.9999999996170073},
        "int8": {"pack_s": 0.007319359000007353,
                 "encode_s": 0.057633983999991756,
                 "per_leaf_encode_s": 0.0698233299999913,
                 "bytes_on_link": 2621214960,
                 "link_fraction": 0.2509765624038778}}}
STEP_S = 0.09602490450001255
BATCH = 2

#: a run that stopped at the check, on an H100 80GB HBM3 (700 W): its
#: calibration and median step, the recovery matrix it profiled (the
#: collapsed cell is [2][0], just past ``detect_s``) and its price
CARD_FAILURE_CALIBRATION = {
    "schema": "bench_ckpt/3", "state_bytes": 10444062724,
    "full_write_s": 22.030160367999997, "restore_s": 63.542134154999985,
    "delta_fraction": 0.7040415721920497,
    "delta_int8_fraction": 0.0011523929102791263,
    "delta_encode_s_per_byte": 5.5725440892134016e-11,
    "snapshot_full_copy_s": 0.005764618999990034,
    "async_blocking_s": 0.0034861280000200168,
    "device": {
        "lossless": {"pack_s": 0.007485790999993469,
                     "encode_s": 0.4075492899999915,
                     "per_leaf_encode_s": 0.43853319699999815,
                     "bytes_on_link": 10444062720,
                     "link_fraction": 0.9999999996170073},
        "int8": {"pack_s": 0.007485790999993469,
                 "encode_s": 0.058867157000008774,
                 "per_leaf_encode_s": 0.06961662500000898,
                 "bytes_on_link": 2621214960,
                 "link_fraction": 0.2509765624038778}}}
CARD_FAILURE_STEP_S = 0.0978177230000199
CARD_FAILURE_PRICE = -87.84521153762185

#: the swept full writes (s)
FULL_WRITES = [round(20.0 + 0.1 * i, 1) for i in range(141)]
#: the full writes whose priced recovery is not > 0, per grid: fault 7
#: (the fitted M_R turns on one or two collapsed cells) at 6 of the 141
#: points at 2 x 3 and still at 5 of them at 5 x 6
NONPOSITIVE = {(2, 3): [20.1, 20.7, 20.8, 21.4, 22.1, 26.7],
               (5, 6): [20.1, 20.7, 20.8, 22.1, 26.7]}


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Pricing:
    """The job of ``chip_smoke.py``'s Khaos phase at one full write."""

    def __init__(self):
        from repro_torch.config import CheckpointPlan, replace
        from repro_torch.data.stream import record_workload
        self.cs = chip_smoke()
        self.plan = CheckpointPlan(
            interval_s=1e9, mode="incremental", full_every=2,
            encode_placement="device", delta_codec="lossless",
            levels=("local",), sync=True, codec="zlib",
            replication_factor=0, keep=1)
        self.plans = [self.plan, replace(self.plan, delta_codec="int8")]
        self.recording = record_workload(
            self.cs.wave_rate(self.cs.STREAM_RATE, self.cs.STREAM_WAVE,
                              self.cs.STREAM_PERIOD_S),
            duration=self.cs.STREAM_PERIOD_S, seed=0)

    def profile(self, full_write_s: float, grid: tuple,
                engine: str = "numpy", calibration: dict = CALIBRATION,
                step_s: float = None):
        """(runtime, CIs, cost) after phases 1-2 (at ``STEP_S`` unless
        ``step_s`` is given)."""
        cost = self.cs.khaos_cost(dict(calibration,
                                       full_write_s=full_write_s),
                                  STEP_S if step_s is None else step_s,
                                  BATCH)
        rt, cis, _ = self.cs.khaos_profile(cost, self.recording, self.plans,
                                           l_const=1.0, grid=grid,
                                           engine=engine)
        return rt, cis, cost

    def price(self, full_write_s: float, grid: tuple, **kw) -> float:
        rt, cis, cost = self.profile(full_write_s, grid, **kw)
        return self.cs.priced_recovery(rt, cost, self.plan, cis,
                                       float(self.recording.counts.mean()))


def second(s: int) -> list:
    """The swept full writes in [s, s + 1)."""
    return [fw for fw in FULL_WRITES if s <= fw < s + 1]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=float, nargs="+", default=[STEP_S],
                    help="median step times (s) of the trainer")
    ap.add_argument("--grid", type=int, nargs=2, default=(5, 6),
                    metavar=("M", "Z"))
    args = ap.parse_args()
    for step in args.steps:
        STEP_S = step
        pricing = Pricing()
        bad = [fw for fw in FULL_WRITES
               if not pricing.price(fw, tuple(args.grid)) > 0]
        print(json.dumps({"step_s": step, "grid": args.grid,
                          "full_writes": len(FULL_WRITES),
                          "nonpositive": bad}))
