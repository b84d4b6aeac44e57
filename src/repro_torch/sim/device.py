"""The device lane engine: ``BatchedCampaign``'s tick on f64 torch tensors.

The sim package is a three-engine hierarchy:

  1. ``StreamSimulator`` — the scalar ORACLE.  One job, one Python tick
     loop.  Ground truth for semantics.
  2. ``BatchedCampaign`` — the NumPy LANE engine.  N jobs as array lanes,
     one fused NumPy tick, bit-exact against the oracle.  Ground truth for
     the vectorized tick ORDER.
  3. ``DeviceCampaign`` (this module) — the DEVICE engine: the same tick
     as eager torch operations on float64 tensors on a torch device (the
     CUDA device unless the caller names another).  Lane state lives on
     the device for a chunk of ticks, λ(t) is the ``dense_rates``
     precompute uploaded once (deduplicated by shared rate array),
     plan/cost tables are gathered per lane, per-lane branches become
     masked ``torch.where`` updates, and lag history comes back in one
     device-to-host readback per chunk.

The device engine must reproduce the NumPy engine's floating-point order
bit for bit (``tests/test_torch_device_campaign.py`` and ``chip_smoke.py``
hold it with exact comparisons).  Three rules keep it so:

  * every arithmetic step is one eager elementwise torch op, which rounds
    once as NumPy does; nothing here uses a fused op (``addcmul``,
    ``lerp``, ``torch.compile``) that could contract a multiply and an
    add into one FMA;
  * no quotient is taken on the device: CUDA divides by a Python scalar
    by multiplying with its reciprocal, which is not IEEE division.  The
    one quotient of the tick, the straggler capacity scale, depends on
    the injection alone and is priced on the host per queued window;
  * ``jitter_phase`` uses ``torch.remainder``, which follows NumPy's sign
    rule (the result takes the divisor's sign).

The two event loops of the tick (crash injections and gray-failure
windows due at ``t``) run a pass per event due on the busiest lane.
Event times are fixed when the lanes are built and the lane clocks
advance one second a tick, so the host counts each tick's passes for a
whole chunk before launching it; the device loop never reads a value
back per tick.  A pass with no event due changes nothing, so counting an
event at both ticks its time could round to is safe.

``DeviceCampaign`` subclasses ``BatchedCampaign``: construction, lane
actuation (``lane_set_ci``/``lane_set_plan``), compaction, handles, and
every result surface reuse the host-side code; only ``run`` is replaced
by a chunked device advance that syncs the lane state host<->device at
chunk boundaries.  Between chunks the host state is exactly what the
NumPy engine would hold, so ``drive_campaign`` controllers actuate lanes
mid-run without knowing which engine is underneath.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.sim.batched import (_DEG_ID, _DIR_ID, KINDS, LEVELS,
                                     BatchedCampaign, LaneSpec)
from repro_torch.sim.costmodel import SimCostModel
from repro_torch.utils.trees import resolve_device

_DEG_STRAGGLER = _DEG_ID["straggler"]
_DEG_NET = _DEG_ID["net_delay"]
_DEG_BP = _DEG_ID["backpressure"]
_DIR_STORE = _DIR_ID["to_ckpt_store"]
_DIR_SOURCE = _DIR_ID["to_source"]

#: per-lane state a chunk may change (uploaded, advanced, read back)
_STATE = ("t", "lag", "produced", "consumed", "processed_total", "pol_last",
          "off_lvl", "last_off", "ck_active", "ck_end", "ck_off", "ck_lvls",
          "ckpt_count", "save_count", "down", "steady_lag", "down_until",
          "pending_ro", "fptr", "_next_fail", "af_active", "af_t0",
          "af_kind", "af_ci", "af_level", "_rec_t_start", "_rec_kind",
          "_rec_ci", "_rec_level", "_rec_t_end", "_rec_count")
_DEG_STATE = ("dptr", "_next_deg", "dg_cap_scale", "dg_cap_until",
              "dg_ck_delay", "dg_ck_jitter", "dg_ck_t0", "dg_ck_until",
              "dg_lat_delay", "dg_lat_jitter", "dg_lat_t0", "dg_lat_until",
              "dg_bp_until", "bp_suppressed")
#: per-lane inputs a chunk only reads (actuation changes them between
#: chunks)
_CONST = ("interval", "plan_id", "_period", "_mu_ck", "lane_ticks",
          "fail_t", "fail_kind")
_DEG_CONST = ("deg_t", "deg_kind", "deg_dur", "deg_jit", "deg_dir",
              "deg_sev")

def jitter_phase(t: torch.Tensor, t0: torch.Tensor) -> torch.Tensor:
    """``ft.failures.jitter_phase`` on tensors: +1 in the even seconds of
    the window since ``t0``, -1 in the odd ones (``torch.remainder``
    takes the divisor's sign, as NumPy's ``%`` does, also for t < t0)."""
    return 1.0 - 2.0 * (torch.remainder(t - t0, 2.0) >= 1.0).to(t.dtype)


def event_passes(times: np.ndarray, ptr: np.ndarray, t: np.ndarray,
                 lane_ticks: np.ndarray, k0: int, n: int) -> np.ndarray:
    """Passes of the event loop each of ticks ``k0 .. k0+n-1`` needs: the
    most events any one lane pops at that tick.  ``times`` (lanes, K) are
    the sorted event times (+inf padded), ``ptr`` each lane's next event,
    ``t`` each lane's clock at tick ``k0``; a lane's clock advances 1 s a
    tick while ``tick < lane_ticks``, and an event pops at the first tick
    whose clock has reached it.  The clock after d ticks is t + 1.0 added
    d times, which can differ from t + d by up to d rounding errors of at
    most eps * (|t| + n) each; an event is counted at every tick that
    margin allows, so no tick is ever short of a pass."""
    passes = np.zeros(n, dtype=np.int64)
    K = times.shape[1]
    pending = (np.arange(K)[None, :] >= ptr[:, None]) & np.isfinite(times)
    rows, cols = np.nonzero(pending)
    if not rows.size:
        return passes
    ft = times[rows, cols]
    rel = ft - t[rows]
    slack = n * np.finfo(np.float64).eps * (np.abs(t[rows]) + n + 1.0)
    alive_n = lane_ticks[rows] - k0
    lo = np.maximum(np.ceil(rel - slack), 0.0)
    hi = np.maximum(np.ceil(rel + slack), 0.0)
    keys = []
    for d, take in ((lo, np.ones(lo.size, dtype=bool)), (hi, hi != lo)):
        ok = take & (d < n) & (d < alive_n)
        keys.append(rows[ok] * n + d[ok].astype(np.int64))
    keys = np.concatenate(keys)
    if keys.size:
        key, count = np.unique(keys, return_counts=True)
        np.maximum.at(passes, key % n, count)
    return passes


class DeviceCampaign(BatchedCampaign):
    """``BatchedCampaign`` advanced on a torch device.

    Construction, per-lane actuation, compaction, handles, and all result
    surfaces are inherited; ``run`` advances the lane state in device
    chunks that are bit-exact with the same number of NumPy ``_step``
    calls, syncing the lane state at every chunk boundary (so mid-run
    ``lane_set_ci``/``lane_set_plan`` between ``run`` calls behave exactly
    as on the NumPy engine).

    ``device`` is the torch device (default: the CUDA device; with no CUDA
    device and none named, construction raises).  ``history_chunk_bytes``
    bounds the device-side lag-history buffer: a recording campaign
    advances in ``history_chunk_bytes / (8 * n_lanes)``-tick chunks and
    copies each chunk's rows back to the host history in one readback.
    ``compact_every`` keeps the NumPy engine's default: a chunk ends at
    each compaction check.
    """

    _PER_LANE = BatchedCampaign._PER_LANE + (
        "_rec_t_start", "_rec_kind", "_rec_ci", "_rec_level", "_rec_t_end",
        "_rec_count", "_rec_seen", "deg_scale")

    def __init__(self, cost: SimCostModel, lanes: Sequence[LaneSpec],
                 record_history: bool = True, flink_semantics: bool = True,
                 early_exit: bool = False, compact_every: int = 256,
                 history_chunk_bytes: int = 64 << 20, device=None):
        self.device = resolve_device(device)
        super().__init__(cost, lanes, record_history=record_history,
                         flink_semantics=flink_semantics,
                         early_exit=early_exit, compact_every=compact_every)
        N = self.n_lanes
        R = max(1, self._n_fail)
        self._rec_t_start = np.zeros((N, R))
        self._rec_kind = np.zeros((N, R), dtype=np.int64)
        self._rec_ci = np.zeros((N, R))
        self._rec_level = np.full((N, R), -1, dtype=np.int64)
        self._rec_t_end = np.zeros((N, R))
        self._rec_count = np.zeros(N, dtype=np.int64)
        self._rec_seen = np.zeros(N, dtype=np.int64)
        # the straggler capacity scale of every queued window, priced on
        # the host by the cost model (the tick then only gathers it)
        self.deg_scale = cost.straggler_capacity_scale(self.deg_sev)
        # λ columns deduplicated by shared rate array: lanes built from one
        # recording all point at the same dense_rates precompute, so the
        # (T, W) upload holds W unique columns, not N
        col_of: dict[int, int] = {}
        firsts: list[int] = []
        self._rate_col_all = np.zeros(N, dtype=np.int64)
        for i, lane in enumerate(self.lanes):
            w = col_of.setdefault(id(lane.rates), len(col_of))
            self._rate_col_all[i] = w
            if w == len(firsts):
                firsts.append(i)
        self._rates_u = np.ascontiguousarray(self._rates_tm[:, firsts])
        self._rates_dev: Optional[torch.Tensor] = None
        if record_history:
            rows = int(history_chunk_bytes) // (8 * max(1, N))
            self._hist_rows = max(16, min(self.horizon, rows))
        else:
            self._hist_rows = 0
        self.chunks = 0          # device chunks advanced (host syncs)

    # -- device advance -------------------------------------------------
    def run(self, n_ticks: Optional[int] = None) -> "DeviceCampaign":
        end = self.horizon if n_ticks is None \
            else min(self.horizon, self._step_idx + n_ticks)
        ce = self.compact_every
        while self._step_idx < end and self._active.size:
            stop = min(end, ((self._step_idx // ce) + 1) * ce) if ce else end
            left = stop - self._step_idx
            while left > 0:
                c = min(left, self._hist_rows) if self._hist_rows else left
                self._device_chunk(c)
                left -= c
            if ce and self._step_idx % ce == 0:
                self._maybe_compact()
        if self.done:
            self._finalize()
        return self

    def _upload(self, names) -> dict:
        dev = self.device
        return {name: torch.as_tensor(getattr(self, name), device=dev)
                for name in names}

    def _device_chunk(self, n: int) -> None:
        k0 = self._step_idx
        any_deg = self._any_deg
        lat_extra = self._lat_extra_tm is not None
        dev = self.device
        f64 = torch.float64
        fail_passes = event_passes(self.fail_t, self.fptr, self.t,
                                   self.lane_ticks, k0, n).tolist()
        deg_passes = event_passes(self.deg_t, self.dptr, self.t,
                                  self.lane_ticks, k0, n).tolist() \
            if any_deg else [0] * n
        last_alive = int(self.lane_ticks.max()) if self.lane_ticks.size \
            else 0

        state_names = _STATE + (_DEG_STATE if any_deg else ())
        s = self._upload(state_names)
        c = self._upload(_CONST + (_DEG_CONST + ("deg_scale",)
                                   if any_deg else ()))
        if self._rates_dev is None:
            self._rates_dev = torch.as_tensor(self._rates_u, device=dev)
        tbl = self.table
        c.update(
            rate_col=torch.as_tensor(self._rate_col_all[self._active],
                                     device=dev),
            trig_dur=torch.as_tensor(tbl.trig_dur, device=dev),
            trig_lvls=torch.as_tensor(tbl.trig_lvls, device=dev),
            restore_dur=torch.as_tensor(tbl.restore_dur, device=dev),
            cold_restore=torch.as_tensor(tbl.cold_restore, device=dev),
            surviving=torch.as_tensor(tbl.surviving, device=dev),
            wipes=torch.as_tensor(tbl.wipes, device=dev),
            rec_slot=torch.arange(self._rec_t_start.shape[1], device=dev))
        n_act = self._active.size
        hist = torch.zeros((n if self._hist_rows else 0, n_act), dtype=f64,
                           device=dev)
        lat = torch.zeros((n if (self._hist_rows and lat_extra) else 0,
                           n_act), dtype=f64, device=dev)
        for d in range(n):
            self._tick(s, c, k0 + d, fail_passes[d], deg_passes[d],
                       k0 + d < last_alive, hist, lat, d, any_deg,
                       lat_extra)
        for name in state_names:
            setattr(self, name, np.array(s[name].cpu()))
        if self._hist_rows:
            rows = hist.cpu().numpy()
            if self._final is None:
                self._lag_hist_tm[k0:k0 + n] = rows
            else:
                self._lag_hist_tm[k0:k0 + n, self._active] = rows
            if lat_extra:
                lrows = lat.cpu().numpy()
                if self._final is None:
                    self._lat_extra_tm[k0:k0 + n] = lrows
                else:
                    self._lat_extra_tm[k0:k0 + n, self._active] = lrows
        self._step_idx += n
        self.chunks += 1
        self._materialize_recoveries()

    # -- the tick (BatchedCampaign._step, masked, same order) ------------
    def _begin_failure_dev(self, s: dict, c: dict, mask, kind, ev_t) -> None:
        """``BatchedCampaign._begin_failure`` as masked writes (a lane not
        in ``act`` keeps every value, as the NumPy early return does)."""
        cost = self.cost
        act = mask & ~s["down"]
        s["ck_active"] = s["ck_active"] & ~act
        pid = c["plan_id"]
        surv = c["surviving"][pid, kind]                    # (N, 3)
        offs = torch.where(surv, s["off_lvl"], -np.inf)
        best = offs.amax(dim=1)
        has = surv.any(dim=1)
        # first column holding the best offset (columns fastest-first)
        lvl = (offs == best[:, None]).to(torch.int32).argmax(dim=1)
        restore = torch.where(has, c["restore_dur"][pid, kind, lvl],
                              c["cold_restore"][pid])
        offset = torch.where(has, best, 0.0)
        wipe = c["wipes"][pid, kind]
        s["off_lvl"] = torch.where(act[:, None] & wipe, 0.0, s["off_lvl"])
        s["down_until"] = torch.where(
            act, ev_t + cost.detect_s + cost.restart_s + restore,
            s["down_until"])
        s["pending_ro"] = torch.where(act, offset, s["pending_ro"])
        s["down"] = s["down"] | act
        s["af_active"] = s["af_active"] | act
        s["af_t0"] = torch.where(act, ev_t, s["af_t0"])
        s["af_kind"] = torch.where(act, kind, s["af_kind"])
        s["af_ci"] = torch.where(act, c["interval"], s["af_ci"])
        s["af_level"] = torch.where(act, torch.where(has, lvl, -1),
                                    s["af_level"])

    def _begin_degradation_dev(self, s: dict, c: dict, mask, cur) -> None:
        """``BatchedCampaign._begin_degradation`` as masked writes."""
        idx = cur[:, None]

        def at(name):
            return c[name].gather(1, idx)[:, 0]
        kind = at("deg_kind")
        ev_t = at("deg_t")
        until = ev_t + at("deg_dur")
        sev = at("deg_sev")
        jit = at("deg_jit")
        dirn = at("deg_dir")
        m = mask & (kind == _DEG_STRAGGLER)
        s["dg_cap_scale"] = torch.where(m, at("deg_scale"), s["dg_cap_scale"])
        s["dg_cap_until"] = torch.where(m, until, s["dg_cap_until"])
        nd = mask & (kind == _DEG_NET)
        m = nd & (dirn == _DIR_STORE)
        s["dg_ck_delay"] = torch.where(m, sev, s["dg_ck_delay"])
        s["dg_ck_jitter"] = torch.where(m, jit, s["dg_ck_jitter"])
        s["dg_ck_t0"] = torch.where(m, ev_t, s["dg_ck_t0"])
        s["dg_ck_until"] = torch.where(m, until, s["dg_ck_until"])
        m = nd & (dirn == _DIR_SOURCE)
        s["dg_lat_delay"] = torch.where(m, sev, s["dg_lat_delay"])
        s["dg_lat_jitter"] = torch.where(m, jit, s["dg_lat_jitter"])
        s["dg_lat_t0"] = torch.where(m, ev_t, s["dg_lat_t0"])
        s["dg_lat_until"] = torch.where(m, until, s["dg_lat_until"])
        m = mask & (kind == _DEG_BP)
        s["dg_bp_until"] = torch.where(m, until, s["dg_bp_until"])

    def _tick(self, s: dict, c: dict, k: int, fail_passes: int,
              deg_passes: int, any_alive: bool, hist, lat, row: int,
              any_deg: bool, lat_extra: bool) -> None:
        cost = self.cost
        t = s["t"]
        alive = k < c["lane_ticks"]
        lam = torch.where(alive, self._rates_dev[k][c["rate_col"]], 0.0)
        s["produced"] = s["produced"] + lam

        # pending failures: one pass per event due on the busiest lane
        Kf = self._n_fail
        for _ in range(fail_passes):
            pend = (s["_next_fail"] <= t) & alive
            cur = torch.clamp(s["fptr"], max=Kf - 1)
            self._begin_failure_dev(
                s, c, pend, c["fail_kind"].gather(1, cur[:, None])[:, 0],
                s["_next_fail"])
            fptr = torch.where(pend, s["fptr"] + 1, s["fptr"])
            nxt = torch.clamp(fptr, max=Kf - 1)
            s["fptr"] = fptr
            s["_next_fail"] = torch.where(
                fptr < Kf, c["fail_t"].gather(1, nxt[:, None])[:, 0], np.inf)

        # pending gray-failure windows (the scalar's second pop)
        Kd = self._n_deg
        for _ in range(deg_passes):
            pend = (s["_next_deg"] <= t) & alive
            cur = torch.clamp(s["dptr"], max=Kd - 1)
            self._begin_degradation_dev(s, c, pend, cur)
            dptr = torch.where(pend, s["dptr"] + 1, s["dptr"])
            nxt = torch.clamp(dptr, max=Kd - 1)
            s["dptr"] = dptr
            s["_next_deg"] = torch.where(
                dptr < Kd, c["deg_t"].gather(1, nxt[:, None])[:, 0], np.inf)

        # down lanes accumulate lag; restart rolls back to the offset
        # (parenthesized as the scalar's `lag += consumed - ro`)
        down_pre = s["down"]
        lag = torch.where(alive & down_pre, s["lag"] + lam, s["lag"])
        restart = alive & down_pre & (t >= s["down_until"])
        rb = restart & (s["pending_ro"] < s["consumed"])
        lag = torch.where(rb, lag + (s["consumed"] - s["pending_ro"]), lag)
        consumed = torch.where(rb, s["pending_ro"], s["consumed"])
        down = down_pre & ~restart
        pol_last = torch.where(restart, t, s["pol_last"])
        # a lane restarting this tick stays out of processing (the NumPy
        # `up` is taken before the restart clears `down`)
        up = alive & ~down_pre

        # checkpoint completion: commit the offset at every level written
        comp = up & s["ck_active"] & (t >= s["ck_end"])
        off = s["ck_off"]
        s["off_lvl"] = torch.where(comp[:, None] & s["ck_lvls"],
                                   off[:, None], s["off_lvl"])
        s["last_off"] = torch.where(comp, torch.maximum(s["last_off"], off),
                                    s["last_off"])
        s["ckpt_count"] = s["ckpt_count"] + comp
        ck_active = s["ck_active"] & ~comp

        # checkpoint start
        due = up & (t - pol_last >= c["interval"]) & ~ck_active
        if any_deg:
            bp = due & (t < s["dg_bp_until"])
            s["bp_suppressed"] = s["bp_suppressed"] + bp
            due = due & ~bp
        pid = c["plan_id"]
        idx = torch.remainder(s["save_count"], c["_period"])
        s["save_count"] = s["save_count"] + due
        dur = c["trig_dur"][pid, idx]
        if any_deg:
            ckd = t < s["dg_ck_until"]
            pen = cost.net_delay_store_factor * s["dg_ck_delay"] \
                + s["dg_ck_jitter"] * jitter_phase(t, s["dg_ck_t0"])
            dur = dur + torch.where(ckd, pen, 0.0)
        s["ck_end"] = torch.where(due, t + dur, s["ck_end"])
        s["ck_off"] = torch.where(due, consumed, s["ck_off"])
        s["ck_lvls"] = torch.where(due[:, None], c["trig_lvls"][pid, idx],
                                   s["ck_lvls"])
        ck_active = ck_active | due
        s["ck_active"] = ck_active
        pol_last = torch.where(due, t, pol_last)

        # capacity + processing
        checkpointing = up & ck_active
        mu = torch.where(checkpointing, c["_mu_ck"], cost.capacity_eps)
        if any_deg:
            reset = up & (t >= s["dg_cap_until"])
            s["dg_cap_scale"] = torch.where(reset, 1.0, s["dg_cap_scale"])
            mu = mu * s["dg_cap_scale"]
        inflow = lag + lam
        processed = torch.where(up, torch.minimum(inflow, mu), 0.0)
        lag = torch.where(up, torch.clamp_min(inflow - processed, 0.0), lag)
        consumed = consumed + processed
        s["processed_total"] = s["processed_total"] + processed

        if hist.shape[0] and any_alive:
            # the NumPy step skips the row write when no lane is alive
            hist[row] = lag
        if lat.shape[0]:
            la = alive & (t < s["dg_lat_until"])
            pen = cost.net_delay_source_factor * s["dg_lat_delay"] \
                + s["dg_lat_jitter"] * jitter_phase(t, s["dg_lat_t0"])
            lat[row] = torch.where(la, pen, 0.0)

        # recovery bookkeeping (records go to bounded per-lane slots; the
        # host materializes the dicts after the chunk)
        settled = alive & ~down
        steady = s["steady_lag"]
        env = lag <= torch.maximum(2.0 * lam, 1.05 * steady + 1.0)
        af_active = s["af_active"]
        upd = settled & ~af_active
        near = af_active & settled & env
        count = s["_rec_count"]
        last = c["rec_slot"].shape[0] - 1
        slot = (c["rec_slot"][None, :]
                == torch.clamp(count, max=last)[:, None]) & near[:, None]
        for name, val in (("_rec_t_start", s["af_t0"]),
                          ("_rec_kind", s["af_kind"]),
                          ("_rec_ci", s["af_ci"]),
                          ("_rec_level", s["af_level"]),
                          ("_rec_t_end", t)):
            s[name] = torch.where(slot, val[:, None], s[name])
        s["_rec_count"] = count + near
        s["af_active"] = af_active & ~near
        s["steady_lag"] = torch.where(upd, 0.9 * steady + 0.1 * lag, steady)

        s.update(t=torch.where(alive, t + 1.0, t), lag=lag, consumed=consumed,
                 down=down, pol_last=pol_last)

    def _materialize_recoveries(self) -> None:
        """Append recovery dicts for records the device wrote since the
        last chunk (the NumPy engine's in-loop appends, same order; done
        before any compaction so retiring lanes never strand records)."""
        new = np.flatnonzero(self._rec_count > self._rec_seen)
        for i in new:
            oi = int(self._active[i])
            for j in range(int(self._rec_seen[i]), int(self._rec_count[i])):
                lvl = int(self._rec_level[i, j])
                t_end = self._rec_t_end[i, j]
                t_start = self._rec_t_start[i, j]
                self.recoveries[oi].append({
                    "t_start": float(t_start),
                    "kind": KINDS[int(self._rec_kind[i, j])],
                    "ci": float(self._rec_ci[i, j]),
                    "restore_level": LEVELS[lvl] if lvl >= 0 else None,
                    "plan": self.lane_plan_name[oi],
                    "t_end": float(t_end),
                    "recovery_s": float(t_end - t_start),
                })
            self._rec_seen[i] = self._rec_count[i]


def fma_contraction_active(device=None) -> bool:
    """True when the tick's multiply-add chain (``0.9*s + 0.1*lag``)
    computed on ``device`` differs from NumPy's in any bit, i.e. when
    something contracted it into an FMA."""
    rng = np.random.default_rng(0)
    a, b = rng.random(4096) * 1e4, rng.random(4096) * 1e4
    dev = resolve_device(device)
    got = (0.9 * torch.as_tensor(a, device=dev)
           + 0.1 * torch.as_tensor(b, device=dev)).cpu().numpy()
    return not np.array_equal(0.9 * a + 0.1 * b, got)


def phase_matches_numpy(device=None) -> bool:
    """``jitter_phase`` on ``device`` equals ``ft.failures.jitter_phase``
    over clocks on each side of the window start (t - t0 from -50.5 to
    +50.5 s in quarter seconds, on fractional and large clocks)."""
    from repro_torch.ft.failures import jitter_phase as np_phase
    dev = resolve_device(device)
    d = np.arange(-202, 203) / 4.0
    for t0 in (0.0, 1234.567, 86400.125):
        t = t0 + d
        got = jitter_phase(torch.as_tensor(t, device=dev),
                           torch.full((t.size,), t0, dtype=torch.float64,
                                      device=dev)).cpu().numpy()
        if not np.array_equal(got, np_phase(t, np.full(t.size, t0))):
            return False
    return True
