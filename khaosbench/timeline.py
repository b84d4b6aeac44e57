"""End-to-end arithmetic over a window's timeline.

The timeline is what the harness saw on the wall clock, in seconds from
the window's start (set-up entries before it are negative): each step's
end with the stream offsets it processed and the job's step count after
it (``("step", t, first_offset, count, step_after)``), and each restore
with the cursor and step it rolled the job back to (``("restore", t,
cursor, step)``).  Offsets are absolute; the window's events are offsets
``base .. base + len(arrivals)``.
"""
from __future__ import annotations

import numpy as np


def event_done_times(log: list, arrivals: np.ndarray, base: int) -> np.ndarray:
    """When each window event was last processed for good (NaN where a
    rollback undid it and nothing processed it again, or nothing did)."""
    done = np.full(len(arrivals), np.nan)
    for entry in log:
        if entry[0] == "step":
            first, count = entry[2], entry[3]
            a, b = max(first - base, 0), min(first + count - base, len(done))
            if a < b:
                done[a:b] = entry[1]
        else:
            done[max(entry[2] - base, 0):] = np.nan
    return done


def event_latencies(log: list, arrivals: np.ndarray, base: int,
                    window_s: float) -> np.ndarray:
    """Seconds from each window event's creation to the end of the step
    that last processed it; an event still pending at the window's end
    counts as pending until the end."""
    done = event_done_times(log, arrivals, base)
    return np.where(np.isnan(done), window_s, done) - arrivals


def recovery_times(log: list, failures: list, arrivals: np.ndarray,
                   base: int, window_s: float) -> list:
    """For each failure ``(t, backlog_before)``: seconds until the backlog
    (events created minus the cursor) is first back at or under its level
    just before the failure, at a step's end; the window's end where it
    never is."""
    out = []
    for tf, before in failures:
        rec = window_s - tf
        for entry in log:
            if entry[0] != "step" or entry[1] <= tf:
                continue
            t, end = entry[1], entry[2] + entry[3]
            created = base + int(np.searchsorted(arrivals, t, side="right"))
            if created - end <= before:
                rec = t - tf
                break
        out.append(rec)
    return out


def downtimes(log: list, failures: list, window_s: float) -> list:
    """For each failure ``(t, backlog_before)``: seconds until the first
    restore after it has ended; the window's end where none has."""
    out = []
    for tf, _ in failures:
        ends = [e[1] for e in log if e[0] == "restore" and e[1] >= tf]
        out.append((min(ends) if ends else window_s) - tf)
    return out


def cursor_violations(log: list, cursor0: int, step0: int,
                      final_cursor: int, final_step: int) -> int:
    """Breaks of exactly-once processing: each step must take the offsets
    right after its predecessor's (after a restore: right after the
    restored cursor), and the surviving steps must end at the job's final
    cursor and step count.  The log starts at the job's first step."""
    bad = 0
    surviving: list = []          # (step_after, end_offset)
    expect, step = cursor0, step0
    for entry in log:
        if entry[0] == "restore":
            _, _, cursor, rstep = entry
            while surviving and surviving[-1][0] > rstep:
                surviving.pop()
            ends, ends_step = surviving[-1][::-1] if surviving else (cursor0,
                                                                    step0)
            bad += int(cursor != ends) + int(rstep != ends_step)
            expect, step = cursor, rstep
            continue
        _, _, first, count, step_after = entry
        bad += int(first != expect) + int(step_after != step + 1)
        expect, step = first + count, step_after
        surviving.append((step_after, expect))
    bad += int(final_cursor != expect) + int(final_step != step)
    return bad
