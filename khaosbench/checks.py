"""The numbers that decide ``correct``, each with its limit.

Training (the first three steps of set-up, which go through the window's
own step and feed): the loss of each step, the per-leaf norm of the first
(clipped) gradient as AdamW got it, worked out from its ``m`` after one
step (``m1 = (1 - b1) g``), and the per-leaf norm of each parameter's
change over the three steps, against the float32 reference.  A norm's gap
is ``|program - reference|`` over the larger of the reference's norm of
that leaf and of the median leaf; leaves whose reference gradient is under
a thousandth of the median leaf's are left out (they move by rounding).

Checkpoint plane: the int8 payload of the newest delta decoded against
its base, as the worst error over the codec's bound; the state restored
after each failure against a fingerprint of the state at the step it
claims; exactly-once processing of the stream across rollbacks; the
tokens the step was fed against the events' definition.
"""
from __future__ import annotations

import statistics
from typing import Optional

import numpy as np
import torch

from khaosbench.reference.codec import GROUP, layout, worst_error_over_bound
from khaosbench.reference.tree import flatten

EXCLUDE_BELOW = 1e-3


def leaf_gaps(program: dict, reference: dict, grads_ref: dict) -> dict:
    """{leaf: gap} of two {leaf: norm} maps (see module doc)."""
    med = statistics.median(reference.values())
    gmed = statistics.median(grads_ref.values())
    return {name: abs(program[name] - ref) / max(ref, med)
            for name, ref in reference.items()
            if grads_ref[name] >= EXCLUDE_BELOW * gmed}


def training_gaps(program: dict, reference: dict,
                  groups: Optional[dict] = None) -> dict:
    """``program``/``reference``: {"losses", "grad_norms",
    "change_norms"}.  The loss's gap is given over the steps and for the
    first alone, each norm's for the worst leaf, for the median leaf, for
    the worst of the leaves whose reference gradient is at least the
    median leaf's (``_big``) and, for each of ``groups`` ({group: part of
    a leaf's name}, a configuration's ``leaf_groups``), for the worst of
    that group's leaves (``.<group>``); a configuration's ``limits`` name
    the ones compared."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(program["losses"], reference["losses"]))
    if len(program["losses"]) != len(reference["losses"]):
        loss = float("inf")
    g = reference["grad_norms"]
    first = abs(program["losses"][0] - reference["losses"][0]) \
        / abs(reference["losses"][0])
    out = {"loss_gap": loss, "loss_gap_first": first}
    gmed = statistics.median(g.values())
    for key in ("grad", "change"):
        gaps = leaf_gaps(program[f"{key}_norms"], reference[f"{key}_norms"],
                         g)
        out[f"{key}_norm_gap"] = max(gaps.values())
        out[f"{key}_norm_gap_median"] = statistics.median(gaps.values())
        out[f"{key}_norm_gap_big"] = max(v for k, v in gaps.items()
                                         if g[k] >= gmed)
        for group, part in (groups or {}).items():
            out[f"{key}_norm_gap.{group}"] = max(
                (v for k, v in gaps.items() if part in k), default=np.inf)
    return out


def leaf_norms(tree: dict, divide: float = 1.0) -> dict:
    return {n: float(torch.linalg.vector_norm(x.float())) / divide
            for n, x in flatten(tree)}


def fingerprint(state: dict) -> list:
    """Per leaf, the sum of its bit patterns as int64 (float32 leaves
    viewed as int32): equal for a bit-equal restore of the same step."""
    sums = []
    for _, x in flatten(state):
        x = x.reshape(-1)
        x = x.view(torch.int32) if x.dtype == torch.float32 else x
        sums.append(torch.sum(x, dtype=torch.int64))
    return torch.stack(sums).cpu().tolist()


def payload_error(entries: list, payload: dict, new: dict, base: dict,
                  device) -> tuple[float, int]:
    """(worst error over the codec's bound over every packed leaf, count of
    leaves whose extent differs from the reference's packing) of one int8
    delta: ``entries`` the payload's (name, offset, size, shape) rows,
    ``payload`` its host "q"/"s" planes, ``new``/``base`` {name: tensor}
    of the state it encodes and of its base."""
    ref = layout([(name, shape) for name, _, _, shape in entries])
    bad = sum(int(tuple(a) != tuple(b)) for a, b in zip(entries, ref))
    q, s = payload.get("q"), payload.get("s")
    worst = 0.0
    for name, off, size, _ in ref:
        padded = -(-size // GROUP) * GROUP
        nw, bs = new[name].reshape(-1), base[name].reshape(-1)
        if q is None:                     # every leaf unchanged: no payload
            worst = max(worst, 0.0 if torch.equal(nw, bs) else np.inf)
            continue
        chunk = GROUP << 14
        for a in range(0, padded, chunk):
            b = min(a + chunk, padded)
            qq = torch.from_numpy(q[off + a:off + b]).to(device)
            ss = torch.from_numpy(s[(off + a) // GROUP:(off + b) // GROUP]
                                  ).to(device)
            worst = max(worst, worst_error_over_bound(
                nw[a:min(b, size)].to(device), bs[a:min(b, size)].to(device),
                qq, ss))
    return worst, bad


def token_mismatches(fed: list, expected: list) -> int:
    """Tokens and labels fed to the first steps that differ from the
    events' definition (every position counts once)."""
    bad = 0
    for (tok, lab), (etok, elab) in zip(fed, expected):
        bad += int(np.count_nonzero(np.asarray(tok) != etok))
        bad += int(np.count_nonzero(np.asarray(lab) != elab))
    return bad + abs(len(fed) - len(expected)) * 10 ** 6
