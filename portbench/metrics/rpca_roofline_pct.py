"""Robust PCA's share of its roofline: the least time the card could take for
the traced calls' work (``counts.rpca``: the threshold's two products and
the elementwise steps a lane-iteration, the inputs and outputs once a call)
over the union of device activity of the traced calls.  The lane-iterations
are the singular-value thresholds the program counted in those calls
(``prox.svt.<route>``, whatever the route); where it counts none, or the
card has no entry in the table of peaks, there is nothing to read."""
from __future__ import annotations

from ..counts import rpca
from ..peaks import peaks_of
from ..spans import program_log, traced_calls

NAME = "rpca.roofline_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "nuclear-norm prox (objectivefunc.NuclearNormPenalty, ops/prox.svt_sign)"
MOVES = "solves_per_s.to_tol"
CELLS = ("rpca.hall_f64",)
COUNTER = "prox.svt."


def thresholds(r) -> float:
    """The lane-applications of the threshold in the traced calls, by every
    route (0 where the program counts none)."""
    calls = traced_calls(r, program_log())
    if not calls:
        return 0.0
    return float(sum(v for rec in calls for k, v in rec["attrs"]["counters"].items()
                     if k.startswith(COUNTER)))


def read(r):
    peaks = peaks_of(r.device_name)
    if r.trace is None or peaks is None or r.trace.busy_s <= 0:
        return None
    lane_iters = thresholds(r)
    if lane_iters <= 0:
        return None
    w = rpca.work(int(r.cfg["m"]), int(r.cfg["n"]), lane_iters, r.lanes, r.trace.calls)
    return 100.0 * rpca.bound_s(w, peaks) / r.trace.busy_s
