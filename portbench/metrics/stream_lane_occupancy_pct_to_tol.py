"""The share of the stream's lane slots that did a scenario's work: the
iterations the harvested scenarios used (``stream.lane_iters``) over B
lanes times the iterations each wave ran (``stream.slot_iters``), from the
port's call counters of the traced calls.  A lane that finished mid-wave,
or is parked once the stream drains, holds its slot idle."""
from __future__ import annotations

from ..spans import program_log, traced_calls

NAME = "stream.lane_occupancy_pct.to_tol"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "scenario scheduler (parallel/scheduler.py _WaveProgram)"
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.stream_f64",)


def read(r):
    calls = traced_calls(r, program_log())
    if not calls:
        return None
    sums = {}
    for name in ("stream.lane_iters", "stream.slot_iters"):
        sums[name] = sum(rec["attrs"]["counters"].get(name, 0) for rec in calls)
    if not sums["stream.slot_iters"]:
        return None
    return 100.0 * sums["stream.lane_iters"] / sums["stream.slot_iters"]
