"""The share of the traced window in which the card is idle while the host
is inside an ``admm.replay`` span: launching a captured chunk's graph with
nothing queued before it."""
from __future__ import annotations

from ..spans import has_spans, idle_by_span

NAME = "program.launch_idle_pct.to_tol"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = ("captured programs (batch._GraphProgram, _FedProgram, fused._FusedProgram, "
         "fused_spm._MixedProgram)")
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.lpath_f64", "spm.mixed_f64")


def read(r):
    tr = r.trace
    if tr is None or not tr.calls or not tr.device or not has_spans(tr):
        return None
    return 100.0 * idle_by_span(tr).get("admm.replay", 0.0) / tr.window_s
