"""The f64 polish's share of a mixed call's stream time: the events the
composite records before each stage and after the last, summed over the
traced calls."""
from __future__ import annotations

from ..spans import traced_marks

NAME = "mixed.polish_share_pct.to_tol"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = ("captured programs (batch._GraphProgram, _FedProgram, fused._FusedProgram, "
         "fused_spm._MixedProgram)")
MOVES = "solves_per_s.to_tol"
CELLS = ("spm.mixed_f64",)


def read(r):
    stages = [m["marks"] for m in traced_marks(r, "polish")]
    if not stages:
        return None
    return (100.0 * sum(m["end"] - m["polish"] for m in stages)
            / sum(m["end"] for m in stages))
