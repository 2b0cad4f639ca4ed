"""The host's blocking reads of the done flags (``admm.flags_read`` spans)
per traced call: each one waits for the card before the next chunk is
launched."""
from __future__ import annotations

from ..spans import has_spans

NAME = "program.flag_reads_per_call.to_tol"
UNIT = "reads"
BETTER = "lower"
SOURCE = "program_span"
LAYER = ("captured programs (batch._GraphProgram, _FedProgram, fused._FusedProgram, "
         "fused_spm._MixedProgram)")
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.lpath_f64", "spm.mixed_f64")


def read(r):
    tr = r.trace
    if tr is None or not tr.calls or not has_spans(tr):
        return None
    return sum(1 for n, _, _ in tr.host if n == "admm.flags_read") / tr.calls
