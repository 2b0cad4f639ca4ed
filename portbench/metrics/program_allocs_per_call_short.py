"""The segments the caching allocator took from the card (one
``cudaMalloc`` each) per traced call, from the port's call counters
(``alloc_segments``): a warm call that allocates waits on ``cudaMalloc``."""
from __future__ import annotations

from ..spans import program_log, traced_calls

NAME = "program.allocs_per_call.short"
UNIT = "segments"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = ("captured programs (batch._GraphProgram, _FedProgram, fused._FusedProgram, "
         "fused_spm._MixedProgram)")
MOVES = "solves_per_s.short"
CELLS = ("spm.fused_f32",)


def read(r):
    calls = traced_calls(r, program_log())
    if not calls or any("alloc_segments" not in rec["attrs"] for rec in calls):
        return None
    return sum(rec["attrs"]["alloc_segments"] for rec in calls) / len(calls)
