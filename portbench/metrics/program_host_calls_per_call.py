"""The host's runtime calls that put work on a stream (kernel launches, graph
launches, asynchronous copies and sets), per call: what the captured
programs leave to the host."""
from __future__ import annotations

NAME = "program.host_calls_per_call"
UNIT = "calls"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = ("captured programs (batch._GraphProgram, _FedProgram, fused._FusedProgram, "
         "fused_spm._MixedProgram)")
MOVES = "solves_per_s"
CELLS = ("bp.fused_f32",)


def read(r):
    if r.trace is None or not r.trace.calls or not r.trace.device:   # no device traced
        return None
    return r.trace.host_launch_calls() / r.trace.calls
