"""``program.host_calls_per_call`` in the cells of short calls, whose host work per call shows
in their spread (they report ``solves_per_s.short``)."""
from __future__ import annotations

from .program_host_calls_per_call import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

NAME = "program.host_calls_per_call.short"
MOVES = "solves_per_s.short"
CELLS = ("spm.fused_f32",)
