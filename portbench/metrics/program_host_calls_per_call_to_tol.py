"""``program.host_calls_per_call`` in the cells whose calls wait on the
solver's stopping rule (they report ``solves_per_s.to_tol``)."""
from __future__ import annotations

from .program_host_calls_per_call import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

NAME = "program.host_calls_per_call.to_tol"
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.lpath_f64", "spm.mixed_f64")
