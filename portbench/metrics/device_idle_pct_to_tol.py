"""``device.idle_pct`` in the cells whose calls wait on the solver's
stopping rule (they report ``solves_per_s.to_tol``)."""
from __future__ import annotations

from .device_idle_pct import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

NAME = "device.idle_pct.to_tol"
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.lpath_f64", "spm.mixed_f64")
