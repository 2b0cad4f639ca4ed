"""The share of the run's lanes that the solver returned converged: useful
outcomes over attempts."""
from __future__ import annotations

NAME = "solver.converged_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_counter"
LAYER = "solver (optimizer.py: convergence and penalty update)"
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.lpath_f64", "spm.mixed_f64")


def read(r):
    if not r.lanes_total:
        return None
    return 100.0 * r.converged_total / r.lanes_total
