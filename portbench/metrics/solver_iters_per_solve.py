"""The mean of the lanes' iteration counts over every call of the run: how
much work the stopping rule and the penalty updates leave per problem."""
from __future__ import annotations

NAME = "solver.iters_per_solve"
UNIT = "iterations"
BETTER = "lower"
SOURCE = "program_counter"
LAYER = "solver (optimizer.py: convergence and penalty update)"
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.lpath_f64", "spm.mixed_f64")


def read(r):
    if not r.lanes_total:
        return None
    return r.iterations_total / r.lanes_total
