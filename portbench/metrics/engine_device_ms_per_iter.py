"""Device time of the traced calls over the iterations their batches ran (the
largest lane count of each call): what one iteration of the batched engine
costs the card."""
from __future__ import annotations

NAME = "engine.device_ms_per_iter"
UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "batched engine (parallel/batch.py _run, optimizer.ADMMPlan)"
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.lpath_f64",)


def read(r):
    if r.trace is None or r.traced_batch_iterations <= 0 or r.trace.busy_s <= 0:
        return None
    return 1e3 * r.trace.busy_s / r.traced_batch_iterations
