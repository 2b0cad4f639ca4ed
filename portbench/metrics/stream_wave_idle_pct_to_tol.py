"""The share of the traced window in which the card is idle while the host
is inside an ``admm.wave`` span, whatever span inside it is open: the
harvest count's read at the wave's end, the launch of the next wave's
entry, and the gaps between the wave's graphs."""
from __future__ import annotations

from ..spans import has_spans

NAME = "stream.wave_idle_pct.to_tol"
UNIT = "%"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "scenario scheduler (parallel/scheduler.py _WaveProgram)"
MOVES = "solves_per_s.to_tol"
CELLS = ("bp.stream_f64",)
WAVE = "admm.wave"


def read(r):
    tr = r.trace
    if tr is None or not tr.calls or not tr.device or not has_spans(tr):
        return None
    waves = sorted((a, b) for n, a, b in tr.host if n == WAVE)
    if not waves:
        return None
    edges = [tr.start] + [t for ab in tr.busy for t in ab] + [tr.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    # both lists are sorted and the waves do not overlap: one sweep
    idle, j = 0.0, 0
    for g0, g1 in gaps:
        while j < len(waves) and waves[j][1] <= g0:
            j += 1
        k = j
        while k < len(waves) and waves[k][0] < g1:
            idle += min(g1, waves[k][1]) - max(g0, waves[k][0])
            k += 1
    return 100.0 * 1e-6 * idle / tr.window_s
