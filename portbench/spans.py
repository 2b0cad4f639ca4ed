"""What the port's own spans, counters and device marks say of the traced
calls (``admmsolver_tpu_torch.utils.telemetry``).

While the profiler records, the port's spans (``admm.solve``,
``admm.chunk``, ``admm.replay``, ``admm.flags_read``, ...) are host events
of the profiler's timeline, beside the device's operations: they have no
copy on the device timeline, so the trace's device work is what it was
without them.  The port keeps its own record too: each call's counters
(``alloc_segments``, ``flag_reads``, ...) and the device marks of its
captured chunks and composite stages.  A program that has neither (an
older port) gives nothing to read, and the readers return None.
"""
from __future__ import annotations

from typing import Dict, List, Optional

PREFIX = "admm."
SOLVE = "admm.solve"
#: the idle time outside every program span
CALLER = "caller"


def has_spans(tr) -> bool:
    """Whether the traced calls hold the program's spans."""
    return any(n == SOLVE for n, _, _ in tr.host)


def idle_by_span(tr) -> Dict[str, float]:
    """Seconds of the traced window in which the card is idle, by the
    innermost program span the host was in (``caller`` outside all)."""
    edges = [tr.start] + [t for ab in tr.busy for t in ab] + [tr.end]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    spans = sorted((a, b, n) for n, a, b in tr.host if n.startswith(PREFIX))
    out: Dict[str, float] = {}
    stack: List[tuple] = []     # (end, name) of the open spans, innermost last
    i = 0
    for g0, g1 in gaps:
        t = g0
        while t < g1:
            while i < len(spans) and spans[i][0] <= t:
                a, b, n = spans[i]
                i += 1
                while stack and stack[-1][0] <= a:
                    stack.pop()
                stack.append((b, n))
            while stack and stack[-1][0] <= t:
                stack.pop()
            nxt = min(g1, spans[i][0] if i < len(spans) else g1,
                      stack[-1][0] if stack else g1)
            name = stack[-1][1] if stack else CALLER
            out[name] = out.get(name, 0.0) + 1e-6 * (nxt - t)
            t = nxt
    return out


def program_log() -> Optional[dict]:
    """The port's telemetry since its last reset, or None where the port
    keeps none."""
    try:
        from admmsolver_tpu_torch.utils import telemetry
    except ImportError:
        return None
    snapshot = getattr(telemetry, "snapshot", None)
    return None if snapshot is None else snapshot()


def traced_calls(r, log: Optional[dict]) -> Optional[List[dict]]:
    """The records of the calls the traced stretch annotated (the
    outermost ``admm.solve`` of each): the last ``r.trace.calls`` calls of
    the port's record, since the stretch's first call, which starts the
    tracer, comes before them and the spans go off with the profiler.  None
    where the record holds fewer."""
    if log is None or r.trace is None or not r.trace.calls:
        return None
    calls = [rec for rec in log["records"]
             if rec["name"] == SOLVE and "counters" in rec["attrs"]]
    if len(calls) < r.trace.calls:
        return None
    return calls[-r.trace.calls:]


def traced_marks(r, has: str) -> List[dict]:
    """The device marks read in the annotated calls that hold a mark named
    ``has``."""
    log = program_log()
    calls = traced_calls(r, log)
    if not calls:
        return []
    ids = {rec["call"] for rec in calls}
    return [m for m in log["marks"] if m["call"] in ids and has in m["marks"]]
