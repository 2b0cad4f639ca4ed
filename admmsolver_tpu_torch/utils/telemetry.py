"""Observability: spans and counters inside the programs, device marks,
profiling scopes, convergence diagnostics, NaN guards.

Counterpart of :mod:`admmsolver_tpu.utils.telemetry`.  The reference's only
observability is the residual history lists and a per-iteration
``callback`` hook (``optimizer.py:162-163,304,315-316``).  Here:

* :func:`tracing` — the one switch of the process for what follows; on
  inside ``tracing()`` and, unless ``tracing(False)`` says otherwise, while
  a ``torch.profiler`` records (the marks inside captured graphs only
  inside ``tracing()``: :func:`marking`);
* :func:`span` — a named stretch of the host's work (``admm.solve``,
  ``admm.chunk``, ``admm.replay``, ``admm.wave``, ...): an event on the
  profiler's timeline and a record kept here; :func:`count` — a counter
  (``flag_reads``, ``replays``, a stream's ``waves``, ``scenarios_out``,
  ``stream.slot_iters`` and ``stream.lane_iters``, the lane-applications of
  the singular-value threshold by route ``prox.svt.<route>``, ...; those
  made inside a captured chunk counted at its capture and added at each
  replay: :func:`capturing`); :class:`Marks` —
  timing events on the device (inside a captured graph, or on the stream
  around a composite's stages), read without waiting for them;
  :func:`snapshot` / :func:`reset` — everything recorded since the last
  reset;
* :func:`trace` — ``torch.profiler`` over CPU and CUDA activities around a
  solve, written as a Chrome trace with the spans in it;
* :func:`convergence_report` — post-hoc diagnostics from residual
  histories: iteration counts, stalls, non-finite values;
* :func:`check_finite_state` — aborts on NaN/Inf solver state between the
  segments of a long run;
* :func:`debug_nans` — a scope in which the engines check their state
  between chunks.

With the switch off a span is one shared null context and a counter or
mark does nothing: the programs pay a flag test at each boundary, and
their graphs are those they capture without marks.  The spans are
recorded from one thread.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import os
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.autograd.profiler as _profiler

__all__ = ["trace", "convergence_report", "check_finite_state",
           "debug_nans", "tracing", "enabled", "span", "spanned", "count", "capturing",
           "mark", "marking", "Marks", "snapshot", "reset"]

# Set inside a ``debug_nans()`` scope; read by the engines between chunks.
_debug_nans = False

#: the span of a public solve entry; the outermost one opens a call
SOLVE = "admm.solve"
#: span records and mark readings kept, the oldest dropped first
MAX_RECORDS = 1 << 16

# None: follow the profiler; True or False inside a ``tracing()`` scope
_switch: Optional[bool] = None
# the marks a capture under way records into (:func:`mark`)
_collector: Optional["Marks"] = None
# the counts a capture under way takes for its replays (:func:`capturing`)
_captured: Optional[Dict[str, float]] = None


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def enabled() -> bool:
    """Whether spans, counters and marks record: inside ``tracing(True)``,
    or outside any ``tracing()`` scope while a ``torch.profiler`` records
    in this process (so that a profile of a solve carries its spans)."""
    return _profiler._is_profiler_enabled if _switch is None else _switch


def marking() -> bool:
    """Whether the programs capture and replay their graphs with device
    marks in them: inside ``tracing(True)`` alone.  A profiler without it
    turns on the spans, counters and the marks outside graphs, but not
    these: they take graphs of their own, whose captures inside the
    profile (each emptying the allocator's cache) would change what it
    sees."""
    return _switch is True


@contextlib.contextmanager
def tracing(enabled: bool = True):
    """The switch of the spans, counters and marks for the scope, one for
    the whole process like :func:`debug_nans`; ``tracing(False)`` keeps
    them off under a profiler too.  On, a solve records its spans and
    counters, and a program captures its graphs once more with timing
    events in them (:class:`Marks`, :func:`marking`), which its replays
    then record."""
    global _switch
    prev = _switch
    _switch = bool(enabled)
    try:
        yield
    finally:
        _switch = prev


class _Record:
    """One span: its name, start and end (``time.perf_counter_ns``), the id
    of the span around it, the call it belongs to and its attributes."""

    __slots__ = ("id", "name", "start", "end", "parent", "call", "attrs")

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


class _Log:
    """What the switch records, until the next :func:`reset`."""

    def __init__(self) -> None:
        self.records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
        #: the open spans, innermost last
        self.open: List[_Record] = []
        self.counters: Dict[str, float] = {}
        #: the device marks read: {"call", attributes..., "marks": {name: ms}}
        self.timed: collections.deque = collections.deque(maxlen=MAX_RECORDS)
        #: marks whose last recording is not read yet
        self.pending: Dict[int, "Marks"] = {}
        #: the id of the open call (the outermost ``admm.solve``), and the last
        self.call: Optional[int] = None
        self.calls = 0
        self.ids = 0
        #: the kernels' launch counters at the reset
        self.launches = {name: k.launches for name, k in _kernels().items()}


def _kernels() -> dict:
    """The kernels' launch counters (``ops.kernels.launch_counters``: the
    wrappers and their routes, e.g. ``fused_two_block_chunk.wgmma``), by
    name (imported only once the port's kernels are)."""
    kernels = sys.modules.get("admmsolver_tpu_torch.ops.kernels")
    if kernels is None:
        return {}
    return {f.__name__: f for f in kernels.launch_counters()}


_log = _Log()


def _segments(device) -> Optional[int]:
    """The caching allocator's count of segments it has allocated on
    ``device`` (a ``cudaMalloc`` each; None: the current CUDA device), None
    off a CUDA device."""
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats_as_nested_dict(device)["segment"]["all"]["allocated"]


class _Span:
    """An open span (:func:`span`): a FUNCTION-scope ``RecordFunction`` on the
    profiler's timeline (a host event with no copy on the device timeline,
    where a ``record_function`` annotation would have one) and a record.
    The outermost ``admm.solve`` opens a call: its record takes the changes
    of the counters in the call (``counters``) and, on a CUDA device, the
    segments the allocator took in it (``alloc_segments``)."""

    __slots__ = ("rec", "rf", "log", "device", "before")

    def __init__(self, name: str, attrs: dict, device=None) -> None:
        self.rec = _Record()
        self.rec.name, self.rec.attrs = name, attrs
        self.device, self.before = device, None

    def __enter__(self):
        log = self.log = _log
        rec = self.rec
        log.ids += 1
        rec.id, rec.end = log.ids, None
        rec.parent = log.open[-1].id if log.open else None
        if rec.name == SOLVE and log.call is None:
            log.calls += 1
            log.call = log.calls
            self.before = (dict(log.counters), _segments(self.device))
        rec.call = log.call
        log.open.append(rec)
        log.records.append(rec)
        rec.start = time.perf_counter_ns()
        self.rf = torch._C._profiler._RecordFunctionFast(rec.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.rf.__exit__(*exc)
        log, rec = self.log, self.rec
        rec.end = time.perf_counter_ns()
        if log.open and log.open[-1] is rec:
            log.open.pop()
        if self.before is not None:
            counters, segments = self.before
            if segments is not None:
                n = rec.attrs["alloc_segments"] = _segments(self.device) - segments
                log.counters["alloc_segments"] = log.counters.get("alloc_segments", 0) + n
            rec.attrs["counters"] = {k: v - counters.get(k, 0)
                                     for k, v in log.counters.items()
                                     if v != counters.get(k, 0)}
            log.call = None
        return False


_NULL = contextlib.nullcontext()


def span(name: str, **attrs):
    """A context manager around a stretch of the host's work, named
    ``name`` (readers match on it) with ``attrs`` (a chunk's key, a stage's
    label); with the switch off the one shared null context."""
    if not enabled():
        return _NULL
    return _Span(name, attrs)


def spanned(name: str):
    """A method decorator: each call inside a span ``name`` with the
    method's name as ``entry``; an ``admm.solve`` span reads the allocator
    of the object's ``device`` (without one, of the current CUDA device)."""
    def wrap(fn):
        entry = fn.__qualname__

        @functools.wraps(fn)
        def inner(self, *args, **kwargs):
            if not enabled():
                return fn(self, *args, **kwargs)
            with _Span(name, {"entry": entry}, getattr(self, "device", None)):
                return fn(self, *args, **kwargs)
        return inner
    return wrap


def count(name: str, n: float = 1) -> None:
    """Add ``n`` to the counter ``name``, with the switch on; inside a
    capture (:func:`capturing`), whatever the switch, to the capture's
    counts, which each replay of its graph adds."""
    if _captured is not None:
        _captured[name] = _captured.get(name, 0) + n
    elif enabled():
        _log.counters[name] = _log.counters.get(name, 0) + n


@contextlib.contextmanager
def capturing(counts: Dict[str, float]):
    """The scope of a graph's capture, in which nothing runs: the counts
    made in it (the work a replay will do, such as ``prox.svt.<route>``)
    go to ``counts`` rather than to the log."""
    global _captured
    prev = _captured
    _captured = counts
    try:
        yield
    finally:
        _captured = prev


class Marks:
    """Timing events on the current CUDA stream, named in the order they
    are recorded: those of one captured graph (``external``: recorded into
    the graph as it is captured, so that each replay records them again),
    or those a program records on the stream at each run.

    :meth:`begin` opens a recording (a replay, a run) in the current call.
    Nothing waits for its events: the next :meth:`begin` first reads the
    last recording where its events are complete (a recording still queued
    on the device is dropped: its events are about to be recorded again),
    and :func:`snapshot` reads what is left once the caller has
    synchronised.  A reading is each mark's milliseconds after the first,
    with the call and the attributes; ``counter`` counts the readings."""

    def __init__(self, counter: str, external: bool = False, **attrs) -> None:
        self.counter, self.external, self.attrs = counter, external, attrs
        self.names: List[str] = []
        self.events: List[torch.cuda.Event] = []
        self.at = 0
        self.call: Optional[int] = None
        self.open = False

    def record(self, name: str) -> None:
        """Record the next mark on the current stream (its event made at the
        first recording)."""
        if self.at == len(self.events):
            self.events.append(torch.cuda.Event(enable_timing=True, external=self.external))
            self.names.append(name)
        self.events[self.at].record()
        self.at += 1

    def begin(self) -> None:
        """Open a recording: the last one read where it is complete, else
        dropped."""
        if self.open:
            self.read()
        log = _log
        self.at, self.call, self.open = 0, log.call, True
        log.pending[id(self)] = self

    def read(self) -> bool:
        """The open recording's reading where its events are complete; whether
        it was read."""
        log = _log
        if not self.events[-1].query():
            self.open = False
            log.pending.pop(id(self), None)
            return False
        first = self.events[0]
        log.timed.append({"call": self.call, **self.attrs,
                          "marks": {n: first.elapsed_time(e)
                                    for n, e in zip(self.names, self.events)}})
        log.counters[self.counter] = log.counters.get(self.counter, 0) + 1
        self.open = False
        log.pending.pop(id(self), None)
        return True


@contextlib.contextmanager
def collecting(marks: Marks):
    """The scope of a capture into whose graph :func:`mark` records."""
    global _collector
    prev = _collector
    _collector = marks
    try:
        yield
    finally:
        _collector = prev


def mark(name: str) -> None:
    """A device mark named ``name`` in the graph being captured with marks;
    nothing elsewhere."""
    if _collector is not None:
        _collector.record(name)


def snapshot() -> dict:
    """Everything recorded since the last :func:`reset`: ``spans`` by name
    (count, total and self seconds: the duration less the time the spans
    inside it cover), the raw ``records``, the ``counters`` (with the
    kernels' ``kernel.<name>.launches`` since the reset) and the device
    ``marks`` read, those still unread read first where complete (the
    caller synchronises before, to have them all)."""
    log = _log
    for m in list(log.pending.values()):
        if m.events[-1].query():
            m.read()
    closed = [r for r in log.records if r.end is not None]
    inner: Dict[int, int] = {}
    for r in closed:
        if r.parent is not None:
            inner[r.parent] = inner.get(r.parent, 0) + r.end - r.start
    spans: Dict[str, dict] = {}
    for r in closed:
        s = spans.setdefault(r.name, {"count": 0, "total_s": 0.0, "self_s": 0.0})
        s["count"] += 1
        s["total_s"] += 1e-9 * (r.end - r.start)
        s["self_s"] += 1e-9 * (r.end - r.start - inner.get(r.id, 0))
    counters = dict(log.counters)
    for name, k in _kernels().items():
        counters[f"kernel.{name}.launches"] = k.launches - log.launches.get(name, 0)
    return {"spans": spans, "records": [r.as_dict() for r in log.records],
            "counters": counters, "marks": list(log.timed)}


def reset() -> None:
    """Forget everything recorded; a recording of marks still open is
    dropped."""
    global _log
    for m in _log.pending.values():
        m.open = False
    _log = _Log()


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Raise ``FloatingPointError`` at the first non-finite chunk inside
    the scope.

    Torch has no per-operation trap like ``jax_debug_nans``: in this scope
    every engine checks its state after every chunk (``SimpleOptimizer``
    with a callback: every iteration), which costs one host read each.  A fault is therefore reported at the end of the chunk that made
    it, not at the operation.  Like ``jax_debug_nans`` the switch is one
    for the whole process."""
    global _debug_nans
    prev = _debug_nans
    _debug_nans = bool(enabled)
    try:
        yield
    finally:
        _debug_nans = prev


def check_chunk(what: str, *state) -> None:
    """Inside :func:`debug_nans`, raise when a state tensor holds NaN or
    Inf; a no-op (no host read) outside it.  ``state`` are tensors or
    sequences of tensors."""
    if not _debug_nans:
        return
    for s in state:
        for t in (s if isinstance(s, (tuple, list)) else (s,)):
            if not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"{what}: non-finite state after a chunk "
                                         "(debug_nans)")


@contextlib.contextmanager
def trace(logdir: str):
    """Profile a solve: ``with trace('/tmp/trace'): solver.solve(...)``.

    Runs ``torch.profiler`` over the CPU and, where there is one, the CUDA
    device, with the spans on (:func:`tracing`), and writes the Chrome
    trace ``trace_<pid>_<ns>.json`` into ``logdir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with tracing(), profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def convergence_report(primal, dual, rtol: Optional[float] = None) -> dict:
    """Diagnostics from residual histories (accepts the single-instance
    lists or one lane of a batched (niter,) buffer)."""
    primal = np.asarray(_host(primal), dtype=float)
    dual = np.asarray(_host(dual), dtype=float)
    mask = np.isfinite(primal)
    n = int(mask.sum())
    report = {
        "iterations": n,
        "finite": bool(np.isfinite(primal[mask]).all()
                       and np.isfinite(dual[:n]).all()),
        "final_primal": float(primal[mask][-1]) if n else None,
        "final_dual": float(dual[:n][-1]) if n else None,
    }
    if n >= 20:
        # stall: no order-of-magnitude progress over the last half
        half = primal[mask][n // 2:]
        report["stalled"] = bool(half.min() > 0 and half[-1] > 0.5 * half[0])
        report["reduction_rate"] = float(
            (np.log10(half[-1] + 1e-300) - np.log10(half[0] + 1e-300))
            / max(len(half) - 1, 1))
    else:
        report["stalled"] = False
        report["reduction_rate"] = None
    return report


def check_finite_state(opt) -> None:
    """Raise ``FloatingPointError`` when solver state went non-finite
    (call between ``solve()`` segments of long runs)."""
    for i, x_ in enumerate(opt.x):
        if not np.isfinite(_host(x_)).all():
            raise FloatingPointError(
                f"non-finite primal state in block {i}; aborting (check "
                "problem conditioning / penalty bounds)")
    for i, h_ in enumerate(opt.h):
        if not np.isfinite(_host(h_)).all():
            raise FloatingPointError(
                f"non-finite dual state for pair {i}; aborting")
