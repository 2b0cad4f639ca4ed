"""Observability: profiling scopes, convergence diagnostics, NaN guards.

Counterpart of :mod:`admmsolver_tpu.utils.telemetry`.  The reference's only
observability is the residual history lists and a per-iteration
``callback`` hook (``optimizer.py:162-163,304,315-316``).  Here:

* :func:`trace` — ``torch.profiler`` over CPU and CUDA activities around a
  solve, written as a Chrome trace;
* :func:`timed_solve` — wall time and instance-iterations/s of a solve;
* :func:`convergence_report` — post-hoc diagnostics from residual
  histories: iteration counts, stalls, non-finite values;
* :func:`check_finite_state` — aborts on NaN/Inf solver state between the
  segments of a long run;
* :func:`debug_nans` — a scope in which the engines check their state
  between chunks.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["trace", "convergence_report", "check_finite_state",
           "debug_nans", "timed_solve"]

# Set inside a ``debug_nans()`` scope; read by the engines between chunks.
_debug_nans = False


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _tensors(r):
    """Every tensor of a result object (a dataclass of tensors and tuples)."""
    for v in vars(r).values():
        for t in (v if isinstance(v, (tuple, list)) else (v,)):
            if isinstance(t, torch.Tensor):
                yield t


def timed_solve(solve, *, instances: int = 1, warmup: bool = True,
                repeats: int = 1) -> dict:
    """Run ``solve()`` and emit a throughput record.

    ``solve`` returns a result object with ``.iterations``; a CUDA result is
    waited for with ``torch.cuda.synchronize()`` before the clock stops.
    With ``warmup``, one unmeasured call absorbs first-use costs (kernel
    builds, cuBLAS handles).  Returns ``{"seconds", "iterations_total",
    "instance_iters_per_s", "result"}`` (the median over ``repeats``).
    """
    def run():
        r = solve()
        devices = {t.device for t in _tensors(r) if t.is_cuda}
        for d in devices:
            torch.cuda.synchronize(d)
        return r

    if warmup:
        run()
    times = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        r = run()
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    iters = int(np.sum(_host(r.iterations))) if hasattr(r, "iterations") else None
    out = {"seconds": dt, "iterations_total": iters, "result": r}
    if iters:
        out["instance_iters_per_s"] = iters / dt
    return out


@contextlib.contextmanager
def debug_nans(enabled: bool = True):
    """Raise ``FloatingPointError`` at the first non-finite chunk inside
    the scope.

    Torch has no per-operation trap like ``jax_debug_nans``: in this scope
    ``SimpleOptimizer`` checks its state after every iteration and the
    batched and fused engines after every chunk, which costs one host read
    each.  A fault is therefore reported at the end of the chunk that made
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
    device, and writes the Chrome trace ``trace_<pid>_<ns>.json`` into
    ``logdir``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
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
