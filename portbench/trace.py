"""Reduction of a ``torch.profiler`` trace of the traced calls to what the
per-layer metrics read: device time by operation, the union of device
activity, the idle gaps with what the host was doing, and the host's calls
that put work on a stream.

The traced window runs from the start of the first ``portbench.call``
annotation to the end of the last, on the profiler's own clock, so device
and host events are read on one timeline.  Inside each call,
``portbench.solve`` spans the call into the code under test alone, without
the harness's own bookkeeping.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

CALL = "portbench.call"
SOLVE = "portbench.solve"
ANNOTATIONS = (CALL, SOLVE)
#: the runtime calls by which the host puts work on a stream (profiler keys)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """The traced window of a profile: ``device`` (name, start, end) of every
    device operation, ``host`` (name, start, end) of every host event,
    times in microseconds."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]]) -> None:
        calls = [(a, b) for n, a, b in host if n == CALL]
        self.calls = len(calls)
        self.start = min((a for a, _ in calls), default=0.0)
        self.end = max((b for _, b in calls), default=0.0)
        clip = lambda a, b: (max(a, self.start), min(b, self.end))
        self.device = [(n,) + clip(a, b) for n, a, b in device if b > self.start and a < self.end]
        self.host = [(n, a, b) for n, a, b in host if b > self.start and a < self.end]
        self.busy = _union([(a, b) for _, a, b in self.device])
        self.solves = sorted((a, b) for n, a, b in self.host if n == SOLVE)

    @classmethod
    def from_profiler(cls, prof) -> "Trace":
        device, host = [], []
        for e in prof.events():
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type.name == "CPU":
                host.append(row)
            elif e.name not in ANNOTATIONS:   # their copies on the device timeline are no work
                device.append(row)
        return cls(device, host)

    @property
    def window_s(self) -> float:
        return 1e-6 * (self.end - self.start)

    @property
    def busy_s(self) -> float:
        return 1e-6 * sum(b - a for a, b in self.busy)

    def device_s(self, contains: str = "") -> float:
        """Device time of the operations whose name contains ``contains``."""
        return 1e-6 * sum(b - a for n, a, b in self.device if contains in n)

    def launches(self, contains: str) -> int:
        return sum(1 for n, _, _ in self.device if contains in n)

    def host_launch_calls(self) -> int:
        """The host's calls that put work on a stream inside the solves."""
        return sum(1 for n, a, b in self.host if n in HOST_LAUNCH_CALLS
                   and any(s0 <= a and b <= s1 for s0, s1 in self.solves))

    def top_ops(self, k: int = 10) -> List[list]:
        """The device operations that took most time, by name: [name, s]."""
        by: Dict[str, float] = {}
        for n, a, b in self.device:
            by[n] = by.get(n, 0.0) + 1e-6 * (b - a)
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The longest stretches of the window with no device operation, each
        named by the innermost host event that covers half of it or more (the
        shortest such; else the one that overlaps it most): [name, s]."""
        edges = [self.start] + [t for ab in self.busy for t in ab] + [self.end]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:k]
        out = []
        for g0, g1 in gaps:
            best = None
            for n, a, b in self.host:
                ov = min(b, g1) - max(a, g0)
                if ov > 0:
                    key = (2 * ov >= g1 - g0, -(b - a) if 2 * ov >= g1 - g0 else ov)
                    if best is None or key > best[0]:
                        best = (key, n)
            out.append([f"host: {best[1] if best else 'none'}", 1e-6 * (g1 - g0)])
        return out
