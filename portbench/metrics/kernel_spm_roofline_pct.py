"""The SpM chunk kernel's share of its roofline: the least time the card could
take for the algorithm's work in the traced calls (``counts.spm``: every
multiply-add the inputs need, counted once, whatever implements it) over the
device time of the kernels named ``fused_spm``.  Where no such kernel ran,
or the card has no entry in the table of peaks, there is nothing to read."""
from __future__ import annotations

from ..counts import spm
from ..peaks import peaks_of

NAME = "kernel.spm.roofline_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "SpM chunk kernel (ops/kernels.py, csrc/fused_spm.cu)"
MOVES = "solves_per_s.short"
CELLS = ("spm.fused_f32",)
KERNEL = "fused_spm"


def read(r):
    peaks = peaks_of(r.device_name)
    if r.trace is None or peaks is None or not r.trace.launches(KERNEL):
        return None
    # a lane's mean iterations in a traced call
    iters = r.traced_iterations / (r.lanes * r.trace.calls)
    w = spm.work(r.lanes, r.cfg["nl"], r.cfg["nw"], iters)
    bound = r.trace.calls * spm.bound_s(w, peaks)
    return 100.0 * bound / r.trace.device_s(KERNEL)
