"""The two-block chunk kernel's share of its roofline: the least time the card
could take for the algorithm's work in the traced calls (``counts.
two_block``: every multiply-add the inputs need, counted once, whatever
implements it) over the device time of the kernels named ``fused_two_block``.
Where no such kernel ran, or the card has no entry in the table of peaks,
there is nothing to read."""
from __future__ import annotations

from ..counts import two_block
from ..peaks import peaks_of

NAME = "kernel.two_block.roofline_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "two-block chunk kernel (ops/kernels.py, csrc/fused_two_block.cu)"
MOVES = "solves_per_s"
CELLS = ("bp.fused_f32",)
KERNEL = "fused_two_block"


def read(r):
    peaks = peaks_of(r.device_name)
    if r.trace is None or peaks is None or not r.trace.launches(KERNEL):
        return None
    N, M = r.cfg["N"], r.cfg["M"]
    R, thin = (M, True) if M < N else (N, False)
    # a lane's mean iterations in a traced call
    iters = r.traced_iterations / (r.lanes * r.trace.calls)
    w = two_block.work(r.lanes, N, R, iters, thin=thin)
    bound = r.trace.calls * two_block.bound_s(w, peaks)
    return 100.0 * bound / r.trace.device_s(KERNEL)
