"""The chunk kernel's share of all device time in the traced calls of a fused
solve: what the step around the kernel (denominators, factor refresh,
residuals, penalty update) leaves to it."""
from __future__ import annotations

NAME = "fused.kernel_share_pct"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "fused chunk around the kernel (parallel/fused.py, parallel/fused_spm.py)"
MOVES = "solves_per_s"
CELLS = ("bp.fused_f32",)
KERNELS = ("fused_two_block", "fused_spm")


def read(r):
    if r.trace is None:
        return None
    kernel = sum(r.trace.device_s(k) for k in KERNELS)
    total = r.trace.device_s()
    if kernel <= 0 or total <= 0:
        return None
    return 100.0 * kernel / total
