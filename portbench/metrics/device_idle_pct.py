"""The share of the traced window in which no operation ran on the device:
one less the union of the device's activity over the window."""
from __future__ import annotations

NAME = "device.idle_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device (H100)"
MOVES = "solves_per_s"
CELLS = ("bp.fused_f32",)


def read(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
