"""``device.idle_pct`` in the cells of short calls, whose host work per call shows
in their spread (they report ``solves_per_s.short``)."""
from __future__ import annotations

from .device_idle_pct import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

NAME = "device.idle_pct.short"
MOVES = "solves_per_s.short"
CELLS = ("spm.fused_f32",)
