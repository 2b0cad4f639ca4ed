"""``fused.kernel_share_pct`` in the cells of short calls, whose host work per call shows
in their spread (they report ``solves_per_s.short``)."""
from __future__ import annotations

from .fused_kernel_share_pct import BETTER, LAYER, SOURCE, UNIT, read  # noqa: F401

NAME = "fused.kernel_share_pct.short"
MOVES = "solves_per_s.short"
CELLS = ("spm.fused_f32",)
