"""Shared helpers of the benchmark's tests: the cells at a size the CPU runs
in seconds, and the card fixture."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench import harness  # noqa: E402

CELLS = sorted(harness.workloads())


def small(cell: str, lanes: int = 8, niter: int = 200) -> dict:
    """The cell's workload at a CPU size: ``lanes`` lanes, two batches,
    ``niter`` iterations a phase; a weight sweep over the lanes of one
    measurement, as the cell's."""
    w = copy.deepcopy(harness.load_json("workloads", cell))
    w["lanes"], w["pool"] = lanes, 2
    for k in ("niter", "niter_low"):
        if k in w["solve"]:
            w["solve"][k] = niter
    if "alpha1" in w["inputs"]:
        w["inputs"] = {"alpha1": {"logspace": [-3, 1, lanes]}, "measurements": 1}
    w["check"]["block"] = lanes // 2      # two blocks of lanes: the block loop runs
    return w


@pytest.fixture
def card():
    """The CUDA device; skips where there is none (decided here, never at
    import, so that every worker collects the same tests)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
