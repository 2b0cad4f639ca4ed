"""Elementwise proximal primitives (``admmsolver_tpu/ops/prox.py:18-30``)."""
from __future__ import annotations

import torch

__all__ = ["soft_threshold", "project_nonneg"]


def soft_threshold(y: torch.Tensor, lam) -> torch.Tensor:
    """Soft-thresholding shrinkage (reference ``_softmax``).

    ``y - lam`` where ``y > lam``; ``y + lam`` where ``y < -lam``; else 0
    (``objectivefunc.py:335-355``).
    """
    return torch.sign(y) * torch.clamp_min(torch.abs(y) - lam, 0.0)


def project_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative orthant (``_project_plus``,
    ``objectivefunc.py:330-333``)."""
    return torch.clamp_min(x, 0.0)
