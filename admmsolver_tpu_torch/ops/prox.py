"""Proximal primitives (``admmsolver_tpu/ops/prox.py:18-53``): the
elementwise shrinkages and the PSD-cone projection of Hermitian slices."""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["soft_threshold", "project_nonneg", "psd_project"]


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


def psd_project(x: torch.Tensor, shape: Sequence[int], axis: int) -> torch.Tensor:
    """Project the Hermitian slices of a 3-way tensor onto the PSD cone.

    The last axis of ``x`` holds ``prod(shape)`` entries; it is viewed as
    ``shape`` and sliced along ``axis``.  Leading axes (one problem instance
    per row in the batched engine) join the slices, so that every slice of
    every row goes through ONE batched ``torch.linalg.eigh`` (the reference
    loops ``np.linalg.eigh`` over the slices, ``objectivefunc.py:320-327``).

    Each slice is the Hermitian matrix the reference diagonalizes: its lower
    triangle mirrored, its diagonal real (``np.linalg.eigh`` reads only
    ``UPLO='L'``).  The slices are not exactly Hermitian inside the ADMM loop,
    so this is not a symmetrization.  Eigenvalues are clamped at 0 and the
    slice rebuilt with one batched product.  Complex slices stay complex.
    """
    lead = tuple(x.shape[:-1])
    shape = tuple(int(s) for s in shape)
    ax = len(lead) + int(axis)
    x3 = torch.movedim(x.reshape(lead + shape), ax, len(lead))     # (..., K, n, n)
    n = x3.shape[-1]
    lo = torch.tril(x3, -1)
    diag = torch.diagonal(x3, dim1=-2, dim2=-1).real
    herm = lo + lo.mH + torch.diag_embed(diag).to(x3.dtype)
    w, V = torch.linalg.eigh(herm.reshape(-1, n, n))
    proj = (V * torch.clamp_min(w, 0.0).to(V.dtype)[:, None, :]) @ V.mH
    proj = proj.reshape(x3.shape)
    return torch.movedim(proj, len(lead), ax).reshape(x.shape)
