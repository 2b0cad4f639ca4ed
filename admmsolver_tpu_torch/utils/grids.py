"""Smoothness-regularizer stencil helpers.

Counterpart of :mod:`admmsolver_tpu.utils.grids` (reference ``util.py:
4-41``): second-derivative projection matrices on a non-uniform mesh,
feeding :class:`~admmsolver_tpu_torch.models.objectivefunc.L2Regularizer`
in the SpM analytic-continuation workload.  Set-up-time constants built
with numpy on the host; the banded forms are
:class:`~admmsolver_tpu_torch.ops.linop.BandedMatrix` operators whose Grams
stay banded.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["second_deriv_prj", "smooth_regularizer_coeff",
           "second_deriv_banded", "smooth_regularizer_banded", "norm"]


def _check_increasing(x: np.ndarray, name: str) -> None:
    if not np.all(x[1:] > x[:-1]):
        raise ValueError(f"{name} must be in increasing order!")


def second_deriv_prj(x: np.ndarray) -> np.ndarray:
    """Second-derivative stencil on a non-uniform increasing mesh.

    Returns P with ``y''(x_i) ≈ (P @ y)_i`` for interior points
    (reference ``util.py:4-23``, vectorized).
    """
    x = np.asarray(x)
    _check_increasing(x, "x")
    n = x.size
    dxf = x[2:] - x[1:-1]   # forward spacing at interior point ip
    dxb = x[1:-1] - x[:-2]  # backward spacing
    coeff = 2.0 / (dxf**2 * dxb + dxb**2 * dxf)
    prj = np.zeros((n - 2, n), dtype=np.float64)
    rows = np.arange(n - 2)
    prj[rows, rows] = coeff * dxf
    prj[rows, rows + 1] = coeff * (-dxb - dxf)
    prj[rows, rows + 2] = coeff * dxb
    return prj


def smooth_regularizer_coeff(omega: np.ndarray) -> np.ndarray:
    """√dx-weighted stencil with ``||P y||² ≈ ∫ |y''|² dω``
    (reference ``util.py:26-39``)."""
    omega = np.asarray(omega)
    _check_increasing(omega, "omega")
    dx = 0.5 * (omega[2:] - omega[:-2])
    return np.sqrt(dx)[:, None] * second_deriv_prj(omega)


def second_deriv_banded(x: np.ndarray):
    """:func:`second_deriv_prj` as a
    :class:`~admmsolver_tpu_torch.ops.linop.BandedMatrix` (offsets 0, 1, 2):
    O(N) storage, and couplings and Grams built from it stay banded (``P†P``
    is pentadiagonal, not a dense N×N array).  Value-identical to the dense
    stencil."""
    from ..ops.linop import BandedMatrix

    x = np.asarray(x)
    _check_increasing(x, "x")
    n = x.size
    dxf = x[2:] - x[1:-1]
    dxb = x[1:-1] - x[:-2]
    coeff = 2.0 / (dxf**2 * dxb + dxb**2 * dxf)
    bands = np.stack([coeff * dxf, coeff * (-dxb - dxf), coeff * dxb])
    return BandedMatrix((0, 1, 2), bands, (n - 2, n))


def smooth_regularizer_banded(omega: np.ndarray):
    """:func:`smooth_regularizer_coeff` in banded form (see
    :func:`second_deriv_banded`)."""
    omega = np.asarray(omega)
    _check_increasing(omega, "omega")
    dx = 0.5 * (omega[2:] - omega[:-2])
    P = second_deriv_banded(omega)
    return type(P)(P.offsets, P.bands * torch.as_tensor(np.sqrt(dx))[None, :], P.shape)


def norm(x) -> float:
    """2-norm (reference ``util.py:41``)."""
    return float(np.linalg.norm(np.asarray(x)))
