"""Carry models and solver state over from the JAX package.

The port never imports ``jax``: :func:`from_jax_model` reads a
``admmsolver_tpu`` model's arrays through ``np.asarray`` and dispatches on
class names, and :func:`state_from_numpy` takes a JAX result already turned
into numpy.  :func:`batch_result_to_numpy` and :func:`batch_state_from_numpy`
carry a batched solve's state from one package to the other.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .models.objectivefunc import (BoxProjectionPenalty, ConstrainedLeastSquares,
                                   GroupL1Regularizer, HuberLoss, L1Regularizer,
                                   L2Regularizer, LeastSquares, NonNegativePenalty,
                                   NuclearNormPenalty, ObjectiveFunctionBase,
                                   SemiPositiveDefinitePenalty)
from .models.problem import Model
from .models.realify import RealPartProx
from .ops.linop import (BandedMatrix, DenseMatrix, DiagonalMatrix,
                        InterleavedComplexDiagonalMatrix, MatrixBase,
                        PartialDiagonalMatrix, ScaledIdentityMatrix)

__all__ = ["from_jax_model", "state_from_numpy", "batch_result_to_numpy",
           "batch_state_from_numpy"]


def _tensor(a, device, dtype) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers
    a = np.array(a)
    if dtype is not None and np.iscomplexobj(a) and not dtype.is_complex:
        # complex arrays keep a complex dtype of the requested precision
        dtype = torch.complex64 if dtype == torch.float32 else torch.complex128
    return torch.as_tensor(a, device=device, dtype=dtype)


def _operator(op, device, dtype) -> MatrixBase:
    name = type(op).__name__
    if name == "DenseMatrix":
        return DenseMatrix(_tensor(op.data, device, dtype))
    if name == "DiagonalMatrix":
        return DiagonalMatrix(_tensor(op.diagonals, device, dtype), op.shape)
    if name == "ScaledIdentityMatrix":
        c = np.asarray(op.coeff)
        return ScaledIdentityMatrix(op.shape, c.item() if dtype is None else
                                    _tensor(c, device, dtype))
    if name == "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(_operator(op.matrix, device, dtype), op.rest_dims)
    if name == "InterleavedComplexDiagonalMatrix":
        return InterleavedComplexDiagonalMatrix(_tensor(op.re, device, dtype),
                                                _tensor(op.im, device, dtype))
    if name == "BandedMatrix":
        return BandedMatrix(op.offsets, _tensor(op.bands, device, dtype), op.shape)
    raise TypeError(f"admmsolver_tpu_torch has no counterpart of operator {name} yet")


def _objective(f, device, dtype) -> ObjectiveFunctionBase:
    name = type(f).__name__
    if name == "LeastSquares":
        return LeastSquares(float(np.asarray(f._alpha)),
                            _operator(f._A, device, dtype),
                            _tensor(f._y, device, dtype))
    if name == "ConstrainedLeastSquares":
        return ConstrainedLeastSquares(float(np.asarray(f._alpha)),
                                       _operator(f._A, device, dtype),
                                       _tensor(f._y, device, dtype),
                                       _operator(f._C, device, dtype),
                                       _tensor(f._D, device, dtype))
    if name == "L2Regularizer":
        return L2Regularizer(float(np.asarray(f._alpha)),
                             _operator(f._A, device, dtype))
    if name == "L1Regularizer":
        offset = None if f._offset is None else _tensor(f._offset, device, dtype)
        return L1Regularizer(float(np.asarray(f._alpha)), int(f._size_x), offset)
    if name == "NonNegativePenalty":
        return NonNegativePenalty(int(f._size_x))
    if name == "BoxProjectionPenalty":
        return BoxProjectionPenalty(int(f._size_x), _tensor(f._lo, device, dtype),
                                    _tensor(f._hi, device, dtype))
    if name == "GroupL1Regularizer":
        return GroupL1Regularizer(float(np.asarray(f._alpha)), f._gs, f._ng)
    if name == "HuberLoss":
        return HuberLoss(float(np.asarray(f._alpha)), _tensor(f._y, device, dtype), f._delta)
    if name == "NuclearNormPenalty":
        return NuclearNormPenalty(float(np.asarray(f._alpha)), f._mn, f._svd_method)
    if name == "SemiPositiveDefinitePenalty":
        return SemiPositiveDefinitePenalty(f._shape, f._axis)
    if name == "RealPartProx":
        return RealPartProx(_objective(f._inner, device, dtype))
    raise TypeError(f"admmsolver_tpu_torch has no counterpart of objective {name} yet")


def from_jax_model(model, device="cuda", dtype: Optional[torch.dtype] = None) -> Model:
    """The port's :class:`Model` for an ``admmsolver_tpu.Model``.

    Arrays keep their numpy dtype unless ``dtype`` is given (complex arrays
    then take the complex dtype of that precision); they are placed on
    ``device``.  Realified models carry over with their structure
    (``PartialDiagonalMatrix``, ``InterleavedComplexDiagonalMatrix``,
    ``RealPartProx``), and banded couplings as :class:`BandedMatrix`.  Raises ``TypeError`` on any objective or operator the
    port does not have yet.
    """
    functions = [_objective(f, device, dtype) for f in model.functions]
    # Condition (i, j, E1, E2) with i > j: E1 x_i = E2 x_j; the JAX model
    # stores E[(j, i)] = E1 and E[(i, j)] = E2.
    conditions = [(i, j, _operator(model.E[(j, i)], device, dtype),
                   _operator(model.E[(i, j)], device, dtype))
                  for (i, j) in model.pairs]
    return Model(functions, conditions)


def state_from_numpy(x0, x1, h, mu, device="cuda") -> Dict[str, torch.Tensor]:
    """Warm-start keyword arguments for ``FusedTwoBlockSolver.solve`` from
    the numpy arrays of a ``FusedResult`` (x0, x1, h: (B, N); mu: (B,)),
    in float32 on ``device``: ``solve(..., **state_from_numpy(...))``."""
    f32 = dict(device=device, dtype=torch.float32)
    return {"x0": _tensor(x0, **f32), "x1": _tensor(x1, **f32),
            "h0": _tensor(h, **f32), "mu0": _tensor(mu, **f32)}


def batch_result_to_numpy(res) -> Dict[str, object]:
    """A :class:`~admmsolver_tpu_torch.parallel.BatchResult` as numpy arrays
    on the host: ``x`` and ``h`` tuples of arrays, the other fields arrays.
    ``x``, ``h`` and ``mu`` warm-start either package's ``BatchedSolver.solve``
    (``x0=``, ``h0=``, ``mu0=``)."""
    host = lambda a: a.detach().cpu().numpy()
    return {"x": tuple(map(host, res.x)), "h": tuple(map(host, res.h)),
            "mu": host(res.mu), "iterations": host(res.iterations),
            "converged": host(res.converged),
            "primal_residual": host(res.primal_residual),
            "dual_residual": host(res.dual_residual)}


def batch_state_from_numpy(x: Sequence, h: Sequence, mu, device="cuda") -> Dict[str, object]:
    """Warm-start keyword arguments for ``BatchedSolver.solve`` from the
    numpy arrays of a JAX ``BatchResult`` (``x``: (B, n_k) per block, ``h``:
    (B, s_p) per pair, ``mu``: (B, npairs)), at their own dtype on
    ``device``: ``solve(..., **batch_state_from_numpy(...))``."""
    return {"x0": tuple(_tensor(a, device, None) for a in x),
            "h0": tuple(_tensor(a, device, None) for a in h),
            "mu0": _tensor(mu, device, None)}
