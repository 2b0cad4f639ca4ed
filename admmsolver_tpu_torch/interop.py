"""Carry models and solver state over from the JAX package.

The port never imports ``jax``: :func:`from_jax_model` reads a
``admmsolver_tpu`` model's arrays through ``np.asarray`` and dispatches on
class names, and :func:`state_from_numpy` takes a JAX result already turned
into numpy.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .models.objectivefunc import (L1Regularizer, LeastSquares,
                                   NonNegativePenalty, ObjectiveFunctionBase)
from .models.problem import Model
from .ops.linop import (DenseMatrix, DiagonalMatrix, MatrixBase,
                        ScaledIdentityMatrix)

__all__ = ["from_jax_model", "state_from_numpy"]


def _tensor(a, device, dtype) -> torch.Tensor:
    # np.array copies: JAX hands out read-only buffers
    return torch.as_tensor(np.array(a), device=device, dtype=dtype)


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
    raise TypeError(f"admmsolver_tpu_torch has no counterpart of operator {name} yet")


def _objective(f, device, dtype) -> ObjectiveFunctionBase:
    name = type(f).__name__
    if name == "LeastSquares":
        return LeastSquares(float(np.asarray(f._alpha)),
                            _operator(f._A, device, dtype),
                            _tensor(f._y, device, dtype))
    if name == "L1Regularizer":
        offset = None if f._offset is None else _tensor(f._offset, device, dtype)
        return L1Regularizer(float(np.asarray(f._alpha)), int(f._size_x), offset)
    if name == "NonNegativePenalty":
        return NonNegativePenalty(int(f._size_x))
    raise TypeError(f"admmsolver_tpu_torch has no counterpart of objective {name} yet")


def from_jax_model(model, device="cpu", dtype: Optional[torch.dtype] = None) -> Model:
    """The port's :class:`Model` for an ``admmsolver_tpu.Model``.

    Arrays keep their numpy dtype unless ``dtype`` is given; they are placed
    on ``device``.  Raises ``TypeError`` on any objective or operator the
    port does not have yet.
    """
    functions = [_objective(f, device, dtype) for f in model.functions]
    # Condition (i, j, E1, E2) with i > j: E1 x_i = E2 x_j; the JAX model
    # stores E[(j, i)] = E1 and E[(i, j)] = E2.
    conditions = [(i, j, _operator(model.E[(j, i)], device, dtype),
                   _operator(model.E[(i, j)], device, dtype))
                  for (i, j) in model.pairs]
    return Model(functions, conditions)


def state_from_numpy(x0, x1, h, mu, device="cpu") -> Dict[str, torch.Tensor]:
    """Warm-start keyword arguments for ``FusedTwoBlockSolver.solve`` from
    the numpy arrays of a ``FusedResult`` (x0, x1, h: (B, N); mu: (B,)),
    in float32 on ``device``: ``solve(..., **state_from_numpy(...))``."""
    f32 = dict(device=device, dtype=torch.float32)
    return {"x0": _tensor(x0, **f32), "x1": _tensor(x1, **f32),
            "h0": _tensor(h, **f32), "mu0": _tensor(mu, **f32)}
