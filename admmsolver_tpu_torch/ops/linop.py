"""Structured linear operators over torch tensors.

Counterpart of :mod:`admmsolver_tpu.ops.linop` (reference
``matrix.py:9-513``) for the operators the basis-pursuit slice uses:
dense, diagonal and scaled identity, with the reference's rectangular
truncate/zero-pad semantics and its structure-preserving ``matmul``/``add``
dispatch.  The structure is a Python type; the values are tensors, which
stay on the device and dtype they were built with until :meth:`MatrixBase.to`
moves them.  Applying an operator follows the precision and device of the
vector it acts on (:func:`_match_precision`).
"""
from __future__ import annotations

import numbers
from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "MatrixBase",
    "DenseMatrix",
    "DiagonalMatrix",
    "ScaledIdentityMatrix",
    "identity",
    "asmatrixtype",
    "matrix_hash",
    "matmul",
    "add",
]


def _asarray(x) -> torch.Tensor:
    """``x`` as a tensor; numpy and Python values are copied and keep their
    numpy dtype (a Python float becomes float64, not torch's default
    float32)."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.array(x))


def _is_scalar(x) -> bool:
    if isinstance(x, (numbers.Number, np.generic)):
        return True
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return x.ndim == 0
    return False


def _real_dtype(dtype: torch.dtype) -> torch.dtype:
    return dtype.to_real() if dtype.is_complex else dtype


def _match_precision(c, like: torch.Tensor):
    """Cast ``c`` to the precision (f32 vs f64) and device of ``like``,
    keeping its real/complex kind.

    Policy: operator values follow the *state*.  Operators are stored at
    setup precision (typically f64); a reduced-precision solve must not
    silently promote back to f64.  Python and numpy scalars come back as
    Python numbers, which torch applies at the tensor's own precision.
    """
    if isinstance(c, (numbers.Number, np.generic)):
        return c.item() if isinstance(c, np.generic) else c
    c = _asarray(c)
    rdt = _real_dtype(like.dtype)
    if c.is_complex():
        tgt = torch.complex64 if rdt == torch.float32 else torch.complex128
    elif c.is_floating_point():
        tgt = rdt
    else:
        tgt = c.dtype
    return c.to(device=like.device, dtype=tgt)


def _conj_scalar(c):
    if isinstance(c, torch.Tensor):
        return torch.conj_physical(c)
    return complex(c).conjugate() if np.iscomplexobj(c) else c


class MatrixBase:
    """Abstract structured operator.

    Mirrors the reference interface (``matrix.py:9-60``): ``@ + - *``, ``.T``,
    ``conj``/``conjugate``, ``inv``, ``asmatrix``, ``hash``, plus the
    (misnamed in the reference) squareness test ``is_diagonal``.
    """

    shape: Tuple[int, int]
    ndim: int = 2

    def is_diagonal(self) -> bool:
        # Reference semantics: actually tests squareness (matrix.py:16-17).
        return self.shape[0] == self.shape[1]

    is_square = is_diagonal

    def asmatrix(self) -> torch.Tensor:
        raise NotImplementedError

    def to(self, device) -> "MatrixBase":
        """The same operator with its tensors on ``device``."""
        raise NotImplementedError

    def __neg__(self) -> "MatrixBase":
        return self * (-1.0)

    def __sub__(self, other) -> "MatrixBase":
        return self + (-other)

    def __add__(self, other) -> "MatrixBase":
        return add(self, other)

    def __radd__(self, other) -> "MatrixBase":
        return add(other, self)

    def __mul__(self, other) -> "MatrixBase":
        if not _is_scalar(other):
            return NotImplemented
        return self._scale(other)

    __rmul__ = __mul__

    def __matmul__(self, other):
        if isinstance(other, (np.ndarray, torch.Tensor)):
            return self.matvec(other)
        if isinstance(other, MatrixBase):
            return matmul(self, other)
        return NotImplemented

    def _scale(self, c) -> "MatrixBase":
        raise NotImplementedError

    def matvec(self, v):
        """Apply to a vector / batched RHS (trailing batch dims)."""
        raise NotImplementedError

    def conjugate(self) -> "MatrixBase":
        raise NotImplementedError

    conj = conjugate

    @property
    def T(self) -> "MatrixBase":
        raise NotImplementedError

    @property
    def H(self) -> "MatrixBase":
        """Conjugate transpose (adjoint)."""
        return self.conjugate().T

    def inv(self) -> "MatrixBase":
        raise NotImplementedError

    def effective_diagonal(self):
        """Diagonal vector if this operator acts as a (full) diagonal, else
        None (``objectivefunc.py:302-309``)."""
        return None

    def hash(self) -> int:
        raise NotImplementedError


class DenseMatrix(MatrixBase):
    """Dense 2-D operator (reference ``matrix.py:63-121``)."""

    def __init__(self, matrix) -> None:
        matrix = _asarray(matrix)
        if matrix.ndim != 2:
            raise ValueError(f"DenseMatrix needs a 2-D array, got {tuple(matrix.shape)}")
        self.data = matrix
        self.shape = tuple(matrix.shape)

    def asmatrix(self) -> torch.Tensor:
        return self.data

    def to(self, device) -> "DenseMatrix":
        return DenseMatrix(self.data.to(device))

    def hash(self) -> int:
        return matrix_hash(self.data)

    def _scale(self, c) -> "DenseMatrix":
        return DenseMatrix(self.data * c)

    @property
    def T(self) -> "DenseMatrix":
        return DenseMatrix(self.data.T)

    def conjugate(self) -> "DenseMatrix":
        return DenseMatrix(torch.conj_physical(self.data))

    conj = conjugate

    def inv(self) -> "DenseMatrix":
        return DenseMatrix(torch.linalg.inv(self.data))

    def matvec(self, v):
        v = _asarray(v)
        return _mm(_match_precision(self.data, v), v, dims=([1], [0]))


class ScaledIdentityMatrix(MatrixBase):
    """c·I, possibly rectangular (zero off the main diagonal).

    Reference: ``matrix.py:124-194``.  ``coeff`` is a Python/numpy scalar
    or a 0-d tensor (the ADMM penalty ``mu`` during a solve).
    """

    def __init__(self, shape: Union[int, Tuple[int, int]], coeff) -> None:
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape), int(shape))
        else:
            shape = (int(shape[0]), int(shape[1]))
        if not _is_scalar(coeff):
            raise TypeError(f"ScaledIdentityMatrix coeff must be a scalar, got {type(coeff)}")
        self.shape = shape
        self.coeff = coeff

    def to(self, device) -> "ScaledIdentityMatrix":
        c = self.coeff.to(device) if isinstance(self.coeff, torch.Tensor) else self.coeff
        return ScaledIdentityMatrix(self.shape, c)

    def hash(self) -> int:
        return matrix_hash(self.coeff)

    def asmatrix(self) -> torch.Tensor:
        c = _asarray(self.coeff)
        return c * torch.eye(self.shape[0], self.shape[1], dtype=c.dtype,
                             device=c.device)

    def _scale(self, c) -> "ScaledIdentityMatrix":
        if isinstance(c, torch.Tensor):
            return ScaledIdentityMatrix(self.shape, c * self.coeff)
        return ScaledIdentityMatrix(self.shape, self.coeff * c)

    @property
    def T(self) -> "ScaledIdentityMatrix":
        return ScaledIdentityMatrix((self.shape[1], self.shape[0]), self.coeff)

    def conjugate(self) -> "ScaledIdentityMatrix":
        return ScaledIdentityMatrix(self.shape, _conj_scalar(self.coeff))

    conj = conjugate

    def inv(self) -> "ScaledIdentityMatrix":
        if not self.is_square():
            raise RuntimeError("A rectangular matrix is not invertible!")
        return ScaledIdentityMatrix(self.shape, 1.0 / self.coeff)

    @property
    def diagonals(self) -> torch.Tensor:
        if not self.is_square():
            raise RuntimeError("Diagonals of a rectangular matrix is ill defined!")
        return self.effective_diagonal()

    def to_diagonal_matrix(self) -> "DiagonalMatrix":
        c = _asarray(self.coeff)
        k = min(self.shape)
        return DiagonalMatrix(c * torch.ones(k, dtype=c.dtype, device=c.device),
                              self.shape)

    def matvec(self, v):
        v = _asarray(v)
        n, m = self.shape
        if v.shape[0] != m:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(v.shape)}")
        if n == m:
            return _match_precision(self.coeff, v) * v
        return self.to_diagonal_matrix().matvec(v)

    def effective_diagonal(self):
        if not self.is_square():
            return None
        return _asarray(self.coeff).expand(self.shape[0])


class DiagonalMatrix(MatrixBase):
    """Diagonal operator with optional rectangular shape.

    Rectangular semantics = truncate/zero-pad, matching
    ``matrix.py:197-298,429-448``.
    """

    def __init__(self, diagonals, shape: Optional[Tuple[int, int]] = None) -> None:
        diagonals = _asarray(diagonals)
        if diagonals.ndim != 1:
            raise ValueError("DiagonalMatrix needs a 1-D diagonal")
        if shape is None:
            shape = (diagonals.shape[0], diagonals.shape[0])
        else:
            shape = (int(shape[0]), int(shape[1]))
        if min(shape) != diagonals.shape[0]:
            raise ValueError(f"diagonal of length {diagonals.shape[0]} does not fit shape {shape}")
        self._diagonals = diagonals
        self.shape = shape

    @property
    def diagonals(self) -> torch.Tensor:
        return self._diagonals

    def to(self, device) -> "DiagonalMatrix":
        return DiagonalMatrix(self._diagonals.to(device), self.shape)

    def hash(self) -> int:
        return matrix_hash(self._diagonals)

    def asmatrix(self) -> torch.Tensor:
        d = self._diagonals
        k = d.shape[0]
        out = torch.zeros(self.shape, dtype=d.dtype, device=d.device)
        out[torch.arange(k), torch.arange(k)] = d
        return out

    def _scale(self, c) -> "DiagonalMatrix":
        return DiagonalMatrix(self._diagonals * c, self.shape)

    @property
    def T(self) -> "DiagonalMatrix":
        return DiagonalMatrix(self._diagonals, (self.shape[1], self.shape[0]))

    def conjugate(self) -> "DiagonalMatrix":
        return DiagonalMatrix(torch.conj_physical(self._diagonals), self.shape)

    conj = conjugate

    def inv(self) -> "DiagonalMatrix":
        if not self.is_square():
            raise RuntimeError("Must be a square matrix!")
        return DiagonalMatrix(1.0 / self._diagonals, self.shape)

    def matvec(self, v):
        v = _asarray(v)
        n = self.shape[0]
        if v.shape[0] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(v.shape)}")
        k = min(self._diagonals.shape[0], v.shape[0])
        d = _match_precision(self._diagonals[:k], v)
        scaled = d.reshape((k,) + (1,) * (v.ndim - 1)) * v[:k]
        if n == k:
            return scaled
        pad = scaled.new_zeros((n - k,) + tuple(scaled.shape[1:]))
        return torch.cat([scaled, pad])

    def effective_diagonal(self):
        if not self.is_square():
            return None
        return self._diagonals

    def __str__(self) -> str:
        return "DiagonalMatrix: " + str(self._diagonals)


def _result_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    return torch.promote_types(a.dtype, b.dtype)


def _mm(a: torch.Tensor, b: torch.Tensor, dims=None) -> torch.Tensor:
    """a @ b (or ``tensordot`` over ``dims``) with NumPy-style type
    promotion; torch's products refuse mixed real/complex operands."""
    dt = _result_dtype(a, b)
    a, b = a.to(dt), b.to(dt)
    return a @ b if dims is None else torch.tensordot(a, b, dims=dims)


def matmul(a: MatrixBase, b: MatrixBase) -> MatrixBase:
    """Structure-preserving a @ b (reference dispatch outcomes)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"shape mismatch: {a.shape} @ {b.shape}")

    # Square c·I on the left is a scalar multiply, which reproduces every
    # reference dispatch outcome for SI @ X (matrix.py:184-187); a
    # rectangular one is normalized to Diagonal.
    if isinstance(a, ScaledIdentityMatrix) and a.is_square():
        return b._scale(a.coeff)
    if isinstance(a, ScaledIdentityMatrix):
        return matmul(a.to_diagonal_matrix(), b)

    if isinstance(a, DenseMatrix):
        if isinstance(b, ScaledIdentityMatrix):
            return matmul(a, b.to_diagonal_matrix())
        if isinstance(b, DiagonalMatrix):
            # Column scaling with truncate/pad (matrix.py:109-116).
            k = min(b.shape)
            d = b.diagonals
            out = torch.zeros((a.shape[0], b.shape[1]),
                              dtype=_result_dtype(a.data, d), device=a.data.device)
            out[:, :k] = a.data[:, :k] * d[None, :]
            return DenseMatrix(out)
        return DenseMatrix(_mm(a.data, b.asmatrix()))

    if isinstance(a, DiagonalMatrix):
        if isinstance(b, ScaledIdentityMatrix):
            return matmul(a, b.to_diagonal_matrix())
        if isinstance(b, DenseMatrix):
            # Row scaling with truncate/pad.
            k = min(a.shape)
            d = a.diagonals
            out = torch.zeros((a.shape[0], b.shape[1]),
                              dtype=_result_dtype(d, b.data), device=d.device)
            out[:k, :] = d[:, None] * b.data[:k, :]
            return DenseMatrix(out)
        if isinstance(b, DiagonalMatrix):
            out_shape = (a.shape[0], b.shape[1])
            k = min(a.diagonals.shape[0], b.diagonals.shape[0])
            prod = a.diagonals[:k] * b.diagonals[:k]
            size = min(out_shape)
            if prod.shape[0] < size:
                prod = torch.cat([prod, prod.new_zeros(size - k)])
            return DiagonalMatrix(prod, out_shape)
        return DenseMatrix(a.matvec(b.asmatrix()))

    return DenseMatrix(_mm(a.asmatrix(), b.asmatrix()))


def add(a: MatrixBase, b: MatrixBase) -> MatrixBase:
    """Structure-preserving a + b (reference ``matrix.py:453-513``)."""
    if not (isinstance(a, MatrixBase) and isinstance(b, MatrixBase)):
        raise TypeError(f"add needs two operators, got {type(a)}, {type(b)}")
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} + {b.shape}")

    for x, y in ((a, b), (b, a)):
        if isinstance(x, ScaledIdentityMatrix) and isinstance(y, ScaledIdentityMatrix):
            return ScaledIdentityMatrix(x.shape, x.coeff + y.coeff)
        if isinstance(x, ScaledIdentityMatrix) and isinstance(y, DiagonalMatrix):
            if x.is_square():
                return DiagonalMatrix(_asarray(x.coeff) + y.diagonals, y.shape)
            return add(x.to_diagonal_matrix(), y)
        if isinstance(x, DiagonalMatrix) and isinstance(y, DiagonalMatrix):
            return DiagonalMatrix(x.diagonals + y.diagonals, x.shape)

    return DenseMatrix(a.asmatrix() + b.asmatrix())


def identity(n, dtype=np.float64) -> ScaledIdentityMatrix:
    """Identity as a scaled-identity operator (matrix.py:404-408)."""
    return ScaledIdentityMatrix(int(n), dtype(1.0))


def matrix_hash(a) -> int:
    """Hash of matrix content (matrix.py:411-418); keys the eager
    ``solve()`` path's one-entry factor cache."""
    if isinstance(a, MatrixBase):
        return a.hash()
    c = a.detach().cpu().resolve_conj().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    if c.ndim == 0:
        return hash(complex(c))
    return hash(c.tobytes())


def asmatrixtype(a) -> MatrixBase:
    """Coerce 2-D arrays to DenseMatrix (matrix.py:421-426)."""
    if isinstance(a, MatrixBase):
        return a
    return DenseMatrix(a)
