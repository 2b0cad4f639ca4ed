"""Structured linear operators over torch tensors.

Counterpart of :mod:`admmsolver_tpu.ops.linop` (reference
``matrix.py:9-513``): dense, diagonal, scaled identity, the Kronecker form
``A ⊗ I`` (:class:`PartialDiagonalMatrix`), the real embedding of a
complex diagonal (:class:`InterleavedComplexDiagonalMatrix`) and banded
operators (:class:`BandedMatrix`, with the cyclic-reduction factor of
tridiagonal systems, :class:`TridiagFactor`), with the
reference's rectangular truncate/zero-pad semantics and its
structure-preserving ``matmul``/``add`` dispatch.  The structure is a Python
type; the values are tensors, which stay on the device and dtype they were
built with until :meth:`MatrixBase.to` moves them.  Applying an operator
follows the precision and device of the vector it acts on
(:func:`_match_precision`).  Where the JAX package decides a structure from
concrete values (a blockwise-constant diagonal), the port always can: every
value is a tensor.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
import numbers
from typing import Optional, Tuple, Union

import numpy as np
import torch

__all__ = [
    "MatrixBase",
    "DenseMatrix",
    "DiagonalMatrix",
    "ScaledIdentityMatrix",
    "PartialDiagonalMatrix",
    "InterleavedComplexDiagonalMatrix",
    "BandedMatrix",
    "TridiagFactor",
    "tridiag_cr_factor",
    "tridiag_cr_solve",
    "jacobi_eigh",
    "svd_via_gram",
    "identity",
    "asmatrixtype",
    "matrix_hash",
    "matmul",
    "add",
    "LaneOperators",
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
    ``conj``/``conjugate``, ``inv``, ``asmatrix`` (and ``to_dense``), ``hash``, plus the
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

    def to_dense(self) -> torch.Tensor:
        """The operator as a dense tensor: :meth:`asmatrix` of its class
        (the JAX package's ``to_dense``, ``linop.py:512``, which each class
        assigns again so that it names that class's ``asmatrix``)."""
        return self.asmatrix()

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

    def matvec_rows(self, v):
        """Apply to every row of ``v``: ``(B, m) -> (B, n)``, one problem
        instance per row, the layout of the batched engine.  (``matvec``
        reads a 2-D argument as ``(m, k)`` columns.)"""
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

    def gram(self) -> "MatrixBase":
        """A† A, keeping structure where possible."""
        return matmul(self.H, self)

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

    def matvec_rows(self, v):
        return _mm(v, _match_precision(self.data, v).T)


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

    def _times(self, v):
        """``c v``; the identity (a Python or numpy real 1) returns ``v`` itself,
        the same values without a copy (identity couplings are the common
        case: one launch and one array fewer for each product)."""
        c = _match_precision(self.coeff, v)
        if isinstance(c, (int, float)) and c == 1:
            return v
        return c * v

    def matvec(self, v):
        v = _asarray(v)
        n, m = self.shape
        if v.shape[0] != m:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(v.shape)}")
        if n == m:
            return self._times(v)
        return self.to_diagonal_matrix().matvec(v)

    def matvec_rows(self, v):
        if v.shape[-1] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ rows of {tuple(v.shape)}")
        if self.is_square():
            return self._times(v)
        return self.to_diagonal_matrix().matvec_rows(v)

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
        # no index tensor: one made on the host would be copied to the device
        out.diagonal()[:k].copy_(d)
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

    def matvec_rows(self, v):
        n = self.shape[0]
        if v.shape[-1] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ rows of {tuple(v.shape)}")
        k = min(self._diagonals.shape[0], v.shape[-1])
        scaled = _match_precision(self._diagonals[:k], v) * v[..., :k]
        if n == k:
            return scaled
        pad = scaled.new_zeros(tuple(scaled.shape[:-1]) + (n - k,))
        return torch.cat([scaled, pad], dim=-1)

    def effective_diagonal(self):
        if not self.is_square():
            return None
        return self._diagonals

    def __str__(self) -> str:
        return "DiagonalMatrix: " + str(self._diagonals)


class PartialDiagonalMatrix(MatrixBase):
    """Kronecker product ``A ⊗ I_rest`` stored as the small factor A.

    Reference: ``matrix.py:301-401``.  The matvec reshapes the operand to
    ``(A.cols, rest·batch)`` and applies A to it; :meth:`matvec_rows` does
    the same for every row of a batch.
    """

    def __init__(self, matrix, rest_dims: tuple) -> None:
        matrix = asmatrixtype(matrix)
        self.matrix = matrix
        self.rest_dims = tuple(int(r) for r in rest_dims)
        self._rest = int(np.prod(self.rest_dims)) if self.rest_dims else 1
        self.shape = (matrix.shape[0] * self._rest, matrix.shape[1] * self._rest)

    def to(self, device) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.to(device), self.rest_dims)

    def hash(self) -> int:
        return self.matrix.hash()

    def asmatrix(self) -> torch.Tensor:
        small = self.matrix.asmatrix()
        eye = torch.eye(self._rest, dtype=small.dtype, device=small.device)
        return torch.einsum("IJ,ij->IiJj", small, eye).reshape(self.shape)

    def _scale(self, c) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix * c, self.rest_dims)

    @property
    def T(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.T, self.rest_dims)

    def conjugate(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.conjugate(), self.rest_dims)

    conj = conjugate

    def inv(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.inv(), self.rest_dims)

    def gram(self) -> "PartialDiagonalMatrix":
        return PartialDiagonalMatrix(self.matrix.gram(), self.rest_dims)

    def matvec(self, v):
        """(A ⊗ I) v; v may carry trailing batch dims (matrix.py:367-401)."""
        v = _asarray(v)
        out_shape = (self.shape[0],) + tuple(v.shape[1:])
        return self.matrix.matvec(v.reshape(self.matrix.shape[1], -1)).reshape(out_shape)

    def matvec_rows(self, v):
        lead = tuple(v.shape[:-1])
        vt = v.reshape(lead + (self.matrix.shape[1], self._rest)).transpose(-1, -2)
        out = self.matrix.matvec_rows(vt).transpose(-1, -2)
        return out.reshape(lead + (self.shape[0],))

    def effective_diagonal(self):
        inner = self.matrix.effective_diagonal()
        if inner is None:
            return None
        return inner.repeat_interleave(self._rest)


class InterleavedComplexDiagonalMatrix(MatrixBase):
    """Real interleaved embedding of a complex diagonal matrix.

    ``diag(a + ib)`` acting on interleaved (Re, Im) coordinates
    (:mod:`admmsolver_tpu_torch.models.realify`) is the real block-diagonal
    matrix with 2×2 blocks ``[[a, -b], [b, a]]`` per entry.  Stored as the
    two real vectors ``re``/``im``, so complex couplings in realified models
    keep an O(n) matvec and a *diagonal* Gram: ``R(D)† R(D) = diag(|d|²) ⊗
    I₂``, which the diagonal-penalty proxes (L1 / NonNegative) require.

    The matrix is real: ``conjugate()`` is the identity; ``T`` is the
    embedding of the conjugate diagonal.
    """

    def __init__(self, re, im) -> None:
        re, im = _asarray(re), _asarray(im)
        if re.ndim != 1 or re.shape != im.shape:
            raise ValueError(f"re {tuple(re.shape)} and im {tuple(im.shape)} must be "
                             "1-D of one length")
        self.re, self.im = re, im
        self.shape = (2 * re.shape[0], 2 * re.shape[0])

    def to(self, device) -> "InterleavedComplexDiagonalMatrix":
        return InterleavedComplexDiagonalMatrix(self.re.to(device), self.im.to(device))

    def hash(self) -> int:
        return hash((matrix_hash(self.re), matrix_hash(self.im)))

    def asmatrix(self) -> torch.Tensor:
        n = self.re.shape[0]
        out = torch.zeros(self.shape, dtype=self.re.dtype, device=self.re.device)
        idx = torch.arange(n, device=self.re.device)
        out[2 * idx, 2 * idx] = self.re
        out[2 * idx + 1, 2 * idx + 1] = self.re
        out[2 * idx, 2 * idx + 1] = -self.im
        out[2 * idx + 1, 2 * idx] = self.im
        return out

    def _scale(self, c) -> "InterleavedComplexDiagonalMatrix":
        # by a REAL scalar (the embedded matrix is real)
        return InterleavedComplexDiagonalMatrix(self.re * c, self.im * c)

    @property
    def T(self) -> "InterleavedComplexDiagonalMatrix":
        return InterleavedComplexDiagonalMatrix(self.re, -self.im)

    def conjugate(self) -> "InterleavedComplexDiagonalMatrix":
        return self

    conj = conjugate

    def inv(self) -> "InterleavedComplexDiagonalMatrix":
        mod2 = self.re * self.re + self.im * self.im
        return InterleavedComplexDiagonalMatrix(self.re / mod2, -self.im / mod2)

    def gram(self) -> "DiagonalMatrix":
        mod2 = self.re * self.re + self.im * self.im
        return DiagonalMatrix(mod2.repeat_interleave(2))

    def matvec(self, v):
        v = _asarray(v)
        if v.shape[0] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(v.shape)}")
        n = self.re.shape[0]
        vr = v.reshape((n, 2) + tuple(v.shape[1:]))
        bshape = (n,) + (1,) * (v.ndim - 1)
        a = _match_precision(self.re, v).reshape(bshape)
        b = _match_precision(self.im, v).reshape(bshape)
        out = torch.stack([a * vr[:, 0] - b * vr[:, 1], b * vr[:, 0] + a * vr[:, 1]], dim=1)
        return out.reshape(v.shape)

    def matvec_rows(self, v):
        if v.shape[-1] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ rows of {tuple(v.shape)}")
        vr = v.reshape(tuple(v.shape[:-1]) + (-1, 2))
        a, b = _match_precision(self.re, v), _match_precision(self.im, v)
        out = torch.stack([a * vr[..., 0] - b * vr[..., 1], b * vr[..., 0] + a * vr[..., 1]],
                          dim=-1)
        return out.reshape(v.shape)

    def effective_diagonal(self):
        if bool(torch.any(self.im != 0)):
            return None
        return self.re.repeat_interleave(2)


def _shift_fill(vec: torch.Tensor, s: int, out_len: int) -> torch.Tensor:
    """``out[..., j] = vec[..., j - s]`` where defined, zero elsewhere (static
    slicing and padding along the last axis; the band-algebra workhorse)."""
    lo = max(0, s)
    hi = min(out_len, vec.shape[-1] + s)
    if hi <= lo:
        return vec.new_zeros(tuple(vec.shape[:-1]) + (out_len,))
    return torch.nn.functional.pad(vec[..., lo - s:hi - s], (lo, out_len - hi))


def _band_range(o: int, shape) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` whose column ``i + o`` lies inside an (M, N) matrix."""
    M, N = shape
    return max(0, -o), min(M, N - o)


def _banded_rows(offsets, bands: torch.Tensor, shape, v: torch.Tensor) -> torch.Tensor:
    """``sum_k bands[..., k, i] v[..., i + o_k]`` for every row ``i``: the
    banded product on the last axis of ``v``; ``bands`` (nb, M) or one set
    per lane (B, nb, M) against rows (B, N)."""
    M = shape[0]
    out = torch.zeros(tuple(np.broadcast_shapes(v.shape[:-1], bands.shape[:-2])) + (M,),
                      dtype=_result_dtype(v, bands), device=v.device)
    for k, o in enumerate(offsets):
        lo, hi = _band_range(o, shape)
        if hi > lo:
            # multiplied and added in place: no (B, M) product beside ``out``
            out[..., lo:hi].addcmul_(bands[..., k, lo:hi], v[..., lo + o:hi + o])
    return out


class BandedMatrix(MatrixBase):
    """Banded operator stored as its diagonals: O(bandwidth · n) memory.

    Counterpart of ``admmsolver_tpu/ops/linop.py:1016-1191``.  With banded
    couplings (TV differences, smoothness stencils) the ``Model`` precompute
    ``D†D`` stays banded under the band algebra below, and the factor path
    solves tridiagonal systems by cyclic reduction (:func:`tridiag_cr_factor`),
    so no dense N × N operator or factor is ever made.

    ``offsets``: static, sorted, unique ints; ``bands`` of shape
    ``(len(offsets), M)`` with ``bands[k, i] = A[i, i + offsets[k]]`` (row
    indexed).  Invariant: positions whose column ``i + o`` falls outside
    ``[0, N)`` hold zero; the constructor checks it and the band algebra
    relies on it.
    """

    def __init__(self, offsets, bands, shape: Optional[Tuple[int, int]] = None) -> None:
        offsets = tuple(int(o) for o in offsets)
        if len(set(offsets)) != len(offsets) or tuple(sorted(offsets)) != offsets:
            raise ValueError(f"offsets must be sorted and unique, got {offsets}")
        bands = _asarray(bands)
        if bands.ndim != 2 or bands.shape[0] != len(offsets):
            raise ValueError(f"bands of shape {tuple(bands.shape)} do not match "
                             f"offsets {offsets}")
        if shape is None:
            shape = (bands.shape[1], bands.shape[1])
        shape = (int(shape[0]), int(shape[1]))
        if bands.shape[1] != shape[0]:
            raise ValueError(f"bands of {bands.shape[1]} rows do not fit shape {shape}")
        for k, o in enumerate(offsets):
            lo, hi = _band_range(o, shape)
            if bool(torch.any(bands[k, :lo] != 0)) or bool(torch.any(bands[k, max(hi, 0):] != 0)):
                raise ValueError(f"band at offset {o} has nonzero entries outside the "
                                 f"valid row range [{lo}, {hi})")
        self.offsets, self.bands, self.shape = offsets, bands, shape

    @classmethod
    def _of(cls, offsets, bands: torch.Tensor, shape) -> "BandedMatrix":
        """A band set that the algebra made: the invariant holds by
        construction, so it is not read back."""
        obj = object.__new__(cls)
        obj.offsets, obj.bands, obj.shape = tuple(offsets), bands, tuple(shape)
        return obj

    @staticmethod
    def from_dense(a, offsets=None) -> "BandedMatrix":
        """The bands of a dense matrix; ``offsets`` defaults to every
        nonzero diagonal."""
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        M, N = a.shape
        if offsets is None:
            offsets = [o for o in range(-M + 1, N) if np.any(np.diagonal(a, o))] or [0]
        offsets = sorted(int(o) for o in offsets)
        bands = np.zeros((len(offsets), M), a.dtype)
        for k, o in enumerate(offsets):
            lo, hi = _band_range(o, (M, N))
            if hi > lo:
                bands[k, lo:hi] = np.diagonal(a, o)
        return BandedMatrix(offsets, bands, (M, N))

    def to(self, device) -> "BandedMatrix":
        return BandedMatrix._of(self.offsets, self.bands.to(device), self.shape)

    @property
    def bandwidth(self) -> int:
        return max(abs(o) for o in self.offsets)

    def hash(self) -> int:
        return hash((self.offsets, self.shape, matrix_hash(self.bands)))

    def asmatrix(self) -> torch.Tensor:
        out = self.bands.new_zeros(self.shape)
        for k, o in enumerate(self.offsets):
            lo, hi = _band_range(o, self.shape)
            if hi > lo:
                i = torch.arange(lo, hi, device=self.bands.device)
                out[i, i + o] = self.bands[k, lo:hi]
        return out

    def _scale(self, c) -> "BandedMatrix":
        return BandedMatrix._of(self.offsets, self.bands * c, self.shape)

    def conjugate(self) -> "BandedMatrix":
        return BandedMatrix._of(self.offsets, torch.conj_physical(self.bands), self.shape)

    conj = conjugate

    @property
    def T(self) -> "BandedMatrix":
        # T[j, j - o] = A[j - o, j]: the band at offset -o, row-shifted
        M, N = self.shape
        offs = tuple(sorted(-o for o in self.offsets))
        pos = {o: k for k, o in enumerate(self.offsets)}
        rows = [_shift_fill(self.bands[pos[-o]], -o, N) for o in offs]
        return BandedMatrix._of(offs, torch.stack(rows), (N, M))

    def inv(self) -> "DenseMatrix":
        """Dense inverse: banded inverses are dense, so this is for small N
        (the factor path never calls it; tridiagonal systems go through
        :func:`tridiag_cr_factor`)."""
        if not self.is_square():
            raise RuntimeError("Must be a square matrix!")
        return DenseMatrix(torch.linalg.inv(self.asmatrix()))

    def matvec(self, v):
        v = _asarray(v)
        if v.shape[0] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ {tuple(v.shape)}")
        vt = torch.movedim(v, 0, -1)
        out = _banded_rows(self.offsets, _match_precision(self.bands, v), self.shape, vt)
        return torch.movedim(out, -1, 0)

    def matvec_rows(self, v):
        if v.shape[-1] != self.shape[1]:
            raise ValueError(f"shape mismatch: {self.shape} @ rows of {tuple(v.shape)}")
        return _banded_rows(self.offsets, _match_precision(self.bands, v), self.shape, v)

    def effective_diagonal(self):
        if not self.is_square():
            return None
        if 0 not in self.offsets:
            return None
        for k, o in enumerate(self.offsets):
            if o != 0 and bool(torch.any(self.bands[k] != 0)):
                return None
        return self.bands[self.offsets.index(0)]

    def _matmul_banded(self, b: "BandedMatrix") -> "BandedMatrix":
        """``A @ B`` stays banded: ``C[i, i+oa+ob] += A[i, i+oa] B[i+oa, ·]``;
        out-of-range entries of B are stored zeros, so the boundary terms
        vanish without masking."""
        M = self.shape[0]
        terms: dict = {}
        for ka, oa in enumerate(self.offsets):
            for kb, ob in enumerate(b.offsets):
                t = self.bands[ka] * _shift_fill(b.bands[kb], -oa, M)
                o = oa + ob
                terms[o] = t if o not in terms else terms[o] + t
        offs = tuple(sorted(terms))
        return BandedMatrix._of(offs, torch.stack([terms[o] for o in offs]), (M, b.shape[1]))

    def __str__(self) -> str:
        return f"BandedMatrix(offsets={self.offsets}, shape={self.shape})"


class TridiagFactor:
    """Cyclic-reduction factorization of a tridiagonal system.

    Counterpart of ``admmsolver_tpu/ops/linop.py:1194-1316``.  Cyclic
    reduction eliminates the odd rows level by level: log2(N) levels, each a
    handful of full-width elementwise products over static strided slices,
    O(N) work per solve and O(N) factor state, stable without pivoting for
    the SPD systems of the ADMM factor path.  The level sizes are Python
    ints, so no shape depends on a tensor's value.

    Every tensor has the row axis LAST; leading axes are lanes (one system
    per lane of the batched engine, or an axis of 1 that every lane shares).
    ``factor @ rhs`` solves for ``rhs`` ``(n,)`` or ``(n, k...)`` (the row
    axis first, the matvec convention of this module) with an unbatched
    factor; :meth:`matvec_rows` solves lane b's system for row b of
    ``(B, n)``, :meth:`matmat` for the columns ``(n, k)`` or ``(B, n, k)``.
    """

    def __init__(self, levels, d_final: torch.Tensor, n: int, sizes) -> None:
        self.levels = tuple(levels)
        self.d_final = d_final
        self.n = int(n)
        # pre-padding row count of each level: the backward pass trims each
        # reconstructed level to it
        self.sizes = tuple(int(m) for m in sizes)

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.d_final.shape[:-1])

    def __matmul__(self, rhs):
        return tridiag_cr_solve(self, rhs)

    def matvec_rows(self, v: torch.Tensor) -> torch.Tensor:
        return _cr_solve_last(self, v, 0)

    def matmat(self, cols: torch.Tensor) -> torch.Tensor:
        out = _cr_solve_last(self, cols.transpose(-1, -2), 1)
        return out.transpose(-1, -2)


def _cr_prev(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """``x`` shifted one row down (last axis): ``out[j] = x[j-1]``,
    ``out[0] = fill``."""
    return torch.nn.functional.pad(x[..., :-1], (1, 0), value=fill)


def _cr_next(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """``x`` shifted one row up (last axis): ``out[j] = x[j+1]``,
    ``out[-1] = fill``."""
    return torch.nn.functional.pad(x[..., 1:], (0, 1), value=fill)


def tridiag_cr_factor(dl, d, du) -> TridiagFactor:
    """Precompute the cyclic-reduction cascade for ``T x = b``.

    ``dl[..., i] = T[i, i-1]`` (``dl[..., 0]`` ignored), ``d[..., i] =
    T[i, i]``, ``du[..., i] = T[i, i+1]`` (``du[..., -1]`` ignored); the row
    axis is last and leading axes are lanes.  The cascade depends only on
    the matrix, so it is made once per penalty change; the solves then run
    the O(N) forward and backward passes per right-hand side.
    """
    dl, d, du = torch.broadcast_tensors(_asarray(dl), _asarray(d), _asarray(du))
    n = d.shape[-1]
    sizes, halves = [], []
    m = n
    while m > 1:
        sizes.append(m)
        m = (m + m % 2) // 2
        halves.append(m)
    # every level's five arrays in one block, made first: the factor is one
    # allocation rather than many among the cascade's transients
    store = torch.empty(tuple(d.shape[:-1]) + (5, sum(halves)),
                        dtype=torch.promote_types(torch.promote_types(dl.dtype, d.dtype),
                                                  du.dtype), device=d.device)
    levels, start = [], 0
    for m, half in zip(sizes, halves):
        if m % 2:
            # a decoupled identity row keeps every level even
            d = torch.nn.functional.pad(d, (0, 1), value=1.0)
            dl = torch.nn.functional.pad(dl, (0, 1))
            du = torch.nn.functional.pad(du, (0, 1))
        alpha, beta, dl_o, d_o, du_o = (store[..., c, start:start + half] for c in range(5))
        d_e, dl_e, du_e = d[..., 0::2], dl[..., 0::2], du[..., 0::2]
        d_o.copy_(d[..., 1::2])
        dl_o.copy_(dl[..., 1::2])
        du_o.copy_(du[..., 1::2])
        if not start and n % 2 == 0:
            # the never-used corner du[n-1] as zero (in an odd n it meets
            # only beta's last entry, set below)
            du_o[..., -1:].zero_()
        torch.div(dl_e, _cr_prev(d_o, fill=1.0), out=alpha)
        torch.div(du_e, d_o, out=beta)
        if not start:
            # the never-used corner dl[0] as zero
            alpha[..., :1].zero_()
            if n % 2:
                beta[..., -1:].zero_()
        start += half
        d_new = d_e - alpha * _cr_prev(du_o) - beta * dl_o
        dl_new = -alpha * _cr_prev(dl_o)
        du_new = -beta * du_o
        levels.append((alpha, beta, dl_o, d_o, du_o))
        dl, d, du = dl_new, d_new, du_new
    return TridiagFactor(levels, d, n, sizes)


def _cr_solve_last(factor: TridiagFactor, rhs: torch.Tensor, extra: int) -> torch.Tensor:
    """The forward and backward passes on the last axis of ``rhs``; each
    factor array gains ``extra`` axes of 1 before its row axis so that it
    broadcasts against ``rhs``'s columns.  Factor values follow ``rhs``'s
    precision and device (state precision, not setup precision)."""
    if rhs.shape[-1] != factor.n:
        raise ValueError(f"rhs of {rhs.shape[-1]} rows against a factor of {factor.n}")

    def f(a):
        a = _match_precision(a, rhs)
        return a.reshape(tuple(a.shape[:-1]) + (1,) * extra + tuple(a.shape[-1:]))

    b = rhs
    b_odds = []
    for alpha, beta, _dl_o, _d_o, _du_o in factor.levels:
        if b.shape[-1] % 2:
            b = torch.nn.functional.pad(b, (0, 1))
        b_e, b_o = b[..., 0::2], b[..., 1::2]
        b_odds.append(b_o)
        b = b_e - f(alpha) * _cr_prev(b_o) - f(beta) * b_o
    x = b / f(factor.d_final)
    for (_alpha, _beta, dl_o, d_o, du_o), b_o, m in zip(
            reversed(factor.levels), reversed(b_odds), reversed(factor.sizes)):
        # eliminated odd rows: x_o = (b_o - dl_o x_prev_even - du_o x_next_even) / d_o
        x_o = (b_o - f(dl_o) * x - f(du_o) * _cr_next(x)) / f(d_o)
        x = torch.stack([x, x_o], dim=-1).reshape(tuple(x.shape[:-1]) + (-1,))[..., :m]
    return x


def tridiag_cr_solve(factor: TridiagFactor, rhs) -> torch.Tensor:
    """Solve with a precomputed :class:`TridiagFactor`; ``rhs`` is ``(n,)``
    or ``(n, *trailing)`` (row axis first, the matvec convention)."""
    rhs = _asarray(rhs)
    if rhs.shape[0] != factor.n:
        raise ValueError(f"rhs of shape {tuple(rhs.shape)} against a factor of {factor.n}")
    out = _cr_solve_last(factor, torch.movedim(rhs, 0, -1), 0)
    return torch.movedim(out, -1, 0)


def _jacobi_sweeps(n: int, unrolled: bool, dtype: torch.dtype) -> int:
    """The JAX package's default sweep count for a (padded, even) n: its
    unrolled form (slices of n <= 16) takes 8 sweeps up to n = 8, else 10;
    its scan form (17..256) was measured to converge by 6-8 sweeps in f32
    and 8-10 in f64 and keeps one sweep of margin."""
    if unrolled:
        return 8 if n <= 8 else 10
    if _real_dtype(dtype).itemsize <= 4:
        return 8 if n <= 64 else 9
    return 9 if n <= 32 else 10 if n <= 128 else 11


def jacobi_eigh(a: torch.Tensor, sweeps: Optional[int] = None,
                sort: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched real-symmetric eigendecomposition by parallel-order Jacobi
    (JAX ``linop.py:184-431``, ``jacobi_eigh`` and ``_jacobi_eigh_scan``).

    ``a``: (..., n, n) real symmetric (the full matrix is read), n <= 256.
    Returns ``(evals, evecs)`` with ``a ≈ evecs @ diag(evals) @ evecs.T``,
    ``evals`` ascending per slice when ``sort`` (as ``torch.linalg.eigh``),
    else in the order of the input's coordinates.  A sweep is n − 1 rounds
    of the circle-method schedule, each rotating n/2 disjoint pairs at once
    by the angle that zeroes a_pq, folded to |θ| ≤ π/4; ``sweeps`` defaults
    to the JAX package's count (:func:`_jacobi_sweeps`), so one loop covers
    what JAX splits into an unrolled form (n <= 16) and a scan-rolled one.
    Odd n is padded with a decoupled dummy dimension whose diagonal
    (1 + Σ|a|) strictly dominates every eigenvalue: every rotation that
    pairs it has θ = 0, and it is cut off at the end.

    The rounds run in :func:`admmsolver_tpu_torch.ops.kernels.jacobi_eigh`:
    the CUDA kernel on a CUDA tensor, its plain version on the CPU.
    Complex input raises ``TypeError`` (use ``torch.linalg.eigh``, or the
    real embedding as :func:`~admmsolver_tpu_torch.ops.prox.psd_project`
    does); n > 256 raises ``ValueError``.
    """
    from . import kernels

    if a.is_complex():
        raise TypeError("jacobi_eigh supports real symmetric input only; "
                        "use torch.linalg.eigh for complex Hermitian blocks")
    n = a.shape[-1]
    if n > kernels.JACOBI_MAX:
        raise ValueError(f"jacobi_eigh is limited to n <= {kernels.JACOBI_MAX}, got n={n};"
                         " use torch.linalg.eigh")
    if n == 1:
        return a[..., 0], torch.ones_like(a)
    odd = n % 2 == 1
    if odd:
        big = 1.0 + torch.sum(torch.abs(a), dim=(-2, -1), keepdim=True)
        a = torch.cat([a, a.new_zeros(a.shape[:-1] + (1,))], dim=-1)
        last = torch.cat([a.new_zeros(a.shape[:-2] + (1, n)), big], dim=-1)
        a = torch.cat([a, last], dim=-2)
    n_pad = n + odd
    if sweeps is None:
        sweeps = _jacobi_sweeps(n_pad, n <= 16, a.dtype)
    lead = tuple(a.shape[:-2])
    w, v = kernels.jacobi_eigh(a.reshape(-1, n_pad, n_pad).contiguous(), sweeps)
    w, v = w.reshape(lead + (n_pad,)), v.reshape(lead + (n_pad, n_pad))
    if odd:
        w, v = w[..., :n], v[..., :n, :n]
    if sort:
        o = torch.argsort(w, dim=-1, stable=True)
        w = torch.take_along_dim(w, o, dim=-1)
        v = torch.take_along_dim(v, o[..., None, :], dim=-1)
    return w, v


def svd_via_gram(x: torch.Tensor, eigh_fn=None):
    """Thin SVD of ``(..., m, n)`` real matrices from a symmetric
    eigendecomposition of the smaller Gram matrix (JAX ``linop.py:432-489``).

    ``U, s, Vh`` with ``x ≈ U @ diag(s) @ Vh`` and ``s`` descending, the
    layout of ``torch.linalg.svd(x, full_matrices=False)``: two products
    and one eigendecomposition of the min(m, n)-sized Gram, by default
    :func:`jacobi_eigh` up to 256 and ``torch.linalg.eigh`` above.  Squaring
    the spectrum floors small singular values at ~sqrt(eps)·s_max, inside
    the dead zone of the nuclear-norm soft-threshold that uses it.  Columns
    of singular values at most eps·max(s_max, 1) divide by 1 instead: their
    numerators are ~0 and the threshold annihilates them.  Both products
    run in full float32/float64 (TF32 stays off, :mod:`..backend`).
    """
    if x.is_complex():
        raise TypeError("svd_via_gram supports real input only")
    m, n = x.shape[-2], x.shape[-1]
    if eigh_fn is None:
        eigh_fn = jacobi_eigh if min(m, n) <= 256 else torch.linalg.eigh
    eps = torch.finfo(x.dtype).eps

    def _safe_div(num, s):
        cut = eps * torch.clamp_min(torch.amax(s, dim=-1, keepdim=True), 1.0)
        return num / torch.where(s > cut, s, torch.ones_like(s))[..., None, :]

    xt = x.mT
    if n <= m:
        w, V = eigh_fn(torch.matmul(xt, x))                # ascending
        w, V = torch.flip(w, dims=(-1,)), torch.flip(V, dims=(-1,))
        s = torch.sqrt(torch.clamp_min(w, 0.0))
        return _safe_div(torch.matmul(x, V), s), s, V.mT
    w, U = eigh_fn(torch.matmul(x, xt))
    w, U = torch.flip(w, dims=(-1,)), torch.flip(U, dims=(-1,))
    s = torch.sqrt(torch.clamp_min(w, 0.0))
    return U, s, torch.matmul(_safe_div(U, s).mT, x)


#: set while a solve program's chunk runs (:func:`static_structure`)
_STATIC_STRUCTURE: contextvars.ContextVar = contextvars.ContextVar("static_structure",
                                                                  default=False)


@contextlib.contextmanager
def static_structure():
    """Inside, the structure of an operator is decided without reading a
    value on the host, as the JAX package decides it on traced values (a
    CUDA graph cannot hold the read): a collapse that depends on values
    (:func:`_blockwise_first`) is not taken, and a spectral shift takes the
    thin basis wherever there is one."""
    token = _STATIC_STRUCTURE.set(True)
    try:
        yield
    finally:
        _STATIC_STRUCTURE.reset(token)


def structure_is_static() -> bool:
    """Whether :func:`static_structure` is in force."""
    return _STATIC_STRUCTURE.get()


#: The device-side ``info`` of each Cholesky factorization that :func:`inv_hpd`
#: makes inside :func:`deferred_cholesky_checks`, or None outside it.
_DEFERRED_INFOS: contextvars.ContextVar = contextvars.ContextVar("deferred_cholesky_infos",
                                                                 default=None)


@contextlib.contextmanager
def deferred_cholesky_checks():
    """Inside the block, :func:`inv_hpd` keeps each factorization's ``info``
    on the device (``torch.linalg.cholesky_ex``) and appends it to the list
    this yields, where ``torch.linalg.cholesky`` would read it on the host at
    once: a CUDA graph cannot hold that read.  The caller checks the list
    later with :func:`raise_if_not_pd`.  Nor does the factors' structure
    read a value (:func:`static_structure`): a spectral shift takes the thin
    basis wherever there is one, as the JAX package's traced solve does (the
    engine's penalties are positive)."""
    infos: list = []
    token = _DEFERRED_INFOS.set(infos)
    try:
        with static_structure():
            yield infos
    finally:
        _DEFERRED_INFOS.reset(token)


def any_not_pd(infos) -> torch.Tensor:
    """A boolean device scalar: whether any factorization of ``infos`` (a
    list of ``cholesky_ex`` infos) failed."""
    return torch.stack([(info != 0).any() for info in infos]).any()


def raise_if_not_pd(failed) -> None:
    """Raise what ``torch.linalg.cholesky`` raises when ``failed`` (a value
    of :func:`any_not_pd`, read on the host here) is set."""
    if bool(failed):
        raise torch.linalg.LinAlgError(
            "inv_hpd: the factorization could not be completed because a matrix is not "
            "positive-definite")


def defer_cholesky_info(info: torch.Tensor) -> None:
    """Hand a factorization's device-side ``info`` (nonzero where a matrix
    is not positive definite) to :func:`deferred_cholesky_checks`' list, or,
    outside it, read it at once and raise as ``torch.linalg.cholesky``
    would."""
    infos = _DEFERRED_INFOS.get()
    if infos is None:
        raise_if_not_pd(any_not_pd([info]))
    else:
        infos.append(info)


def inv_hpd(a: torch.Tensor) -> torch.Tensor:
    """Inverse of Hermitian positive-definite matrices ``(..., n, n)`` by a
    (batched) Cholesky factorization ``a = L L†``: ``a^{-1} = L^{-†} L^{-1}``
    with ``L^{-1}`` from one batched triangular solve (the reference calls
    ``np.linalg.inv``, ``objectivefunc.py:11,94``); like the reference, a
    matrix that is not positive definite raises: at once, or inside
    :func:`deferred_cholesky_checks` where its caller reads the infos."""
    infos = _DEFERRED_INFOS.get()
    if infos is None:
        L = torch.linalg.cholesky(a)
    else:
        L, info = torch.linalg.cholesky_ex(a)
        infos.append(info)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device).expand_as(a)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.mH @ Linv


def _blockwise_first(d: torch.Tensor, nblocks: int):
    """The first entry of each of ``nblocks`` contiguous blocks of ``d``
    when ``d`` is (close to) constant within each block, else None (the
    JAX package's concrete-value check, ``np.allclose``); None under
    :func:`static_structure`, as for the JAX package's traced values."""
    if structure_is_static():
        return None
    blocks = d.reshape(nblocks, -1)
    if torch.allclose(blocks, blocks[:, :1].expand_as(blocks)):
        return blocks[:, 0]
    return None


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

    if isinstance(a, InterleavedComplexDiagonalMatrix):
        if isinstance(b, InterleavedComplexDiagonalMatrix):
            # Complex-diagonal product in real arithmetic; a real product
            # (the Hermitian Gram R(D)† R(D) of a coupling) collapses to a
            # plain diagonal so that penalty structure survives.
            re = a.re * b.re - a.im * b.im
            im = a.re * b.im + a.im * b.re
            if not bool(torch.any(im != 0)):
                return DiagonalMatrix(re.repeat_interleave(2))
            return InterleavedComplexDiagonalMatrix(re, im)
        if isinstance(b, ScaledIdentityMatrix) and b.is_square():
            return a._scale(b.coeff)
        return DenseMatrix(a.matvec(b.asmatrix()))

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
        if isinstance(b, PartialDiagonalMatrix) and a.is_square():
            # Kronecker form survives a blockwise-constant diagonal
            # (matrix.py:283-291).
            d = _blockwise_first(a.diagonals, b.matrix.shape[0])
            if d is not None:
                return PartialDiagonalMatrix(matmul(DiagonalMatrix(d), _as_dense(b.matrix)),
                                             b.rest_dims)
        if isinstance(b, BandedMatrix) and a.is_square():
            # row scaling keeps the bands
            return BandedMatrix._of(b.offsets, b.bands * a.diagonals[None, :], b.shape)
        return DenseMatrix(a.matvec(b.asmatrix()))

    if isinstance(a, BandedMatrix):
        if isinstance(b, BandedMatrix):
            return a._matmul_banded(b)
        if isinstance(b, ScaledIdentityMatrix) and b.is_square():
            return a._scale(b.coeff)
        if isinstance(b, DiagonalMatrix) and b.is_square():
            # column scaling: the band at offset o picks up d[i + o]
            M = a.shape[0]
            rows = [a.bands[k] * _shift_fill(b.diagonals, -o, M)
                    for k, o in enumerate(a.offsets)]
            return BandedMatrix._of(a.offsets, torch.stack(rows), a.shape)
        return DenseMatrix(_mm(a.asmatrix(), b.asmatrix()))

    if isinstance(a, PartialDiagonalMatrix):
        if isinstance(b, PartialDiagonalMatrix) and a.rest_dims == b.rest_dims:
            return PartialDiagonalMatrix(matmul(a.matrix, b.matrix), a.rest_dims)
        if isinstance(b, ScaledIdentityMatrix) and b.is_square():
            return PartialDiagonalMatrix(a.matrix * b.coeff, a.rest_dims)
        return DenseMatrix(a.matvec(b.asmatrix()))

    return DenseMatrix(_mm(a.asmatrix(), b.asmatrix()))


def _as_dense(m: MatrixBase) -> DenseMatrix:
    return m if isinstance(m, DenseMatrix) else DenseMatrix(m.asmatrix())


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
        if isinstance(x, ScaledIdentityMatrix) and isinstance(y, PartialDiagonalMatrix):
            if x.is_square():
                inner = add(ScaledIdentityMatrix(y.matrix.shape[0], x.coeff), y.matrix)
                return PartialDiagonalMatrix(inner, y.rest_dims)
        if isinstance(x, DiagonalMatrix) and isinstance(y, DiagonalMatrix):
            return DiagonalMatrix(x.diagonals + y.diagonals, x.shape)
        if isinstance(x, DiagonalMatrix) and isinstance(y, PartialDiagonalMatrix) \
                and x.is_square():
            # Collapse when blockwise constant (matrix.py:461-468).
            eff = y.matrix.effective_diagonal()
            if eff is not None:
                return add(x, DiagonalMatrix(eff.repeat_interleave(y._rest), x.shape))
            d = _blockwise_first(x.diagonals, y.matrix.shape[0])
            if d is not None:
                return PartialDiagonalMatrix(add(DiagonalMatrix(d), y.matrix), y.rest_dims)
        if isinstance(x, InterleavedComplexDiagonalMatrix) and \
                isinstance(y, InterleavedComplexDiagonalMatrix):
            return InterleavedComplexDiagonalMatrix(x.re + y.re, x.im + y.im)
        if isinstance(x, ScaledIdentityMatrix) and \
                isinstance(y, InterleavedComplexDiagonalMatrix) and x.is_square():
            return InterleavedComplexDiagonalMatrix(y.re + x.coeff, y.im)
        if isinstance(x, DiagonalMatrix) and \
                isinstance(y, InterleavedComplexDiagonalMatrix) and x.is_square():
            # structured only when the diagonal is constant over each (Re, Im) pair
            d = _blockwise_first(x.diagonals, y.re.shape[0])
            if d is not None:
                return InterleavedComplexDiagonalMatrix(y.re + d, y.im)
        if isinstance(x, PartialDiagonalMatrix) and isinstance(y, PartialDiagonalMatrix):
            if x.rest_dims == y.rest_dims:
                return PartialDiagonalMatrix(add(x.matrix, y.matrix), x.rest_dims)
            break
        if isinstance(x, BandedMatrix) and isinstance(y, BandedMatrix):
            return BandedMatrix._of(*_add_bands(x.offsets, x.bands, y.offsets, y.bands),
                                    x.shape)
        if isinstance(x, BandedMatrix) and x.is_square() and \
                isinstance(y, (ScaledIdentityMatrix, DiagonalMatrix)):
            if isinstance(y, ScaledIdentityMatrix):
                # a Python coefficient made on the device: no copy from the host
                c = y.coeff
                dvec = (c.to(x.bands.device) if isinstance(c, torch.Tensor) else torch.full(
                    (), c, dtype=_asarray(c).dtype, device=x.bands.device)).expand(x.shape[0])
            else:
                dvec = y.diagonals
            return BandedMatrix._of(*_add_bands(x.offsets, x.bands, (0,), dvec[None]), x.shape)

    return DenseMatrix(a.asmatrix() + b.asmatrix())


def _add_bands(offs_x, bx: torch.Tensor, offs_y, by: torch.Tensor):
    """(offsets, bands) of the sum of two band sets of one shape; the bands
    carry any leading lane axes (which broadcast) and promote as the dense
    sum would, never downcasting either side."""
    offs = tuple(sorted(set(offs_x) | set(offs_y)))
    px = {o: k for k, o in enumerate(offs_x)}
    py = {o: k for k, o in enumerate(offs_y)}
    shape = np.broadcast_shapes(bx.shape[:-2], by.shape[:-2]) + bx.shape[-1:]
    dt = _result_dtype(bx, by)

    # each row written into its place: no row is made twice
    out = torch.empty(tuple(shape[:-1]) + (len(offs),) + tuple(shape[-1:]), dtype=dt,
                      device=bx.device)
    for k, o in enumerate(offs):
        if o in px and o in py:
            torch.add(bx[..., px[o], :], by[..., py[o], :], out=out[..., k, :])
        else:
            out[..., k, :] = bx[..., px[o], :] if o in px else by[..., py[o], :]
    return offs, out


class LaneOperators:
    """One square operator per batch lane, all of one structure.

    ``kind`` is ``"scalar"`` (``c_b I``, data ``(B,)``), ``"diag"``
    (``(B, n)``), ``"banded"`` (data ``(B, nbands, n)`` on the static
    ``offsets``, the per-lane form of :class:`BandedMatrix`), ``"kron"``
    (``G_b ⊗ I_rest``, data ``(B, m, m)`` with ``n = m·rest``, the per-lane
    form of :class:`PartialDiagonalMatrix`) or ``"dense"`` (``(B, n, n)``); a
    leading axis of 1 stands for an operator that all lanes share.  This is
    what the batched engine composes penalties and factors from, where the
    JAX package maps the structured operators over the batch: ``scale`` and
    ``+`` keep the cheapest structure that holds the result, as :func:`add`
    does, and densify only where none does.  ``known_zero`` marks the
    penalty of a block without couplings.  ``block`` (kind ``"diag"``): a
    width w, dividing n, such that every lane's diagonal is known to be
    constant on each run ``[i w, (i + 1) w)`` (1: nothing known beyond the
    trivial), or None where no one has looked; it decides ``kron + diag``
    without reading values (:meth:`with_block` sets it where an operator is
    made once: the penalty terms and the Gram of a batched solve, whose
    structure no iteration changes).
    """

    _NDIM = {"scalar": 1, "diag": 2, "banded": 3, "kron": 3, "dense": 3}
    _RANK = {"scalar": 0, "diag": 1, "banded": 2, "kron": 3, "dense": 4}

    def __init__(self, kind: str, data: torch.Tensor, n: int,
                 known_zero: bool = False, rest: int = 1, offsets=(),
                 block: Optional[int] = None) -> None:
        if data.ndim != self._NDIM[kind]:
            raise ValueError(f"{kind} lane operators need {self._NDIM[kind]}-D data, "
                             f"got {tuple(data.shape)}")
        if kind == "kron" and data.shape[-1] * rest != n:
            raise ValueError(f"a kron factor of {data.shape[-1]} times I_{rest} is not {n} wide")
        if kind == "banded" and data.shape[-2:] != (len(offsets), n):
            raise ValueError(f"banded lane operators on offsets {tuple(offsets)} need "
                             f"(B, {len(offsets)}, {n}) data, got {tuple(data.shape)}")
        self.kind, self.data, self.n, self.known_zero = kind, data, int(n), known_zero
        self.rest = int(rest)
        self.offsets = tuple(offsets) if kind == "banded" else ()
        self.block = block if kind == "diag" else None

    @classmethod
    def shared(cls, op: MatrixBase) -> "LaneOperators":
        """A square structured operator that every lane shares."""
        if not op.is_square():
            raise ValueError(f"lane operators are square, got {op.shape}")
        n = op.shape[0]
        if isinstance(op, ScaledIdentityMatrix):
            return cls("scalar", _asarray(op.coeff).reshape(1), n)
        if isinstance(op, DiagonalMatrix):
            return cls("diag", op.diagonals[None], n)
        if isinstance(op, BandedMatrix):
            return cls("banded", op.bands[None], n, offsets=op.offsets)
        if isinstance(op, PartialDiagonalMatrix) and op.matrix.is_square():
            d = op.effective_diagonal()
            if d is not None:
                return cls("diag", d[None], n)
            return cls("kron", op.matrix.asmatrix()[None], n, rest=op._rest)
        return cls("dense", op.asmatrix()[None], n)

    def _lanes(self, c):
        """A scalar or per-lane ``(B,)`` coefficient shaped to scale the data."""
        if isinstance(c, torch.Tensor) and c.ndim == 1:
            return c.reshape((-1,) + (1,) * (self.data.ndim - 1))
        return c

    def _with(self, kind: str, data: torch.Tensor) -> "LaneOperators":
        return LaneOperators(kind, data, self.n, rest=self.rest if kind == "kron" else 1,
                             offsets=self.offsets if kind == "banded" else (),
                             block=self.block if kind == self.kind else None)

    def blockwise_constant(self, width: int) -> bool:
        """Whether every lane's diagonal (kind ``"diag"``) is constant over
        each run of ``width`` entries: from ``block`` where it is known,
        else read from the values (a host read)."""
        if self.block is not None:
            return self.block % width == 0
        blocks = self.data.reshape(self.data.shape[0], -1, width)
        return bool((blocks == blocks[..., :1]).all())

    def with_block(self) -> "LaneOperators":
        """This operator with ``block`` set, for kind ``"diag"``, to the
        widest run its values are constant on (host reads: once, where the
        operator is made); the widths that hold are the divisors of it."""
        if self.kind != "diag" or self.block is not None:
            return self
        out = self._with(self.kind, self.data)
        out.block = next(w for w in range(self.n, 0, -1)
                         if self.n % w == 0 and self.blockwise_constant(w))
        return out

    def scale(self, c) -> "LaneOperators":
        """Every lane's operator times its coefficient (scalar or ``(B,)``);
        the result follows a tensor coefficient's device and precision."""
        data = _match_precision(self.data, c) if isinstance(c, torch.Tensor) else self.data
        return self._with(self.kind, data * self._lanes(c))

    def _as(self, kind: str) -> torch.Tensor:
        """The data as the higher ``kind`` ("diag" or "dense")."""
        d = self.data
        if self.kind == kind:
            return d
        if self.kind == "kron":
            eye = torch.eye(self.rest, dtype=d.dtype, device=d.device)
            return torch.einsum("bij,rs->birjs", d, eye).reshape(d.shape[0], self.n, self.n)
        if self.kind == "banded":
            shape = (self.n, self.n)
            return torch.stack([BandedMatrix._of(self.offsets, b, shape).asmatrix() for b in d])
        if self.kind == "scalar":
            d = d[:, None].expand(d.shape[0], self.n)
        return d if kind == "diag" else torch.diag_embed(d)

    def __add__(self, other: "LaneOperators") -> "LaneOperators":
        if self.n != other.n:
            raise ValueError(f"shape mismatch: {self.n} + {other.n}")
        lo, hi = sorted((self, other), key=lambda o: self._RANK[o.kind])
        # a shared operator made from a Python scalar lives on the host
        lo = lo._with(lo.kind, lo.data.to(hi.data.device))
        if hi.kind == "banded":
            if lo.kind == "banded":
                offs, data = _add_bands(hi.offsets, hi.data, lo.offsets, lo.data)
            else:
                offs, data = _add_bands(hi.offsets, hi.data, (0,), lo._as("diag")[:, None, :])
            return LaneOperators("banded", data, self.n, offsets=offs)
        if hi.kind == "kron":
            m = hi.data.shape[-1]
            if lo.kind == "kron" and lo.rest == hi.rest:
                return hi._with("kron", lo.data + hi.data)
            if lo.kind == "scalar":
                eye = torch.eye(m, dtype=hi.data.dtype, device=hi.data.device)
                return hi._with("kron", hi.data + lo.data[:, None, None] * eye)
            if lo.kind == "diag" and lo.blockwise_constant(hi.rest):
                # G ⊗ I + D stays Kronecker where D is constant over each
                # block of rest entries (the check of :func:`add`)
                first = lo.data.reshape(lo.data.shape[0], m, hi.rest)[..., 0]
                return hi._with("kron", hi.data + torch.diag_embed(first))
            return LaneOperators("dense", lo._as("dense") + hi._as("dense"), self.n)
        block = None
        if hi.kind == "diag":
            # a scalar is constant over the whole diagonal
            lo_block = self.n if lo.kind == "scalar" else lo.block
            if hi.block is not None and lo_block is not None:
                block = math.gcd(hi.block, lo_block)
        return LaneOperators(hi.kind, lo._as(hi.kind) + hi.data, self.n, block=block)

    def matvec_rows(self, v):
        """Lane b's operator on row b of ``v`` (B, n)."""
        d = _match_precision(self.data, v)
        if self.kind == "scalar":
            return d[:, None] * v
        if self.kind == "diag":
            return d * v
        if self.kind == "banded":
            return _banded_rows(self.offsets, d, (self.n, self.n), v)
        if self.kind == "kron":
            return (d @ v.reshape(v.shape[0], -1, self.rest)).reshape(v.shape)
        return (d @ v[..., None])[..., 0]

    def matmat(self, cols):
        """Every lane's operator on the columns ``cols``, (n, k) shared or
        (B, n, k): (B, n, k)."""
        d = _match_precision(self.data, cols)
        if self.kind == "scalar":
            return d[:, None, None] * cols
        if self.kind == "diag":
            return d[:, :, None] * cols
        if self.kind == "banded":
            # columns as rows of a (B, k, n) batch, bands broadcast over k
            out = _banded_rows(self.offsets, d[:, None], (self.n, self.n), cols.transpose(-1, -2))
            return out.transpose(-1, -2)
        if self.kind == "kron":
            k = cols.shape[-1]
            c2 = cols.reshape(tuple(cols.shape[:-2]) + (d.shape[-1], self.rest * k))
            out = d @ c2
            return out.reshape(out.shape[0], self.n, k)
        return d @ cols


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


def _vecprod(v1, v2, size: int):
    """Elementwise product truncated to the shorter vector and zero-padded
    on the right to ``size`` (rectangular-diagonal product semantics,
    matrix.py:429-439)."""
    v1, v2 = _asarray(v1), _asarray(v2)
    k = min(v1.shape[0], v2.shape[0])
    return _pad_by_zero(v1[:k] * v2[:k], size)


def _pad_by_zero(arr, size: int):
    """Right-pad a vector with zeros to ``size`` (matrix.py:442-448)."""
    arr = _asarray(arr)
    if arr.shape[0] > size:
        raise ValueError(f"a vector of {arr.shape[0]} does not fit {size}")
    if arr.shape[0] == size:
        return arr
    return torch.cat([arr, arr.new_zeros(size - arr.shape[0])])
