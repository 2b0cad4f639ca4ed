"""Complex→real embedding: complex problems as real models of doubled size.

Counterpart of :mod:`admmsolver_tpu.models.realify`.  The reference solver
is complex128-first (``optimizer.py:151,159``).  The port's engines run
complex128 directly, but the float32 chunk kernels are real: this module
maps a complex :class:`~admmsolver_tpu_torch.models.problem.Model` onto an
*exactly trajectory-isomorphic* real model, so complex workloads run through
them.

Embedding (interleaved layout): a complex vector ``v ∈ C^n`` becomes
``R(v) = [Re v_0, Im v_0, Re v_1, Im v_1, …] ∈ R^{2n}`` and a complex matrix
``M = a + ib`` the real matrix with 2×2 blocks ``[[a, -b], [b, a]]`` per
entry.  Then ``R(Mv) = R(M) R(v)``, ``R(M†) = R(M)^T``, ``Re(u†v) =
R(u)·R(v)`` and ``‖v‖ = ‖R(v)‖``: every piece of the ADMM iteration maps
term by term, so the real trajectory *is* the complex trajectory.

The interleaved layout keeps **real** structured operators structured: a
real operator acts on interleaved coordinates as ``A ⊗ I_2``, a
:class:`~admmsolver_tpu_torch.ops.linop.PartialDiagonalMatrix`; real
diagonals stay diagonal and identities scaled identities.  Complex diagonal
and scaled-identity operators become
:class:`~admmsolver_tpu_torch.ops.linop.InterleavedComplexDiagonalMatrix`,
whose Hermitian Gram is a plain diagonal, so the diagonal-penalty proxes
survive complex couplings; only complex dense operators densify.

Objectives map as:

* quadratic blocks (LeastSquares / ConstrainedLeastSquares /
  L2Regularizer): the same class over the embedded operators; the spectral
  solve sees ``A†A ⊗ I_2`` and keeps the eigensystem of the small factor;
* separable blocks (L1 / NonNegative): the reference prox consumes only
  ``h.real`` and returns a real minimizer (``objectivefunc.py:193-194,
  267-268``); the embedded prox reads the even (Re) lanes and writes zeros
  to the odd (Im) lanes (:class:`RealPartProx`).

``encode``/``decode`` run where their tensor lives: ``torch.view_as_real``
of a complex ``(…, n)`` tensor reshaped to ``(…, 2n)`` is exactly the
interleaved layout, and ``view_as_complex`` of ``(…, n, 2)`` inverts it.
"""
from __future__ import annotations

import copy
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.linop import (
    DenseMatrix,
    DiagonalMatrix,
    InterleavedComplexDiagonalMatrix,
    MatrixBase,
    PartialDiagonalMatrix,
    ScaledIdentityMatrix,
    _asarray,
)
from .objectivefunc import (
    ConstrainedLeastSquares,
    L1Regularizer,
    L2Regularizer,
    LeastSquares,
    NonNegativePenalty,
    SemiPositiveDefinitePenalty,
    ObjectiveFunctionBase,
    _mu_diagonal,
)
from .problem import Model

__all__ = ["encode", "decode", "realify_matrix", "realify_objective",
           "realify_model", "RealifiedModel", "RealPartProx"]


def encode(v) -> torch.Tensor:
    """Complex ``(..., n)`` → real interleaved ``(..., 2n)``, on ``v``'s
    device (a real ``v`` gets zero imaginary lanes)."""
    v = _asarray(v)
    if not v.is_complex():
        v = torch.complex(v, torch.zeros_like(v))
    return torch.view_as_real(v.resolve_conj()).reshape(tuple(v.shape[:-1]) + (2 * v.shape[-1],))


def decode(v) -> torch.Tensor:
    """Real interleaved ``(..., 2n)`` → complex ``(..., n)``, on ``v``'s
    device."""
    v = _asarray(v)
    pairs = v.reshape(tuple(v.shape[:-1]) + (v.shape[-1] // 2, 2)).contiguous()
    return torch.view_as_complex(pairs)


def _embed_dense(M: torch.Tensor) -> torch.Tensor:
    """Interleaved real embedding of a complex matrix."""
    m, n = M.shape
    re, im = M.real, M.imag
    R = torch.zeros((2 * m, 2 * n), dtype=re.dtype, device=M.device)
    R[0::2, 0::2] = re
    R[0::2, 1::2] = -im
    R[1::2, 0::2] = im
    R[1::2, 1::2] = re
    return R


def _leaves(op: MatrixBase):
    if isinstance(op, PartialDiagonalMatrix):
        return _leaves(op.matrix)
    if isinstance(op, DenseMatrix):
        return [op.data]
    if isinstance(op, DiagonalMatrix):
        return [op.diagonals]
    if isinstance(op, ScaledIdentityMatrix):
        return [op.coeff]
    if isinstance(op, InterleavedComplexDiagonalMatrix):
        return [op.re, op.im]
    return [op.asmatrix()]


def _is_real(op: MatrixBase) -> bool:
    """True when every value of ``op`` is real (complex dtypes with zero
    imaginary parts count as real)."""
    for leaf in _leaves(op):
        leaf = _asarray(leaf)
        if leaf.is_complex() and bool(torch.any(leaf.imag != 0)):
            return False
    return True


def _real_scalar(c):
    """A real-valued scalar of complex type as its real part."""
    if isinstance(c, torch.Tensor):
        return c.real if c.is_complex() else c
    return float(np.real(c)) if np.iscomplexobj(c) else c


def _as_real_matrix(op: MatrixBase) -> MatrixBase:
    """A real-valued (possibly complex-dtype) operator with real dtype."""
    real = lambda a: a.real if a.is_complex() else a
    if isinstance(op, DenseMatrix):
        return DenseMatrix(real(op.data))
    if isinstance(op, DiagonalMatrix):
        return DiagonalMatrix(real(op.diagonals), op.shape)
    if isinstance(op, ScaledIdentityMatrix):
        return ScaledIdentityMatrix(op.shape, _real_scalar(op.coeff))
    if isinstance(op, PartialDiagonalMatrix):
        return PartialDiagonalMatrix(_as_real_matrix(op.matrix), op.rest_dims)
    return op


def realify_matrix(op: MatrixBase) -> MatrixBase:
    """Structured interleaved embedding of an operator.

    Real operators stay structured (``A ⊗ I_2``); complex diagonal and
    scaled-identity ones become :class:`InterleavedComplexDiagonalMatrix`;
    complex dense ones densify.
    """
    if _is_real(op):
        if isinstance(op, ScaledIdentityMatrix):
            coeff = _real_scalar(op.coeff)
            if op.is_square():
                return ScaledIdentityMatrix(2 * op.shape[0], coeff)
            return PartialDiagonalMatrix(
                ScaledIdentityMatrix(op.shape, coeff).to_diagonal_matrix(), (2,))
        if isinstance(op, DiagonalMatrix):
            d = _as_real_matrix(op).diagonals
            if op.is_square():
                return DiagonalMatrix(d.repeat_interleave(2))
            return PartialDiagonalMatrix(DiagonalMatrix(d, op.shape), (2,))
        if isinstance(op, PartialDiagonalMatrix):
            return PartialDiagonalMatrix(_as_real_matrix(op.matrix), op.rest_dims + (2,))
        if isinstance(op, DenseMatrix):
            return PartialDiagonalMatrix(_as_real_matrix(op), (2,))
        return PartialDiagonalMatrix(_as_real_matrix(DenseMatrix(op.asmatrix())), (2,))
    # Genuinely complex operators.  Diagonal structure survives the embedding
    # exactly (2×2 rotation-scale blocks): keep it, so that E†E products in
    # realified models stay diagonal.
    if isinstance(op, ScaledIdentityMatrix) and op.is_square():
        c = complex(op.coeff.item() if isinstance(op.coeff, torch.Tensor) else op.coeff)
        dev = op.coeff.device if isinstance(op.coeff, torch.Tensor) else None
        full = lambda x: torch.full((op.shape[0],), x, dtype=torch.float64, device=dev)
        return InterleavedComplexDiagonalMatrix(full(c.real), full(c.imag))
    if isinstance(op, DiagonalMatrix) and op.is_square():
        d = op.diagonals
        return InterleavedComplexDiagonalMatrix(d.real.clone(), d.imag.clone())
    return DenseMatrix(_embed_dense(_asarray(op.asmatrix())))


class RealPartProx(ObjectiveFunctionBase):
    """Embedded separable objective: prox on the Re lanes, zero Im lanes.

    Wraps L1 / NonNegative / the PSD cone, whose proxes project ``h`` to
    its real part and return a real minimizer (reference
    ``objectivefunc.py:193-194, 267-268``; JAX ``objectivefunc.py:
    998-1000``): in interleaved coordinates that is exactly "prox of the even
    lanes, zeros in the odd lanes".  Penalty diagonals are constant over
    each (Re, Im) pair (they come from embedded Hermitian couplings), so
    the even-lane diagonal is the original diagonal.  Batched, the rows are
    instances as everywhere in the engine.
    """

    needs_diagonal_mu = True

    def __init__(self, inner: ObjectiveFunctionBase) -> None:
        if not inner.needs_diagonal_mu:
            raise TypeError(f"RealPartProx wraps separable objectives, got {type(inner).__name__}")
        super().__init__(2 * inner.size_x)
        self._inner = inner

    @property
    def batch_fields(self) -> tuple:  # type: ignore[override]
        return self._inner.batch_fields

    def _apply_updates(self, updates: dict) -> None:
        if updates:
            self._inner = self._inner.clone_with(**updates)

    def to(self, device) -> "RealPartProx":
        obj = copy.copy(self)
        obj._inner = self._inner.to(device)
        return obj

    def __call__(self, x) -> float:
        return self._inner(decode(x))

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        return self.prox_diag(_asarray(h), _mu_diagonal(mu))

    def prox_diag(self, h, mu_diag, batched: bool = False):
        lead, n = tuple(h.shape[:-1]), self._inner.size_x
        pairs = lead + (n, 2)
        h_re = h.reshape(pairs)[..., 0]
        mu_re = torch.broadcast_to(_asarray(mu_diag), h.shape).reshape(pairs)[..., 0]
        x_re = self._inner.prox_diag(h_re, mu_re, batched=batched)
        return torch.stack([x_re, torch.zeros_like(x_re)], dim=-1).reshape(lead + (2 * n,))


def realify_objective(f: ObjectiveFunctionBase) -> ObjectiveFunctionBase:
    if isinstance(f, ConstrainedLeastSquares):
        return ConstrainedLeastSquares(f._alpha, realify_matrix(f._A), encode(f._y),
                                       realify_matrix(f._C), encode(f._D))
    if isinstance(f, LeastSquares):
        return LeastSquares(f._alpha, realify_matrix(f._A), encode(f._y))
    if isinstance(f, L2Regularizer):
        return L2Regularizer(f._alpha, realify_matrix(f._A))
    if isinstance(f, (L1Regularizer, NonNegativePenalty, SemiPositiveDefinitePenalty)):
        return RealPartProx(f)
    raise TypeError(f"realify_objective: unsupported objective {type(f).__name__}")


class RealifiedModel:
    """A real :class:`Model` equivalent to a (possibly complex) one.

    ``.model`` is the embedded real model (block sizes doubled): run any
    solver on it; ``encode_x``/``decode_x`` convert solver state tuples.
    """

    def __init__(self, model: Model) -> None:
        self.original = model
        functions = [realify_objective(f) for f in model.functions]
        # The model stores E[(j, i)] = E1, E[(i, j)] = E2 for a condition
        # (j, i, E1, E2) with i > j: rebuild the conditions in pair order.
        conds = [(j, i, realify_matrix(model.E[(i, j)]), realify_matrix(model.E[(j, i)]))
                 for (i, j) in model.pairs]
        self.model = Model(functions, conds)

    def encode_x(self, x: Sequence) -> Tuple[torch.Tensor, ...]:
        return tuple(encode(x_) for x_ in x)

    def decode_x(self, x: Sequence) -> Tuple[torch.Tensor, ...]:
        return tuple(decode(x_) for x_ in x)

    encode = staticmethod(encode)
    decode = staticmethod(decode)


def realify_model(model: Model) -> RealifiedModel:
    return RealifiedModel(model)
