"""Objective functions and their proximal solvers.

Counterpart of :mod:`admmsolver_tpu.models.objectivefunc` (reference
``objectivefunc.py:28-355``) for the basis-pursuit slice: least squares,
L1 and nonnegativity.  Each objective solves its own regularized
subproblem

    argmin_x  F(x) + h† x + x† h + x† mu x

(the linear term enters twice, ``objectivefunc.py:44-53``), through two
interfaces:

* ``solve(h, mu)`` — eager and reference-compatible, with the reference's
  one-entry hash-keyed factor cache (``objectivefunc.py:89-96``);
* the **factor protocol** of the ADMM engine: quadratic objectives expose
  ``make_factors(mu_op)`` (run only when the penalty changes) and
  ``prox_with_factors(factors, h)``; separable objectives expose
  ``prox_diag(h, mu_diag)``.

The spectral precompute stays in numpy (``np.linalg.eigh``), exactly as in
the JAX package, so both packages iterate on the same eigenbasis.
"""
from __future__ import annotations

import copy
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..ops.linop import (
    DenseMatrix,
    DiagonalMatrix,
    MatrixBase,
    ScaledIdentityMatrix,
    _asarray,
    _match_precision,
    _mm,
    add,
    asmatrixtype,
    matmul,
    matrix_hash,
)
from ..ops.prox import project_nonneg, soft_threshold

__all__ = [
    "ObjectiveFunctionBase",
    "LeastSquares",
    "L1Regularizer",
    "NonNegativePenalty",
]


class SpectralShift(NamedTuple):
    """Factor state for the spectral-shift solve path.

    With a scaled-identity penalty, ``B = (alpha A†A + c I)^{-1} =
    U diag(1/(alpha λ + c)) U†`` with ONE eigendecomposition of the shared
    Gram matrix.  The factor state is just the shift ``c``: refactoring at a
    penalty update is free, and a solve is two products with ``U``.
    ``thin`` selects the thin basis; a zero shift takes the full one, since
    the thin form divides by the shift.
    """

    shift: torch.Tensor
    thin: bool


def _inv_hpd(m: MatrixBase) -> MatrixBase:
    """Inverse of a Hermitian positive-definite operator.

    Dense operators go through a Cholesky inverse (the reference calls
    ``np.linalg.inv``, ``objectivefunc.py:11,94``); like the reference, a
    matrix that is not positive definite raises.  Diagonal and
    scaled-identity operators invert in closed form.
    """
    if isinstance(m, DenseMatrix):
        return DenseMatrix(torch.cholesky_inverse(torch.linalg.cholesky(m.data)))
    if isinstance(m, (DiagonalMatrix, ScaledIdentityMatrix)):
        return m.inv()
    raise TypeError(f"no HPD inverse for {type(m).__name__}")


def _real_if_complex(h: torch.Tensor) -> torch.Tensor:
    return h.real if h.is_complex() else h


def _mu_diagonal(mu: MatrixBase):
    """Effective diagonal of a penalty operator (``objectivefunc.py:296-310``)."""
    d = mu.effective_diagonal()
    if d is None:
        raise TypeError(
            f"Penalty mu of structure {type(mu).__name__} has no diagonal "
            "interpretation; this objective requires a diagonal penalty")
    return d


class ObjectiveFunctionBase:
    """Contract mirror of ``objectivefunc.py:28-53``."""

    #: True when the prox needs a (refactorizable) quadratic solve.
    is_quadratic = False
    #: True when the prox consumes only the diagonal of mu.
    needs_diagonal_mu = False
    #: When set to a group size ``g``, the prox requires the effective
    #: diagonal penalty to be constant within each group of ``g`` entries;
    #: :class:`~admmsolver_tpu_torch.optimizer.ADMMPlan` checks it.
    uniform_mu_group: Optional[int] = None

    def __init__(self, size_x: int) -> None:
        self._size_x = int(size_x)

    @property
    def size_x(self) -> int:
        return self._size_x

    def to(self, device) -> "ObjectiveFunctionBase":
        """A copy whose tensors and operators live on ``device``."""
        obj = copy.copy(self)
        for k, v in vars(self).items():
            if isinstance(v, (torch.Tensor, MatrixBase)):
                setattr(obj, k, v.to(device))
        return obj

    def __call__(self, x) -> float:
        raise NotImplementedError

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        """Return argmin_x F(x) + h†x + x†h + x† mu x."""
        raise NotImplementedError

    # --- factor protocol (engine) --------------------------------------
    def make_factors(self, mu_op: MatrixBase):
        return ()

    def prox_with_factors(self, factors, h):
        raise NotImplementedError

    def prox_diag(self, h, mu_diag):
        raise NotImplementedError


class _ShiftedQuadratic:
    """Shared solve machinery for blocks whose prox is ``B @ v`` with
    ``B = (alpha A†A + mu)^{-1}``.

    Two strategies, chosen from the penalty structure:

    * **spectral** — scaled-identity penalty and a dense Gram: shared
      eigendecomposition, per-solve shift scalar (:class:`SpectralShift`).
      When ``A`` is wide (M < N), the eigensystem comes from the small
      ``A A†`` instead: ``(alpha A†A + c I)^{-1} v = U_r [(alpha λ_r + c)^{-1}
      − c^{-1}] (U_r† v) + v / c`` with a thin (N, r) basis.
    * **cached inverse** — anything else: Cholesky inverse recomputed when
      the penalty changes (:func:`_inv_hpd`).
    """

    _alpha: object
    _AcA: MatrixBase
    _eig = None
    _eig_thin = None  # (lam_r, U_r) with r = rank(A†A) < N, or False

    def to(self, device):
        obj = ObjectiveFunctionBase.to(self, device)
        obj._B_cache = (None, None)
        obj._basis_cache = {}
        return obj

    def _spectral_ok(self) -> bool:
        return isinstance(self._AcA, DenseMatrix)

    def _get_eig(self):
        if self._eig is None:
            gram = self._AcA.data.detach().cpu().numpy()
            self._eig = np.linalg.eigh(gram)
        return self._eig

    def _thin_A(self):
        """Dense wide A as a numpy array, or None."""
        A_op = getattr(self, "_A", None)
        if not isinstance(A_op, DenseMatrix):
            return None
        A = A_op.data.detach().cpu().numpy()
        if A.shape[0] >= A.shape[1]:
            return None
        return A

    def _get_eig_thin(self):
        """Thin eigensystem of A†A via the small Gram A A†, or False.

        From ``A A† = W Σ² W†``: ``λ_r = σ²``, ``U_r = A† W σ^{-1}``.
        Numerically-null rows (σ² ≤ M·eps·σ²_max) are dropped — their
        exact treatment is the closed-form ``v/c`` null-space term.
        """
        if self._eig_thin is None:
            A = self._thin_A()
            if A is None:
                self._eig_thin = False
            else:
                AAc = A @ A.conj().T
                lam, W = np.linalg.eigh(AAc)
                tol = AAc.shape[0] * np.finfo(lam.dtype).eps * \
                    max(lam.max(initial=0.0), 0.0)
                keep = lam > tol
                lam = lam[keep]
                U_r = (A.conj().T @ W[:, keep]) / np.sqrt(lam)
                self._eig_thin = (lam, U_r)
        return self._eig_thin

    def _basis(self, thin: bool, like: torch.Tensor):
        """(lam, U) of the thin or full eigensystem as tensors on ``like``'s
        device and precision, moved there once."""
        cache = self.__dict__.setdefault("_basis_cache", {})
        key = (thin, like.device, like.dtype)
        if key not in cache:
            lam, U = self._get_eig_thin() if thin else self._get_eig()
            cache[key] = (_match_precision(lam, like), _match_precision(U, like))
        return cache[key]

    def make_factors(self, mu_op: MatrixBase):
        """B = (alpha A†A + mu)^{-1}: spectral shift or explicit inverse."""
        if isinstance(mu_op, ScaledIdentityMatrix) and self._spectral_ok():
            shift = _asarray(mu_op.coeff)
            thin = self._get_eig_thin() is not False and bool(torch.any(shift != 0))
            return SpectralShift(shift, thin)
        return _inv_hpd(add(self._AcA * self._alpha, mu_op))

    def _apply_B(self, factors, rhs):
        if isinstance(factors, SpectralShift):
            lam, U = self._basis(factors.thin, rhs)
            shift = _match_precision(factors.shift, rhs)
            w = _mm(U.conj().T, rhs)
            if factors.thin:
                coef = 1.0 / (self._alpha * lam + shift) - 1.0 / shift
                w = w * (coef if w.ndim == 1 else coef[:, None])
                return _mm(U, w) + rhs / shift
            denom = self._alpha * lam + shift
            w = w / (denom if w.ndim == 1 else denom[:, None])
            return _mm(U, w)
        return factors @ rhs


class LeastSquares(_ShiftedQuadratic, ObjectiveFunctionBase):
    """``alpha * ||y - A x||_2^2`` (reference ``objectivefunc.py:56-110``)."""

    is_quadratic = True

    def __init__(self, alpha: float, A: Union[np.ndarray, MatrixBase], y) -> None:
        if A.ndim != 2:
            raise ValueError("A must be 2-D")
        A = asmatrixtype(A)
        y = _asarray(y)
        if y.ndim != 1 or A.shape[0] != y.shape[0]:
            raise ValueError(f"y of shape {tuple(y.shape)} does not match A {A.shape}")
        super().__init__(A.shape[1])
        self._alpha = alpha
        self._A = A
        self._y = y
        self._Ac = A.conjugate().T
        self._AcA = matmul(self._Ac, A)
        self._Acy = self._Ac @ y
        self._Nx = A.shape[1]
        self._B_cache = (None, None)  # eager-path one-entry cache

    def __call__(self, x) -> float:
        x = _match_precision(x, self._y)
        diff = self._y - (self._A @ x)
        return float(self._alpha * torch.vdot(diff, diff).real)

    # --- eager path ----------------------------------------------------
    def _get_B(self, mu: MatrixBase) -> MatrixBase:
        key = matrix_hash(mu)
        if self._B_cache[0] != key:
            self._B_cache = (key, self.make_factors(mu))
        return self._B_cache[1]

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            h = torch.zeros(self._Nx, dtype=self._Acy.dtype, device=self._Acy.device)
        if mu is None:
            mu = DiagonalMatrix(torch.zeros(self._Nx, dtype=torch.float64,
                                            device=self._Acy.device))
        h = _asarray(h)
        if tuple(h.shape) != (self._Nx,) or mu.shape != (self._Nx, self._Nx):
            raise ValueError("h or mu does not match the block size")
        return self.prox_with_factors(self._get_B(mu), h)

    # --- factor protocol ----------------------------------------------
    def prox_with_factors(self, factors, h):
        Acy = _match_precision(self._Acy, h)
        return self._apply_B(factors, self._alpha * Acy - h)


class L1Regularizer(ObjectiveFunctionBase):
    """``F(x) = alpha |x - offset|_1`` (reference ``objectivefunc.py:
    160-195``; ``offset=None`` is the reference's plain L1).

    By the substitution ``z = x - offset`` the prox is the plain
    soft-threshold on a shifted dual, ``x = offset + soft(-h/mu - offset,
    alpha/(2 mu))``.
    """

    needs_diagonal_mu = True

    def __init__(self, alpha: float, size_x: int, offset=None) -> None:
        if not isinstance(size_x, (int, np.integer)):
            raise TypeError(f"size_x must be an int, got {type(size_x)}")
        super().__init__(size_x)
        if not alpha > 0:
            raise ValueError("alpha must be positive")
        self._alpha = alpha
        if offset is not None:
            offset = _asarray(offset)
            if tuple(offset.shape) != (size_x,):
                raise ValueError(f"offset of shape {tuple(offset.shape)} != ({size_x},)")
        self._offset = offset

    def __call__(self, x) -> float:
        x = _asarray(x)
        v = x if self._offset is None else x - _match_precision(self._offset, x)
        return float(self._alpha * torch.sum(torch.abs(v)))

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        return self.prox_diag(_asarray(h), _mu_diagonal(mu))

    def prox_diag(self, h, mu_diag):
        h = _real_if_complex(h)
        mu_diag = _match_precision(mu_diag, h)
        thr = 0.5 * self._alpha / mu_diag
        if self._offset is None:
            return soft_threshold(-(h / mu_diag), thr)
        y = _match_precision(_real_if_complex(self._offset), h)
        return y + soft_threshold(-(h / mu_diag) - y, thr)


class NonNegativePenalty(ObjectiveFunctionBase):
    """``F(x) = infty * Theta(-x)`` (reference ``objectivefunc.py:245-271``)."""

    needs_diagonal_mu = True

    def __call__(self, x) -> float:
        return 0.0

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        return self.prox_diag(_asarray(h), _mu_diagonal(mu))

    def prox_diag(self, h, mu_diag):
        h = _real_if_complex(h)
        return project_nonneg(-(h / _match_precision(mu_diag, h)))
