"""Objective functions and their proximal solvers.

Counterpart of :mod:`admmsolver_tpu.models.objectivefunc` (reference
``objectivefunc.py:28-355``): least squares with and without a hard
equality constraint, L1, L2, nonnegativity and the PSD cone, and the added
families (box, group L1, Huber, nuclear norm).  Each objective solves its
own regularized subproblem

    argmin_x  F(x) + h† x + x† h + x† mu x

(the linear term enters twice, ``objectivefunc.py:44-53``), through two
interfaces:

* ``solve(h, mu)`` — eager and reference-compatible, with the reference's
  one-entry hash-keyed factor cache (``objectivefunc.py:89-96``);
* the **factor protocol** of the ADMM engine: quadratic objectives expose
  ``make_factors(mu_op)`` (run only when the penalty changes) and
  ``prox_with_factors(factors, h)``; separable objectives expose
  ``prox_diag(h, mu_diag)``.

The batched engine runs the same protocol with one problem instance per
row: ``h`` is ``(B, n)``, the penalty a :class:`~admmsolver_tpu_torch.ops.
linop.LaneOperators`, and the call passes ``batched=True``.  Per-instance
values come from :meth:`ObjectiveFunctionBase.clone_with`, whose clones hold
*batched* leaves (``alpha`` ``(B,)``, ``Acy`` ``(B, N)``, ``A`` ``(B, M, N)``)
where the JAX package maps unbatched clones over the batch.

The spectral precompute stays in numpy (``np.linalg.eigh``), exactly as in
the JAX package, so both packages iterate on the same eigenbasis.
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..ops.linop import (
    BandedMatrix,
    DenseMatrix,
    DiagonalMatrix,
    LaneOperators,
    MatrixBase,
    PartialDiagonalMatrix,
    ScaledIdentityMatrix,
    _asarray,
    _match_precision,
    _mm,
    add,
    asmatrixtype,
    matmul,
    matrix_hash,
    static_structure,
    structure_is_static,
    svd_via_gram,
    tridiag_cr_factor,
)
from ..ops.prox import (ROUTE_CAPTURABLE, _jacobi_boundary, project_nonneg, psd_project,
                        psd_route, soft_threshold, svt_sign)

__all__ = [
    "ObjectiveFunctionBase",
    "LeastSquares",
    "ConstrainedLeastSquares",
    "L1Regularizer",
    "L2Regularizer",
    "GroupL1Regularizer",
    "HuberLoss",
    "NonNegativePenalty",
    "NuclearNormPenalty",
    "BoxProjectionPenalty",
    "SemiPositiveDefinitePenalty",
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
    read a value (:func:`~admmsolver_tpu_torch.ops.linop.static_structure`):
    a spectral shift takes the thin basis wherever there is one, as the JAX
    package's traced solve does (the engine's penalties are positive)."""
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


def _tridiag_of(offsets, bands: torch.Tensor):
    """The cyclic-reduction factor of a tridiagonal band set (row axis last,
    leading lane axes kept): O(N) state, never a dense N × N inverse."""
    get = {o: bands[..., k, :] for k, o in enumerate(offsets)}
    band = lambda o: get[o] if o in get else torch.zeros_like(get[0])
    return tridiag_cr_factor(band(-1), get[0], band(1))


def _inv_hpd(m):
    """Inverse of a Hermitian positive-definite operator (or of one per
    lane): dense operators through :func:`inv_hpd`, a Kronecker ``G ⊗ I``
    through the inverse of its small factor, diagonal and scaled-identity
    ones in closed form.  A tridiagonal banded operator (TV and stencil
    penalties) becomes its cyclic-reduction factor, a wider one a dense
    inverse (correct, without the O(N) scaling; JAX
    ``objectivefunc.py:104-118``)."""
    if isinstance(m, LaneOperators):
        if m.kind == "banded":
            if set(m.offsets) <= {-1, 0, 1} and 0 in m.offsets:
                return _tridiag_of(m.offsets, m.data)
            return LaneOperators("dense", inv_hpd(m._as("dense")), m.n)
        return m._with(m.kind, inv_hpd(m.data) if m.kind in ("dense", "kron") else 1.0 / m.data)
    if isinstance(m, DenseMatrix):
        return DenseMatrix(inv_hpd(m.data))
    if isinstance(m, BandedMatrix):
        if set(m.offsets) <= {-1, 0, 1} and 0 in m.offsets:
            return _tridiag_of(m.offsets, m.bands)
        return DenseMatrix(inv_hpd(m.asmatrix()))
    if isinstance(m, PartialDiagonalMatrix):
        return PartialDiagonalMatrix(_inv_hpd(m.matrix), m.rest_dims)
    if isinstance(m, (DiagonalMatrix, ScaledIdentityMatrix)):
        return m.inv()
    raise TypeError(f"no HPD inverse for {type(m).__name__}")


def _real_if_complex(h: torch.Tensor) -> torch.Tensor:
    return h.real if h.is_complex() else h


def _lanes(c, like: torch.Tensor):
    """A per-lane ``(B,)`` coefficient as a ``(B, 1)`` column at ``like``'s
    precision, to scale ``(B, n)`` rows; a scalar passes unchanged."""
    if isinstance(c, torch.Tensor) and c.ndim == 1:
        return _match_precision(c, like)[:, None]
    return c


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
    #: Per-instance parameters the batched runtime may override
    #: (:mod:`admmsolver_tpu_torch.parallel.batch`); the structure (C, E)
    #: stays shared across the batch.
    batch_fields: tuple = ()
    #: When set to a group size ``g``, the prox requires the effective
    #: diagonal penalty to be constant within each group of ``g`` entries;
    #: :class:`~admmsolver_tpu_torch.optimizer.ADMMPlan` checks it.
    uniform_mu_group: Optional[int] = None

    def __init__(self, size_x: int) -> None:
        self._size_x = int(size_x)

    @property
    def size_x(self) -> int:
        return self._size_x

    def clone_with(self, **updates):
        """Shallow copy with per-instance parameters replaced by batched
        ones (leading axis B).

        Used by the batched runtime: heavy derived operators (A†A, the
        eigenbasis, couplings) are shared by reference; only the
        per-instance values are swapped.  Unknown fields raise.
        """
        if updates:
            unknown = set(updates) - set(self.batch_fields)
            if unknown:
                raise ValueError(
                    f"{type(self).__name__} has no batchable fields "
                    f"{sorted(unknown)}; available: {self.batch_fields}")
        obj = copy.copy(self)
        obj._apply_updates(updates)
        return obj

    def _apply_updates(self, updates: dict) -> None:
        if updates:
            raise ValueError(
                f"{type(self).__name__} accepts no batch overrides")

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

    def prox_with_factors(self, factors, h, batched: bool = False):
        raise NotImplementedError

    def prox_diag(self, h, mu_diag, batched: bool = False):
        raise NotImplementedError

    def capturable(self, dtype: torch.dtype, device) -> bool:
        """Whether a CUDA graph can hold this objective's engine steps
        (factors and prox) for a state of real ``dtype`` on ``device``: none
        of them reads a value on the host.  Only routes of the spectral
        proxes cannot (:data:`~admmsolver_tpu_torch.ops.prox.
        ROUTE_CAPTURABLE`)."""
        return True


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

    Batched, the penalty is a :class:`LaneOperators`: per-lane shifts
    ``(B,)`` on the shared eigenbasis, or per-lane inverses.  Which basis a
    shift takes is then decided without reading its values (as the JAX
    package decides it at trace time): thin wherever there is one, full
    only for a block without couplings.
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

    def clone_with(self, **updates):
        # Decompose on the template, so that its clones share the eigenbasis.
        if "A" not in updates and self._spectral_ok() and self._get_eig_thin() is False:
            self._get_eig()
        return ObjectiveFunctionBase.clone_with(self, **updates)

    def _spectral_inner(self):
        """(dense Gram, kron rest) if the spectral path applies, else None.

        ``A†A`` may be plain dense, or ``G ⊗ I_rest`` (a
        :class:`PartialDiagonalMatrix` — the real embedding of a complex
        problem, :mod:`admmsolver_tpu_torch.models.realify`): the eigensystem
        of the small factor G diagonalizes the whole Gram blockwise, so a
        solve stays two small products with ``rest`` columns per lane.
        """
        if isinstance(self._AcA, DenseMatrix):
            return self._AcA.data, 1
        if isinstance(self._AcA, PartialDiagonalMatrix) and \
                isinstance(self._AcA.matrix, DenseMatrix):
            return self._AcA.matrix.data, self._AcA._rest
        return None

    def _spectral_ok(self) -> bool:
        return self._spectral_inner() is not None

    def _get_eig(self):
        if self._eig is None:
            gram, _ = self._spectral_inner()
            self._eig = np.linalg.eigh(gram.detach().cpu().numpy())
        return self._eig

    def _thin_A(self):
        """Dense wide A (or the small factor of ``A ⊗ I``) as a numpy
        array, or None."""
        A_op = getattr(self, "_A", None)
        if isinstance(A_op, PartialDiagonalMatrix):
            A_op = A_op.matrix
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

    def _kron_rest(self) -> int:
        """``rest`` of a Kronecker Gram ``G ⊗ I_rest``, 1 for a plain one."""
        inner = self._spectral_inner()
        return 1 if inner is None else inner[1]

    def _basis(self, thin: bool, like: torch.Tensor):
        """(lam, U) of the thin or full eigensystem as tensors on ``like``'s
        device and precision, moved there once."""
        cache = self.__dict__.setdefault("_basis_cache", {})
        key = (thin, like.device, like.dtype)
        if key not in cache:
            lam, U = self._get_eig_thin() if thin else self._get_eig()
            cache[key] = (_match_precision(lam, like), _match_precision(U, like))
        return cache[key]

    def _get_B(self, mu: MatrixBase):
        """Factors for ``mu`` through the eager path's one-entry cache."""
        key = matrix_hash(mu)
        if self._B_cache[0] != key:
            self._B_cache = (key, self.make_factors(mu))
        return self._B_cache[1]

    def make_factors(self, mu_op):
        """B = (alpha A†A + mu)^{-1}: spectral shift or explicit inverse."""
        if isinstance(mu_op, LaneOperators):
            if mu_op.kind == "scalar" and self._spectral_ok():
                thin = self._get_eig_thin() is not False and not mu_op.known_zero
                return SpectralShift(mu_op.data, thin)
            total = self._lane_gram(mu_op.data.device).scale(self._alpha) + mu_op
            # per-lane penalties of a large banded block are (B, n) arrays:
            # the penalty goes before the factorization's transients come
            del mu_op
            return _inv_hpd(total)
        if isinstance(mu_op, ScaledIdentityMatrix) and self._spectral_ok():
            shift = _asarray(mu_op.coeff)
            thin = self._get_eig_thin() is not False and (
                structure_is_static() or bool(torch.any(shift != 0)))
            return SpectralShift(shift, thin)
        return _inv_hpd(add(self._AcA * self._alpha, mu_op))

    def _lane_gram(self, device):
        """A†A as lane operators on ``device``: per-lane ones as they are, a
        shared one made once a device (made from a Python scalar it lives on
        the host, and a captured chunk can neither copy it over nor read a
        diagonal's values to find its structure)."""
        if isinstance(self._AcA, LaneOperators):
            return self._AcA
        cache = self.__dict__.setdefault("_lane_gram_cache", {})
        if device not in cache:
            gram = LaneOperators.shared(self._AcA)
            cache[device] = gram._with(gram.kind, gram.data.to(device)).with_block()
        return cache[device]

    def _apply_B_rows(self, factors, rhs):
        """Lane b's B on row b of ``rhs`` (B, n)."""
        if not isinstance(factors, SpectralShift):
            return factors.matvec_rows(rhs)
        lam, U = self._basis(factors.thin, rhs)
        shift = _match_precision(factors.shift, rhs)[:, None]
        denom = _lanes(self._alpha, rhs) * lam + shift              # (B, R)
        rest = self._kron_rest()
        if rest > 1:
            # G ⊗ I_rest: each lane's rest entries are columns of its products
            r3 = rhs.reshape(rhs.shape[0], -1, rest)                 # (B, m, rest)
            w = _mm(U.conj().T, r3)                                  # (B, R, rest)
            if factors.thin:
                out = _mm(U, w * (1.0 / denom - 1.0 / shift)[:, :, None]) \
                    + r3 / shift[:, :, None]
            else:
                out = _mm(U, w / denom[:, :, None])
            return out.reshape(rhs.shape)
        w = _mm(rhs, U.conj())
        if factors.thin:
            return _mm(w * (1.0 / denom - 1.0 / shift), U.T) + rhs / shift
        return _mm(w / denom, U.T)

    def _apply_B_cols(self, factors, cols):
        """Every lane's B on the shared columns ``cols`` (n, k): (B, n, k)."""
        if not isinstance(factors, SpectralShift):
            return factors.matmat(cols)
        lam, U = self._basis(factors.thin, cols)
        shift = _match_precision(factors.shift, cols)[:, None]
        denom = _lanes(self._alpha, cols) * lam + shift
        rest = self._kron_rest()
        # G ⊗ I_rest: the rest axis joins the columns
        c2 = cols if rest == 1 else cols.reshape(cols.shape[0] // rest, -1)
        w = _mm(U.conj().T, c2)                                      # (R, rest·k)
        if factors.thin:
            coef = 1.0 / denom - 1.0 / shift
            out = _mm(U, coef[:, :, None] * w) + c2 / shift[:, :, None]
        else:
            out = _mm(U, w / denom[:, :, None])
        return out.reshape((out.shape[0],) + tuple(cols.shape))

    def _apply_B(self, factors, rhs):
        if isinstance(factors, SpectralShift):
            lam, U = self._basis(factors.thin, rhs)
            shift = _match_precision(factors.shift, rhs)
            rest = self._kron_rest()
            # G ⊗ I_rest: fold the rest axis into columns
            r2 = rhs if rest == 1 else rhs.reshape(rhs.shape[0] // rest, -1)
            w = _mm(U.conj().T, r2)
            if factors.thin:
                coef = 1.0 / (self._alpha * lam + shift) - 1.0 / shift
                w = w * (coef if w.ndim == 1 else coef[:, None])
                return (_mm(U, w) + r2 / shift).reshape(rhs.shape)
            denom = self._alpha * lam + shift
            w = w / (denom if w.ndim == 1 else denom[:, None])
            return _mm(U, w).reshape(rhs.shape)
        return factors @ rhs


class LeastSquares(_ShiftedQuadratic, ObjectiveFunctionBase):
    """``alpha * ||y - A x||_2^2`` (reference ``objectivefunc.py:56-110``)."""

    is_quadratic = True
    batch_fields = ("alpha", "y", "Acy", "A")

    def _apply_updates(self, updates: dict) -> None:
        if "A" in updates:
            # One dense operator per lane: no shared eigenbasis, so the
            # factors are per-lane dense inverses (``_spectral_ok`` sees no
            # DenseMatrix Gram).
            A = _asarray(updates["A"])                       # (B, M, N)
            self._A = A
            self._Ac = A.mH
            self._AcA = LaneOperators("dense", self._Ac @ A, A.shape[-1])
            self._Acy = self._adjoint_rows(self._y)
            self._eig = None
            self._eig_thin = None
            self._basis_cache = {}
        if "alpha" in updates:
            self._alpha = updates["alpha"]
        if "y" in updates:
            self._y = _asarray(updates["y"])
            self._Acy = self._adjoint_rows(self._y)
        if "Acy" in updates:
            # A†y made once per instance by the batched prologue.
            self._Acy = updates["Acy"]
        self._B_cache = (None, None)

    def _adjoint_rows(self, y):
        """A†y for ``y`` (M,) or one data vector per lane (B, M)."""
        if isinstance(self._Ac, torch.Tensor):               # per-lane operators
            return (self._Ac @ _match_precision(y, self._Ac)[..., None])[..., 0]
        return self._Ac.matvec_rows(y) if y.ndim == 2 else self._Ac @ y

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
    def prox_with_factors(self, factors, h, batched: bool = False):
        Acy = _match_precision(self._Acy, h)
        if batched:
            return self._apply_B_rows(factors, _lanes(self._alpha, h) * Acy - h)
        return self._apply_B(factors, self._alpha * Acy - h)


class ConstrainedLeastSquares(LeastSquares):
    """``alpha * ||y - A x||² s.t. C x = D`` exactly, by Lagrange block
    elimination (reference ``objectivefunc.py:113-157``)."""

    batch_fields = ("alpha", "y", "Acy", "D", "A")

    def _apply_updates(self, updates: dict) -> None:
        D = updates.pop("D", None)
        super()._apply_updates(updates)
        if D is not None:
            self._D = _asarray(D)

    def __init__(self, alpha, A, y, C, D) -> None:
        C = asmatrixtype(C)
        D = _asarray(D)
        if D.ndim != 1 or C.shape[0] != D.shape[0] or A.shape[1] != C.shape[1]:
            raise ValueError(f"constraint C {C.shape}, D {tuple(D.shape)} does not "
                             f"match A {tuple(A.shape)}")
        super().__init__(alpha, A, y)
        self._C = C
        self._D = D

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if mu is None:
            mu = ScaledIdentityMatrix(self._Nx, 0.0)
        return super().solve(h, mu)

    def make_factors(self, mu_op: MatrixBase):
        """(B, xi2 = -B C†, S^{-1} = (C xi2)^{-1}).  The reference recomputes
        ``xi2`` and the small (Nc×Nc) inverse on every call
        (``objectivefunc.py:148-157``); both depend only on B, so they are
        made when the penalty changes."""
        B = super().make_factors(mu_op)
        if isinstance(mu_op, LaneOperators):
            # per lane: xi2 (B, Nx, Nc), S^{-1} (B, Nc, Nc)
            xi2 = -self._apply_B_cols(B, self._C.conjugate().T.asmatrix())
            S = _mm(self._C.asmatrix(), xi2)
            return (B, xi2, -inv_hpd(-S))
        xi2 = -self._apply_B(B, self._C.conjugate().T.asmatrix())
        S = self._C @ xi2
        # S = -C B C† with B positive definite, so -S is too.
        return (B, xi2, -inv_hpd(-S))

    def prox_with_factors(self, factors, h, batched: bool = False):
        B, xi2, Sinv = factors
        xi1 = super().prox_with_factors(B, h, batched)
        D = _match_precision(self._D, xi1)
        if batched:
            nu = _mm(_match_precision(Sinv, xi1), (D - self._C.matvec_rows(xi1))[..., None])
            return xi1 + _mm(_match_precision(xi2, xi1), nu)[..., 0]
        nu = _mm(_match_precision(Sinv, xi1), D - (self._C @ xi1))
        return xi1 + _mm(_match_precision(xi2, xi1), nu)


class L1Regularizer(ObjectiveFunctionBase):
    """``F(x) = alpha |x - offset|_1`` (reference ``objectivefunc.py:
    160-195``; ``offset=None`` is the reference's plain L1).

    By the substitution ``z = x - offset`` the prox is the plain
    soft-threshold on a shifted dual, ``x = offset + soft(-h/mu - offset,
    alpha/(2 mu))``.
    """

    needs_diagonal_mu = True
    batch_fields = ("alpha", "offset")

    def _apply_updates(self, updates: dict) -> None:
        if "alpha" in updates:
            self._alpha = updates["alpha"]
        if "offset" in updates:
            self._offset = _asarray(updates["offset"])

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

    def prox_diag(self, h, mu_diag, batched: bool = False):
        h = _real_if_complex(h)
        mu_diag = _match_precision(mu_diag, h)
        alpha = _lanes(self._alpha, h) if batched else self._alpha
        thr = 0.5 * alpha / mu_diag
        if self._offset is None:
            return soft_threshold(torch.div(h, mu_diag).neg_(), thr)
        y = _match_precision(_real_if_complex(self._offset), h)
        return y + soft_threshold(-(h / mu_diag) - y, thr)


class L2Regularizer(_ShiftedQuadratic, ObjectiveFunctionBase):
    """``F(x) = alpha |A x|_2^2`` — generalized ridge / smoothness
    (reference ``objectivefunc.py:198-242``)."""

    is_quadratic = True
    batch_fields = ("alpha",)

    def _apply_updates(self, updates: dict) -> None:
        if "alpha" in updates:
            self._alpha = updates["alpha"]
        self._B_cache = (None, None)

    def __init__(self, alpha: float, A: Union[np.ndarray, MatrixBase]) -> None:
        A = asmatrixtype(A)
        super().__init__(A.shape[1])
        if not alpha > 0:
            raise ValueError("alpha must be positive")
        self._alpha = alpha
        self._A = A
        self._AcA = matmul(A.conjugate().T, A)
        self._B_cache = (None, None)

    def __call__(self, x) -> float:
        Ax = self._A @ _asarray(x)
        return float(self._alpha * torch.vdot(Ax, Ax).real)

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        n = self._A.shape[1]
        if mu is None:
            mu = ScaledIdentityMatrix(n, 0.0)
        if h is None:
            return torch.zeros(n, dtype=torch.float64)
        return self.prox_with_factors(self._get_B(mu), _asarray(h))

    def prox_with_factors(self, factors, h, batched: bool = False):
        if batched:
            return -self._apply_B_rows(factors, h)
        return -self._apply_B(factors, h)


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

    def prox_diag(self, h, mu_diag, batched: bool = False):
        h = _real_if_complex(h)
        return project_nonneg(-(h / _match_precision(mu_diag, h)))


def _batched_bound(v) -> torch.Tensor:
    """A per-lane override of a bound or offset: ``(B,)`` (one scalar a lane)
    as a ``(B, 1)`` column, ``(B, n)`` as it is."""
    v = _asarray(v)
    return v[:, None] if v.ndim == 1 else v


class BoxProjectionPenalty(ObjectiveFunctionBase):
    """Indicator of the box ``lo <= x <= hi`` (JAX ``objectivefunc.py:
    669-711``; generalizes ``NonNegativePenalty``, reference
    ``objectivefunc.py:245-271``, to arbitrary bounds).

    The prox is the box projection ``clip(-h/mu, lo, hi)``.  Bounds are
    scalars or per-coordinate, and per-instance overridable in the batched
    engine (``batch_fields``): ``(B,)`` for one bound a lane, ``(B, n)`` for
    per-coordinate ones.
    """

    needs_diagonal_mu = True
    batch_fields = ("lo", "hi")

    def _apply_updates(self, updates: dict) -> None:
        if "lo" in updates:
            self._lo = _batched_bound(updates["lo"])
        if "hi" in updates:
            self._hi = _batched_bound(updates["hi"])

    def __init__(self, size_x: int, lo=0.0, hi=1.0) -> None:
        super().__init__(size_x)
        lo, hi = _asarray(lo), _asarray(hi)
        for name, b in (("lo", lo), ("hi", hi)):
            if b.ndim and tuple(b.shape) != (size_x,):
                raise ValueError(f"{name} of shape {tuple(b.shape)} is neither a scalar "
                                 f"nor ({size_x},)")
        if not bool(torch.all(lo <= hi)):
            raise ValueError("empty box: lo > hi")
        self._lo, self._hi = lo, hi

    def __call__(self, x) -> float:
        return 0.0

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        return self.prox_diag(_asarray(h), _mu_diagonal(mu))

    def prox_diag(self, h, mu_diag, batched: bool = False):
        h = _real_if_complex(h)
        v = -(h / _match_precision(mu_diag, h))
        # bounds follow the state's precision and device (a Python-scalar
        # bound is a 0-d host tensor)
        return torch.clamp(v, min=_match_precision(self._lo, v),
                           max=_match_precision(self._hi, v))


class GroupL1Regularizer(ObjectiveFunctionBase):
    """``F(x) = alpha * sum_g ||x_g||_2`` over ``n_groups`` equal, contiguous
    groups of ``group_size`` (group lasso; JAX ``objectivefunc.py:714-789``,
    extends ``L1Regularizer``, reference ``objectivefunc.py:160-195``, to
    block sparsity).

    With a penalty ``mu_g`` constant within each group the prox is the group
    soft-threshold ``v_g max(1 - (alpha/(2 mu_g)) / ||v_g||, 0)``, ``v =
    -h/mu``.  Identity couplings give such a penalty: the eager ``solve``
    checks it on the values, the engine at plan build
    (``ADMMPlan._check_uniform_mu``), never inside the loop.
    """

    needs_diagonal_mu = True
    batch_fields = ("alpha",)

    def _apply_updates(self, updates: dict) -> None:
        if "alpha" in updates:
            self._alpha = _asarray(updates["alpha"])

    def __init__(self, alpha: float, group_size: int, n_groups: int) -> None:
        if not alpha > 0:
            raise ValueError("alpha must be positive")
        if group_size < 1 or n_groups < 1:
            raise ValueError(f"group_size {group_size} and n_groups {n_groups} must be >= 1")
        super().__init__(int(group_size) * int(n_groups))
        self._alpha = alpha
        self._gs = int(group_size)
        self._ng = int(n_groups)
        # engine contract, checked at ADMMPlan build
        self.uniform_mu_group = self._gs

    def __call__(self, x) -> float:
        x = _asarray(x)
        xg = x.reshape(tuple(x.shape[:-1]) + (self._ng, self._gs))
        return float(self._alpha * torch.sum(torch.sqrt(torch.sum(torch.abs(xg) ** 2, dim=-1))))

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        mu_diag = _mu_diagonal(mu)
        mg = np.broadcast_to(mu_diag.detach().cpu().numpy(), (self.size_x,)).reshape(-1, self._gs)
        if not np.allclose(mg, mg[:, :1]):
            raise ValueError(
                "GroupL1Regularizer needs a blockwise-uniform penalty "
                "(constant mu within each group); couple this block "
                "through identity/ScaledIdentity operators")
        return self.prox_diag(_asarray(h), mu_diag)

    def prox_diag(self, h, mu_diag, batched: bool = False):
        h = _real_if_complex(h)
        mu_diag = _match_precision(mu_diag, h)
        v = -(h / mu_diag)
        groups = tuple(v.shape[:-1]) + (self._ng, self._gs)
        vg = v.reshape(groups)
        mug = torch.broadcast_to(mu_diag, v.shape).reshape(groups)
        alpha = _lanes(self._alpha, h) if batched else self._alpha
        t = 0.5 * alpha / mug[..., 0]                                 # (..., ng)
        nrm = torch.sqrt(torch.sum(vg * vg, dim=-1))                  # (..., ng)
        scale = torch.where(nrm > t, 1.0 - t / torch.where(nrm > 0.0, nrm, 1.0), 0.0)
        return (vg * scale[..., None]).reshape(v.shape)


class HuberLoss(ObjectiveFunctionBase):
    """``F(x) = alpha * sum_i H_delta(x_i - y_i)`` with ``H_delta(z) = z²/2``
    for ``|z| <= delta``, else ``delta (|z| - delta/2)`` (JAX
    ``objectivefunc.py:792-854``; robust data fits).

    The prox is elementwise, a three-way ``where``: with ``z = x - y`` and
    ``u = h + mu y``, the quadratic region gives ``z = -2u / (alpha + 2 mu)``
    and the linear tails ``z = -(2u ± alpha delta) / (2 mu)``.
    """

    needs_diagonal_mu = True
    batch_fields = ("alpha", "y")

    def _apply_updates(self, updates: dict) -> None:
        if "alpha" in updates:
            self._alpha = _asarray(updates["alpha"])
        if "y" in updates:
            self._y = _asarray(updates["y"])

    def __init__(self, alpha: float, y, delta: float = 1.0) -> None:
        y = _asarray(y)
        if y.ndim != 1:
            raise ValueError("y must be 1-D")
        super().__init__(y.shape[0])
        if not (alpha > 0 and delta > 0):
            raise ValueError("alpha and delta must be positive")
        self._alpha = alpha
        self._y = y
        self._delta = float(delta)

    def __call__(self, x) -> float:
        x = _real_if_complex(_asarray(x))
        z = torch.abs(x - _match_precision(_real_if_complex(self._y), x))
        d = self._delta
        return float(self._alpha * torch.sum(torch.where(z <= d, 0.5 * z * z, d * (z - 0.5 * d))))

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        return self.prox_diag(_asarray(h), _mu_diagonal(mu))

    def prox_diag(self, h, mu_diag, batched: bool = False):
        h = _real_if_complex(h)
        # the state's precision: an f32 phase stays f32
        y = _match_precision(_real_if_complex(self._y), h)
        mu_diag = _match_precision(mu_diag, h)
        a = _lanes(self._alpha, h) if batched else self._alpha
        d = self._delta
        u = h + mu_diag * y
        zq = -2.0 * u / (a + 2.0 * mu_diag)
        zp = -(2.0 * u + a * d) / (2.0 * mu_diag)
        zn = -(2.0 * u - a * d) / (2.0 * mu_diag)
        return y + torch.where(zq > d, zp, torch.where(zq < -d, zn, zq))


class NuclearNormPenalty(ObjectiveFunctionBase):
    """``F(x) = alpha ||mat(x)||_*``: the nuclear norm of ``x`` viewed as an
    (m, n) matrix, row-major (JAX ``objectivefunc.py:857-970``; low-rank
    recovery, :func:`rpca_model`).

    The prox is the singular-value soft-threshold of every lane's matrix at
    once:

        argmin_X  alpha ||X||_* + 2 Re<H, X> + mu |X|_F²
                = U soft(s, alpha/(2 mu)) Vᴴ,   U s Vᴴ = svd(-H/mu).

    The closed form needs a uniform penalty, which identity couplings give:
    the eager ``solve`` checks it on the values, the engine at plan build.
    ``svd_method`` (the JAX package's, with its "on the TPU" read as "on a
    CUDA device"): ``"xla"`` is ``torch.linalg.svd``; ``"gram"`` the Gram
    route (:func:`~admmsolver_tpu_torch.ops.linop.svd_via_gram`, Jacobi eigh
    up to 256); ``"sign"`` the SVD-free polar route
    (:func:`~admmsolver_tpu_torch.ops.prox.svt_sign`; the objective value
    then uses the Gram route); ``"auto"`` takes ``"xla"`` on the CPU and, for
    a real matrix on the card, ``"sign"`` in the prox where min(m, n) is
    above the Jacobi boundary and ``"gram"`` otherwise.
    """

    needs_diagonal_mu = True
    batch_fields = ("alpha",)

    def _apply_updates(self, updates: dict) -> None:
        if "alpha" in updates:
            self._alpha = _asarray(updates["alpha"])

    def __init__(self, alpha: float, shape: Sequence, svd_method: str = "auto") -> None:
        if not alpha > 0:
            raise ValueError("alpha must be positive")
        if svd_method not in ("auto", "xla", "gram", "sign"):
            raise ValueError(f"unknown svd_method {svd_method!r}")
        m, n = (int(s) for s in shape)
        super().__init__(m * n)
        self._alpha = alpha
        self._mn = (m, n)
        self._svd_method = svd_method
        # fully uniform penalty required; checked at ADMMPlan build
        self.uniform_mu_group = m * n

    def prox_route(self, dtype: torch.dtype, device) -> str:
        """The route of :meth:`prox_diag` for a real state of ``dtype`` on
        ``device`` (JAX ``objectivefunc.py:923-970``): ``"sign"``
        (:func:`~admmsolver_tpu_torch.ops.prox.svt_sign`), ``"jacobi"`` or
        ``"eigh"`` (the Gram route, its eigh by the Jacobi kernel up to 256
        and the library's above) or ``"svd"`` (``torch.linalg.svd``).
        ``"auto"`` takes the sign route on the card above the Jacobi
        boundary, the Gram route below it, and the library SVD elsewhere."""
        method = self._svd_method
        if method == "auto":
            if torch.device(device).type != "cuda":
                return "svd"
            method = "sign" if min(self._mn) > _jacobi_boundary(dtype) else "gram"
        if method == "sign":
            return "sign"
        if method == "gram":
            return "jacobi" if min(self._mn) <= 256 else "eigh"
        return "svd"

    def capturable(self, dtype: torch.dtype, device) -> bool:
        return ROUTE_CAPTURABLE[self.prox_route(dtype, device)]

    def _svd(self, X: torch.Tensor):
        """Thin SVD by the route ``svd_method`` names (JAX
        ``objectivefunc.py:895-921``): ``"auto"`` is the Gram route for a
        real matrix on a CUDA device, ``torch.linalg.svd`` otherwise."""
        method = self._svd_method
        if method == "auto":
            method = "gram" if X.device.type == "cuda" and not X.is_complex() else "xla"
        if method in ("gram", "sign"):
            # "sign" has no SVD of its own: the value uses the Gram route
            return svd_via_gram(X)
        return torch.linalg.svd(X, full_matrices=False)

    def __call__(self, x) -> float:
        x = _asarray(x)
        X = x.reshape(tuple(x.shape[:-1]) + self._mn)
        return float(self._alpha * torch.sum(self._svd(X)[1]))

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        mu_diag = _mu_diagonal(mu)
        md = mu_diag.detach().cpu().numpy()
        if md.ndim and not np.allclose(md, md.flat[0]):
            raise ValueError(
                "NuclearNormPenalty needs a uniform penalty (constant mu "
                "over the matrix); couple this block through identity/"
                "ScaledIdentity operators")
        return self.prox_diag(_asarray(h), mu_diag)

    def prox_diag(self, h, mu_diag, batched: bool = False):
        h = _real_if_complex(h)
        mu_diag = _match_precision(mu_diag, h)
        v = -(h / mu_diag)
        X = v.reshape(tuple(v.shape[:-1]) + self._mn)
        # one penalty a lane (uniform by contract)
        mu0 = torch.broadcast_to(mu_diag, v.shape)[..., 0]
        tau = 0.5 * _match_precision(self._alpha, h) / mu0           # () or (B,)
        route = self.prox_route(X.dtype, X.device)
        if route == "sign":
            # above the Gram-Jacobi envelope the SVD-free polar route: the
            # threshold annihilates the polynomial's inexact small directions
            return svt_sign(X, tau).reshape(v.shape)
        U, s, Vh = svd_via_gram(X) if route != "svd" else torch.linalg.svd(X, full_matrices=False)
        s2 = torch.clamp_min(s - tau[..., None], 0.0)
        return ((U * s2[..., None, :].to(U.dtype)) @ Vh).reshape(v.shape)


class SemiPositiveDefinitePenalty(ObjectiveFunctionBase):
    """Indicator of the PSD cone for ``x`` viewed as a 3-way tensor with
    Hermitian slices along ``axis`` (reference ``objectivefunc.py:274-327``,
    JAX ``objectivefunc.py:973-1000``).

    The prox projects every slice onto the PSD cone in one batched call by
    the route :func:`~admmsolver_tpu_torch.ops.prox.psd_project` chooses
    (Jacobi eigh, the matrix sign or a library eigh); batched, every lane's
    slices join that one call.
    """

    needs_diagonal_mu = True

    def __init__(self, shape: Sequence, axis: int) -> None:
        if len(shape) != 3:
            raise ValueError(f"shape must have 3 axes, got {tuple(shape)}")
        super().__init__(int(np.prod(shape)))
        self._shape = tuple(int(s) for s in shape)
        self._axis = int(axis)

    def __call__(self, x) -> float:
        return 0.0

    def solve(self, h=None, mu: Optional[MatrixBase] = None):
        if h is None:
            raise ValueError("h must not be None!")
        if mu is None:
            raise ValueError("mu must not be None!")
        return self.prox_diag(_asarray(h), _mu_diagonal(mu))

    def capturable(self, dtype: torch.dtype, device) -> bool:
        n = [s for i, s in enumerate(self._shape) if i != self._axis][-1]
        return ROUTE_CAPTURABLE[psd_route(n, dtype, device)]

    def prox_diag(self, h, mu_diag, batched: bool = False):
        h = _real_if_complex(h)
        return psd_project(-(h / _match_precision(mu_diag, h)), self._shape, self._axis)
