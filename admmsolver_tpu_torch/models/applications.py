"""Problem constructors for the ported workloads.

Counterpart of :mod:`admmsolver_tpu.models.applications`, composing the
objective library and constraint graph like the reference's demo notebooks:

* :func:`basis_pursuit_model` — ``notebooks/basis_pursuit.ipynb`` cells
  5-7: LeastSquares + L1 coupled by identities.
* :func:`lasso_model` — LASSO / elastic-net / nonnegative variants.
* :func:`spm_model` — ``notebooks/spm.ipynb`` cells 10-11: the
  sparse-modeling analytic-continuation model — ConstrainedLeastSquares
  (sum rule) + L1 + NonNegativity through a real-frequency projector.
* :func:`sdp_model` — semidefinite-constrained quadratic with the
  PSD-projection prox.
* :func:`synthetic_spm_data` — a self-contained stand-in for the
  ``sparse_ir`` basis the reference notebook downloads (an SVD of an
  analytic-continuation kernel), so the workload runs hermetically.

The added model families (each a composition of the same block and
coupling machinery):

* :func:`covariance_denoise_model` — weighted nearest-PSD matrix.
* :func:`tv_denoise_model` — 1-D total-variation denoising.
* :func:`bounded_lsq_model` — box-constrained least squares.
* :func:`group_lasso_model` — block-sparse (group-L1) recovery.
* :func:`portfolio_model` — long-only mean-variance portfolio.
* :func:`rpca_model` — robust PCA (nuclear norm plus offset L1).
* :func:`robust_regression_model` — Huber regression.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..ops.linop import BandedMatrix, DiagonalMatrix, ScaledIdentityMatrix, identity
from .objectivefunc import (BoxProjectionPenalty, ConstrainedLeastSquares,
                            GroupL1Regularizer, HuberLoss, L1Regularizer,
                            L2Regularizer, LeastSquares, NonNegativePenalty,
                            NuclearNormPenalty, SemiPositiveDefinitePenalty)
from .problem import Model

__all__ = ["basis_pursuit_model", "lasso_model", "spm_model", "sdp_model",
           "covariance_denoise_model", "synthetic_spm_data", "tv_denoise_model",
           "bounded_lsq_model", "group_lasso_model", "portfolio_model",
           "rpca_model", "robust_regression_model"]


def basis_pursuit_model(A, y, alpha_l1: float = 0.1) -> Model:
    """min ||y - A x||² + alpha |z|_1  s.t. z = x  (2-block)."""
    N = A.shape[1]
    return Model(
        [LeastSquares(1.0, A, y), L1Regularizer(alpha_l1, N)],
        [(1, 0, identity(N), identity(N))])


def lasso_model(A, y, alpha_l1: float,
                alpha_l2: float = 0.0,
                nonneg: bool = False,
                smooth_A: Optional[np.ndarray] = None) -> Model:
    """LASSO / elastic-net / nonnegative-LASSO (2- or 3-block).

    ``alpha_l2 > 0`` adds an L2 (ridge or, with ``smooth_A``, smoothness)
    term on the same variable block; ``nonneg`` adds the nonnegativity
    block coupled by identity.
    """
    N = A.shape[1]
    functions = [LeastSquares(1.0, A, y), L1Regularizer(alpha_l1, N)]
    eqs = [(1, 0, identity(N), identity(N))]
    if alpha_l2 > 0.0:
        B = smooth_A if smooth_A is not None else np.eye(N)
        functions.append(L2Regularizer(alpha_l2, B))
        eqs.append((len(functions) - 1, 0, identity(N), identity(N)))
    if nonneg:
        functions.append(NonNegativePenalty(N))
        eqs.append((len(functions) - 1, 0, identity(N), identity(N)))
    return Model(functions, eqs)


def spm_model(s_diag, g, prj_sum, prj_w, alpha_l1: float,
              sum_value: float = 1.0) -> Model:
    """Sparse-modeling analytic continuation (``spm.ipynb`` cells 10-11).

    Blocks: 0 = IR coefficients rho_l fitted as
    ``ConstrainedLeastSquares(1, -Diag(s), g, prj_sum, [sum_value])``
    (the sum rule as a hard equality); 1 = L1 sparsity on rho_l;
    2 = nonnegativity of the real-frequency spectrum.  Couplings:
    ``(0, 1, I, I)`` and ``(0, 2, prj_w, I)``.
    """
    s_diag = np.asarray(s_diag)
    nl = s_diag.size
    nw = prj_w.shape[0]
    if prj_w.shape[1] != nl:
        raise ValueError(f"prj_w {tuple(prj_w.shape)} does not match {nl} coefficients")
    f0 = ConstrainedLeastSquares(
        1.0, DiagonalMatrix(-s_diag), g,
        np.asarray(prj_sum).reshape(1, nl), np.array([sum_value]))
    f1 = L1Regularizer(alpha_l1, nl)
    f2 = NonNegativePenalty(nw)
    eqs = [
        (0, 1, identity(nl), identity(nl)),
        (0, 2, prj_w, identity(nw)),
    ]
    return Model([f0, f1, f2], eqs)


def sdp_model(A, y, shape: Tuple[int, int, int], axis: int,
              alpha_l1: float = 0.0) -> Model:
    """Semidefinite-constrained quadratic: LS data fit + PSD cone on x
    viewed as ``shape`` with Hermitian slices along ``axis``."""
    N = int(np.prod(shape))
    if A.shape[1] != N:
        raise ValueError(f"A of shape {tuple(A.shape)} does not act on {N} = prod{tuple(shape)}")
    functions = [LeastSquares(1.0, A, y), SemiPositiveDefinitePenalty(shape, axis)]
    eqs = [(1, 0, identity(N), identity(N))]
    if alpha_l1 > 0.0:
        functions.append(L1Regularizer(alpha_l1, N))
        eqs.append((2, 0, identity(N), identity(N)))
    return Model(functions, eqs)


def covariance_denoise_model(Y, weights=None) -> Model:
    """Weighted nearest-PSD matrix (covariance denoising):
    ``min_X ||W^(1/2) (X - Y)||_F^2  s.t.  X >= 0`` for a noisy symmetric
    ``Y`` (k, k) and optional positive per-entry weights ``W`` (flat, k*k).

    The data operator is diagonal, so the quadratic block is O(N) and an
    iteration's cost is the PSD projection of one k × k slice a lane.
    Batch per-lane ``Y`` through the ``(0, "y")`` override, passing
    ``sqrt(w) * Y.ravel()`` to match the operator's ``sqrt(w)`` scaling.
    """
    Y = np.asarray(Y)
    k = Y.shape[-1]
    if Y.shape[-2] != k:
        raise ValueError(f"Y must be square, got {Y.shape}")
    N = k * k
    w = (np.ones(N) if weights is None
         else np.broadcast_to(np.asarray(weights, np.float64), (N,)))
    if not np.all(w > 0):
        raise ValueError("weights must be positive")
    # ||W^(1/2)(X - Y)||² = ||sqrt(w) X - sqrt(w) Y||²: the operator carries
    # sqrt(w), so each entry is weighted w_i
    rw = np.sqrt(w)
    return Model(
        [LeastSquares(1.0, DiagonalMatrix(rw), rw * np.reshape(Y, (-1,))),
         SemiPositiveDefinitePenalty((k, k, 1), 2)],
        [(1, 0, identity(N), identity(N))])


def tv_denoise_model(y, lam: float, structured: bool = True) -> Model:
    """1-D total-variation denoising ``min_x 0.5 ||x - y||² + lam |D x|_1``
    with ``D`` the forward difference: LS data fit + L1 on an auxiliary
    block, coupled by ``D x = z``.

    ``structured=True`` (default) stores ``D`` as a :class:`BandedMatrix`:
    the ``Model`` precompute ``D†D`` stays tridiagonal and the quadratic
    factor is a cyclic-reduction cascade, O(N) memory and O(N log N) solves,
    so TV runs at N = 10⁵ and more where a dense N × N Gram or factor would
    not fit.  ``structured=False`` keeps the dense ``D`` (the same
    trajectories; the parity tests use it).
    """
    y = np.asarray(y)
    if y.ndim != 1 or y.shape[0] < 2:
        raise ValueError("y must be 1-D with at least 2 entries")
    N = y.shape[0]
    if structured:
        bands = np.zeros((2, N - 1))
        bands[0, :] = -1.0   # offset 0
        bands[1, :] = 1.0    # offset +1
        D = BandedMatrix((0, 1), bands, (N - 1, N))
    else:
        D = np.zeros((N - 1, N))
        idx = np.arange(N - 1)
        D[idx, idx] = -1.0
        D[idx, idx + 1] = 1.0
    return Model(
        [LeastSquares(0.5, ScaledIdentityMatrix(N, 1.0), y),
         L1Regularizer(lam, N - 1)],
        [(0, 1, D, identity(N - 1))])


def bounded_lsq_model(A, y, lo=0.0, hi=1.0) -> Model:
    """Box-constrained least squares ``min_x ||y - A x||²  s.t.  lo <= x <=
    hi``: LS + box projection coupled by identity."""
    N = A.shape[1]
    return Model(
        [LeastSquares(1.0, A, y), BoxProjectionPenalty(N, lo, hi)],
        [(1, 0, identity(N), identity(N))])


def group_lasso_model(A, y, alpha: float, group_size: int) -> Model:
    """Group lasso ``min_x ||y - A x||² + alpha sum_g ||x_g||_2`` over equal
    contiguous groups: LS + group soft-threshold coupled by identity (which
    gives the blockwise-uniform penalty the group prox needs)."""
    N = A.shape[1]
    if N % group_size:
        raise ValueError(f"{N} columns do not split into groups of {group_size}")
    return Model(
        [LeastSquares(1.0, A, y), GroupL1Regularizer(alpha, group_size, N // group_size)],
        [(1, 0, identity(N), identity(N))])


def robust_regression_model(A, y, delta: float = 1.0, alpha_reg: float = 1e-6) -> Model:
    """Robust (Huber) regression ``min_x sum_i H_delta((A x - y)_i) +
    alpha_reg ||x||²``: a ridge-regularized coefficient block coupled
    through ``A`` to a residual block with the elementwise Huber prox,
    offset ``y`` (per-instance ``{(1, "y"): y_batch}``)."""
    A = np.asarray(A)
    y = np.asarray(y, dtype=np.float64)
    M, N = A.shape
    if y.shape != (M,):
        raise ValueError(f"y of shape {y.shape} does not match A {A.shape}")
    return Model(
        [L2Regularizer(alpha_reg, np.eye(N)), HuberLoss(1.0, y, delta)],
        [(0, 1, A, identity(M))])


def rpca_model(Y, lam: Optional[float] = None, svd_method: str = "auto") -> Model:
    """Robust PCA ``min_L ||L||_* + lam |Y - L|_1``: a low-rank part
    ``L = x0`` (nuclear norm) and a sparse part ``Y - L`` (offset L1),
    coupled by identity.  ``lam`` defaults to ``1/sqrt(max(Y.shape))``;
    per-instance ``Y`` through ``{(1, "offset"): vec(Y_batch)}``."""
    Y = np.asarray(Y, dtype=np.float64)
    if Y.ndim != 2:
        raise ValueError("Y must be 2-D")
    m, n = Y.shape
    if lam is None:
        lam = 1.0 / np.sqrt(max(m, n))
    mn = m * n
    return Model(
        [NuclearNormPenalty(1.0, (m, n), svd_method=svd_method),
         L1Regularizer(lam, mn, offset=Y.reshape(mn))],
        [(1, 0, identity(mn), identity(mn))])


def portfolio_model(cov, returns, gamma: float = 1.0) -> Model:
    """Long-only mean-variance portfolio ``min_x x†Σx − gamma r†x  s.t.
    1†x = 1, x >= 0``, in the ``alpha ||y − A x||²`` form with ``A = Σ^{1/2}``
    and ``y = (gamma/2) Σ^{-1/2} r`` (constant dropped): the hard equality
    of ConstrainedLeastSquares and the nonnegative block."""
    cov = np.asarray(cov, dtype=np.float64)
    returns = np.asarray(returns, dtype=np.float64)
    N = returns.shape[0]
    if cov.shape != (N, N):
        raise ValueError(f"cov of shape {cov.shape} does not match {N} returns")
    w, V = np.linalg.eigh((cov + cov.T) / 2.0)
    if not w.min() > 0:
        raise ValueError("covariance must be positive definite")
    sqrt_cov = (V * np.sqrt(w)) @ V.T
    y = (gamma / 2.0) * ((V * (1.0 / np.sqrt(w))) @ V.T @ returns)
    f0 = ConstrainedLeastSquares(1.0, sqrt_cov, y, np.ones((1, N)), np.array([1.0]))
    return Model([f0, NonNegativePenalty(N)], [(1, 0, identity(N), identity(N))])


def synthetic_spm_data(nl: int = 30, nw: int = 61, beta: float = 10.0,
                       wmax: float = 5.0, noise: float = 1e-5,
                       seed: int = 0):
    """Hermetic stand-in for the sparse_ir basis of ``spm.ipynb``.

    Builds the fermionic analytic-continuation kernel
    ``K(tau, w) = -exp(-tau w) / (1 + exp(-beta w))`` on a tau x omega
    grid, takes its SVD ``K = U S V†`` (the IR basis), synthesizes a
    two-peak spectrum rho(w) >= 0 with unit weight, and returns

    (s, g, prj_sum, prj_w, omega, rho_true)

    as numpy arrays, where ``s`` are the singular values, ``g = -S V†
    (rho*dw)`` the noisy IR-basis data, ``prj_sum`` the sum-rule row,
    ``prj_w`` the coefficient→spectrum projector (V† rows), mirroring the
    notebook's model wiring.
    """
    rng = np.random.RandomState(seed)
    ntau = 2 * nl
    tau = np.linspace(0, beta, ntau)
    omega = np.linspace(-wmax, wmax, nw)
    dw = np.gradient(omega)

    with np.errstate(over="ignore"):
        K = -np.exp(-tau[:, None] * omega[None, :]) / \
            (1.0 + np.exp(-beta * omega[None, :]))
    # weight columns by dw so K @ rho approximates the integral
    Kw = K * dw[None, :]
    U, S, Vh = np.linalg.svd(Kw, full_matrices=False)
    s = S[:nl]
    V = Vh[:nl]  # (nl, nw): rho_l = V @ rho_w

    # ground-truth spectrum: two Gaussians, unit total weight
    rho = (np.exp(-0.5 * ((omega - 1.2) / 0.4) ** 2) +
           0.7 * np.exp(-0.5 * ((omega + 1.0) / 0.6) ** 2))
    rho = rho / (rho * dw).sum()
    rho_l = V @ (rho * dw)

    g = -s * rho_l
    g = g + noise * rng.randn(nl)

    # prj_w maps coefficients rho_l -> spectrum values rho(w)*dw through
    # the (pseudo)inverse relation rho_w ≈ V† rho_l (V has orthonormal
    # rows), matching the notebook's real-frequency projector.
    prj_w = V.T  # (nw, nl)
    prj_sum = np.ones(nw) @ prj_w  # sum rule: 1·rho_w = sum over weights
    return s, g, prj_sum, prj_w, omega, rho * dw
