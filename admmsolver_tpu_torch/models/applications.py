"""Problem constructors for the ported workloads.

Counterpart of :mod:`admmsolver_tpu.models.applications`, composing the
objective library and constraint graph like the reference's demo notebooks:

* :func:`basis_pursuit_model` — ``notebooks/basis_pursuit.ipynb`` cells
  5-7: LeastSquares + L1 coupled by identities.
* :func:`lasso_model` — LASSO / elastic-net / nonnegative variants.
* :func:`spm_model` — ``notebooks/spm.ipynb`` cells 10-11: the
  sparse-modeling analytic-continuation model — ConstrainedLeastSquares
  (sum rule) + L1 + NonNegativity through a real-frequency projector.
* :func:`synthetic_spm_data` — a self-contained stand-in for the
  ``sparse_ir`` basis the reference notebook downloads (an SVD of an
  analytic-continuation kernel), so the workload runs hermetically.

The other constructors of the JAX package come with their objectives.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..ops.linop import DiagonalMatrix, identity
from .objectivefunc import (ConstrainedLeastSquares, L1Regularizer,
                            L2Regularizer, LeastSquares, NonNegativePenalty)
from .problem import Model

__all__ = ["basis_pursuit_model", "lasso_model", "spm_model",
           "synthetic_spm_data"]


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
