"""Proximal primitives (``admmsolver_tpu/ops/prox.py``): the elementwise
shrinkages, the PSD-cone projection of Hermitian slices with the JAX
package's dispatch among its routes (Jacobi eigh, the polynomial matrix
sign, a library eigh), and the singular-value soft-threshold by the matrix
sign."""
from __future__ import annotations

from typing import Sequence

import torch

__all__ = ["soft_threshold", "project_nonneg", "psd_project", "psd_project_sign",
           "svt_sign", "psd_route", "ROUTE_CAPTURABLE"]


def soft_threshold(y: torch.Tensor, lam) -> torch.Tensor:
    """Soft-thresholding shrinkage (reference ``_softmax``).

    ``y - lam`` where ``y > lam``; ``y + lam`` where ``y < -lam``; else 0
    (``objectivefunc.py:335-355``).
    """
    shrunk = torch.abs(y) - lam
    # in place on the one temporary: the values of sign(y) * max(|y| - lam, 0)
    return shrunk.clamp_min_(0.0).mul_(torch.sign(y))


def project_nonneg(x: torch.Tensor) -> torch.Tensor:
    """Projection onto the nonnegative orthant (``_project_plus``,
    ``objectivefunc.py:330-333``)."""
    return torch.clamp_min(x, 0.0)


def psd_project(x: torch.Tensor, shape: Sequence[int], axis: int) -> torch.Tensor:
    """Project the Hermitian slices of a 3-way tensor onto the PSD cone.

    The last axis of ``x`` holds ``prod(shape)`` entries; it is viewed as
    ``shape`` and sliced along ``axis``.  Leading axes (one problem instance
    per row in the batched engine) join the slices, so that every slice of
    every row goes through ONE batched projection (the reference loops
    ``np.linalg.eigh`` over the slices, ``objectivefunc.py:320-327``), by
    the route :func:`_psd_project_herm` chooses.

    Each slice is the Hermitian matrix the reference diagonalizes: its lower
    triangle mirrored, its diagonal real (``np.linalg.eigh`` reads only
    ``UPLO='L'``).  The slices are not exactly Hermitian inside the ADMM loop,
    so this is not a symmetrization.
    """
    lead = tuple(x.shape[:-1])
    shape = tuple(int(s) for s in shape)
    ax = len(lead) + int(axis)
    x3 = torch.movedim(x.reshape(lead + shape), ax, len(lead))     # (..., K, n, n)
    n = x3.shape[-1]
    lo = torch.tril(x3, -1)
    diag = torch.diagonal(x3, dim1=-2, dim2=-1).real
    herm = lo + lo.mH + torch.diag_embed(diag).to(x3.dtype)
    proj = _psd_project_herm(herm.reshape(-1, n, n)).reshape(x3.shape)
    return torch.movedim(proj, len(lead), ax).reshape(x.shape)


# PSD-projection dispatch (JAX ``prox.py:55-105``), module-level so that a
# caller or a test can force each route:
#   n <= JACOBI_MAX_N            -> Jacobi eigh (ops.linop.jacobi_eigh: the
#                                   CUDA kernel on the card)
#   n >  JACOBI_MAX_N, sign on   -> the polynomial matrix-sign projection
#                                   (psd_project_sign): any slice size, only
#                                   batched products
#   n >  JACOBI_MAX_N, sign off  -> one batched torch.linalg.eigh
JACOBI_MAX_N = 64
#: The boundary for float32 slices; ``None`` falls back to JACOBI_MAX_N.
JACOBI_MAX_N_F32: "int | None" = 32
#: Above the Jacobi boundary: True (default) = the matrix-sign projection
#: when the operand lies on the card (the port's accelerator, as the TPU is
#: the JAX package's), the exact library eigh elsewhere; "always" = the sign
#: route on every device; False = always the library eigh.
USE_SIGN_ABOVE_JACOBI = True


def _jacobi_boundary(dtype: torch.dtype) -> int:
    if JACOBI_MAX_N_F32 is not None and torch.finfo(dtype).bits <= 32:
        return JACOBI_MAX_N_F32
    return JACOBI_MAX_N


def _sign_active(where) -> bool:
    """Whether the sign route is on for an operand ``where`` (a tensor or its
    device): the JAX package's ``jax.default_backend() == "tpu"`` reads "the
    operand is on a CUDA device"."""
    device = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    return USE_SIGN_ABOVE_JACOBI == "always" or (
        bool(USE_SIGN_ABOVE_JACOBI) and device.type == "cuda")


#: Whether a CUDA graph can hold each route of the spectral proxes (the
#: batched engine captures a chunk only where every route it takes can):
#: the Jacobi kernel and the matrix sign are launches and products only; the
#: library eigh and SVD read their ``info`` on the host (a sync, which a
#: capture refuses) and have no ``_ex`` form.  The nuclear prox's routes are
#: :meth:`~admmsolver_tpu_torch.models.objectivefunc.NuclearNormPenalty.
#: prox_route`'s.
ROUTE_CAPTURABLE = {"jacobi": True, "sign": True, "eigh": False, "complex_eigh": False,
                    "svd": False}


def psd_route(n: int, dtype: torch.dtype, device) -> str:
    """The route :func:`_psd_project_herm` takes for Hermitian slices of
    n × n of ``dtype`` on ``device``: real slices ``"jacobi"`` (n at most
    the boundary), ``"sign"`` above it where :func:`_sign_active`, else
    ``"eigh"``; complex slices the real route of their 2n × 2n embedding
    where that is not ``"eigh"``, else ``"complex_eigh"``."""
    if dtype.is_complex:
        real = psd_route(2 * n, dtype.to_real(), device)
        return "complex_eigh" if real == "eigh" else real
    if n <= _jacobi_boundary(dtype):
        return "jacobi"
    return "sign" if _sign_active(device) else "eigh"


# Matrix-sign polynomial schedules (quintic steps, cubic steps) by float
# width (JAX ``prox.py:95-105``).  The quintic is the tuned Newton–Schulz
# variant a*x + b*x^3 + c*x^5; the cubic tail is the exact Newton–Schulz
# sign iteration.  Eigenvalues with |lam|/||X||_F >= delta are signed to
# eps, delta ~ 1.0e-5 for float32 (8, 8) and ~ 1.8e-10 for float64
# (16, 10); a smaller eigenvalue errs by at most its own magnitude.
SIGN_SCHEDULES = {32: (8, 8), 64: (16, 10)}
_SIGN_QUINTIC = (3.4445, -4.7750, 2.0315)


def _sign_schedule(dtype: torch.dtype):
    return SIGN_SCHEDULES[64 if torch.finfo(dtype).bits > 32 else 32]


def psd_project_sign(herm: torch.Tensor) -> torch.Tensor:
    """PSD projection of real symmetric slices (..., n, n) by the polynomial
    matrix sign: batched products only, no eigendecomposition (JAX
    ``prox.py:108-143``).

    ``P(X) = (X + X sign(X)) / 2`` with ``sign(X)`` from a fixed odd
    polynomial iteration on ``X / ||X||_F`` (:data:`SIGN_SCHEDULES`), the
    absolute value symmetrized before the last product.  Exact for
    eigenvalue magnitudes above ``delta * ||X||_F``; a smaller eigenvalue
    errs by at most its own magnitude.  The products are ``torch.matmul`` in
    full float32/float64.
    """
    k1, k2 = _sign_schedule(herm.dtype)
    a, b, c = _SIGN_QUINTIC
    s = torch.sqrt(torch.sum(herm * herm, dim=(-2, -1), keepdim=True))
    y = herm / torch.where(s > 0, s, torch.ones_like(s))
    eye = torch.eye(herm.shape[-1], dtype=herm.dtype, device=herm.device)
    z = y
    for _ in range(k1):
        z2 = torch.matmul(z, z)
        z4 = torch.matmul(z2, z2)
        z = torch.matmul(z, a * eye + b * z2 + c * z4)
    for _ in range(k2):
        z2 = torch.matmul(z, z)
        z = torch.matmul(z, 1.5 * eye - 0.5 * z2)
    # |Y| = Y sign(Y), symmetrized against rounding drift
    absy = torch.matmul(y, z)
    absy = 0.5 * (absy + absy.mT)
    return s * 0.5 * (y + absy)


def svt_sign(x: torch.Tensor, tau) -> torch.Tensor:
    """Singular-value soft-threshold ``U (S - tau)_+ Vᵀ`` of real ``(...,
    m, n)`` matrices by the polynomial polar decomposition: batched
    products only, no SVD or eigh (JAX ``prox.py:146-190``).

    The thin polar factor ``U_p = U Vᵀ`` comes from the same polynomial
    iteration as :func:`psd_project_sign` on ``X / ||X||_F``; then ``H =
    U_pᵀ X = V S Vᵀ`` (symmetrized) and ``SVT = U_p psd_project_sign(H -
    tau I)``.  Singular directions below ``delta * ||X||_F`` are the ones the
    threshold zeroes whenever ``tau`` is above that floor.  ``tau``: a scalar
    or one value per leading index.  Wide matrices (m < n) go through their
    transpose; complex input raises ``TypeError``.
    """
    if x.is_complex():
        raise TypeError("svt_sign supports real input only")
    m, n = x.shape[-2], x.shape[-1]
    if m < n:
        return svt_sign(x.mT, tau).mT
    k1, k2 = _sign_schedule(x.dtype)
    a, b, c = _SIGN_QUINTIC
    s = torch.sqrt(torch.sum(x * x, dim=(-2, -1), keepdim=True))
    z = x / torch.where(s > 0, s, torch.ones_like(s))
    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    for _ in range(k1):
        g = torch.matmul(z.mT, z)
        z = torch.matmul(z, a * eye + b * g + c * torch.matmul(g, g))
    for _ in range(k2):
        g = torch.matmul(z.mT, z)
        z = torch.matmul(z, 1.5 * eye - 0.5 * g)
    # z ~ U_p = U Vᵀ; H = U_pᵀ X = V S Vᵀ
    h = torch.matmul(z.mT, x)
    h = 0.5 * (h + h.mT)
    tau = torch.as_tensor(tau, dtype=x.dtype, device=x.device)
    shifted = h - (tau[..., None, None] if tau.ndim else tau) * eye
    return torch.matmul(z, psd_project_sign(shifted))


def _rebuild(w: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """V diag(max(w, 0)) Vᴴ."""
    return torch.matmul(V * torch.clamp_min(w, 0.0).to(V.dtype)[..., None, :], V.mH)


def _psd_project_herm(herm: torch.Tensor) -> torch.Tensor:
    """PSD projection of exactly Hermitian slices (K, n, n), by the JAX
    package's dispatch (``prox.py:193-250``), branch for branch
    (:func:`psd_route`).

    Real n <= :func:`_jacobi_boundary`: :func:`~..linop.jacobi_eigh`
    unsorted, then the rebuild.  Larger real slices: :func:`psd_project_sign`
    where :func:`_sign_active`, else one batched ``torch.linalg.eigh``.
    Complex: the real embedding ``X + iY -> [[X, -Y], [Y, X]]`` (spectral
    functions commute with it) through the real dispatch where 2n <= the
    boundary or the sign route is on, else a complex ``torch.linalg.eigh``.
    """
    from .linop import jacobi_eigh

    n = herm.shape[-1]
    route = psd_route(n, herm.dtype, herm.device)
    if herm.is_complex():
        if route == "complex_eigh":
            return _rebuild(*torch.linalg.eigh(herm))
        X, Y = herm.real, herm.imag
        R = torch.cat([torch.cat([X, -Y], dim=-1), torch.cat([Y, X], dim=-1)], dim=-2)
        Rp = _psd_project_herm(R)
        Xp = 0.5 * (Rp[..., :n, :n] + Rp[..., n:, n:])
        Yp = 0.5 * (Rp[..., n:, :n] - Rp[..., :n, n:])
        return torch.complex(Xp, Yp)
    if route == "jacobi":
        return _rebuild(*jacobi_eigh(herm, sort=False))
    if route == "sign":
        return psd_project_sign(herm)
    return _rebuild(*torch.linalg.eigh(herm))
