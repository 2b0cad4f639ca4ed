"""Large-N operator sharding: one problem instance across the ranks of a mesh.

Counterpart of :mod:`admmsolver_tpu.parallel.rowshard`.  The instance-batch
axis (:mod:`~admmsolver_tpu_torch.parallel.batch` with a
:func:`~admmsolver_tpu_torch.parallel.mesh.batch_sharding`) scales *many*
problems; this module scales ONE problem whose dense operator outgrows one
device, by giving each rank a block of the operator's long axis and summing
the reductions with ``all_reduce``.

* :func:`sharded_gram`: ``A†A`` and ``A†y`` of a tall ``A`` whose rows are
  split over the ranks: each rank contracts its row block, and ONE
  ``all_reduce`` sums the Gram and the right-hand side together.
* :class:`LargeNTwoBlockSolver`: a 2-block identity-coupled solve
  (LeastSquares + L1/NonNegative) with the feature axis N split over the
  ranks: each rank holds N/W rows of ``Ac = A†``, of the thin spectral basis
  ``U`` (N, R) and of the state.  The basis is built on the devices: the
  M x M Gram ``A A†`` is the sharded Gram of the tall ``Ac``, rank 0 takes its
  eigh and broadcasts it, and each rank makes its rows of ``U``.  Each
  iteration makes exactly TWO collectives: the sum of ``U_s^T v_s`` for the
  spectral solve, and the sum of the five residual square-norms for the
  convergence and penalty decisions, which the host then takes alike on
  every rank.  Iteration math as the JAX package's (``rowshard.py:152-185``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.linop import _asarray
from .mesh import Mesh

__all__ = ["sharded_gram", "LargeNTwoBlockSolver", "LargeNResult"]


def _check_axis(mesh: Mesh, axis_name: Optional[str]) -> None:
    if axis_name is not None and axis_name not in mesh.axis_names:
        raise ValueError(f"axis {axis_name!r} is not an axis of the mesh {mesh.axis_names}")


def _own_rows(a, mesh: Mesh, n_rows: int) -> torch.Tensor:
    """This rank's block of the rows of a global array, taken before it moves
    to the rank's device."""
    per = n_rows // mesh.world_size
    return _asarray(a)[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


def _gram(a_s: torch.Tensor, y_s: Optional[torch.Tensor], mesh: Mesh):
    """(sum over ranks of a_s† a_s, of a_s† y_s) in one ``all_reduce``."""
    ah = a_s.mH
    parts = [ah @ a_s] + ([] if y_s is None else [(ah @ y_s)[:, None]])
    buf = mesh.all_reduce(torch.cat(parts, dim=1))
    n = a_s.shape[1]
    return buf[:, :n].contiguous(), None if y_s is None else buf[:, n].contiguous()


def sharded_gram(A, y, mesh: Mesh, axis_name: Optional[str] = None):
    """(A†A, A†y) for a tall ``A`` whose rows are split over the mesh.

    ``A`` (M, N) and ``y`` (M,) are the global arrays, on the host or on a
    device; each rank takes its M/W rows before moving them to its device,
    contracts them, and one ``all_reduce`` leaves the (N, N) Gram and the
    (N,) right-hand side on every rank.
    """
    _check_axis(mesh, axis_name)
    ndev = mesh.world_size
    M = A.shape[0]
    if M % ndev:
        raise AssertionError(
            f"rows {M} must divide the mesh size {ndev}; pad A/y with zero "
            "rows (zero rows contribute nothing to A†A or A†y)")
    return _gram(_own_rows(A, mesh, M), _own_rows(y, mesh, M), mesh)


@dataclasses.dataclass
class LargeNResult:
    """``x0``, ``x1``, ``h``: this rank's (N/W,) rows of the state; ``mu``: the
    final penalty (0-d); ``primal_residual``/``dual_residual``: (niter,)
    float64 histories, NaN past the exit (the same on every rank)."""

    x0: torch.Tensor
    x1: torch.Tensor
    h: torch.Tensor
    mu: torch.Tensor
    iterations: int
    converged: bool
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor


class LargeNTwoBlockSolver:
    """One huge-N 2-block problem (LS + L1/NonNeg, identity-coupled) with the
    feature axis split over the ranks of ``mesh``.

    ``A`` (M, N), M < N (the compressed-sensing shape), is the global
    operator on the host or on a device; each rank keeps its N/W columns as
    its rows of ``Ac = A†`` (a view where ``A`` is already on the rank's
    device) and makes its rows of the thin basis ``U = A† W λ^{-1/2}`` (N, R),
    so no rank holds an (N, N) matrix or all of ``U``.
    """

    def __init__(self, A, mesh: Mesh, prox: str = "l1",
                 alpha_ls: float = 1.0, alpha1: float = 0.1,
                 axis_name: Optional[str] = None) -> None:
        A = _asarray(A)
        self._setup(A.shape, mesh, prox, alpha_ls, alpha1, axis_name)
        per = self.N // mesh.world_size
        self.Ac = A[:, mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device).mH
        # The thin eigensystem of the SMALL (M, M) Gram A A† = Ac† Ac: the one
        # dense object every rank holds.  Rank 0's eigh goes to every rank, so
        # that all use the same basis (eigenvector signs are the library's
        # free choice).
        G, _ = _gram(self.Ac, None, mesh)
        if mesh.rank == 0:
            lam, W = torch.linalg.eigh(G)
            # eigh's vectors come column-major; a broadcast sends the storage
            W = W.contiguous()
        else:
            lam, W = G.new_empty(self.M, dtype=G.real.dtype), torch.empty_like(G)
        mesh.broadcast(lam)
        mesh.broadcast(W)
        tol = self.M * torch.finfo(lam.dtype).eps * max(float(lam.max()), 0.0)
        keep = lam > tol
        self.lam = lam[keep]
        self.U = (self.Ac @ W[:, keep]).div_(torch.sqrt(self.lam))

    def _setup(self, shape, mesh: Mesh, prox: str, alpha_ls: float, alpha1: float,
               axis_name: Optional[str]) -> None:
        _check_axis(mesh, axis_name)
        ndev = mesh.world_size
        M, N = shape
        if not M < N:
            raise AssertionError("large-N path expects a wide A (thin basis)")
        if N % ndev:
            raise AssertionError(f"N={N} must divide the mesh size {ndev}; pad the problem")
        if prox not in ("l1", "nonneg"):
            raise AssertionError(f"prox must be 'l1' or 'nonneg', got {prox!r}")
        self.mesh, self.prox = mesh, prox
        self.alpha_ls, self.alpha1 = float(alpha_ls), float(alpha1)
        self.N, self.M = N, M

    @classmethod
    def from_basis(cls, lam, U, Ac, mesh: Mesh, prox: str = "l1",
                   alpha_ls: float = 1.0, alpha1: float = 0.1) -> "LargeNTwoBlockSolver":
        """A solver on a given thin basis: ``lam`` (R,), the global ``U``
        (N, R) and ``Ac = A†`` (N, M); each rank keeps its N/W rows."""
        self = cls.__new__(cls)
        N, M = np.shape(Ac)
        self._setup((M, N), mesh, prox, alpha_ls, alpha1, None)
        self.lam = _asarray(lam).to(mesh.device)
        self.U = _own_rows(U, mesh, N)
        self.Ac = _own_rows(Ac, mesh, N)
        return self

    def solve(self, y, niter: int = 10000, mu0: float = 1.0,
              rtol: float = 1e-12, atol: float = 0.0,
              interval_update_mu: int = 100) -> LargeNResult:
        """The engine's 2-block sweep in thin-spectral form until the
        reference's convergence test holds or ``niter`` iterations ran; the
        penalty doubles or halves (10x imbalance, capped at 1e3) on every
        ``interval_update_mu``-th iteration that has not converged.  ``y``
        (M,) is the global right-hand side, of ``A``'s dtype."""
        mesh, U, lam = self.mesh, self.U, self.lam
        alpha, alpha1, interval = self.alpha_ls, self.alpha1, int(interval_update_mu)
        acy = self.Ac @ _asarray(y).to(mesh.device, self.Ac.dtype)
        x0 = x1 = h = torch.zeros_like(acy)
        mu = float(mu0)
        pb, db = [], []
        it, done = 0, False
        sq = lambda a: (a * a).sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            while it < niter and not done:
                v = alpha * acy + h + mu * x1
                w = mesh.all_reduce(U.T @ v)
                coef = 1.0 / (alpha * lam + mu) - 1.0 / mu
                x0n = U @ (coef * w) + v / mu
                z = x0n - h / mu
                if self.prox == "l1":
                    x1n = torch.sign(z) * torch.clamp_min(z.abs() - 0.5 * alpha1 / mu, 0.0)
                else:
                    x1n = torch.clamp_min(z, 0.0)
                hn = h + mu * (x1n - x0n)
                norms = mesh.all_reduce(torch.stack(
                    [sq(x0n - x1n), sq(x0n - x0), sq(x0n), sq(x1n), sq(x0)]))
                # the decisions in float64 on the host, alike on every rank
                pn, dn, n0, n1, n0p = np.sqrt(norms.cpu().numpy().astype(np.float64))
                dn = mu * dn
                conv = bool((pn / np.maximum(n0, n1) < rtol)
                            & (dn / (mu * np.maximum(n0, n0p)) < rtol))
                conv = conv or bool((pn < atol) & (dn < atol))
                pb.append(pn)
                db.append(dn)
                if it % interval == 0 and not conv:
                    mu_n = mu * 2.0 if pn > 10.0 * dn else mu
                    mu_n = mu_n / 2.0 if dn > 10.0 * pn else mu_n
                    mu = min(float(mu_n), 1e3)
                x0, x1, h = x0n, x1n, hn
                done = conv
                it += 1
        hist = lambda vals: torch.cat([
            torch.tensor(vals, dtype=torch.float64),
            torch.full((int(niter) - it,), math.nan, dtype=torch.float64)]).to(mesh.device)
        return LargeNResult(x0=x0, x1=x1, h=h,
                            mu=torch.tensor(mu, dtype=lam.dtype, device=mesh.device),
                            iterations=it, converged=done,
                            primal_residual=hist(pb), dual_residual=hist(db))
