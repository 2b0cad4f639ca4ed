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
  convergence and penalty decisions, which every rank takes alike on its
  device, in ``lam``'s dtype.  Iteration math as the JAX package's
  (``rowshard.py:152-185``).

The solve runs through a static program (:class:`_LargeNProgram`, the JAX
package's one ``shard_map``-ped ``while_loop``): fixed buffers for the
state, iteration 0 and then chunks of ``interval_update_mu`` iterations
over them, each chunk on a CUDA device a replay of a graph captured once
(:class:`~admmsolver_tpu_torch.parallel.batch._GraphProgram`), its two
collectives inside.  The host reads the done flag after a chunk only where
the solve can finish.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops.linop import _asarray
from ..utils import telemetry
from . import batch
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
    histories, NaN past the exit (the same on every rank); ``mu`` and the
    histories in ``lam``'s dtype, as in the JAX package."""

    x0: torch.Tensor
    x1: torch.Tensor
    h: torch.Tensor
    mu: torch.Tensor
    iterations: int
    converged: bool
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor


class _LargeNProgram(batch._GraphProgram):
    """The static program of a large-N solve key ``(niter, interval)``: the
    counterpart of the JAX package's ``_compiled`` (``rowshard.py:131-205``).

    It owns this rank's buffers: A†y, x0, x1, h, mu (0-d, ``lam``'s dtype),
    the done flag, the count of iterations run, the (niter,) residual
    histories (NaN where not written) and the tolerances as device scalars
    of ``lam``'s dtype, loaded per solve (:meth:`load`).  A chunk (keyed by
    its length) runs the JAX ``step`` that many times with every decision
    on the device: the convergence test and, on an iteration whose index is
    a multiple of ``interval`` and that has not converged, the ×2 / ÷2
    penalty rule capped at 1e3.  Once done an iteration changes nothing.
    The ranks all-reduce the same norms, so they take the same decisions
    and read the same done flag.
    """

    def __init__(self, solver: "LargeNTwoBlockSolver", niter: int, interval: int) -> None:
        self.mesh, self.U, self.lam = solver.mesh, solver.U, solver.lam
        self.prox, self.alpha, self.alpha1 = solver.prox, solver.alpha_ls, solver.alpha1
        self.interval = interval
        dev, rdt = solver.Ac.device, solver.lam.dtype
        self.acy, self.x0, self.x1, self.h = (
            torch.zeros(solver.Ac.shape[0], dtype=solver.Ac.dtype, device=dev) for _ in range(4))
        self.mu = torch.zeros((), dtype=rdt, device=dev)
        self.it = torch.zeros((), dtype=torch.long, device=dev)
        super().__init__(torch.zeros((), dtype=torch.bool, device=dev), "LargeNTwoBlockSolver",
                         (self.x0, self.x1, self.h), (niter,), rdt)
        self.tols = (self.mu.clone(), self.mu.clone())

    def load(self, acy: torch.Tensor, mu0: float, tols) -> None:
        """A solve's A†y, penalty and tolerances; the state from zero."""
        self.acy.copy_(acy)
        for t in (self.x0, self.x1, self.h, self.it):
            t.zero_()
        self.done.fill_(False)
        self.mu.fill_(float(mu0))
        for d, t in zip(self.tols, tols):
            d.fill_(t)
        self.clear_histories()

    def _chunk(self, n: int) -> None:
        for _ in range(n):
            self._step()

    def _step(self) -> None:
        """One iteration (JAX ``rowshard.py:152-185``) on the buffers."""
        mesh, U, lam, mu = self.mesh, self.U, self.lam, self.mu
        alpha, x0, x1, h = self.alpha, self.x0, self.x1, self.h
        rtol, atol = self.tols
        active = ~self.done
        v = alpha * self.acy + h + mu * x1
        w = mesh.all_reduce(U.T @ v)
        coef = 1.0 / (alpha * lam + mu) - 1.0 / mu
        x0n = U @ (coef * w) + v / mu
        z = x0n - h / mu
        if self.prox == "l1":
            x1n = torch.sign(z) * torch.clamp_min(z.abs() - 0.5 * self.alpha1 / mu, 0.0)
        else:
            x1n = torch.clamp_min(z, 0.0)
        hn = h + mu * (x1n - x0n)
        sq = lambda a: (a * a).sum()
        norms = mesh.all_reduce(torch.stack(
            [sq(x0n - x1n), sq(x0n - x0), sq(x0n), sq(x1n), sq(x0)]))
        # the decisions in lam's dtype on the device, alike on every rank
        pn, dn, n0, n1, n0p = torch.sqrt(norms.to(lam.dtype)).unbind()
        dn = mu * dn
        conv = ((pn / torch.maximum(n0, n1) < rtol)
                & (dn / (mu * torch.maximum(n0, n0p)) < rtol))
        conv = conv | ((pn < atol) & (dn < atol))
        slot = self.it.view(1)
        for buf, value in ((self.pbuf, pn), (self.dbuf, dn)):
            buf.index_copy_(0, slot, torch.where(active, value, buf.index_select(0, slot)))
        # the penalty update on the reference schedule
        do_mu = active & (self.it % self.interval == 0) & ~conv
        mu_n = torch.where(pn > 10.0 * dn, mu * 2.0, mu)
        mu_n = torch.where(dn > 10.0 * pn, mu_n / 2.0, mu_n)
        mu_n = torch.clamp_max(mu_n, 1e3)
        for d, t in ((x0, x0n), (x1, x1n), (h, hn)):
            d.copy_(torch.where(active, t, d))
        mu.copy_(torch.where(do_mu, mu_n, mu))
        self.it.add_(active.to(self.it.dtype))
        self.done.logical_or_(active & conv)

    def buffers(self):
        """Every tensor the program holds between solves."""
        return (self.acy, self.x0, self.x1, self.h, self.mu, self.done, self.it, self.pbuf,
                self.dbuf) + self.tols


class LargeNTwoBlockSolver:
    """One huge-N 2-block problem (LS + L1/NonNeg, identity-coupled) with the
    feature axis split over the ranks of ``mesh``.

    ``A`` (M, N), M < N (the compressed-sensing shape), is the global
    operator on the host or on a device; each rank keeps its N/W columns as
    its rows of ``Ac = A†`` (a view where ``A`` is already on the rank's
    device) and makes its rows of the thin basis ``U = A† W λ^{-1/2}`` (N, R),
    so no rank holds an (N, N) matrix or all of ``U``.
    """

    @telemetry.spanned("admm.init")
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
        #: the solve programs by (niter, interval) (:meth:`solve`), and the
        #: memory of their graphs
        self._programs = batch._ProgramCache(mesh.device)

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

    @property
    def captures(self) -> bool:
        """Whether a solve replays its chunks as captured graphs
        (:meth:`~admmsolver_tpu_torch.parallel.batch._ProgramCache.captures`),
        where the mesh has no group or a NCCL one.  A gloo group's
        collectives run on the host, which a graph cannot hold: its chunks
        run without graphs."""
        group = self.mesh.group
        return self._programs.captures(
            allowed=group is None or dist.get_backend(group) == "nccl")

    @telemetry.spanned(telemetry.SOLVE)
    def solve(self, y, niter: int = 10000, mu0: float = 1.0,
              rtol: float = 1e-12, atol: float = 0.0,
              interval_update_mu: int = 100) -> LargeNResult:
        """The engine's 2-block sweep in thin-spectral form until the
        reference's convergence test holds or ``niter`` iterations ran; the
        penalty doubles or halves (10x imbalance, capped at 1e3) on every
        ``interval_update_mu``-th iteration that has not converged.  ``y``
        (M,) is the global right-hand side, of ``A``'s dtype.

        Runs through the solver's program for ``(niter, interval)``
        (:class:`_LargeNProgram`, at most :data:`~admmsolver_tpu_torch.
        parallel.batch.PROGRAM_CACHE_SIZE`, the oldest dropped first):
        iteration 0, full chunks, the remainder, each a replay of a captured
        graph where :attr:`captures` (the first chunk runs eagerly, which
        also forms a NCCL communicator before any capture).  The host reads
        the done flag after a chunk only where the solve can finish."""
        niter, interval = int(niter), int(interval_update_mu)
        keys = [n for n, _ in _LargeNProgram.schedule(niter, interval)]
        acy = self.Ac @ _asarray(y).to(self.mesh.device, self.Ac.dtype)
        program = self._programs.program((niter, interval),
                                         lambda: _LargeNProgram(self, niter, interval))
        program.load(acy, mu0, (rtol, atol))
        del acy
        capture = self.captures
        program.run_schedule(keys, capture, self._programs.graph_pool(capture),
                             rtol > 0 or atol > 0)
        it, done = torch.stack([program.it, program.done.to(program.it.dtype)]).tolist()
        # copies: the next solve overwrites the buffers
        return LargeNResult(x0=program.x0.clone(), x1=program.x1.clone(), h=program.h.clone(),
                            mu=program.mu.clone(), iterations=int(it), converged=bool(done),
                            primal_residual=program.pbuf.clone(),
                            dual_residual=program.dbuf.clone())
