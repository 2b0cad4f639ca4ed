"""Fused fast path for the 3-block SpM family.

Counterpart of :mod:`admmsolver_tpu.parallel.fused_spm`.  Drives
:func:`admmsolver_tpu_torch.ops.kernels.fused_spm_chunk`: per chunk the
kernel runs ``interval_update_mu`` iterations with all per-lane state kept
on chip.  A chunk is the refreshed per-lane affine factor, one kernel
launch, then the pair residuals, the convergence predicate and the
residual-balancing penalty update (reference ``optimizer.py:277-299``), at
chunk granularity like :class:`~admmsolver_tpu_torch.parallel.fused.
FusedTwoBlockSolver`, through the same static run program
(:class:`~admmsolver_tpu_torch.parallel.fused._FusedProgram`: on a CUDA
device one replay of a captured graph a chunk).  As in the JAX package's
``_compiled_solve``, the A†y product of the lanes' data is part of the
program (its first chunk); the factorizations keep their Cholesky infos on
the device, read with the done flags or once after the solve.

Scope: ``Model([ConstrainedLeastSquares-or-LeastSquares, L1Regularizer,
NonNegativePenalty], [(0, 1, I, I), (0, 2, P, I)])`` — the reference's SpM
analytic-continuation workload (``notebooks/spm.ipynb`` cells 10-11) — in
float32.  The constrained prox is folded into a per-lane affine map when
the factors are made:

    x0 = b2 - M hk0,  M = (I - xi2 S^{-1} C) B,  B = (a A†A + mu_op)^{-1}
    b2 = a M A†y + xi2 S^{-1} D

algebraically identical to the engine's block elimination (reference
``objectivefunc.py:138-157``); a plain LeastSquares block is the special
case M = B, b2 = a B A†y.

:meth:`FusedSpMSolver.solve_mixed` runs the bulk of the iterations through
the kernel in float32 and hands primal, dual and penalty state to a float64
:class:`~admmsolver_tpu_torch.parallel.batch.BatchedSolver` for the polish.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.objectivefunc import (ConstrainedLeastSquares, L1Regularizer,
                                    LeastSquares, NonNegativePenalty)
from ..models.problem import Model
from ..ops import kernels
from ..utils import telemetry
from . import batch
from .batch import BatchedSolver, BatchResult
from .fused import _check_fused_overrides, _FusedProgram, _is_identity_si, _run

#: the knobs of the one-program mixed solve (the JAX package's fused set,
#: ``fused_spm.py:477-480``); a solve with another takes the two-dispatch form
_MIXED_FUSED_KW = frozenset({"interval_update_mu", "update_h", "rtol", "atol", "fact_incr",
                             "th_change", "max_mu", "record_residuals", "chunked_checks",
                             "done0"})

__all__ = ["FusedSpMSolver", "FusedSpMResult"]


@dataclasses.dataclass
class FusedSpMResult:
    """Batch-major final state (x: tuple of (B, n_k))."""

    x: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    h: Tuple[torch.Tensor, torch.Tensor]
    mu: torch.Tensor              # (B, 2), pair order [(1,0), (2,0)]
    iterations: torch.Tensor
    converged: torch.Tensor
    primal_residual: torch.Tensor  # (B, nchunks) per-chunk samples
    dual_residual: torch.Tensor


def _dense32(op) -> np.ndarray:
    """An operator or tensor as a float32 numpy matrix; complex data raises."""
    a = op if isinstance(op, torch.Tensor) else op.asmatrix()
    a = a.detach().cpu().numpy()
    if np.iscomplexobj(a):
        raise ValueError("fused SpM path is real-f32 only")
    return np.asarray(a, np.float32)


class FusedSpMSolver:
    """Fused chunk solver for the SpM 3-block family, in float32.

    ``device`` is where the solve runs: on ``cuda`` (the default; without a
    CUDA device the constructor raises) every chunk is one launch of the
    Hopper kernel, on ``cpu`` the kernel's plain version.  Any batch size
    and any nl, nw run as they are; nothing is padded.  ``tile_b`` is taken
    for the JAX constructor's callers and has no effect: the JAX solver pads
    the batch to a multiple of it for its Pallas grid (padded lanes start
    done, so the real lanes never depend on it), and the CUDA kernel needs
    no padding.
    """

    @telemetry.spanned("admm.init")
    def __init__(self, model: Model, tile_b: int = 256, device="cuda") -> None:
        if int(tile_b) < 1:
            raise ValueError(f"tile_b must be positive, got {tile_b}")
        if model.num_func != 3:
            raise ValueError("fused SpM path covers 3-block models")
        if model.pairs != [(1, 0), (2, 0)]:
            raise ValueError(f"blocks 1 and 2 must each be coupled to block 0, "
                             f"got pairs {model.pairs}")
        f0, f1, f2 = model.functions
        if not isinstance(f0, LeastSquares):
            raise ValueError("block 0 must be (Constrained)LeastSquares")
        if not isinstance(f1, L1Regularizer):
            raise ValueError("block 1 must be L1Regularizer")
        if f1._offset is not None:
            raise ValueError(
                "fused SpM path does not support L1Regularizer offsets "
                "(the kernel applies the plain soft-threshold)")
        if not isinstance(f2, NonNegativePenalty):
            raise ValueError("block 2 must be NonNegativePenalty")
        if not (_is_identity_si(model.E[(1, 0)])
                and _is_identity_si(model.E[(0, 1)])
                and _is_identity_si(model.E[(0, 2)])):
            raise ValueError("couplings must be (0,1,I,I), (0,2,P,I)")

        self.model = model
        self.f0, self.f1 = f0, f1
        self.nl = f0.size_x
        self.nw = f2.size_x
        self.device = torch.device(device)

        # Set-up products in float32 numpy on the host, as the JAX package
        # makes them, so both iterate on the same constants.
        f32 = dict(dtype=torch.float32, device=self.device)
        P = _dense32(model.E[(2, 0)])
        self.P = torch.as_tensor(P, **f32).contiguous()
        self.W = torch.as_tensor(P.T @ P, **f32)
        self.AcA = torch.as_tensor(_dense32(f0._AcA), **f32)
        self.Ac = torch.as_tensor(_dense32(f0._Ac), **f32)
        self.Acy = torch.as_tensor(_dense32(f0._Acy), **f32)
        self.is_cls = isinstance(f0, ConstrainedLeastSquares)
        if self.is_cls:
            self.C = torch.as_tensor(_dense32(f0._C), **f32)      # (nc, nl)
            self.D = torch.as_tensor(_dense32(f0._D), **f32)      # (nc,)
        #: the run programs by key (:func:`~admmsolver_tpu_torch.parallel.fused.
        #: _run`), and the memory of their graphs
        self._programs = batch._ProgramCache(self.device)

    # -- factor refresh (chunk boundaries) -----------------------------
    def _factors(self, mu1, mu2, alpha_ls, acy):
        """Per-lane affine factor: M (B, nl, nl) and b2 (B, nl)
        (:func:`~admmsolver_tpu_torch.ops.kernels.spm_factor_refresh`: on
        the card one kernel launch at nl <= 32).

        ``mu1``/``mu2``/``alpha_ls``: (B,); ``acy`` = A†y (B, nl).
        """
        C, D = (self.C, self.D) if self.is_cls else (None, None)
        return kernels.spm_factor_refresh(self.AcA, self.W, C, D, alpha_ls, mu1, mu2, acy)

    def _acy_of(self, data):
        """A†y of the lanes' data (B, M)."""
        return data @ self.Ac.T

    def _step(self, state, acy, alpha_ls, alpha1, knobs, n_iters: int, do_mu: bool):
        """One chunk: the factor refresh, ``n_iters`` kernel iterations,
        then residuals, convergence and (if ``do_mu``) the penalty update.
        ``knobs``: rtol, atol, fact_incr, th_change, max_mu."""
        x0, x1, x2, h10, h20, mu, done, count = state
        rtol, atol, fact_incr, th_change, max_mu = knobs
        mu1, mu2 = mu[:, 0], mu[:, 1]

        M, b2 = self._factors(mu1, mu2, alpha_ls, acy)
        telemetry.mark("refresh.end")
        thr = (0.5 * alpha1 / mu1)[:, None]
        x0n, x1n, x2n, h10n, h20n, x0p = kernels.fused_spm_chunk(
            self.P, M, b2, mu, thr, x0, x1, x2, h10, h20, n_iters=n_iters)
        telemetry.mark("kernel.end")
        active = ~done
        am = active[:, None]
        x0n = torch.where(am, x0n, x0)
        x1n = torch.where(am, x1n, x1)
        x2n = torch.where(am, x2n, x2)
        h10n = torch.where(am, h10n, h10)
        h20n = torch.where(am, h20n, h20)
        x0p = torch.where(am, x0p, x0)

        # pair residuals of the chunk's final iteration (engine semantics;
        # pairs (1,0) and (2,0))
        norm = lambda a: torch.linalg.vector_norm(a, dim=1)
        Px0 = x0n @ self.P.T
        Px0p = x0p @ self.P.T
        pn1 = norm(x0n - x1n)
        dn1 = mu1 * norm(x0n - x0p)
        pn2 = norm(Px0 - x2n)
        dn2 = mu2 * norm(Px0 - Px0p)
        rp1 = pn1 / torch.maximum(norm(x0n), norm(x1n))
        rd1 = dn1 / torch.maximum(mu1 * norm(x0n), mu1 * norm(x0p))
        rp2 = pn2 / torch.maximum(norm(Px0), norm(x2n))
        rd2 = dn2 / torch.maximum(mu2 * norm(Px0), mu2 * norm(Px0p))
        conv = (rp1 < rtol) & (rd1 < rtol) & (rp2 < rtol) & (rd2 < rtol)
        pn, dn = pn1 + pn2, dn1 + dn2
        conv = conv | ((pn < atol) & (dn < atol))
        done_new = done | (active & conv)

        def balance(m, p, d):
            m2 = torch.where(p > th_change * d, m * fact_incr, m)
            m2 = torch.where(d > th_change * p, m2 / fact_incr, m2)
            return torch.minimum(m2, max_mu)

        if do_mu:
            upd = active & ~done_new
            mu = torch.stack([torch.where(upd, balance(mu1, pn1, dn1), mu1),
                              torch.where(upd, balance(mu2, pn2, dn2), mu2)],
                             dim=1)

        count = count + active.to(count.dtype) * n_iters
        return (x0n, x1n, x2n, h10n, h20n, mu, done_new, count), (pn, dn)

    @telemetry.spanned("admm.inputs")
    def _kernel_inputs(self, overrides: Dict, B: int, mu0, done0):
        """The kernel phase's initial state (five blocks, mu, done, count),
        its inputs (the lanes' data, whose A†y the program's first chunk
        makes, or A†y of the template; both alphas) and whether the lanes
        have data."""
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)

        def batch_of(key, default):
            if key in overrides:
                return torch.as_tensor(overrides[key], **f32)
            return torch.full((B,), float(default), **f32)

        ys = overrides.get((0, "y"))
        has_y = ys is not None
        first = torch.as_tensor(ys, **f32) if has_y else self.Acy.expand(B, self.nl)
        alpha_ls = batch_of((0, "alpha"), self.f0._alpha)
        alpha1 = batch_of((1, "alpha"), self.f1._alpha)
        if done0 is None:
            d0 = torch.zeros(B, dtype=torch.bool, device=dev)
        else:
            d0 = torch.as_tensor(done0, dtype=torch.bool, device=dev)
            if tuple(d0.shape) != (B,):
                raise ValueError(f"done0 has shape {tuple(d0.shape)}, expected ({B},)")
        zeros = lambda n: torch.zeros((B, n), **f32)
        state = (zeros(self.nl), zeros(self.nl), zeros(self.nw), zeros(self.nl),
                 zeros(self.nw), torch.full((B, 2), float(mu0), **f32), d0,
                 torch.zeros(B, dtype=torch.int32, device=dev))
        return state, (first, alpha_ls, alpha1), has_y

    @telemetry.spanned(telemetry.SOLVE)
    def solve(self,
              overrides: Optional[Dict] = None,
              batch_size: Optional[int] = None,
              niter: int = 10000,
              mu0: float = 1.0,
              interval_update_mu: int = 100,
              rtol: float = 1e-12,
              atol: float = 0.0,
              fact_incr: float = 2.0,
              th_change: float = 10.0,
              max_mu: float = 1e3,
              done0=None) -> FusedSpMResult:
        """Solve a batch; overrides ``{(0,'y'): (B, M), (0,'alpha'): (B,),
        (1,'alpha'): (B,)}`` subsets (numpy arrays or tensors).  ``done0``:
        (B,) bool mask of lanes that start converged and never iterate."""
        overrides = dict(overrides or {})
        B = _check_fused_overrides(overrides, "FusedSpMSolver")
        if B is None:
            B = batch_size
        if B is None:
            raise ValueError("pass overrides or batch_size")
        state, inputs, has_y = self._kernel_inputs(overrides, B, mu0, done0)
        interval, niter = int(interval_update_mu), int(niter)
        can_finish = rtol > 0 or atol > 0
        program = _run(self, (interval, B, has_y, str(self.device), can_finish), state, inputs,
                       (rtol, atol, fact_incr, th_change, max_mu), niter, interval, can_finish,
                       done0 is not None, prologue=self._acy_of if has_y else None)
        # copies: the next solve overwrites the buffers
        with telemetry.span("admm.result"):
            x0, x1, x2, h10, h20, mu, done, count = (t.clone() for t in program.state)
            primal, dual = program.histories(B)
        return FusedSpMResult(
            x=(x0, x1, x2), h=(h10, h20), mu=mu,
            iterations=torch.clamp_max(count, niter), converged=done,
            primal_residual=primal, dual_residual=dual)

    @telemetry.spanned(telemetry.SOLVE)
    def solve_mixed(self,
                    overrides: Optional[Dict] = None,
                    niter_low: int = 2000,
                    niter: int = 2000,
                    mu0=1.0,
                    low_atol: float = 1e-5,
                    fused: bool = True,
                    **kw) -> BatchResult:
        """Fused-f32 phase, then f64 engine polish from the warm state.

        The kernel burns down the bulk of the iterations in float32 (up to
        ``niter_low``, stopping early where the summed residuals fall below
        ``low_atol``); the handed-off primal/dual/penalty state carries the
        progress exactly, and a float64 :class:`BatchedSolver` kept on this
        solver finishes to reference precision with up to ``niter`` more.
        Returns the polish phase's :class:`BatchResult` with
        ``iterations = min(kernel count, niter_low) + polish count``.
        Lanes the caller marked ``done0`` skip both phases; lanes the
        kernel phase finished are polished all the same.

        ``fused=True`` (default) runs both phases as one program, the JAX
        package's composite (:class:`_MixedProgram`): the kernel phase's run
        program, then the polish's, whose entry is the hand-off on the card
        (float32 to float64, the caller's ``done0``); ``kw`` (``rtol``,
        ``atol``, ``record_residuals``, ``chunked_checks``, ``update_h``,
        the penalty knobs ``interval_update_mu``, ``fact_incr``,
        ``th_change``, ``max_mu`` and ``done0``) goes to the polish, the
        penalty knobs and ``done0`` to the kernel phase too.  ``fused=False``
        and a ``kw`` outside that set take two solves, as the JAX package's
        two-dispatch form does: the kernel phase with ``niter_low``,
        ``mu0``, ``low_atol`` and ``done0`` alone, the polish with ``kw``.
        """
        overrides = dict(overrides or {})
        # An engine-legal override that the kernel phase cannot take, like
        # (0, 'A'), would warm-start the polish from the TEMPLATE problem's
        # trajectory: reject it, as solve() does.
        if _check_fused_overrides(overrides, "FusedSpMSolver.solve_mixed") is None:
            raise ValueError("pass overrides with a leading batch axis")
        bs = getattr(self, "_polish_solver", None)
        if bs is None:
            bs = self._polish_solver = BatchedSolver(
                self.model, dtype=torch.float64, device=self.device)
        if fused and not set(kw) - _MIXED_FUSED_KW:
            return self._solve_mixed_fused(bs, overrides, niter_low, niter, mu0, low_atol, **kw)
        p1 = self.solve(overrides, niter=niter_low, mu0=mu0, rtol=0.0, atol=low_atol,
                        done0=kw.get("done0"))
        f64 = lambda t: tuple(a.double() for a in t)
        p2 = bs.solve(overrides, x0=f64(p1.x), h0=f64(p1.h), mu0=p1.mu.double(),
                      niter=niter, **kw)
        return BatchResult(
            x=p2.x, h=p2.h, mu=p2.mu,
            iterations=p1.iterations + p2.iterations,
            converged=p2.converged,
            primal_residual=p2.primal_residual,
            dual_residual=p2.dual_residual)

    def _solve_mixed_fused(self, bs: BatchedSolver, overrides: Dict, niter_low: int,
                           niter: int, mu0, low_atol: float,
                           interval_update_mu: int = 100,
                           update_h: bool = True,
                           rtol: float = 1e-12,
                           atol: float = 0.0,
                           fact_incr: float = 2.0,
                           th_change: float = 10.0,
                           max_mu: float = 1e3,
                           record_residuals=True,
                           chunked_checks: bool = False,
                           done0=None) -> BatchResult:
        """Both phases through their mixed program (JAX
        ``_solve_mixed_fused``, ``fused_spm.py:498-618``), made on a miss,
        keyed as the JAX package's ``ckey`` (``:581-582``) with the device,
        whether a lane of each phase can finish and whether the caller marks
        lanes done (and the route switches: :class:`~admmsolver_tpu_torch.
        parallel.batch._ProgramCache`).  Both phases capture into this
        solver's graph pool."""
        B = _check_fused_overrides(overrides, "FusedSpMSolver.solve_mixed")
        state, inputs, has_y = self._kernel_inputs(overrides, B, mu0, done0)
        interval, niter_low = int(interval_update_mu), int(niter_low)
        if niter_low < 1 or interval < 1:
            raise ValueError(f"niter_low and interval_update_mu must be >= 1, got {niter_low}, "
                             f"{interval}")
        cfg = bs._config(niter, interval, update_h, max_mu, fact_incr, th_change, 1.0)
        record, stride = batch._parse_record_residuals(record_residuals)
        stacks = {k: batch._cast_like(torch.float64, v, self.device)[None]
                  for k, v in sorted(overrides.items())}
        tols = (rtol, atol)
        finish = (low_atol > 0, rtol > 0 or atol > 0)
        key = ("mixed", niter_low, cfg,
               tuple((k, tuple(v.shape), v.dtype) for k, v in stacks.items()), record, stride,
               bool(chunked_checks), B, has_y, str(self.device), finish, done0 is not None)
        program = self._programs.program(key, lambda: _MixedProgram(
            self, bs, state, inputs, niter_low, interval, finish[0], has_y, stacks,
            done0 is not None, cfg, tols, record, stride, bool(chunked_checks)))
        program.load(state, inputs, (0.0, low_atol, fact_incr, th_change, max_mu), stacks,
                     tols)
        captures = (self._programs.captures(),
                    bs._programs.captures(bs.model.functions, torch.float64))
        program.run(captures, self._programs.graph_pool(captures[0]))
        return program.result(niter_low)


class _MixedProgram(batch._Composite):
    """``FusedSpMSolver.solve_mixed(fused=True)`` as one program: the JAX
    package's composite (``fused_spm.py:591-610``).  The kernel phase's run
    program (:class:`~admmsolver_tpu_torch.parallel.fused._FusedProgram`),
    then the polish solver's fed program (:class:`~admmsolver_tpu_torch.
    parallel.batch._FedProgram`), whose entry is the hand-off on the card:
    the five state blocks and mu of the kernel phase's buffers in float64,
    and the caller's ``done0`` (not the kernel phase's flags).  The count
    ``min(kernel count, niter_low)`` is added on the card (:meth:`result`);
    the failure flags of both phases are read once, after the polish."""

    def __init__(self, solver: FusedSpMSolver, bs: BatchedSolver, state, inputs, niter_low: int,
                 interval: int, can_finish: bool, has_y: bool, stacks: Dict, marks_done: bool,
                 cfg, tols, record: bool, stride: int, chunked_checks: bool) -> None:
        self.nchunks = len(_FusedProgram.schedule(niter_low, interval))
        self.kernel = _FusedProgram(solver._step, state, inputs, self.nchunks,
                                    solver._acy_of if has_y else None)
        # the caller's done0, which the kernel phase's flags overwrite
        done0 = batch._fresh(state[6]) if marks_done else None
        seed = tuple(self.kernel.state[:6])
        feed = batch._Feed({k: v.clone() for k, v in stacks.items()}, seed, done=done0)
        self.polish = batch._phase_program(bs, cfg, feed, torch.float64, tols, record, stride,
                                           chunked_checks)
        # the kernel phase's schedule; its failure flag is read after the polish
        keys = self.kernel.keys(niter_low, interval)
        schedule = lambda capture, pool: self.kernel.run_schedule(keys, capture, pool, can_finish)
        super().__init__([("kernel phase", self.kernel, schedule),
                          ("polish", self.polish, None)], solver.device)

    def load(self, state, inputs, knobs, stacks: Dict, tols) -> None:
        self.kernel.load(state, inputs, knobs, self.nchunks)
        if self.polish.feed.done is not None:
            self.polish.feed.done.copy_(state[6])
        self.polish.load(tols, stacks)

    @telemetry.spanned("admm.result")
    def result(self, niter_low: int) -> BatchResult:
        p = self.polish
        return BatchResult(x=tuple(map(torch.clone, p.x)), h=tuple(map(torch.clone, p.h)),
                           mu=p.mu.clone(),
                           iterations=p.count + torch.clamp_max(self.kernel.state[-1], niter_low),
                           converged=p.done.clone(),
                           primal_residual=p.pbuf[:, :p.hist].clone(),
                           dual_residual=p.dbuf[:, :p.hist].clone())
