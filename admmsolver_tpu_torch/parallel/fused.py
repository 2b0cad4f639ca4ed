"""Fused fast path for 2-block identity-coupled problems.

Counterpart of :mod:`admmsolver_tpu.parallel.fused`.  Drives
:func:`admmsolver_tpu_torch.ops.kernels.fused_two_block_chunk`, which runs
``interval_update_mu``-iteration chunks with the state kept on chip.  A
chunk is the spectral denominators and threshold, one kernel launch, then
the residuals, the convergence predicate and the adaptive penalty update
(the engine's residual-balancing rule, reference ``optimizer.py:277-299``).

The solve runs through a static run program (:class:`_FusedProgram`, the
JAX package's one compiled ``_compiled_run``): fixed buffers for the state,
the solve's inputs, its tolerances and knobs, and the residual histories;
on a CUDA device each kind of chunk (iteration 0, a full chunk, the
remainder) is captured once into a CUDA graph and replayed once a chunk
(:class:`~admmsolver_tpu_torch.parallel.batch._GraphProgram`).  The host
reads the done flags between chunks only where a lane can finish
(``rtol > 0`` or ``atol > 0``), the counterpart of the JAX
``while_loop``'s exit; it runs every chunk, reading nothing, otherwise.

Scope: ``Model([LeastSquares-like spectral block, L1 or NonNegative],
[(1, 0, I, I)])`` in float32, and its real embedding from
:func:`admmsolver_tpu_torch.models.realify.realify_model` (block 1 a
``RealPartProx``: the kernel's ``_even`` prox modes).  Convergence is
checked once per chunk (not per iteration as the reference does): lanes may
run up to one chunk longer than strictly needed; solutions are unaffected.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from ..models.objectivefunc import (L1Regularizer, NonNegativePenalty, _ShiftedQuadratic,
                                    raise_if_not_pd)
from ..models.problem import Model
from ..models.realify import RealPartProx
from ..ops import kernels
from ..ops.linop import ScaledIdentityMatrix
from ..utils import telemetry
from . import batch

__all__ = ["FusedTwoBlockSolver", "FusedResult"]


@dataclasses.dataclass
class FusedResult:
    x0: torch.Tensor
    x1: torch.Tensor
    h: torch.Tensor
    mu: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    primal_residual: torch.Tensor  # (B, nchunks) per-chunk samples
    dual_residual: torch.Tensor


def _is_identity_si(E) -> bool:
    return (isinstance(E, ScaledIdentityMatrix) and E.is_square()
            and np.allclose(np.asarray(torch.as_tensor(E.coeff).cpu()), 1.0))


# The per-instance fields the fused kernel plumbs.  Anything else would
# silently solve the TEMPLATE problem and return wrong results flagged
# converged — reject it up front.
_FUSED_OV_KEYS = frozenset({(0, "y"), (0, "alpha"), (1, "alpha")})


def _check_fused_overrides(overrides, path: str) -> Optional[int]:
    """Validate fused-path override keys and return the batch size, or
    None for empty overrides (caller falls back to ``batch_size``)."""
    bad = sorted(set(overrides) - _FUSED_OV_KEYS, key=repr)
    if bad:
        raise ValueError(
            f"{path} supports per-instance overrides "
            f"{sorted(_FUSED_OV_KEYS)} only, got {bad}")
    B = None
    for key, v in overrides.items():
        if np.ndim(v) < 1:
            raise ValueError(
                f"override {key} must have a leading batch axis, got a "
                "scalar; wrap per-instance scalars as a (B,) array")
        b = np.shape(v)[0]
        if B is None:
            B = b
        elif B != b:
            raise ValueError(
                f"inconsistent batch sizes: {B} vs {b} for override {key}")
    return B


class _FusedProgram(batch._GraphProgram):
    """The static run program of a fused solver for one cache key: the
    counterpart of an entry of the JAX package's ``_run_cache``
    (``fused.py:234-302``, ``fused_spm.py:235-384``) without ``niter``.

    It owns the buffers its chunks read and write: the solver's state (the
    blocks, then mu, done and count), the solve's inputs (``inputs[0]`` the
    lanes' A†y, or their data where ``prologue`` makes A†y from it in the
    first chunk), the tolerances and penalty knobs (rtol, atol, fact_incr,
    th_change, max_mu) as device scalars, the history row and the
    ``(nchunks, B)`` residual histories, all loaded per solve
    (:meth:`load`).  A chunk (``key`` = (iterations, penalty update,
    prologue)) runs the solver's ``step`` on them, its factorizations'
    failure gathered in :attr:`failed`, and copies the new state into the
    buffers and the residuals into the history row, which it advances; rows
    no chunk wrote stay NaN.  So three graphs serve every solve: iteration
    0, a full chunk and the remainder.
    """

    def __init__(self, step, state, inputs, nchunks: int, prologue=None) -> None:
        # the solver's methods, held weakly: the solver holds the program
        self._step = weakref.WeakMethod(step)
        self._prologue = None if prologue is None else weakref.WeakMethod(prologue)
        self.state = [batch._fresh(t) for t in state]
        self.inputs = [batch._fresh(t) for t in inputs]
        dev = self.state[0].device
        # the lanes' A†y: made from the data in the first chunk, or an input
        self.acy = prologue(self.inputs[0]) if prologue is not None else self.inputs[0]
        self.knobs = torch.zeros(5, dtype=torch.float32, device=dev)
        self.row = torch.zeros(1, dtype=torch.long, device=dev)
        super().__init__(self.state[-2], type(step.__self__).__name__, self.state[:-3],
                         (nchunks, self.state[0].shape[0]), torch.float32)

    def keys(self, niter: int, interval: int):
        """The chunk keys of a solve (:meth:`~admmsolver_tpu_torch.parallel.
        batch._GraphProgram.schedule`), the first with the prologue where
        the program has one."""
        return [(n, do_mu, not k and self._prologue is not None)
                for k, (n, do_mu) in enumerate(self.schedule(niter, interval))]

    @telemetry.spanned("admm.load")
    def load(self, state, inputs, knobs, nchunks: int) -> None:
        """A solve's initial state, inputs and knobs into the buffers, and
        its number of chunks."""
        self.nchunks = nchunks
        for d, t in zip(self.state + self.inputs, tuple(state) + tuple(inputs)):
            d.copy_(t)
        for d, v in zip(self.knobs.unbind(), knobs):
            d.fill_(float(v))
        self.row.zero_()
        self.failed.zero_()
        self.clear_histories()

    def _chunk(self, key) -> None:
        n_iters, do_mu, prologue = key
        if prologue:
            self.acy.copy_(self._prologue()(self.inputs[0]))
        with self.factorizing():
            state, (pn, dn) = self._step()(self.state, self.acy, *self.inputs[1:],
                                           self.knobs.unbind(), n_iters, do_mu)
        for d, t in zip(self.state, state):
            d.copy_(t)
        self.pbuf.index_copy_(0, self.row, pn[None])
        self.dbuf.index_copy_(0, self.row, dn[None])
        self.row.add_(1)

    def buffers(self):
        """Every tensor the program holds between solves."""
        return tuple(self.state + self.inputs) + (self.acy, self.pbuf, self.dbuf)

    def histories(self, B: int):
        """The solve's (B, nchunks) primal and dual residual histories,
        copied out of the buffers that the next solve overwrites."""
        return tuple(t[:self.nchunks, :B].T.clone() for t in (self.pbuf, self.dbuf))


def _run(solver, key: tuple, state, inputs, knobs, niter: int, interval: int,
         can_finish: bool, read_done0: bool, prologue=None) -> _FusedProgram:
    """A solve of a fused ``solver`` through its program of ``key`` (made on
    a miss, :class:`~admmsolver_tpu_torch.parallel.batch._ProgramCache`),
    its chunks replays of captured graphs on a CUDA device with
    :data:`~admmsolver_tpu_torch.parallel.batch.CAPTURE_CHUNKS`.  The host
    reads the done flags, with the failure flag of the factorizations,
    after a chunk that is not the last where a lane can finish, and
    (``read_done0``) once before the first chunk for a caller's ``done0``
    where no such read follows.  Returns the program, its buffers holding
    the result."""
    nchunks = len(_FusedProgram.schedule(niter, interval))
    programs = solver._programs
    capture = programs.captures()
    pool = programs.graph_pool(capture)
    program = programs.program(key, lambda: _FusedProgram(solver._step, state, inputs, nchunks,
                                                          prologue))
    program.reserve(nchunks)
    program.load(state, inputs, knobs, nchunks)
    all_done = read_done0 and not can_finish and nchunks > 1 and batch._flags_read(program.done)
    if program.run_schedule(program.keys(niter, interval), capture, pool, can_finish,
                            all_done=all_done):
        raise_if_not_pd(program.failed)
    return program


class FusedTwoBlockSolver:
    """Fused chunk solver for the flagship 2-block family, in float32.

    ``device`` is where the solve runs: on ``cuda`` (the default; without a
    CUDA device the constructor raises) every chunk is one launch of the
    Hopper kernel, on ``cpu`` the kernel's plain version.
    ``tile_b`` pads the batch to a multiple (padding lanes start done), as
    the JAX solver does.
    """

    @telemetry.spanned("admm.init")
    def __init__(self, model: Model, tile_b: int = 128, device="cuda") -> None:
        if model.num_func != 2:
            raise ValueError("fused path covers 2-block models")
        if model.pairs != [(1, 0)]:
            raise ValueError("blocks must be coupled")
        E10, E01 = model.E[(1, 0)], model.E[(0, 1)]
        if not (_is_identity_si(E10) and _is_identity_si(E01)):
            raise ValueError("fused path requires identity couplings")
        f0, f1 = model.functions
        if not (isinstance(f0, _ShiftedQuadratic) and f0._spectral_ok()):
            raise ValueError(
                "block 0 must be a dense-Gram quadratic (LeastSquares)")
        if f0._kron_rest() != 1:
            raise ValueError(
                "block 0 has a Kronecker Gram (G ⊗ I); the kernel's eigenbasis spans "
                "the whole block: use BatchedSolver")
        # Realified complex models (models.realify) wrap the separable block
        # in RealPartProx: the same elementwise prox on the Re lanes, zeros on
        # the Im lanes (the `_even` kernel modes).
        f1_inner, suffix = f1, ""
        if isinstance(f1, RealPartProx):
            f1_inner, suffix = f1._inner, "_even"
        if isinstance(f1_inner, L1Regularizer):
            if f1_inner._offset is not None:
                raise ValueError(
                    "fused path does not support L1Regularizer offsets "
                    "(the kernel applies the plain soft-threshold)")
            self.prox = "l1" + suffix
        elif isinstance(f1_inner, NonNegativePenalty):
            self.prox = "nonneg" + suffix
        else:
            raise ValueError(
                "block 1 must be L1 or NonNegative (optionally realified), "
                f"got {type(f1_inner).__name__}")
        self._f1 = f1_inner
        self.model = model
        self.f0 = f0
        self.tile_b = int(tile_b)
        self.device = torch.device(device)

        thin = f0._get_eig_thin()
        lam, U = thin if thin is not False else f0._get_eig()
        if np.iscomplexobj(U):
            if np.abs(U.imag).max() > 0:
                raise ValueError("fused path is real-f32 only")
            U = U.real
        self.thin = thin is not False
        self.N = U.shape[0]
        f32 = dict(dtype=torch.float32, device=self.device)
        self.lam = torch.as_tensor(np.asarray(lam), **f32)
        self.U = torch.as_tensor(U, **f32).contiguous()
        self.Ut = self.U.T.contiguous()
        # A† on the device once: a copy from the host would wait for the card
        self.Ac = torch.as_tensor(f0._Ac.asmatrix(), **f32)
        #: the run programs by key (:func:`_run`), and the memory of their graphs
        self._programs = batch._ProgramCache(self.device)

    def _step(self, state, acy, alpha_ls, alpha1, knobs, n_iters: int, do_mu: bool):
        """One chunk: ``n_iters`` kernel iterations, then residuals,
        convergence and (if ``do_mu``) the penalty update.  ``knobs``:
        rtol, atol, fact_incr, th_change, max_mu."""
        x0, x1, h, mu, done, count = state
        rtol, atol, fact_incr, th_change, max_mu = knobs
        dinv = 1.0 / (alpha_ls[:, None] * self.lam[None, :] + mu)
        if self.thin:
            dinv = dinv - 1.0 / mu
        if self.prox.startswith("l1"):
            thr = 0.5 * alpha1[:, None] / mu
        else:
            thr = torch.zeros_like(mu)
        x0n, x1n, hn, x0p = kernels.fused_two_block_chunk(
            self.U, self.Ut, dinv, acy, mu, thr, x0, x1, h,
            n_iters=n_iters, prox=self.prox, thin=self.thin)
        active = ~done
        am = active[:, None]
        x0n = torch.where(am, x0n, x0)
        x1n = torch.where(am, x1n, x1)
        hn = torch.where(am, hn, h)

        # residuals of the chunk's final iteration (engine semantics:
        # pair (1,0), E both identity)
        norm = lambda a: torch.linalg.vector_norm(a, dim=1)
        mu1 = mu[:, 0]
        pn = norm(x0n - x1n)
        dn = mu1 * norm(x0n - x0p)
        n0 = norm(x0n)
        n1 = norm(x1n)
        d1 = mu1 * n0
        d2 = mu1 * norm(x0p)
        conv = ((pn / torch.maximum(n0, n1) < rtol)
                & (dn / torch.maximum(d1, d2) < rtol))
        conv = conv | ((pn < atol) & (dn < atol))
        done_new = done | (active & conv)

        # residual-balancing penalty update (chunk-granular)
        mu_new = torch.where(pn > th_change * dn, mu1 * fact_incr, mu1)
        mu_new = torch.where(dn > th_change * pn, mu_new / fact_incr, mu_new)
        mu_new = torch.minimum(mu_new, max_mu)
        if do_mu:
            upd = active & ~done_new
            mu = torch.where(upd, mu_new, mu1)[:, None]

        count = count + active.to(count.dtype) * n_iters
        return (x0n, x1n, hn, mu, done_new, count), (pn, dn)

    @telemetry.spanned(telemetry.SOLVE)
    def solve(self,
              overrides: Optional[Dict] = None,
              batch_size: Optional[int] = None,
              niter: int = 10000,
              mu0=1.0,
              interval_update_mu: int = 100,
              rtol: float = 1e-12,
              atol: float = 0.0,
              fact_incr: float = 2.0,
              th_change: float = 10.0,
              max_mu: float = 1e3,
              x0=None, x1=None, h0=None, done0=None) -> FusedResult:
        """Solve a batch.  ``overrides``: ``{(0,'y'): (B,M), (0,'alpha'):
        (B,), (1,'alpha'): (B,)}`` subsets (numpy arrays or tensors).
        ``x0``/``x1``/``h0``/``mu0`` warm-start the state
        (:func:`admmsolver_tpu_torch.interop.state_from_numpy` builds them
        from a JAX result); ``done0``: (B,) mask of lanes that start
        converged and never iterate."""
        overrides = dict(overrides or {})
        B = _check_fused_overrides(overrides, "FusedTwoBlockSolver")
        if B is None:
            B = batch_size
        if B is None:
            raise ValueError("pass overrides or batch_size")
        Bp = ((B + self.tile_b - 1) // self.tile_b) * self.tile_b
        state, inputs = self._kernel_inputs(overrides, B, Bp, mu0, x0, x1, h0, done0)
        interval, niter = int(interval_update_mu), int(niter)
        can_finish = rtol > 0 or atol > 0
        program = _run(self, (interval, Bp, str(self.device), can_finish), state, inputs,
                       (rtol, atol, fact_incr, th_change, max_mu), niter, interval, can_finish,
                       done0 is not None)
        x0f, x1f, hf, muf, done, count = program.state
        # copies: the next solve overwrites the buffers
        with telemetry.span("admm.result"):
            primal, dual = program.histories(B)
            return FusedResult(
                x0=x0f[:B].clone(), x1=x1f[:B].clone(), h=hf[:B].clone(),
                mu=muf[:B, 0].clone(), iterations=torch.clamp_max(count[:B], niter),
                converged=done[:B].clone(), primal_residual=primal, dual_residual=dual)

    @telemetry.spanned("admm.inputs")
    def _kernel_inputs(self, overrides: Dict, B: int, Bp: int, mu0, x0, x1, h0, done0):
        """The initial state (x0, x1, h, mu, done, count) and the inputs (the
        lanes' A†y scaled by their weight, both weights) of a batch of B
        lanes padded to Bp: padding lanes copy lane 0's data and start
        done."""
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)

        def pad_first(a):
            # padding lanes copy lane 0's data; they start done
            if Bp == B:
                return a
            return torch.cat([a, a[:1].expand((Bp - B,) + tuple(a.shape[1:]))])

        def batch_of(key, default):
            if key in overrides:
                a = torch.as_tensor(overrides[key], **f32)
            else:
                a = torch.full((B,), float(default), **f32)
            return pad_first(a)

        f0 = self.f0
        ys = overrides.get((0, "y"))
        if ys is not None:
            acy = pad_first(torch.as_tensor(ys, **f32) @ self.Ac.T)
        else:
            acy = torch.as_tensor(f0._Acy, **f32).expand(Bp, self.N)
        alpha_ls = batch_of((0, "alpha"), f0._alpha)
        acy = (acy * alpha_ls[:, None]).contiguous()
        alpha1 = batch_of((1, "alpha"), getattr(self._f1, "_alpha", 0.0) or 0.0)

        def state_of(a):
            if a is None:
                return torch.zeros((Bp, self.N), **f32)
            a = torch.as_tensor(a, **f32)
            if a.shape[0] == Bp:
                return a.contiguous()
            return torch.cat([a, a.new_zeros((Bp - B, self.N))])

        x0a, x1a, ha = state_of(x0), state_of(x1), state_of(h0)
        if np.ndim(mu0) == 1:
            mu = pad_first(torch.as_tensor(mu0, **f32))[:, None]
        else:
            mu = torch.full((Bp, 1), float(mu0), **f32)
        if done0 is None:
            d0 = torch.zeros(B, dtype=torch.bool, device=dev)
        else:
            d0 = torch.as_tensor(done0, dtype=torch.bool, device=dev)
            if tuple(d0.shape) != (B,):
                raise ValueError(f"done0 has shape {tuple(d0.shape)}, expected ({B},)")
        # padding lanes start done: they never iterate
        d0 = torch.cat([d0, torch.ones(Bp - B, dtype=torch.bool, device=dev)])
        state = (x0a, x1a, ha, mu, d0, torch.zeros(Bp, dtype=torch.int32, device=dev))
        return state, (acy, alpha_ls, alpha1)
