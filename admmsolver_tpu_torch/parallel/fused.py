"""Fused fast path for 2-block identity-coupled problems.

Counterpart of :mod:`admmsolver_tpu.parallel.fused`.  Drives
:func:`admmsolver_tpu_torch.ops.kernels.fused_two_block_chunk`, which runs
``interval_update_mu``-iteration chunks with the state kept on chip;
between chunks a torch step computes residuals, the convergence predicate
and the adaptive penalty update (the engine's residual-balancing rule,
reference ``optimizer.py:277-299``), then refreshes the spectral
denominators.  The chunk schedule is a Python loop; after each chunk the
host checks whether every lane is done.

Scope: ``Model([LeastSquares-like spectral block, L1 or NonNegative],
[(1, 0, I, I)])`` in float32.  Convergence is checked once per chunk (not
per iteration as the reference does): lanes may run up to one chunk longer
than strictly needed; solutions are unaffected.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..models.objectivefunc import (L1Regularizer, NonNegativePenalty,
                                    _ShiftedQuadratic)
from ..models.problem import Model
from ..ops import kernels
from ..ops.linop import ScaledIdentityMatrix

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


class FusedTwoBlockSolver:
    """Fused chunk solver for the flagship 2-block family, in float32.

    ``device`` is where the solve runs: on ``cuda`` every chunk is one
    launch of the Hopper kernel, on ``cpu`` the kernel's plain version.
    ``tile_b`` pads the batch to a multiple (padding lanes start done), as
    the JAX solver does.
    """

    def __init__(self, model: Model, tile_b: int = 128, device="cpu") -> None:
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
        if type(f1).__name__ == "RealPartProx":
            raise ValueError(
                "realified models (RealPartProx, the `_even` kernel modes) need "
                "models.realify, which admmsolver_tpu_torch does not have yet")
        if isinstance(f1, L1Regularizer):
            if f1._offset is not None:
                raise ValueError(
                    "fused path does not support L1Regularizer offsets "
                    "(the kernel applies the plain soft-threshold)")
            self.prox = "l1"
        elif isinstance(f1, NonNegativePenalty):
            self.prox = "nonneg"
        else:
            raise ValueError(
                "block 1 must be L1 or NonNegative, "
                f"got {type(f1).__name__}")
        self._f1 = f1
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

    def _step(self, state, acy, alpha_ls, alpha1, tols, knobs,
              n_iters: int, do_mu: bool):
        """One chunk: ``n_iters`` kernel iterations, then residuals,
        convergence and (if ``do_mu``) the penalty update."""
        x0, x1, h, mu, done, count = state
        rtol, atol = tols
        fact_incr, th_change, max_mu = knobs
        dinv = 1.0 / (alpha_ls[:, None] * self.lam[None, :] + mu)
        if self.thin:
            dinv = dinv - 1.0 / mu
        if self.prox == "l1":
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
        mu_new = torch.clamp_max(mu_new, max_mu)
        if do_mu:
            upd = active & ~done_new
            mu = torch.where(upd, mu_new, mu1)[:, None]

        count = count + active.to(count.dtype) * n_iters
        return (x0n, x1n, hn, mu, done_new, count), (pn, dn)

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
        dev = self.device
        f32 = dict(dtype=torch.float32, device=dev)
        Bp = ((B + self.tile_b - 1) // self.tile_b) * self.tile_b

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
            Ac = torch.as_tensor(f0._Ac.asmatrix(), **f32)
            acy = pad_first(torch.as_tensor(ys, **f32) @ Ac.T)
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

        # reference schedule: penalty update after iterations 0, interval,
        # 2*interval, ... (optimizer.py:319-320); chunk boundaries align
        # with it, the remainder chunk skips the update.
        interval = int(interval_update_mu)
        niter = int(niter)
        nfull = (niter - 1) // interval
        nrem = (niter - 1) % interval
        nchunks = 1 + nfull + (1 if nrem else 0)
        tols = (rtol, atol)
        knobs = (fact_incr, th_change, max_mu)
        state = (x0a, x1a, ha, mu, d0, torch.zeros(Bp, dtype=torch.int32, device=dev))
        pbuf = torch.full((nchunks, Bp), float("nan"), **f32)
        dbuf = torch.full((nchunks, Bp), float("nan"), **f32)

        schedule = [(0, 1, True)]
        schedule += [(1 + k, interval, True) for k in range(nfull)]
        if nrem:
            schedule.append((nchunks - 1, nrem, False))
        for k, (row, n_iters, do_mu) in enumerate(schedule):
            if k > 0 and bool(state[4].all()):
                break
            state, (pn, dn) = self._step(state, acy, alpha_ls, alpha1, tols,
                                         knobs, n_iters, do_mu)
            pbuf[row] = pn
            dbuf[row] = dn

        x0f, x1f, hf, muf, done, count = state
        return FusedResult(
            x0=x0f[:B], x1=x1f[:B], h=hf[:B], mu=muf[:B, 0],
            iterations=torch.clamp_max(count, niter)[:B],
            converged=done[:B],
            primal_residual=pbuf.T[:B],
            dual_residual=dbuf.T[:B])
