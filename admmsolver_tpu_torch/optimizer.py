"""The ADMM engine: Gauss–Seidel multi-block ADMM in eager PyTorch.

Counterpart of :mod:`admmsolver_tpu.optimizer` (reference
``optimizer.py:121-341``).  :class:`ADMMPlan` resolves the constraint
graph, operator structures and block order once; :class:`SimpleOptimizer`
runs the solve as a Python loop over iterations.  Factorizations are
recomputed only when the penalty ``mu`` changes, which replaces the
reference's hash-keyed cache (``objectivefunc.py:89-96``).  The per-pair
coupling products ``E x`` are computed once per iteration and shared by the
dual update, the residual norms, the convergence test and the penalty
update.

Semantics preserved exactly: Gauss–Seidel sweep order and sign
conventions (``optimizer.py:183-207``), dual ascent (``optimizer.py:
334-341``), absolute summed residuals (``optimizer.py:251-274``), the
per-pair relative convergence test including its 0/0 → NaN → "not
converged" behavior (``optimizer.py:232-249``), and residual-balancing mu
adaptation with clamping (``optimizer.py:277-299``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .backend import default_dtype
from .config import ADMMConfig
from .models.problem import Model
from .ops.linop import (MatrixBase, ScaledIdentityMatrix, _asarray,
                        _match_precision, add)

__all__ = ["ADMMPlan", "SimpleOptimizer"]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _has_complex(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_complex()
    if isinstance(v, MatrixBase):
        return any(_has_complex(a) for a in vars(v).values())
    return isinstance(v, (complex, np.complexfloating))


class ADMMPlan:
    """Static specialization of a :class:`Model` for the ADMM loop.

    Holds the ordered pair list, per-block Gauss–Seidel coupling terms,
    per-block penalty composition and the per-pair residual operators.
    ``model`` should already live on ``device``; the effective penalty
    diagonals of scalar couplings are made there once.
    """

    def __init__(self, model: Model, device="cpu") -> None:
        self.model = model
        self.nblocks = model.num_func
        self.pairs: List[Tuple[int, int]] = model.pairs
        self.pair_index: Dict[Tuple[int, int], int] = {
            p: idx for idx, p in enumerate(self.pairs)}
        self.npairs = len(self.pairs)
        self.pair_sizes = [model.E[(i, j)].shape[0] for (i, j) in self.pairs]
        self.block_sizes = [f.size_x for f in model.functions]

        # Per-block k: terms of h_k (optimizer.py:175-207).  Each term is
        # (pair_idx, sign, E[i,k]^H, EcE[(k,i)], partner i, E[(k,i)],
        # E[(i,k)]); sign +1 for i < k, -1 for i > k.  The last two
        # operators feed the over-relaxation path only.
        self.hk_terms: List[List[Tuple]] = []
        # Per-block k: penalty terms (pair_idx, EcE2[(i,k)])
        # (optimizer.py:209-230).
        self.mu_terms: List[List[Tuple[int, MatrixBase]]] = []
        # For diagonal-penalty blocks: (pair_idx, effective diagonal vector).
        self.mu_diag_terms: List[Optional[List[Tuple[int, torch.Tensor]]]] = []

        for k in range(self.nblocks):
            terms = []
            muterms = []
            for i in range(self.nblocks):
                if i == k or (k, i) not in model.E:
                    continue
                pair = (k, i) if i < k else (i, k)
                sign = 1.0 if i < k else -1.0
                terms.append((self.pair_index[pair], sign,
                              model.E[(i, k)].conjugate().T,
                              model.EcE[(k, i)], i,
                              model.E[(k, i)], model.E[(i, k)]))
                muterms.append((self.pair_index[pair], model.EcE2[(i, k)]))
            self.hk_terms.append(terms)
            self.mu_terms.append(muterms)

            f = model.functions[k]
            if f.needs_diagonal_mu:
                if not muterms:
                    raise ValueError(
                        f"Block {k} ({type(f).__name__}) requires a diagonal "
                        "penalty but has no couplings (reference would raise "
                        "at objectivefunc.py:190-192)")
                diag_terms = []
                for p_idx, ece2 in muterms:
                    d = ece2.effective_diagonal()
                    if d is None:
                        raise TypeError(
                            f"Penalty structure {type(ece2).__name__} for "
                            f"block {k} has no diagonal interpretation "
                            "(reference assert at objectivefunc.py:187,296)")
                    diag_terms.append((p_idx, d.to(device)))
                self._check_uniform_mu(k, f, diag_terms)
                self.mu_diag_terms.append(diag_terms)
            else:
                self.mu_diag_terms.append(None)

        # Residual operators per pair p=(i,j): E[(i,j)] acts on x_j,
        # E[(j,i)] acts on x_i (optimizer.py:251-274).
        self.E_ij = [model.E[(i, j)] for (i, j) in self.pairs]
        self.E_ji = [model.E[(j, i)] for (i, j) in self.pairs]

    def _check_uniform_mu(self, k, f, diag_terms) -> None:
        """Verify blockwise-uniform penalty contracts at plan-build time.

        Objectives with ``uniform_mu_group = g`` need the effective diagonal
        penalty ``Σ_p mu[p] · d_p`` constant within each group of ``g``
        entries; with scalar ``mu[p]`` that holds exactly when every
        coupling diagonal ``d_p`` is.  Every coupling is a concrete tensor
        here, so the check always decides.
        """
        g = getattr(f, "uniform_mu_group", None)
        if not g or g <= 1:
            return
        for _p_idx, d in diag_terms:
            dv = np.broadcast_to(d.detach().cpu().numpy(), (f.size_x,))
            dg = dv.reshape(-1, g)
            if not np.allclose(dg, dg[:, :1]):
                raise ValueError(
                    f"block {k} ({type(f).__name__}) requires a penalty "
                    f"constant within each group of {g} entries, but its "
                    "coupling produces a non-uniform effective diagonal; "
                    "couple this block through identity/ScaledIdentity "
                    "operators")

    # ------------------------------------------------------------------
    # Functions of one iteration
    # ------------------------------------------------------------------
    def compute_factors(self, mu):
        """Per-block factorizations for the current penalties ``mu``
        (npairs,); O(N^3) per dense quadratic block, so called only when
        mu changes."""
        factors = []
        for k, f in enumerate(self.model.functions):
            if not f.is_quadratic:
                factors.append(())
                continue
            if self.mu_terms[k]:
                mu_op = None
                for p_idx, ece2 in self.mu_terms[k]:
                    term = ece2 * mu[p_idx]
                    mu_op = term if mu_op is None else add(mu_op, term)
            else:
                mu_op = ScaledIdentityMatrix(f.size_x, 0.0)
            factors.append(f.make_factors(mu_op))
        return tuple(factors)

    def mu_diag(self, k: int, mu):
        """Effective diagonal penalty for block k (objectivefunc.py:296-310)."""
        out = None
        for p_idx, d in self.mu_diag_terms[k]:
            t = mu[p_idx] * _match_precision(d, mu)
            out = t if out is None else out + t
        return out

    def sweep(self, x, h, mu, factors, update_h: bool, relax: float = 1.0):
        """One Gauss–Seidel sweep + dual ascent (optimizer.py:322-341).

        Returns (x_new, h_new, pair_products) where pair_products caches the
        per-pair coupling matvecs for the residual computation.

        ``relax`` != 1.0 enables over-relaxation (no reference
        counterpart): in every pair, the earlier-updated member's
        constraint image is replaced by ``relax * (E_kj x_j_new) + (1 -
        relax) * (E_jk x_k_prev)`` in the later block's subproblem and in
        the dual ascent.  Fixed points are unchanged.
        """
        relax_on = float(relax) != 1.0
        if relax_on and self.npairs != 1:
            # Multi-pair Gauss-Seidel sweeps stall under relaxation.
            raise ValueError(
                "relax != 1.0 is supported for single-pair (2-block) "
                f"models only; this model has {self.npairs} pairs")
        x_new = list(x)
        for k, f in enumerate(self.model.functions):
            terms = self.hk_terms[k]
            if terms:
                hk = None
                for p_idx, sign, EikH, EcE_ki, i, E_ki, E_ik in terms:
                    # Gauss–Seidel: partners i<k already updated this sweep.
                    xi = x_new[i]
                    if relax_on and i < k:
                        r = (relax * (E_ki @ xi)
                             + (1.0 - relax) * (E_ik @ x[k]))
                        t = sign * (EikH @ h[p_idx]) - mu[p_idx] * (EikH @ r)
                    else:
                        t = sign * (EikH @ h[p_idx]) \
                            - mu[p_idx] * (EcE_ki @ xi)
                    hk = t if hk is None else hk + t
            else:
                hk = torch.zeros(f.size_x, dtype=x[k].dtype, device=x[k].device)

            if f.is_quadratic:
                xk = f.prox_with_factors(factors[k], hk)
            elif f.needs_diagonal_mu:
                xk = f.prox_diag(hk, self.mu_diag(k, mu))
            else:
                xk = f.solve(hk, None)
            x_new[k] = xk.to(x[k].dtype)

        # Shared per-pair products: p1 = E_ij x_j, p2 = E_ji x_i.
        p1s, p2s = [], []
        for idx, (i, j) in enumerate(self.pairs):
            p1s.append(self.E_ij[idx] @ x_new[j])
            p2s.append(self.E_ji[idx] @ x_new[i])

        h_new = list(h)
        if update_h:
            for idx, (i, j) in enumerate(self.pairs):
                # h[i,j] += mu * (E[j,i] x_i - E[i,j] x_j)
                # (optimizer.py:334-341); under relaxation the earlier
                # member's (j's) image is the relaxed mix.
                p1 = p1s[idx]
                if relax_on:
                    p1 = (relax * p1
                          + (1.0 - relax) * (self.E_ji[idx] @ x[i]))
                h_new[idx] = h[idx] + mu[idx] * (p2s[idx] - p1)

        return tuple(x_new), tuple(h_new), (p1s, p2s)

    def pair_residuals(self, x_new, x_old, mu, pair_products=None):
        """Per-pair primal/dual residual norms and relative residuals.

        Returns (primal_norms, dual_norms, convs), where ``convs`` holds
        (relative primal, relative dual) per pair (optimizer.py:232-299).
        """
        if pair_products is None:
            p1s = [self.E_ij[idx] @ x_new[j]
                   for idx, (i, j) in enumerate(self.pairs)]
            p2s = [self.E_ji[idx] @ x_new[i]
                   for idx, (i, j) in enumerate(self.pairs)]
        else:
            p1s, p2s = pair_products

        primal_norms, dual_norms, convs = [], [], []
        for idx, (i, j) in enumerate(self.pairs):
            p1, p2 = p1s[idx], p2s[idx]
            d_primal = p1 - p2
            # dual residual: mu * E[j,i] @ E[i,j] @ (x_j - x_j_old)
            d_dual = mu[idx] * (self.E_ji[idx] @ (
                self.E_ij[idx] @ (x_new[j] - x_old[j])))
            dual1 = mu[idx] * (self.E_ji[idx] @ p1)
            dual2 = dual1 - d_dual
            pn = _norm(d_primal)
            dn = _norm(d_dual)
            primal_norms.append(pn)
            dual_norms.append(dn)
            convs.append((pn / torch.maximum(_norm(p1), _norm(p2)),
                          dn / torch.maximum(_norm(dual1), _norm(dual2))))
        return primal_norms, dual_norms, convs

    def updated_mu(self, mu, primal_norms, dual_norms,
                   fact_incr, th_change, max_mu):
        """Residual-balancing penalty adaptation (optimizer.py:277-299)."""
        pn = torch.stack(primal_norms).to(mu.dtype)
        dn = torch.stack(dual_norms).to(mu.dtype)
        mu_new = torch.where(pn > th_change * dn, mu * fact_incr, mu)
        mu_new = torch.where(dn > th_change * pn, mu_new / fact_incr, mu_new)
        return torch.clamp_max(mu_new, max_mu)

    def is_complex(self) -> bool:
        """True when any operator or objective data is complex; drives the
        default state dtype."""
        if any(_has_complex(op) for op in self.model.E.values()):
            return True
        return any(_has_complex(v) for f in self.model.functions
                   for v in vars(f).values())

    def default_dtype(self) -> torch.dtype:
        return default_dtype(self.is_complex())

    def make_initial_state(self, x0=None, mu0: float = 1.0, dtype=None,
                           device="cpu"):
        """Initial primal/dual state and penalties (optimizer.py:141-160).
        ``mu`` takes the real dtype of the state."""
        if dtype is None:
            dtype = self.default_dtype()
        if x0 is not None:
            if len(x0) != self.nblocks:
                raise ValueError(f"x0 needs {self.nblocks} blocks, got {len(x0)}")
            x = tuple(_asarray(x_).to(device) for x_ in x0)
            for k, x_ in enumerate(x):
                if x_.numel() != self.model.functions[k].size_x:
                    raise ValueError(f"x0[{k}] has {x_.numel()} entries, "
                                     f"expected {self.model.functions[k].size_x}")
        else:
            x = tuple(torch.zeros(n, dtype=dtype, device=device)
                      for n in self.block_sizes)
        h = tuple(torch.zeros(s, dtype=dtype, device=device) for s in self.pair_sizes)
        real = dtype.to_real() if dtype.is_complex else dtype
        mu = torch.full((self.npairs,), float(mu0), dtype=real, device=device)
        return x, h, mu


class SimpleOptimizer:
    """Reference-compatible front end over the engine.

    Mirrors the public surface of the reference ``SimpleOptimizer``
    (``optimizer.py:121-341``): ``solve``, ``one_sweep``, ``residual``,
    ``update_mu``, ``check_convergence``, ``__call__``, ``.x``, and the
    ``_primal_residual`` / ``_dual_residual`` histories.  The model is
    moved to ``device``; ``dtype`` defaults to float64 (complex128 for
    complex data).
    """

    def __init__(self, model: Model, x0=None, mu=None, max_mu: float = 1e3,
                 dtype=None, device="cpu") -> None:
        if not isinstance(model, Model):
            raise TypeError(f"expected a Model, got {type(model).__name__}")
        self._model = model.to(device)
        self._plan = ADMMPlan(self._model, device)
        self._max_mu = float(max_mu)
        mu0 = 1.0 if mu is None else float(mu)
        self._x, self._h, self._mu = self._plan.make_initial_state(
            x0, mu0, dtype, device)
        self._x_old = None
        self._primal_residual: List[float] = []
        self._dual_residual: List[float] = []

    # -- reference API -----------------------------------------------------
    @property
    def x(self) -> List[torch.Tensor]:
        return list(self._x)

    @property
    def h(self) -> List[torch.Tensor]:
        return list(self._h)

    @property
    def mu(self) -> torch.Tensor:
        """Per-pair penalties, ordered like ``Model.pairs``."""
        return self._mu

    @property
    def primal_residual_history(self) -> List[float]:
        """Per-iteration absolute primal residuals recorded so far
        (reference ``_primal_residual``, ``optimizer.py:162,312-314``)."""
        return list(self._primal_residual)

    @property
    def dual_residual_history(self) -> List[float]:
        """Per-iteration absolute dual residuals recorded so far
        (reference ``_dual_residual``, ``optimizer.py:163,312-314``)."""
        return list(self._dual_residual)

    @property
    def iterations(self) -> int:
        """Number of iterations executed across all ``solve`` calls."""
        return len(self._primal_residual)

    def __call__(self, x: Sequence) -> float:
        return float(np.sum([f(x_) for x_, f in
                             zip(x, self._model.functions)]))

    def solve(self, niter: int = 10000, callback=None,
              interval_update_mu: int = 100, update_h: bool = True,
              rtol: float = 1e-12, atol: float = 0.0,
              fact_incr: float = 2.0, th_change: float = 10.0,
              record_residuals: bool = True,
              relax: float = 1.0) -> None:
        """Run up to ``niter`` iterations (optimizer.py:302-320).

        Each iteration: sweep, residuals and convergence test (``atol`` > 0
        adds an absolute stop on the summed residuals), then the penalty
        update after iteration 0 and every ``interval_update_mu``
        iterations — never after the converging one.  ``callback`` runs
        after every iteration.
        """
        if niter <= 0:
            # The reference's `for iter in range(0)` is a no-op
            # (optimizer.py:310).
            return
        cfg = ADMMConfig(
            niter=int(niter), interval_update_mu=int(interval_update_mu),
            update_h=bool(update_h), max_mu=self._max_mu,
            fact_incr=float(fact_incr), th_change=float(th_change),
            relax=float(relax))
        plan = self._plan
        x, h, mu = self._x, self._h, self._mu
        rdtype = mu.dtype
        pbuf = torch.full((cfg.niter,), float("nan"), dtype=rdtype, device=mu.device)
        dbuf = torch.full((cfg.niter,), float("nan"), dtype=rdtype, device=mu.device)
        factors = plan.compute_factors(mu)
        n = 0
        for it in range(cfg.niter):
            x_new, h_new, prods = plan.sweep(x, h, mu, factors, cfg.update_h,
                                             relax=cfg.relax)
            primal_norms, dual_norms, convs = plan.pair_residuals(
                x_new, x, mu, prods)
            if plan.npairs:
                primal = sum(primal_norms[1:], primal_norms[0])
                dual = sum(dual_norms[1:], dual_norms[0])
                # NaN (0/0) and Inf (x/0) both fail `< rtol`, matching the
                # reference's float semantics at optimizer.py:244-247.
                conv = torch.stack([(rp < rtol) & (rd < rtol) for rp, rd in convs]).all()
                conv = conv | ((primal < atol) & (dual < atol))
                pbuf[it] = primal
                dbuf[it] = dual
            else:
                conv = torch.tensor(True)
                pbuf[it] = 0.0
                dbuf[it] = 0.0
            x_old, x, h = x, x_new, h_new
            n = it + 1
            done = bool(conv)
            if callback is not None:
                self._x, self._h, self._mu, self._x_old = x, h, mu, x_old
                self._record(record_residuals, pbuf, dbuf, it, it + 1)
                callback()
            if done:
                break
            if it % cfg.interval_update_mu == 0 and plan.npairs:
                mu_new = plan.updated_mu(mu, primal_norms, dual_norms,
                                         cfg.fact_incr, cfg.th_change, cfg.max_mu)
                if not torch.equal(mu_new, mu):
                    factors = plan.compute_factors(mu_new)
                mu = mu_new
        self._x, self._h, self._mu, self._x_old = x, h, mu, x_old
        if callback is None:
            self._record(record_residuals, pbuf, dbuf, 0, n)

    def _record(self, record: bool, pbuf, dbuf, start: int, stop: int) -> None:
        if record:
            self._primal_residual.extend(pbuf[start:stop].tolist())
            self._dual_residual.extend(dbuf[start:stop].tolist())

    def one_sweep(self, update_h: bool = True) -> None:
        """Single Gauss–Seidel sweep + dual ascent (optimizer.py:322-341)."""
        self._x_old = tuple(self._x)
        factors = self._plan.compute_factors(self._mu)
        self._x, self._h, _ = self._plan.sweep(
            self._x, self._h, self._mu, factors, update_h)

    def residual(self) -> Tuple[float, float]:
        """(primal, dual) absolute residuals (optimizer.py:251-274)."""
        if self._x_old is None:
            raise RuntimeError(
                "residual() requires a prior one_sweep() (the reference "
                "crashes here with AttributeError, optimizer.py:324)")
        pn, dn, _ = self._plan.pair_residuals(self._x, self._x_old, self._mu)
        return (float(sum(float(p) for p in pn)),
                float(sum(float(d) for d in dn)))

    def check_convergence(self, rtol: float) -> bool:
        if self._x_old is None:
            raise RuntimeError("check_convergence() requires a prior one_sweep()")
        _, _, convs = self._plan.pair_residuals(
            self._x, self._x_old, self._mu)
        return all(bool(rp < rtol) and bool(rd < rtol) for rp, rd in convs)

    def update_mu(self, fact_incr: float = 2.0,
                  th_change: float = 10.0) -> None:
        if self._x_old is None:
            raise RuntimeError("update_mu() requires a prior one_sweep()")
        pn, dn, _ = self._plan.pair_residuals(self._x, self._x_old, self._mu)
        self._mu = self._plan.updated_mu(
            self._mu, pn, dn, fact_incr, th_change, self._max_mu)
