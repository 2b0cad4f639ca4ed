"""The ADMM engine: Gauss–Seidel multi-block ADMM in eager PyTorch.

Counterpart of :mod:`admmsolver_tpu.optimizer` (reference
``optimizer.py:121-341``).  :class:`ADMMPlan` resolves the constraint
graph, operator structures and block order once; :class:`SimpleOptimizer`
runs the solve through a static run program (:class:`_RunProgram`, the JAX
package's one jitted ``while_loop``): iteration 0, then chunks of
``interval_update_mu`` iterations over fixed buffers, on a CUDA device each
chunk a replay of a captured CUDA graph.  Factorizations are recomputed at
the start of a chunk, where the penalty ``mu`` may have changed, which
replaces the reference's hash-keyed cache (``objectivefunc.py:89-96``).
The per-pair coupling products ``E x`` are computed once per iteration and
shared by the dual update, the residual norms, the convergence test and
the penalty update.

Semantics preserved exactly: Gauss–Seidel sweep order and sign
conventions (``optimizer.py:183-207``), dual ascent (``optimizer.py:
334-341``), absolute summed residuals (``optimizer.py:251-274``), the
per-pair relative convergence test including its 0/0 → NaN → "not
converged" behavior (``optimizer.py:232-249``), and residual-balancing mu
adaptation with clamping (``optimizer.py:277-299``).

The same functions carry a leading batch axis for
:class:`~admmsolver_tpu_torch.parallel.batch.BatchedSolver` when called with
``batched=True``: ``x[k]`` is ``(B, n_k)``, ``h[p]`` ``(B, s_p)``, ``mu``
``(B, npairs)``, one problem instance per row, and norms reduce over the
last axis only.  The couplings stay shared; per-instance objective values
come as a ``functions`` list of clones.  :meth:`ADMMPlan.iteration` is the
batched iteration with per-lane convergence masking (the function the JAX
package maps over the batch).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .backend import default_dtype
from .config import ADMMConfig
from .models.objectivefunc import any_not_pd, deferred_cholesky_checks, raise_if_not_pd
from .models.problem import Model
from .ops.linop import (LaneOperators, MatrixBase, ScaledIdentityMatrix,
                        _asarray, _match_precision)
from .utils import telemetry

__all__ = ["ADMMPlan", "SimpleOptimizer"]


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v)


def _row_norm(v: torch.Tensor) -> torch.Tensor:
    """Norm of every row of ``v`` (B, n): one per lane."""
    return torch.linalg.vector_norm(v, dim=-1)


def _apply(op: MatrixBase, v: torch.Tensor, batched: bool) -> torch.Tensor:
    """``op`` on a vector, or on every row of a batch."""
    return op.matvec_rows(v) if batched else op @ v


def _write_column(buf: torch.Tensor, idx, active: torch.Tensor, value) -> None:
    """``buf[:, idx] = where(active, value, buf[:, idx])`` in place; ``idx``
    an int or a (1,) index tensor on ``buf``'s device (the slot of a
    captured chunk, which steps it on the device)."""
    if isinstance(idx, torch.Tensor):
        old = buf.index_select(1, idx)[:, 0]
        buf.index_copy_(1, idx, torch.where(active, value, old)[:, None])
    else:
        buf[:, idx] = torch.where(active, value, buf[:, idx])


def _shared_penalty(ece2: MatrixBase, device) -> LaneOperators:
    """A penalty term ``ece2`` as lane operators that every lane shares, on
    ``device``; a diagonal one with its ``block`` found
    (:meth:`~admmsolver_tpu_torch.ops.linop.LaneOperators.with_block`), so
    that no refactor reads its values."""
    op = LaneOperators.shared(ece2)
    return op._with(op.kind, op.data.to(device)).with_block()


def _has_complex(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.is_complex()
    if isinstance(v, MatrixBase):
        return any(_has_complex(a) for a in vars(v).values())
    return isinstance(v, (complex, np.complexfloating))


def _sum_taken(terms: list):
    """``terms[0] + terms[1] + ...`` in that order, taking each term out of
    the list: once summed, no term is referenced from here."""
    total = terms.pop(0)
    while terms:
        total = total + terms.pop(0)
    return total


class _RunProgram:
    """The static run program of one ``SimpleOptimizer`` solve key: the
    counterpart of the JAX package's jitted ``_build_run``
    (``optimizer.py:424-461``).

    It owns the buffers its chunks read and write: x, the x before the last
    iteration, h, mu, the done flag, the count of iterations run (the
    history slot of the next one, ``min(count, hist - 1)``), the (hist,)
    residual histories (NaN where not written) and the tolerances as device
    scalars of the residuals' real dtype, all loaded per solve
    (:meth:`load`).  A chunk (key = (iterations, penalty update)) refactors
    from mu, then runs its iterations, each freezing the state once done;
    the penalty update fires at its last iteration where the key says so and
    the solve is not done.  So three chunks serve a solve (iteration 0, a
    full chunk of ``interval_update_mu``, the remainder: :func:`~admmsolver_
    tpu_torch.parallel.batch._schedule`), run directly or, on a CUDA device,
    captured once each into a graph and replayed (:class:`~admmsolver_tpu_
    torch.parallel.batch._GraphProgram`, which it holds).  The Cholesky
    factorizations keep their info on the device, gathered in
    :attr:`failed`.
    """

    def __init__(self, plan: "ADMMPlan", cfg: ADMMConfig, record: bool, x, h, mu) -> None:
        from .parallel import batch   # batch imports this module

        self.plan, self.cfg = plan, cfg
        self.hist = cfg.niter if record else 1
        self.x, self.x_old, self.h = (tuple(t.clone(memory_format=torch.contiguous_format)
                                            for t in v) for v in (x, x, h))
        self.mu = mu.clone()
        dev = mu.device
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.count = torch.zeros((), dtype=torch.long, device=dev)
        self.pbuf, self.dbuf = (torch.full((self.hist,), float("nan"), dtype=mu.dtype,
                                           device=dev) for _ in range(2))
        self.tols = (mu.new_zeros(()), mu.new_zeros(()))
        self.failed = torch.zeros((), dtype=torch.bool, device=dev)
        self.checks = False
        self.graphs = batch._GraphProgram(self._chunk)

    def load(self, x, h, mu, tols) -> None:
        """A solve's initial state and tolerances into the buffers."""
        for d, t in zip(self.x + self.x_old + self.h + (self.mu,), x + x + h + (mu,)):
            d.copy_(t)
        for d, t in zip(self.tols, tols):
            d.fill_(t)
        self.done.fill_(False)
        self.count.zero_()
        self.pbuf.fill_(float("nan"))
        self.dbuf.fill_(float("nan"))
        self.failed.fill_(False)

    def _chunk(self, key) -> None:
        n, update = key
        with deferred_cholesky_checks() as infos:
            factors = self.plan.compute_factors(self.mu)
        if infos:
            self.checks = True
            self.failed.logical_or_(any_not_pd(infos))
        for j in range(n):
            self._iteration(factors, update and j == n - 1)

    def _iteration(self, factors, update: bool) -> None:
        """One iteration of the JAX ``iteration`` (``optimizer.py:323-401``)
        on the buffers: sweep, residuals and convergence, the history row,
        and with ``update`` the penalty update; nothing changes once done."""
        plan, cfg = self.plan, self.cfg
        rtol, atol = self.tols
        x, h, mu = self.x, self.h, self.mu
        active = ~self.done
        x_new, h_new, prods = plan.sweep(x, h, mu, factors, cfg.update_h, relax=cfg.relax)
        if plan.npairs:
            primal_norms, dual_norms, convs = plan.pair_residuals(x_new, x, mu, prods)
            primal = sum(primal_norms[1:], primal_norms[0])
            dual = sum(dual_norms[1:], dual_norms[0])
            # NaN (0/0) and Inf (x/0) both fail `< rtol`, matching the
            # reference's float semantics at optimizer.py:244-247.
            conv = torch.stack([(rp < rtol) & (rd < rtol) for rp, rd in convs]).all()
            conv = conv | ((primal < atol) & (dual < atol))
        else:
            primal = dual = mu.new_zeros(())
            conv = torch.ones_like(active)
        slot = torch.clamp_max(self.count, self.hist - 1).view(1)
        for buf, value in ((self.pbuf, primal), (self.dbuf, dual)):
            buf.index_copy_(0, slot, torch.where(active, value.to(buf.dtype),
                                                 buf.index_select(0, slot)))
        for d, a in zip(self.x_old, x):
            d.copy_(torch.where(active, a, d))
        for d, a in zip(self.x + self.h, x_new + h_new):
            d.copy_(torch.where(active, a, d))
        del x_new, h_new
        done = self.done | conv
        if update and plan.npairs:
            # never after the converging iteration (optimizer.py:319-320)
            mu_new = plan.updated_mu(mu, primal_norms, dual_norms,
                                     cfg.fact_incr, cfg.th_change, cfg.max_mu)
            self.mu.copy_(torch.where(done, mu, mu_new))
        self.count.add_(active.to(self.count.dtype))
        self.done.copy_(done)

    def run(self, key, capture: bool, pool) -> None:
        """One chunk: a replay of its graph where ``capture``, else run
        directly."""
        self.graphs._run_chunk(key, capture, pool)

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        """Every tensor the program holds between solves."""
        return self.x + self.x_old + self.h + (self.mu, self.done, self.count, self.pbuf,
                                               self.dbuf, self.failed) + self.tols

    @property
    def capture_s(self) -> Dict:
        return self.graphs.capture_s


class ADMMPlan:
    """Static specialization of a :class:`Model` for the ADMM loop.

    Holds the ordered pair list, per-block Gauss–Seidel coupling terms,
    per-block penalty composition and the per-pair residual operators.
    ``model`` should already live on ``device``; the effective penalty
    diagonals of scalar couplings are made there once.
    """

    def __init__(self, model: Model, device="cuda") -> None:
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
        # The same terms as lane operators, by device, made at the first
        # batched refactor (:meth:`_lane_penalties`).
        self._mu_lanes: Dict[torch.device, List[List[Tuple[int, LaneOperators]]]] = {}
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
                    # E†E is Hermitian: its diagonal is real
                    d = (d.real if d.is_complex() else d).to(device)
                    if d.ndim == 1 and d.numel() > 1 and bool((d == d[:1]).all()):
                        # a uniform diagonal (an identity coupling) as one
                        # entry: the penalty broadcasts to the same values
                        # without a (B, n) array of them
                        d = d[:1].clone()
                    diag_terms.append((p_idx, d))
                self._check_uniform_mu(k, f, diag_terms)
                self.mu_diag_terms.append(diag_terms)
            else:
                self.mu_diag_terms.append(None)

        # Residual operators per pair p=(i,j): E[(i,j)] acts on x_j,
        # E[(j,i)] acts on x_i (optimizer.py:251-274).
        self.E_ij = [model.E[(i, j)] for (i, j) in self.pairs]
        self.E_ji = [model.E[(j, i)] for (i, j) in self.pairs]
        #: the single-instance run programs by key (:meth:`_compiled_run`)
        self._run_cache: Dict[tuple, _RunProgram] = {}
        #: the memory of their graphs, made by the first captured solve
        self._pool = None

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

    def _lane_penalties(self, k: int, device) -> List[Tuple[int, LaneOperators]]:
        """Block k's penalty terms as shared lane operators on ``device``
        (:func:`_shared_penalty`), made once a device."""
        if device not in self._mu_lanes:
            fs = self.model.functions
            self._mu_lanes[device] = [
                [(p_idx, _shared_penalty(ece2, device)) for p_idx, ece2 in terms]
                if fs[j].is_quadratic else [] for j, terms in enumerate(self.mu_terms)]
        return self._mu_lanes[device][k]

    # ------------------------------------------------------------------
    # Functions of one iteration
    # ------------------------------------------------------------------
    def compute_factors(self, mu, functions=None, batched: bool = False):
        """Per-block factorizations for the current penalties ``mu``
        (npairs,); O(N^3) per dense quadratic block, so called only when
        mu changes.  ``functions`` optionally replaces the block objectives
        (the batched runtime passes per-instance clones); batched, ``mu`` is
        (B, npairs) and each block's penalty a :class:`LaneOperators`."""
        factors = []
        for k, f in enumerate(functions or self.model.functions):
            if not f.is_quadratic:
                factors.append(())
                continue
            if batched:
                terms = [op.scale(mu[:, p_idx])
                         for p_idx, op in self._lane_penalties(k, mu.device)]
                zero = LaneOperators("scalar", mu.new_zeros(1), f.size_x, known_zero=True)
            else:
                terms = [ece2 * mu[p_idx] for p_idx, ece2 in self.mu_terms[k]]
                zero = ScaledIdentityMatrix(f.size_x, 0.0)
            # MatrixBase and LaneOperators both add through ``+``; the sum is
            # passed on unnamed, so that make_factors can drop it once used
            factors.append(f.make_factors(_sum_taken(terms) if terms else zero))
        return tuple(factors)

    def mu_diag(self, k: int, mu, batched: bool = False):
        """Effective diagonal penalty for block k (objectivefunc.py:296-310);
        batched, one row per lane."""
        out = None
        for p_idx, d in self.mu_diag_terms[k]:
            t = (mu[:, p_idx, None] if batched else mu[p_idx]) * _match_precision(d, mu)
            out = t if out is None else out + t
        return out

    def sweep(self, x, h, mu, factors, update_h: bool, functions=None,
              relax: float = 1.0, batched: bool = False):
        """One Gauss–Seidel sweep + dual ascent (optimizer.py:322-341).

        Returns (x_new, h_new, pair_products) where pair_products caches the
        per-pair coupling matvecs for the residual computation.

        ``relax`` != 1.0 enables over-relaxation (no reference
        counterpart): in every pair, the earlier-updated member's
        constraint image is replaced by ``relax * (E_kj x_j_new) + (1 -
        relax) * (E_jk x_k_prev)`` in the later block's subproblem and in
        the dual ascent.  Fixed points are unchanged.

        ``functions`` optionally replaces the block objectives (the
        arguments are in the JAX package's order, ``batched`` last);
        ``batched`` runs one instance per row of the state.
        """
        relax_on = float(relax) != 1.0
        if relax_on and self.npairs != 1:
            # Multi-pair Gauss-Seidel sweeps stall under relaxation.
            raise ValueError(
                "relax != 1.0 is supported for single-pair (2-block) "
                f"models only; this model has {self.npairs} pairs")
        mu_of = (lambda p: mu[:, p, None]) if batched else (lambda p: mu[p])
        x_new = list(x)
        for k, f in enumerate(functions or self.model.functions):
            terms = self.hk_terms[k]
            if terms:
                hk = None
                for p_idx, sign, EikH, EcE_ki, i, E_ki, E_ik in terms:
                    # Gauss–Seidel: partners i<k already updated this sweep.
                    xi = x_new[i]
                    if relax_on and i < k:
                        r = (relax * _apply(E_ki, xi, batched)
                             + (1.0 - relax) * _apply(E_ik, x[k], batched))
                        t = sign * _apply(EikH, h[p_idx], batched) \
                            - mu_of(p_idx) * _apply(EikH, r, batched)
                    else:
                        t = sign * _apply(EikH, h[p_idx], batched) \
                            - mu_of(p_idx) * _apply(EcE_ki, xi, batched)
                    hk = t if hk is None else hk + t
            else:
                hk = torch.zeros_like(x[k])

            if f.is_quadratic:
                xk = f.prox_with_factors(factors[k], hk, batched=batched)
            elif f.needs_diagonal_mu:
                xk = f.prox_diag(hk, self.mu_diag(k, mu, batched), batched=batched)
            else:
                xk = f.solve(hk, None)
            x_new[k] = xk.to(x[k].dtype)
            hk = xk = None

        # Shared per-pair products: p1 = E_ij x_j, p2 = E_ji x_i.
        p1s, p2s = [], []
        for idx, (i, j) in enumerate(self.pairs):
            p1s.append(_apply(self.E_ij[idx], x_new[j], batched))
            p2s.append(_apply(self.E_ji[idx], x_new[i], batched))

        h_new = list(h)
        if update_h:
            for idx, (i, j) in enumerate(self.pairs):
                # h[i,j] += mu * (E[j,i] x_i - E[i,j] x_j)
                # (optimizer.py:334-341); under relaxation the earlier
                # member's (j's) image is the relaxed mix.
                p1 = p1s[idx]
                if relax_on:
                    p1 = (relax * p1
                          + (1.0 - relax) * _apply(self.E_ji[idx], x[i], batched))
                # the values of h + mu * (p2 - p1), made in one array
                h_new[idx] = (p2s[idx] - p1).mul_(mu_of(idx)).add_(h[idx])

        return tuple(x_new), tuple(h_new), (p1s, p2s)

    def pair_residuals(self, x_new, x_old, mu, pair_products=None,
                       batched: bool = False):
        """Per-pair primal/dual residual norms and relative residuals.

        Returns (primal_norms, dual_norms, convs), where ``convs`` holds
        (relative primal, relative dual) per pair (optimizer.py:232-299);
        batched, every entry is (B,).
        """
        if pair_products is None:
            p1s = [_apply(self.E_ij[idx], x_new[j], batched)
                   for idx, (i, j) in enumerate(self.pairs)]
            p2s = [_apply(self.E_ji[idx], x_new[i], batched)
                   for idx, (i, j) in enumerate(self.pairs)]
        else:
            # the sweep's lists, emptied below as their products are used
            p1s, p2s = pair_products

        norm = _row_norm if batched else _norm
        primal_norms, dual_norms, convs = [], [], []
        for idx, (i, j) in enumerate(self.pairs):
            p1, p2 = p1s[idx], p2s[idx]
            # the products' last use: the lists let go of them, so that they
            # go once used (a pair's arrays are (B, n) each)
            p1s[idx] = p2s[idx] = None
            mu_p = mu[:, idx, None] if batched else mu[idx]
            pn = norm(p1 - p2)
            n_p1, n_p2 = norm(p1), norm(p2)
            dual1 = mu_p * _apply(self.E_ji[idx], p1, batched)
            del p1, p2
            n_dual1 = norm(dual1)
            # dual residual: mu * E[j,i] @ E[i,j] @ (x_j - x_j_old)
            d_dual = mu_p * _apply(self.E_ji[idx], _apply(
                self.E_ij[idx], x_new[j] - x_old[j], batched), batched)
            dn = norm(d_dual)
            # dual2 = dual1 - d_dual, made in dual1's place once its norm is taken
            n_dual2 = norm(dual1.sub_(d_dual))
            del d_dual, dual1
            primal_norms.append(pn)
            dual_norms.append(dn)
            convs.append((pn / torch.maximum(n_p1, n_p2),
                          dn / torch.maximum(n_dual1, n_dual2)))
        return primal_norms, dual_norms, convs

    def updated_mu(self, mu, primal_norms, dual_norms,
                   fact_incr, th_change, max_mu):
        """Residual-balancing penalty adaptation (optimizer.py:277-299);
        per-lane norms (B,) stack into (B, npairs) beside a batched ``mu``."""
        pn = torch.stack(primal_norms, dim=-1).to(mu.dtype)
        dn = torch.stack(dual_norms, dim=-1).to(mu.dtype)
        mu_new = torch.where(pn > th_change * dn, mu * fact_incr, mu)
        mu_new = torch.where(dn > th_change * pn, mu_new / fact_incr, mu_new)
        return torch.clamp_max(mu_new, max_mu)

    def iteration(self, carry, buf_idx: int, global_it: int, cfg: ADMMConfig,
                  tols, functions=None, compute_residuals: bool = True,
                  freeze: bool = True):
        """One iteration of a batch (optimizer.py:310-320): sweep →
        residuals and convergence → scheduled mu update, every lane for
        itself.

        ``carry`` = (x, h, mu, factors, done, count, primal_buf, dual_buf)
        with a leading batch axis: ``done``/``count`` (B,), the histories
        (B, hist); the JAX package also carries the previous x, which
        nothing reads.  ``buf_idx`` is the history column to write (an int,
        or a (1,) index tensor on the state's device),
        ``global_it`` drives the penalty-update schedule.  Finished lanes
        are frozen; the caller refactorizes.  With
        ``compute_residuals=False`` this is the sweep-only iteration of the
        chunked-checks mode.  The histories are written in place.
        ``freeze=False`` is for a batch where no lane is or can become done
        (nothing to freeze): the new state is taken as it is, the same values
        without a copy of it.
        """
        rtol, atol = tols
        x, h, mu, factors, done, count, pbuf, dbuf = carry
        active = ~done
        am = active[:, None]

        x_new, h_new, prods = self.sweep(
            x, h, mu, factors, cfg.update_h, relax=cfg.relax,
            functions=functions, batched=True)

        # Freeze finished lanes.
        if freeze:
            x_out = tuple(torch.where(am, a, b) for a, b in zip(x_new, x))
            h_out = tuple(torch.where(am, a, b) for a, b in zip(h_new, h))
        else:
            x_out, h_out = x_new, h_new
        count = count + active.to(count.dtype)
        if not compute_residuals:
            return (x_out, h_out, mu, factors, done, count, pbuf, dbuf)

        primal_norms, dual_norms, convs = self.pair_residuals(
            x_new, x, mu, prods, batched=True)

        if self.npairs:
            primal = sum(primal_norms[1:], primal_norms[0])
            dual = sum(dual_norms[1:], dual_norms[0])
            # NaN (0/0) and Inf (x/0) both fail `< rtol`, matching the
            # reference's float semantics at optimizer.py:244-247.
            conv = torch.ones_like(done)
            for rp, rd in convs:
                conv = conv & (rp < rtol) & (rd < rtol)
            # Optional absolute-residual stop (atol=0 disables it).
            conv = conv | ((primal < atol) & (dual < atol))
            _write_column(pbuf, buf_idx, active, primal.to(pbuf.dtype))
            _write_column(dbuf, buf_idx, active, dual.to(dbuf.dtype))
        else:
            conv = torch.ones_like(done)
            _write_column(pbuf, buf_idx, active, 0.0)
            _write_column(dbuf, buf_idx, active, 0.0)
        done_new = done | conv

        # The mu update fires on the reference schedule (optimizer.py:
        # 319-320): after iterations 0, interval, 2*interval, ... and never
        # after a lane's converging iteration.
        if self.npairs and global_it % cfg.interval_update_mu == 0:
            mu_adapted = self.updated_mu(mu, primal_norms, dual_norms,
                                         cfg.fact_incr, cfg.th_change, cfg.max_mu)
            mu = torch.where(done_new[:, None], mu, mu_adapted)
        return (x_out, h_out, mu, factors, done_new, count, pbuf, dbuf)

    # ------------------------------------------------------------------
    # Single-instance run program
    # ------------------------------------------------------------------
    def _compiled_run(self, cfg: ADMMConfig, record: bool, x, h, mu) -> _RunProgram:
        """The run program of a solve of the state ``x, h, mu``: cached per
        plan as the JAX package's ``_run_cache`` (``optimizer.py:406-422``),
        keyed by ``(cfg, record)`` with the state's dtypes and the route
        switches a graph keeps, at most 32, the oldest dropped first."""
        from .parallel import batch   # batch imports this module

        key = (cfg, record, tuple(t.dtype for t in x + h + (mu,)), batch._route_switches())
        program = self._run_cache.get(key)
        if program is None:
            program = batch._keep(self._run_cache, key, _RunProgram(self, cfg, record, x, h, mu))
        return program

    def _graph_pool(self, device: torch.device):
        """The plan's graph pool, made by its first captured solve."""
        from .parallel import batch

        if self._pool is None:
            self._pool = batch._GraphPool(device)
        return self._pool

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
                           device="cuda"):
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
    moved to ``device`` (default ``cuda``; without a CUDA device that
    raises, pass ``device="cpu"`` to run on the host); ``dtype`` defaults to
    float64 (complex128 for complex data).
    """

    def __init__(self, model: Model, x0=None, mu=None, max_mu: float = 1e3,
                 dtype=None, device="cuda") -> None:
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

        The solve runs through the plan's run program (:class:`_RunProgram`,
        the JAX package's one jitted ``while_loop``): iteration 0, then
        chunks of ``interval_update_mu`` iterations, each refactoring first;
        on a CUDA device each chunk is a replay of a captured graph (not for
        a route a graph cannot hold, nor with
        :data:`~admmsolver_tpu_torch.parallel.batch.CAPTURE_CHUNKS` off).
        The host reads the done flag after a chunk only where the solve can
        finish (``rtol`` > 0 or ``atol`` > 0).  With ``callback`` the host
        runs one iteration at a time, as the JAX package does.
        """
        if niter <= 0:
            # The reference's `for iter in range(0)` is a no-op
            # (optimizer.py:310).
            return
        from .parallel import batch   # batch imports this module

        interval = int(interval_update_mu)
        if interval < 1:
            raise ValueError(f"interval_update_mu must be >= 1, got {interval}")
        plan = self._plan
        cfg = ADMMConfig(
            niter=1 if callback is not None else int(niter), interval_update_mu=interval,
            update_h=bool(update_h), max_mu=self._max_mu,
            fact_incr=float(fact_incr), th_change=float(th_change),
            relax=float(relax))
        # the callback's one-iteration program records every row (JAX
        # optimizer.py:603-617)
        record = bool(record_residuals) or callback is not None
        state = (self._x, self._h, self._mu)
        program = plan._compiled_run(cfg, record, *state)
        program.load(*state, (rtol, atol))
        dev = self._mu.device
        capture = batch._captures(self._model.functions, self._mu.dtype, dev)
        pool = plan._graph_pool(dev) if capture else plan._pool
        if callback is not None:
            self._solve_with_callback(program, int(niter), interval, callback, capture, pool)
            return
        # no iteration converges where neither tolerance can be met (a model
        # without pairs converges at once)
        can_finish = rtol > 0 or atol > 0 or not plan.npairs
        schedule = batch._schedule(cfg.niter, interval)
        unread = False
        for k, key in enumerate(schedule):
            program.run(key, capture, pool)
            telemetry.check_chunk("SimpleOptimizer", program.x, program.h)
            unread = program.checks
            if can_finish and k + 1 < len(schedule):
                done = batch._flags_read(program.done, program.failed if unread else None)
                unread = False
                if done:
                    break
        if unread:
            raise_if_not_pd(program.failed)
        self._take(program)
        if record_residuals:
            n = int(program.count)
            self._primal_residual.extend(program.pbuf[:n].tolist())
            self._dual_residual.extend(program.dbuf[:n].tolist())

    def _solve_with_callback(self, program: _RunProgram, niter: int, interval: int,
                             callback, capture: bool, pool) -> None:
        """The per-iteration host loop of a solve with a callback: one
        iteration a chunk (refactor, the iteration, the penalty update where
        the schedule fires), the state and the iteration's history row taken
        after each, then ``callback``; the loop stops at the converging
        iteration (JAX ``optimizer.py:600-620``)."""
        from .parallel import batch

        for it in range(niter):
            program.run((1, it % interval == 0), capture, pool)
            telemetry.check_chunk("SimpleOptimizer", program.x, program.h)
            done = batch._flags_read(program.done, program.failed if program.checks else None)
            self._take(program)
            self._primal_residual.append(float(program.pbuf[0]))
            self._dual_residual.append(float(program.dbuf[0]))
            callback()
            if done:
                return

    def _take(self, program: _RunProgram) -> None:
        """The state of a solve, copied out of the buffers that the next
        solve overwrites."""
        clone = lambda v: tuple(t.clone() for t in v)
        self._x, self._x_old, self._h = clone(program.x), clone(program.x_old), clone(program.h)
        self._mu = program.mu.clone()

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
