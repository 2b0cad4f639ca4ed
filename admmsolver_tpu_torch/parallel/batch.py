"""Batched ADMM: solve many problem instances of one structure at once.

Counterpart of :mod:`admmsolver_tpu.parallel.batch`.  Independent problem
instances — per-frequency SpM problems, λ-path sweeps, compressed sensing
with many right-hand sides — are rows of one state: ``x[k]`` is ``(B, n_k)``
and every step of the engine (:meth:`~admmsolver_tpu_torch.optimizer.
ADMMPlan.iteration`) acts on all rows.  The reference solves one
``SimpleOptimizer`` at a time (``optimizer.py:302-320``).

Control flow: per-instance convergence inside a batch means masked lanes
whose state is frozen by ``where`` selects, while the loop keeps stepping
until *all* lanes are done.  Penalty updates stay per-instance (``mu`` is
``(B, npairs)``), but their *schedule* is iteration-count based and thus
shared, so the factors are refreshed at chunk boundaries: iteration 0, then
chunks of ``interval_update_mu`` iterations, each followed by a refresh —
the batched analogue of the reference's hash-keyed cache
(``objectivefunc.py:89-96``).  The schedule is a Python loop; the host reads
the done flags once per chunk, never per iteration, and not at all when no
lane can finish (``rtol <= 0`` and ``atol <= 0``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import ADMMConfig
from ..models.problem import Model
from ..optimizer import ADMMPlan
from ..ops.linop import _asarray, _real_dtype
from ..utils import telemetry

__all__ = ["BatchedSolver", "BatchResult"]


def _as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _cast_like(dtype, a, device=None) -> torch.Tensor:
    """Cast ``a`` to the real/complex companion of ``dtype`` (floats to
    its real type, complex to its complex type) so a mixed-precision phase
    doesn't get silently re-promoted by f64 constants."""
    a = _asarray(a)
    real = _real_dtype(_as_dtype(dtype))
    if a.is_complex():
        tgt = torch.complex64 if real == torch.float32 else torch.complex128
    elif a.is_floating_point():
        tgt = real
    else:
        tgt = a.dtype
    return a.to(device=device, dtype=tgt)


def _to_state_dtype(a, dtype, device=None) -> torch.Tensor:
    """Cast user-supplied initial state to the solver state dtype.

    Complex input to a REAL-dtype solve is explicit, not silent: the
    reference initializes state as ``complex128`` zeros
    (``optimizer.py:151,159``), so all-zero-imag complex ``x0``/``h0``
    is accepted (via an explicit ``.real``), but any nonzero imaginary
    part raises instead of being discarded."""
    a = _asarray(a)
    if a.is_complex() and not dtype.is_complex:
        if bool(torch.any(a.imag != 0)):
            raise TypeError(
                "complex initial state passed to a real-dtype solve would "
                "discard its imaginary part; pass dtype=complex")
        a = a.real
    return a.to(device=device, dtype=dtype)


def _parse_record_residuals(record_residuals) -> Tuple[bool, int]:
    """Normalize the ``record_residuals`` knob to ``(record, stride)``.

    ``True`` → per-iteration histories; ``False`` → none; an int ``s >= 1``
    → every s-th iteration (shared by every batched and fused solve)."""
    if record_residuals is True:
        return True, 1
    if record_residuals is False:
        return False, 1
    stride = int(record_residuals)
    if stride < 1:
        raise ValueError(
            f"record_residuals stride must be >= 1, got {stride}")
    return True, stride


@dataclasses.dataclass
class BatchResult:
    """Final batch state.

    ``x``: tuple of (B, n_k) tensors; ``h``: tuple of (B, size_p) tensors;
    ``mu``: (B, npairs); ``iterations``: (B,) int32 per-lane executed
    iteration counts; ``converged``: (B,) bools; ``primal_residual``/
    ``dual_residual``: (B, hist) histories, NaN-padded past each lane's
    exit (mirrors the reference's per-iteration history lists,
    ``optimizer.py:312-314``).  The histories are float64 whatever the
    dtype of the phase that wrote them, as in the JAX package.
    """

    x: Tuple[torch.Tensor, ...]
    h: Tuple[torch.Tensor, ...]
    mu: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor
    primal_residual: torch.Tensor
    dual_residual: torch.Tensor


def _lanewise(fn, *results: BatchResult) -> BatchResult:
    """``fn`` over the corresponding tensors of the results, field by field."""
    blocks = lambda name: tuple(fn(*t) for t in zip(*(getattr(r, name) for r in results)))
    rest = ("mu", "iterations", "converged", "primal_residual", "dual_residual")
    return BatchResult(x=blocks("x"), h=blocks("h"),
                       **{name: fn(*(getattr(r, name) for r in results)) for name in rest})


def _concat(parts: Sequence[BatchResult]) -> BatchResult:
    """Results of consecutive groups of lanes as one result."""
    return parts[0] if len(parts) == 1 else _lanewise(lambda *a: torch.cat(a), *parts)


def _trim(res: BatchResult, n: int) -> BatchResult:
    """The first ``n`` lanes of a result."""
    return _lanewise(lambda a: a[:n], res)


def _pad_last(a: torch.Tensor, pad_n: int) -> torch.Tensor:
    """``a`` with its last lane repeated ``pad_n`` more times."""
    if not pad_n:
        return a
    return torch.cat([a, a[-1:].expand((pad_n,) + tuple(a.shape[1:]))])


class BatchedSolver:
    """Solve a batch of same-structure problems.

    ``model`` is the template: its operators (A, C, E couplings) are shared
    across the batch.  Per-instance values are supplied to :meth:`solve` as
    ``overrides``: a dict ``{(block_index, field): batched_array}`` where
    ``field`` is one of the block objective's ``batch_fields`` (e.g.
    ``{(0, "y"): y_batch, (1, "alpha"): lambdas}`` for a λ-path sweep of
    ``LS + L1``); numpy arrays or tensors.  Heavy derived values are made
    once per solve in a prologue (e.g. ``A†y``), so the iteration carries
    only the per-iteration math.

    ``device`` is where the solve runs: ``cuda`` by default (without a CUDA
    device the constructor raises), the host only with ``device="cpu"``.
    ``dtype`` defaults to float64 (complex128 for complex data).
    """

    def __init__(self, model: Model, dtype=None, device="cuda") -> None:
        if not isinstance(model, Model):
            raise TypeError(f"expected a Model, got {type(model).__name__}")
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.plan = ADMMPlan(self.model, self.device)
        # real problems get a real state (see ADMMPlan.is_complex)
        self.dtype = self.plan.default_dtype() if dtype is None else _as_dtype(dtype)

    # -- parameter binding -------------------------------------------------
    def _bind(self, ov: Dict):
        """Per-instance objective clones from an override dict (batched
        leaves)."""
        if not ov:
            return list(self.model.functions)
        updates: Dict[int, Dict] = {}
        for (k, field), val in ov.items():
            updates.setdefault(k, {})[field] = val
        return [
            f.clone_with(**updates[k]) if k in updates else f
            for k, f in enumerate(self.model.functions)
        ]

    def _validate_overrides(self, overrides: Dict,
                            allow_large_A: bool = False) -> Optional[int]:
        batch = None
        for (k, field), val in overrides.items():
            f = self.model.functions[k]
            if field not in f.batch_fields:
                raise ValueError(
                    f"block {k} ({type(f).__name__}) has no batchable "
                    f"field {field!r}; available: {f.batch_fields}")
            if np.ndim(val) < 1:
                raise ValueError(
                    f"override {(k, field)} must have a leading batch "
                    f"axis, got a scalar; wrap per-instance scalars as a "
                    f"(B,) array")
            if field == "A":
                # Per-instance operators force per-lane dense factors
                # ((B, n, n) inverses).  n <= 128 keeps that factor state
                # small; ``allow_large_A`` (solve_scan) lifts the cap: the
                # scan keeps only one group's factors resident.
                if f.size_x > 128 and not allow_large_A:
                    raise ValueError(
                        f"per-instance A batching is limited to blocks "
                        f"with n <= 128 (block {k} has n={f.size_x}): "
                        "per-lane dense factors at larger n violate the "
                        "HBM budget; use solve_scan (amortized scan over "
                        "instances) or rowshard for large single problems")
                want = getattr(f, "_A").shape
                if tuple(np.shape(val)[1:]) != tuple(want):
                    raise ValueError(
                        f"override {(k, 'A')} must be (B, {want[0]}, "
                        f"{want[1]}) matching the template operator, got "
                        f"{tuple(np.shape(val))}")
            b = np.shape(val)[0]
            if batch is None:
                batch = b
            elif batch != b:
                raise ValueError(
                    f"inconsistent batch sizes: {batch} vs {b} for "
                    f"override {(k, field)}")
        return batch

    def _prologue_overrides(self, ov: Dict) -> Dict:
        """Derived per-instance values, made once per solve.

        ``y`` overrides on (Constrained)LeastSquares blocks are replaced by
        ``Acy`` (= A†y, with the per-instance ``A`` where one is given) so
        the loop never recomputes the reduction.
        """
        out = dict(ov)
        for (k, field) in list(out.keys()):
            f = self.model.functions[k]
            if field == "y" and hasattr(f, "_Ac"):
                y = out.pop((k, field))
                A = out.get((k, "A"))
                out[(k, "Acy")] = (f._Ac.matvec_rows(y) if A is None
                                   else (A.mH @ y[..., None])[..., 0])
        return out

    # -- set-up shared by the solves ---------------------------------------
    def _solve_dtype(self, dtype) -> torch.dtype:
        return self.dtype if dtype is None else _as_dtype(dtype)

    def _config(self, niter, interval_update_mu, update_h, max_mu, fact_incr,
                th_change, relax) -> ADMMConfig:
        if niter <= 0:
            raise ValueError("niter must be positive for batched solves")
        return ADMMConfig(niter=int(niter),
                          interval_update_mu=int(interval_update_mu),
                          update_h=bool(update_h), max_mu=float(max_mu),
                          fact_incr=float(fact_incr),
                          th_change=float(th_change), relax=float(relax))

    def _initial_state(self, B: int, dtype: torch.dtype, x0, h0, mu0, done0):
        """State tensors of a batch of ``B`` on the solver's device."""
        plan, dev = self.plan, self.device

        def blocks(init, sizes, name):
            if init is None:
                # one zero row seen by every lane: the first iteration replaces
                # the state, so a (B, n) array of zeros would only be held by
                # the caller for the whole solve
                return tuple(torch.zeros(n, dtype=dtype, device=dev).expand(B, n)
                             for n in sizes)
            out = tuple(_to_state_dtype(a, dtype, dev) for a in init)
            if [tuple(a.shape) for a in out] != [(B, n) for n in sizes]:
                raise ValueError(f"{name} needs shapes {[(B, n) for n in sizes]}, got "
                                 f"{[tuple(a.shape) for a in out]}")
            return out

        x = blocks(x0, plan.block_sizes, "x0")
        h = blocks(h0, plan.pair_sizes, "h0")
        mu0 = _cast_like(dtype, mu0, dev)
        if mu0.ndim == 1:
            mu0 = mu0[:, None]
        if mu0.ndim == 2 and mu0.shape[0] != B:
            raise ValueError(f"mu0 has {mu0.shape[0]} lanes, expected {B}")
        mu = mu0.expand(B, plan.npairs).clone()
        if done0 is not None:
            done0 = torch.as_tensor(done0, dtype=torch.bool, device=dev)
            if tuple(done0.shape) != (B,):
                raise ValueError(f"done0 has shape {tuple(done0.shape)}, expected ({B},)")
        return x, h, mu, done0

    # -- the chunk schedule ------------------------------------------------
    def _run(self, cfg: ADMMConfig, ov: Dict, x, h, mu, tols, done0,
             record: bool, stride: int, chunked_checks: bool,
             read_done0: bool = True) -> BatchResult:
        """One batch through the schedule: prologue, factors, iteration 0,
        refactor, then chunks of ``interval_update_mu`` iterations (those
        past ``niter`` are not run) with a refactor at each chunk's end,
        until every lane is done.  ``ov`` is already cast and on the device;
        ``done0`` is a (B,) mask or None.  The host reads the done flags
        only before a chunk that could be skipped: after a chunk that is not
        the last, and (``read_done0``) once for ``done0``."""
        plan = self.plan
        interval, niter = cfg.interval_update_mu, cfg.niter
        rtol, atol = tols
        B = mu.shape[0]
        functions = self._bind(self._prologue_overrides(ov))
        refactored = lambda c: c[:3] + (
            plan.compute_factors(c[2], functions, batched=True),) + c[4:]
        # A carry without its factors: the caller drops the old ones before
        # the new ones are made, so that both never coexist (per-lane factors
        # of a large banded block are several (B, n) arrays).
        unfactored = lambda c: c[:3] + (None,) + c[4:]

        # Strided history: one slot per `stride` iterations (the last
        # in-window value wins).
        hist = (niter + stride - 1) // stride if record else 1
        slot = (lambda git: min(git // stride, hist - 1)) if record else (lambda git: 0)
        nan = lambda: torch.full((B, hist), float("nan"), dtype=torch.float64,
                                 device=self.device)
        # No lane's flag can change when neither tolerance can be met: then
        # the host never reads the flags.
        can_finish = rtol > 0 or atol > 0
        all_done = False if done0 is None or not read_done0 else bool(done0.all())
        # no lane to freeze when none starts done and none can finish
        freeze = can_finish or done0 is not None
        if done0 is None:
            done0 = torch.zeros(B, dtype=torch.bool, device=self.device)
        carry = refactored((x, h, mu, None, done0,
                            torch.zeros(B, dtype=torch.int32, device=self.device),
                            nan(), nan()))

        def step(carry, git, residuals=True):
            return plan.iteration(carry, slot(git), git, cfg, tols, functions,
                                  compute_residuals=residuals, freeze=freeze)

        # iteration 0, then refactor (the mu update fires at global_it=0,
        # reference optimizer.py:319-320)
        carry = unfactored(step(carry, 0))
        carry = refactored(carry)
        telemetry.check_chunk("BatchedSolver", carry[0], carry[1])
        it = 1
        while it < niter and not all_done:
            boundary = it + interval - 1
            for git in range(it, min(it + interval, niter)):
                # chunked checks: residuals, convergence and the penalty
                # update only on the chunk's boundary iteration
                carry = step(carry, git, not chunked_checks or git == boundary)
            carry = unfactored(carry)
            carry = refactored(carry)
            it += interval
            telemetry.check_chunk("BatchedSolver", carry[0], carry[1])
            if can_finish and it < niter:
                all_done = bool(carry[4].all())
        x, h, mu, _, done, count, pbuf, dbuf = carry
        return BatchResult(x=x, h=h, mu=mu, iterations=count, converged=done,
                           primal_residual=pbuf, dual_residual=dbuf)

    def solve(self,
              overrides: Optional[Dict] = None,
              batch_size: Optional[int] = None,
              x0: Optional[Sequence] = None,
              h0: Optional[Sequence] = None,
              mu0=1.0,
              niter: int = 10000,
              interval_update_mu: int = 100,
              update_h: bool = True,
              rtol: float = 1e-12,
              atol: float = 0.0,
              fact_incr: float = 2.0,
              th_change: float = 10.0,
              max_mu: float = 1e3,
              record_residuals: Union[bool, int] = True,
              dtype=None,
              chunked_checks: bool = False,
              done0=None,
              recipe: str = "auto",
              relax: float = 1.0) -> BatchResult:
        """Solve the batch.  Reference-default knobs
        (``optimizer.py:302-309,277,125``); ``atol`` adds an absolute
        primal+dual residual stop (0 = off); ``fact_incr``/``th_change``
        tune the penalty adaptation as the reference's ``update_mu``
        does; ``dtype`` overrides the solver's state dtype for this call
        (mixed-precision phases); ``x0``/``h0``/``mu0`` (scalar, (B,) or
        (B, npairs)) warm-start the state; ``chunked_checks=True``
        evaluates residuals/convergence/penalty adaptation only on
        penalty-boundary iterations (throughput mode — histories have one
        sample per ``interval_update_mu`` iterations and lanes may overrun
        their convergence point by up to one interval; the default
        preserves exact per-iteration reference semantics).

        ``record_residuals``: True = per-iteration histories ((B, niter)
        float64 buffers); an int ``s`` records one sample per ``s``
        iterations ((B, ceil(niter/s)) buffers, slot ``min(it // s,
        hist - 1)``); False = none.  ``done0``: optional (B,) bool mask of
        lanes to freeze from the start; frozen lanes keep their state, count
        no iterations and do not hold up the exit.

        ``recipe``: ``"plain"`` is the single-phase solve (exact reference
        trajectory semantics); ``"mixed"`` routes through
        :meth:`solve_mixed` with 3/4 of the budget in float32 and needs
        ``niter >= 2``; ``"auto"`` (default) is plain: when the mixed recipe
        pays on this hardware has not been measured."""
        if recipe not in ("auto", "plain", "mixed"):
            raise ValueError(f"recipe must be auto|plain|mixed, {recipe!r}")
        if recipe == "mixed":
            if niter < 2:
                raise ValueError(
                    "recipe='mixed' splits niter into two positive phases "
                    f"and needs niter >= 2, got {niter}")
            nl = 3 * niter // 4
            return self.solve_mixed(
                overrides, niter_low=nl, niter=niter - nl,
                # fixed-iteration runs (rtol=atol=0) burn the full f32
                # budget; convergence runs let phase 1 exit at plateau
                low_rtol=(0.0 if (rtol == 0.0 and atol == 0.0) else 1e-6),
                batch_size=batch_size, x0=x0, h0=h0, mu0=mu0,
                interval_update_mu=interval_update_mu, update_h=update_h,
                rtol=rtol, atol=atol, fact_incr=fact_incr,
                th_change=th_change, max_mu=max_mu,
                record_residuals=record_residuals,
                chunked_checks=chunked_checks, done0=done0, relax=relax,
                dtype=dtype)
        dtype = self._solve_dtype(dtype)
        overrides = dict(overrides or {})
        B = self._validate_overrides(overrides)
        if B is None:
            B = batch_size
        if B is None:
            raise ValueError(
                "batch size is undetermined: pass overrides with a leading "
                "batch axis or batch_size=")
        if batch_size is not None and batch_size != B:
            raise ValueError(f"batch_size={batch_size} != override batch {B}")
        cfg = self._config(niter, interval_update_mu, update_h, max_mu,
                           fact_incr, th_change, relax)
        record, stride = _parse_record_residuals(record_residuals)
        x, h, mu, done0 = self._initial_state(B, dtype, x0, h0, mu0, done0)
        ov = {k: _cast_like(dtype, v, self.device) for k, v in overrides.items()}
        return self._run(cfg, ov, x, h, mu, (rtol, atol), done0, record, stride,
                         bool(chunked_checks))

    def solve_path(self,
                   field: Tuple[int, str],
                   values,
                   overrides: Optional[Dict] = None,
                   group_size: Optional[int] = None,
                   fused: bool = True,
                   **kw) -> BatchResult:
        """Warm-started regularization-path continuation.

        Splits ``values`` (e.g. a descending λ grid) into groups of
        ``group_size``; each group solves as one batch, warm-started from
        the previous group's last lane (the nearest value's state).  For
        dense paths this cuts iteration counts several-fold versus cold
        starts.  Returns concatenated per-value results in input order;
        further ``overrides`` are per value (length ``len(values)``).

        ``fused=True`` (default) pads the last group by repeating the final
        value, so that every group has ``group_size`` lanes, and trims the
        padding from the result, as the JAX package's one-program form
        does; ``fused=False`` solves the shorter last group as it is.  Both
        give the same lanes.
        """
        values = np.asarray(values)
        n = values.shape[0]
        if group_size is None:
            group_size = n
        gs = int(group_size)
        if gs < n:
            # Warm starts broadcast the previous group's LAST lane state —
            # only sensible when consecutive values are nearest neighbors.
            d = np.diff(values.astype(np.float64))
            if not (np.all(d <= 0) or np.all(d >= 0)):
                raise ValueError(
                    "solve_path warm-starting requires a monotone `values` "
                    "grid (each group is seeded from the previous group's "
                    "last solution); sort the values or pass "
                    "group_size=len(values)")
        ov_all = {k: _asarray(v) for k, v in dict(overrides or {}).items()}
        ov_all[field] = _asarray(values)
        for (k, f_), v in ov_all.items():
            if v.shape[0] != n:
                raise ValueError(
                    f"solve_path override {(k, f_)} must be per-value "
                    f"(length {n}), got leading axis {v.shape[0]}")
        pad_n = (-n) % gs if fused and gs < n else 0
        ov_all = {k: _pad_last(v, pad_n) for k, v in ov_all.items()}
        mu0 = kw.pop("mu0", 1.0)
        x0, h0 = kw.pop("x0", None), kw.pop("h0", None)
        parts = []
        for s in range(0, n + pad_n, gs):
            ov = {k: v[s:s + gs] for k, v in ov_all.items()}
            prev = self.solve(ov, x0=x0, h0=h0, mu0=mu0, **kw)
            parts.append(prev)
            # warm start every lane of the next group from this group's
            # last (nearest) solution
            nxt = min(gs, n + pad_n - s - gs)
            take = lambda a: a[-1:].expand((nxt,) + tuple(a.shape[1:]))
            x0, h0 = tuple(map(take, prev.x)), tuple(map(take, prev.h))
            mu0 = take(prev.mu)
        return _trim(_concat(parts), n)

    def solve_scan(self,
                   overrides: Dict,
                   group_size: int = 1,
                   x0: Optional[Sequence] = None,
                   h0: Optional[Sequence] = None,
                   mu0=1.0,
                   niter: int = 10000,
                   interval_update_mu: int = 100,
                   update_h: bool = True,
                   rtol: float = 1e-12,
                   atol: float = 0.0,
                   fact_incr: float = 2.0,
                   th_change: float = 10.0,
                   max_mu: float = 1e3,
                   record_residuals: Union[bool, int] = False,
                   chunked_checks: bool = False,
                   relax: float = 1.0) -> BatchResult:
        """Sequential solve over groups of ``group_size`` instances.

        The fallback for batches of LARGE heterogeneous problems (per-
        instance ``(k, 'A')`` operators with n > 128): :meth:`solve` keeps
        every lane's dense factor resident ((B, n, n), which the n <= 128
        cap guards).  Here only ``group_size`` instances' factors exist at
        a time.  Reference analogue: one ``SimpleOptimizer`` per problem
        (``optimizer.py:121-152``).  The last group is padded by repeating
        the final instance; the padding is trimmed from the result.

        Wall-clock is sequential over ``B / group_size`` groups — use
        :meth:`solve` when the factor state fits.  ``record_residuals``
        defaults to False; the other knobs are those of :meth:`solve`
        (the recipe is plain, the dtype the solver's).
        """
        overrides = dict(overrides or {})
        B = self._validate_overrides(overrides, allow_large_A=True)
        if B is None:
            raise ValueError("solve_scan needs overrides with a leading "
                             "batch axis")
        g = int(group_size)
        pad_n = (-B) % g
        cfg = self._config(niter, interval_update_mu, update_h, max_mu,
                           fact_incr, th_change, relax)
        record, stride = _parse_record_residuals(record_residuals)
        x, h, mu, _ = self._initial_state(B, self.dtype, x0, h0, mu0, None)
        pad = lambda a: _pad_last(a, pad_n)
        x, h, mu = tuple(map(pad, x)), tuple(map(pad, h)), pad(mu)
        ov = {k: pad(_cast_like(self.dtype, v, self.device))
              for k, v in overrides.items()}
        parts = []
        for s in range(0, B + pad_n, g):
            grp = lambda a: a[s:s + g]
            parts.append(self._run(cfg, {k: grp(v) for k, v in ov.items()},
                                   tuple(map(grp, x)), tuple(map(grp, h)), grp(mu),
                                   (rtol, atol), None, record, stride,
                                   bool(chunked_checks)))
        return _trim(_concat(parts), B)

    def solve_resumable(self,
                        path: str,
                        overrides: Optional[Dict] = None,
                        checkpoint_every: int = 1000,
                        niter: int = 10000,
                        mu0=1.0,
                        **kw) -> BatchResult:
        """Preemption-tolerant solve: checkpoint every ``checkpoint_every``
        iterations, resume from ``path`` if it exists.

        The reference's only resume mechanism is a manual ``x0`` warm start
        (``optimizer.py:146-149``); this drives the same warm start segment
        by segment and persists the full carry (primal, dual, penalties,
        per-lane iteration counts, convergence flags) through
        :mod:`admmsolver_tpu_torch.utils.checkpoint` after each segment, in
        the layout the JAX package reads and writes.  Killing the process
        loses at most one segment.  The loop stops once every lane has
        converged; a checkpoint that already covers ``niter`` is returned
        without another solve.

        Each segment starts the ``interval_update_mu`` clock afresh (as a
        fresh solve from a warm start does), so pick ``checkpoint_every`` as
        a multiple of ``interval_update_mu`` to keep the uninterrupted
        schedule.
        """
        import os

        from ..utils.checkpoint import load_batch_result, save_batch_result

        # segments continue exact state; a mixed recipe's f32 phase would
        # truncate a warm-started carry mid-run
        kw.setdefault("recipe", "plain")
        x0 = h0 = None
        done_iters = 0
        total = None
        if os.path.exists(path):
            ckpt = load_batch_result(path, device=self.device)
            x0, h0, mu0 = ckpt.x, ckpt.h, ckpt.mu
            total = ckpt.iterations
            done_iters = int(total.max())
        res = None
        while done_iters < niter:
            n = min(int(checkpoint_every), niter - done_iters)
            res = self.solve(overrides, x0=x0, h0=h0, mu0=mu0, niter=n, **kw)
            x0, h0, mu0 = res.x, res.h, res.mu
            done_iters += n
            total = res.iterations if total is None else total + res.iterations
            res = dataclasses.replace(res, iterations=total)
            save_batch_result(path, res)
            if bool(res.converged.all()):
                break
        if res is None:
            # the checkpoint already covered the full budget
            res = load_batch_result(path, device=self.device)
        return res

    def solve_mixed(self,
                    overrides: Optional[Dict] = None,
                    niter_low: int = 2000,
                    niter: int = 10000,
                    low_dtype="float32",
                    low_rtol: float = 1e-6,
                    fused: bool = False,
                    dtype=None,
                    **kw) -> BatchResult:
        """Two-phase mixed-precision solve.

        Phase 1 iterates in ``low_dtype`` until the relative residual
        change plateaus at ``low_rtol`` or ``niter_low`` is reached; phase
        2 continues the SAME primal/dual/penalty state at full precision
        (``dtype`` when given, else the solver's) to the requested
        tolerance.  ADMM is self-correcting — the dual state carries the
        low-precision phase's progress exactly — so the hand-off costs
        nothing in final accuracy.  Iteration counts are summed and the
        histories concatenated; the other knobs go to both phases.

        ``fused`` is accepted for the JAX package's callers: there it
        selects a second program, here both settings run the same two
        calls and give the same result.  As there, ``fused=True`` polishes
        at the solver dtype only.
        """
        kw.pop("recipe", None)  # the phases ARE the recipe
        if fused and dtype is not None and _as_dtype(dtype) != self.dtype:
            raise ValueError(
                "the fused mixed solve always polishes at the "
                "solver dtype; construct the solver with the "
                "desired full precision or use fused=False")
        if niter_low <= 0 or niter <= 0:
            raise ValueError("phase iteration budgets must be positive")
        p1 = self.solve(overrides, niter=niter_low, dtype=low_dtype,
                        rtol=low_rtol, recipe="plain",
                        **{k: v for k, v in kw.items()
                           if k not in ("rtol", "atol")})
        # phase 2 continues phase 1's state at the FULL precision — the
        # caller's explicit dtype when given, else the solver dtype.  Lanes
        # that phase 1 finished start anew: only the caller's done0 skips
        # the polish.
        p2 = self.solve(overrides, x0=p1.x, h0=p1.h, mu0=p1.mu,
                        niter=niter, recipe="plain", dtype=dtype,
                        **{k: v for k, v in kw.items()
                           if k not in ("mu0", "x0", "h0")})
        return BatchResult(
            x=p2.x, h=p2.h, mu=p2.mu,
            iterations=p1.iterations + p2.iterations,
            converged=p2.converged,
            primal_residual=torch.cat(
                [p1.primal_residual, p2.primal_residual], dim=1),
            dual_residual=torch.cat(
                [p1.dual_residual, p2.dual_residual], dim=1))
