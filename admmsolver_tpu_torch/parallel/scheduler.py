"""Scenario scheduler: continuous batching over a stream of problems.

Counterpart of :mod:`admmsolver_tpu.parallel.scheduler`.  When there are
more independent problem instances (scenarios) than fit one batch — many
per-frequency SpM problems, dense λ grids — a fixed-width batch runs on the
device and the scheduler swaps **converged lanes out and fresh scenarios
in** between waves of ``chunk_iters`` iterations, instead of waiting for
the slowest lane of a static batch.

Runs on top of :class:`~admmsolver_tpu_torch.parallel.batch.BatchedSolver`.
The penalty-update schedule restarts every wave, as the reference's does
under repeated ``solve()`` calls (``optimizer.py:310,319``).  :meth:`run`
keeps the lane state on the host between waves; :meth:`run_compiled` keeps
it on the device and does the harvest and refill as tensor code there.

On a sharded solver every rank drives the same stream through :meth:`run`:
each wave's flags, counts and states are gathered to every rank, so that all
ranks harvest and refill the same lanes and return every result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..ops.linop import _real_dtype
from .batch import BatchedSolver, _cast_like

__all__ = ["ScenarioScheduler", "ScenarioResult"]


@dataclasses.dataclass
class ScenarioResult:
    """Outcome of one scenario."""

    scenario_id: int
    x: Tuple[np.ndarray, ...]
    iterations: int
    converged: bool
    final_mu: np.ndarray


def _host(a: torch.Tensor) -> np.ndarray:
    # a copy: lanes of the host mirrors are overwritten on reload
    return np.array(a.detach().cpu().numpy())


class ScenarioScheduler:
    """Drain a stream of scenarios through a fixed-width batch.

    ``scenarios``: iterable of override dicts ``{(block, field): value}``
    (unbatched per-instance values, the same keys for every scenario).
    Lanes whose problem converges (``atol``/``rtol``) or exhausts
    ``niter_max`` are harvested and refilled after each
    ``chunk_iters``-iteration wave.  ``solve_kw`` go to every wave's solve.
    """

    def __init__(self, solver: BatchedSolver, batch_size: int,
                 chunk_iters: int = 100, niter_max: int = 10000,
                 rtol: float = 1e-12, atol: float = 0.0,
                 mu0: float = 1.0, **solve_kw) -> None:
        self.solver = solver
        self.B = int(batch_size)
        self.chunk_iters = int(chunk_iters)
        self.niter_max = int(niter_max)
        self.rtol = rtol
        self.atol = atol
        self.mu0 = float(mu0)
        # waves continue exact per-lane state; a mixed recipe would truncate
        # warm-started carries to f32 each wave
        solve_kw.setdefault("recipe", "plain")
        self.solve_kw = solve_kw

    def run(self, scenarios: Iterable[Dict]) -> List[ScenarioResult]:
        """Drain a (possibly lazy) stream: one ``BatchedSolver.solve`` per
        wave, with the lane state mirrored on the host in between."""
        plan = self.solver.plan
        it = iter(enumerate(scenarios))
        B = self.B

        first = next(it, None)
        if first is None:
            return []
        sid0, ov0 = first
        keys = tuple(sorted(ov0.keys()))

        lane_sid = np.full(B, -1, dtype=np.int64)
        lane_iters = np.zeros(B, dtype=np.int64)
        lane_ov = {k: np.zeros((B,) + np.shape(np.asarray(ov0[k])),
                               dtype=np.asarray(ov0[k]).dtype)
                   for k in keys}
        dtype = torch.empty(0, dtype=self.solver.dtype).numpy().dtype
        x = [np.zeros((B, n), dtype=dtype) for n in plan.block_sizes]
        h = [np.zeros((B, s), dtype=dtype) for s in plan.pair_sizes]
        mu = np.full((B, plan.npairs), self.mu0)

        def load(lane: int, sid: int, ov: Dict) -> None:
            if tuple(sorted(ov.keys())) != keys:
                raise ValueError(f"scenario {sid} keys {sorted(ov.keys())} != {keys}")
            lane_sid[lane] = sid
            lane_iters[lane] = 0
            for k in keys:
                lane_ov[k][lane] = np.asarray(ov[k])
            for a in x + h:
                a[lane] = 0
            mu[lane] = self.mu0

        load(0, sid0, ov0)
        pending = True
        for lane in range(1, B):
            nxt = next(it, None)
            if nxt is None:
                pending = False
                break
            load(lane, *nxt)

        results: List[ScenarioResult] = []
        while (lane_sid >= 0).any():
            res = self.solver._gathered(self.solver.solve(
                overrides={k: lane_ov[k] for k in keys},
                x0=tuple(x), h0=tuple(h), mu0=mu,
                niter=self.chunk_iters, rtol=self.rtol, atol=self.atol,
                record_residuals=False,
                # parked lanes (drained stream) freeze from iteration 0
                # instead of re-solving their old problem every wave
                done0=lane_sid < 0,
                **self.solve_kw), B)
            x = [_host(a) for a in res.x]
            h = [_host(a) for a in res.h]
            mu = _host(res.mu)
            conv = _host(res.converged)
            lane_iters += _host(res.iterations)

            for lane in range(B):
                if lane_sid[lane] < 0:
                    continue
                if not (conv[lane] or lane_iters[lane] >= self.niter_max):
                    continue
                results.append(ScenarioResult(
                    scenario_id=int(lane_sid[lane]),
                    x=tuple(a[lane].copy() for a in x),
                    iterations=int(lane_iters[lane]),
                    converged=bool(conv[lane]),
                    final_mu=mu[lane].copy()))
                nxt = next(it, None) if pending else None
                if nxt is None:
                    pending = False
                    lane_sid[lane] = -1   # park the lane
                    lane_iters[lane] = 0
                else:
                    load(lane, *nxt)

        results.sort(key=lambda r: r.scenario_id)
        return results

    def run_compiled(self, scenarios: Iterable[Dict]) -> List[ScenarioResult]:
        """Drain a materialized stream with the lane state kept on the device.

        The JAX package runs this as one compiled ``while_loop`` (one
        dispatch for the whole stream).  Here it is a Python loop over waves
        whose bookkeeping is tensor code on the device: the overrides of all
        S scenarios are staged as ``(S, ...)`` tensors in the solver's dtype,
        lanes gather their scenario's rows, finished lanes scatter into
        ``(S+1)``-row outputs (row S takes the lanes that finish nothing),
        and freed lanes take the next scenarios in lane order with zero state
        and ``mu0`` — the lanes :meth:`run` assigns.  The host reads one
        number per wave, the count of harvested scenarios.

        Semantics match :meth:`run`.  ``solve_kw`` beyond the penalty knobs
        and ``recipe="plain"``, and a sharded solver (whose lanes are spread
        over the ranks), fall back to :meth:`run`.
        """
        scen = list(scenarios)
        if not scen:
            return []
        extra = {k: v for k, v in self.solve_kw.items()
                 if k not in ("interval_update_mu", "update_h", "fact_incr",
                              "th_change", "max_mu", "recipe")}
        if (extra or self.solve_kw.get("recipe", "plain") != "plain"
                or self.solver.sharding is not None):
            return self.run(scen)

        solver = self.solver
        plan = solver.plan
        keys = tuple(sorted(scen[0].keys()))
        for sid, ov in enumerate(scen):
            if tuple(sorted(ov.keys())) != keys:
                raise ValueError(f"scenario {sid} keys {sorted(ov.keys())} != {keys}")
        solver._validate_overrides({k: np.stack([np.asarray(scen[0][k])]) for k in keys})
        S, B = len(scen), self.B
        dtype, dev = solver.dtype, solver.device
        # solve()'s dtype discipline: f64 scenario values must not promote
        # an f32 solve
        ov_all = {k: _cast_like(dtype, np.stack([np.asarray(ov[k]) for ov in scen]), dev)
                  for k in keys}
        kw = self.solve_kw
        cfg = solver._config(self.chunk_iters, kw.get("interval_update_mu", 100),
                             kw.get("update_h", True), kw.get("max_mu", 1e3),
                             kw.get("fact_incr", 2.0), kw.get("th_change", 10.0), 1.0)
        tols = (self.rtol, self.atol)
        niter_max, mu0 = self.niter_max, self.mu0

        zeros = lambda rows, n, dt=dtype: torch.zeros((rows, n), dtype=dt, device=dev)
        x = tuple(zeros(B, n) for n in plan.block_sizes)
        h = tuple(zeros(B, s) for s in plan.pair_sizes)
        mu = torch.full((B, plan.npairs), mu0, dtype=_real_dtype(dtype), device=dev)
        # initial fill: scenarios 0..B-1, lanes beyond S parked
        sid = torch.arange(B, device=dev)
        sid = torch.where(sid < S, sid, -1)
        nxt = torch.tensor(min(B, S), device=dev)
        harvested = torch.tensor(0, device=dev)
        iters = torch.zeros(B, dtype=torch.int32, device=dev)
        # row S is the write-off slot of the lanes that finish nothing
        outx = [zeros(S + 1, n) for n in plan.block_sizes]
        outmu = zeros(S + 1, plan.npairs, mu.dtype)
        outit = torch.zeros(S + 1, dtype=torch.int32, device=dev)
        outcv = torch.zeros(S + 1, dtype=torch.bool, device=dev)

        while int(harvested) < S:
            parked = sid < 0
            sidc = sid.clamp_min(0)
            ov_lane = {k: v.index_select(0, sidc) for k, v in ov_all.items()}
            res = solver._run(cfg, ov_lane, x, h, mu, tols, parked, record=False,
                              stride=1, chunked_checks=False, read_done0=False)
            iters2 = iters + res.iterations
            fin = ~parked & (res.converged | (iters2 >= niter_max))
            slot = torch.where(fin, sidc, S)
            for o, a in zip(outx, res.x):
                o[slot] = a
            outmu[slot] = res.mu
            outit[slot] = iters2
            outcv[slot] = res.converged
            # refill finished lanes with the next scenarios in lane order;
            # park them when the stream is drained
            cand = nxt + torch.cumsum(fin.long(), 0) - 1
            refill = fin & (cand < S)
            sid = torch.where(refill, cand, torch.where(fin, -1, sid))
            keep = ~fin & ~parked
            kb = keep[:, None]
            x = tuple(torch.where(kb, a, 0.0) for a in res.x)
            h = tuple(torch.where(kb, a, 0.0) for a in res.h)
            mu = torch.where(kb, res.mu, mu0)
            iters = torch.where(keep, iters2, 0)
            nfin = fin.sum()
            nxt = nxt + nfin
            harvested = harvested + nfin

        xs = [o[:S].cpu().numpy() for o in outx]
        its, cvs, mus = (t[:S].cpu().numpy() for t in (outit, outcv, outmu))
        return [ScenarioResult(scenario_id=s, x=tuple(a[s].copy() for a in xs),
                               iterations=int(its[s]), converged=bool(cvs[s]),
                               final_mu=mus[s].copy())
                for s in range(S)]
