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
keeps the lane state on the host between waves; :meth:`run_stacked` keeps
it on the device in one wave program (:class:`_WaveProgram`), whose entry,
chunks and exit (the harvest and refill) are replays of captured graphs
where a solve's chunks are: a stream of stacked tensors in, a
:class:`StreamResult` of tensors out, all on the solver's device.
:meth:`run_compiled` is the same drain for a list of per-scenario dicts,
stacked on the host and unpacked into :class:`ScenarioResult` s.

On a sharded solver every rank drives the same stream through :meth:`run`:
each wave's flags, counts and states are gathered to every rank, so that all
ranks harvest and refill the same lanes and return every result.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Tuple

import numpy as np
import torch

from ..models.objectivefunc import raise_if_not_pd
from ..ops.linop import _real_dtype
from ..utils import telemetry
from . import batch
from .batch import BatchedSolver, _cast_like

__all__ = ["ScenarioScheduler", "ScenarioResult", "StreamResult"]


@dataclasses.dataclass
class ScenarioResult:
    """Outcome of one scenario."""

    scenario_id: int
    x: Tuple[np.ndarray, ...]
    iterations: int
    converged: bool
    final_mu: np.ndarray


@dataclasses.dataclass
class StreamResult:
    """Outcome of a stacked stream (:meth:`ScenarioScheduler.run_stacked`),
    row ``s`` scenario ``s``, every tensor on the solver's device: ``x``
    one (S, n) tensor a block, ``iterations`` (S,), ``converged`` (S,) and
    ``final_mu`` (S, npairs)."""

    x: Tuple[torch.Tensor, ...]
    iterations: torch.Tensor
    converged: torch.Tensor
    final_mu: torch.Tensor


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

    @telemetry.spanned(telemetry.SOLVE)
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

    @telemetry.spanned(telemetry.SOLVE)
    def run_compiled(self, scenarios: Iterable[Dict]) -> List[ScenarioResult]:
        """Drain a materialized stream with the lane state kept on the device:
        the scenarios stacked on the host into ``(S, ...)`` arrays, then
        :meth:`run_stacked`, then one :class:`ScenarioResult` a scenario.

        The JAX package runs this as one compiled ``while_loop`` (one
        dispatch for the whole stream, ``scheduler.py:164-323``).  Here it
        is one wave program (:class:`_WaveProgram`) whose waves the host
        starts (:meth:`run_stacked`).  Semantics match :meth:`run`.
        """
        scen = list(scenarios)
        if not scen:
            return []
        with telemetry.span("admm.stream_in"):
            keys = tuple(sorted(scen[0].keys()))
            for sid, ov in enumerate(scen):
                if tuple(sorted(ov.keys())) != keys:
                    raise ValueError(f"scenario {sid} keys {sorted(ov.keys())} != {keys}")
            stacks = {k: torch.as_tensor(np.stack([np.asarray(ov[k]) for ov in scen]))
                      for k in keys}
        r = self.run_stacked(stacks)
        xs = [a.cpu().numpy() for a in r.x]
        mus, its, cvs = (a.cpu().numpy() for a in (r.final_mu, r.iterations, r.converged))
        return [ScenarioResult(scenario_id=s, x=tuple(a[s].copy() for a in xs),
                               iterations=int(its[s]), converged=bool(cvs[s]),
                               final_mu=mus[s].copy())
                for s in range(len(scen))]

    @telemetry.spanned(telemetry.SOLVE)
    def run_stacked(self, overrides: Dict) -> StreamResult:
        """Drain a stream of stacked scenarios with the lane state kept on
        the device.

        ``overrides``: ``{(block, field): tensor (S, ...)}``, row ``s``
        scenario ``s``, on any device and in any dtype; cast to the
        solver's dtype (floats to its real type, complex to its complex
        type: :func:`~admmsolver_tpu_torch.parallel.batch._cast_like`) and
        device.  Each wave's entry gathers every lane's rows by its
        scenario id, its chunks run the wave's iterations, and its exit
        scatters the finished lanes into ``(S+1)``-row outputs (row S takes
        the lanes that finish nothing) and refills the freed lanes with the
        next scenarios in lane order, zero state and ``mu0``: the lanes
        :meth:`run` assigns.  The host reads one number a wave, the count
        of harvested scenarios (with the factorizations' failure flag),
        beside the done flags the chunks read where a wave has more than
        one and a lane can finish.

        Semantics match :meth:`run`.  ``solve_kw`` beyond the penalty knobs
        and ``recipe="plain"``, and a sharded solver (whose lanes are spread
        over the ranks), fall back to :meth:`run` over the rows; the result
        is stacked all the same.
        """
        solver = self.solver
        S = solver._validate_overrides(overrides)
        if S is None:
            raise ValueError("run_stacked needs at least one override to stack the stream on")
        dtype, dev = solver.dtype, solver.device
        # solve()'s dtype discipline: f64 scenario values must not promote
        # an f32 solve
        stacks = {k: _cast_like(dtype, overrides[k], dev) for k in sorted(overrides)}
        extra = {k: v for k, v in self.solve_kw.items()
                 if k not in ("interval_update_mu", "update_h", "fact_incr",
                              "th_change", "max_mu", "recipe")}
        if (extra or self.solve_kw.get("recipe", "plain") != "plain"
                or solver.sharding is not None or S == 0):
            rows = {k: _host(v) for k, v in stacks.items()}
            res = self.run({k: v[s] for k, v in rows.items()} for s in range(S))
            return self._stacked(res)

        kw = self.solve_kw
        cfg = solver._config(self.chunk_iters, kw.get("interval_update_mu", 100),
                             kw.get("update_h", True), kw.get("max_mu", 1e3),
                             kw.get("fact_incr", 2.0), kw.get("th_change", 10.0), 1.0)
        tols = (self.rtol, self.atol)
        program = self._program(cfg, stacks, S, tols)
        program.load(tols, stacks, self.mu0)
        capture = solver._programs.captures(solver.model.functions, dtype)
        pool = solver._programs.graph_pool(capture)
        while not program.wave(capture, pool):
            pass
        out = program.results()
        if telemetry.enabled():
            telemetry.count("stream.lane_iters", int(out.iterations.sum()))
        return out

    def _stacked(self, res: List[ScenarioResult]) -> StreamResult:
        """The results of :meth:`run` as one :class:`StreamResult` (the
        counts int32, as the wave program keeps them)."""
        plan, dev, S = self.solver.plan, self.solver.device, len(res)
        rows = lambda vals, dt, *shape: torch.as_tensor(
            np.array(vals, dtype=dt).reshape((S,) + shape), device=dev)
        xdt, rdt = (torch.empty(0, dtype=d).numpy().dtype
                    for d in (self.solver.dtype, _real_dtype(self.solver.dtype)))
        return StreamResult(
            x=tuple(rows([r.x[b] for r in res], xdt, n) for b, n in enumerate(plan.block_sizes)),
            iterations=rows([r.iterations for r in res], np.int32),
            converged=rows([r.converged for r in res], np.bool_),
            final_mu=rows([r.final_mu for r in res], rdt, plan.npairs))

    def _program(self, cfg, stacks: Dict, S: int, tols) -> "_WaveProgram":
        """The stream's wave program, made on a miss.  The key: the JAX
        package's ``("stream", cfg, keys, S, B, niter_max)``
        (``scheduler.py:228``) with each key's row shape and dtype, the
        solver's dtype and device and whether a lane can finish (and the
        route switches a graph keeps: :class:`~admmsolver_tpu_torch.parallel.
        batch._ProgramCache`); ``mu0`` is a value of the program.  A solver
        keeps the stacks of one stream: a program of another key drops the
        others."""
        programs = self.solver._programs

        def build() -> _WaveProgram:
            for other in [k for k, p in programs.items() if isinstance(p, _WaveProgram)]:
                del programs[other]
            return _WaveProgram(self.solver, cfg, {k: batch._fresh(v) for k, v in stacks.items()},
                                S, self.B, self.niter_max, tols)

        return programs.program(
            ("stream", cfg, tuple((k, tuple(v.shape[1:]), v.dtype) for k, v in stacks.items()),
             S, self.B, self.niter_max, self.solver.dtype, str(self.solver.device),
             tols[0] > 0 or tols[1] > 0), build)


class _WaveProgram(batch._FedProgram):
    """A wave of :meth:`ScenarioScheduler.run_stacked`: the body of the JAX
    package's ``while_loop`` (``scheduler.py:263-296``) step for step, as a
    fed program of B lanes (:class:`~admmsolver_tpu_torch.parallel.batch.
    _FedProgram`) whose state buffers carry the lanes from wave to wave.

    It holds the (S, ...) scenario overrides, the lanes' scenario ids
    (``sid``, -1 for a parked lane), their iteration counts, the next
    scenario (``nxt``), the harvested count, ``mu0`` and the (S+1)-row
    outputs of x, mu, the counts and the flags.  A wave:

    * the entry gathers each lane's overrides by ``sid.clamp_min(0)`` and
      runs the prologue, the factors and iteration 0 from the carried
      state, the parked lanes done from the start;
    * the chunks of the wave's iterations;
    * the exit scatters the finished lanes (converged, or at ``niter_max``)
      into their rows, refills them with the next scenarios in lane order
      (parks them once the stream is drained), zeroes x and h and resets mu
      to ``mu0`` and the counts to 0 of every lane it refills or parks,
      and advances ``nxt`` and the harvested count.

    Each step is captured where a solve's chunks are."""

    def __init__(self, solver: BatchedSolver, cfg, stacks: Dict, S: int, B: int,
                 niter_max: int, tols) -> None:
        plan, dev, dtype = solver.plan, solver.device, solver.dtype
        rdt = _real_dtype(dtype)
        self.S, self.niter_max = S, niter_max
        zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=dev)
        out = (tuple(zeros(S + 1, n) for n in plan.block_sizes)
               + (zeros(S + 1, plan.npairs, dt=rdt), zeros(S + 1, dt=torch.int32),
                  zeros(S + 1, dt=torch.bool)))
        # copies of the first run's stacks, which no one else holds, become the stacks
        feed = batch._Feed(dict(stacks), None, out=out)
        # the buffers sized by a wave of the first scenarios
        first = torch.arange(B, device=dev).clamp_max(S - 1)
        super().__init__(solver, cfg, feed, solver._bound(
            {k: v.index_select(0, first) for k, v in feed.ov.items()}), B, dtype, tols, False, 1,
            False, freeze=True)
        self.sid = zeros(B, dt=torch.long)
        self.iters = zeros(B, dt=torch.int32)
        self.nxt, self.harvested = zeros(dt=torch.long), zeros(dt=torch.long)
        # the harvested count of the last read (the host's copy)
        self.seen = 0
        self.mu0 = zeros(dt=rdt)

    def load(self, tols, stacks: Dict, mu0: float) -> None:
        """A run's tolerances, scenarios and ``mu0``: scenarios 0..B-1 in
        the lanes (the lanes beyond S parked), zero state, empty outputs."""
        super().load(tols, stacks)
        B = self.sid.shape[0]
        torch.arange(B, out=self.sid)
        self.sid.masked_fill_(self.sid >= self.S, -1)
        self.nxt.fill_(min(B, self.S))
        self.harvested.zero_()
        self.seen = 0
        self.iters.zero_()
        self.mu0.fill_(mu0)
        for a in self.x + self.h + self.feed.out:
            a.zero_()
        self.mu.fill_(mu0)

    def _overrides(self) -> Dict:
        sidc = self.sid.clamp_min(0)
        return {k: v.index_select(0, sidc) for k, v in self.feed.ov.items()}

    def _done0(self) -> torch.Tensor:
        return self.sid < 0

    def _exit(self) -> None:
        S = self.S
        parked = self.sid < 0
        sidc = self.sid.clamp_min(0)
        iters = self.iters + self.count
        fin = ~parked & (self.done | (iters >= self.niter_max))
        slot = torch.where(fin, sidc, S)
        for o, a in zip(self.feed.out, self.x + (self.mu, iters, self.done)):
            o.index_copy_(0, slot, a)
        # refill the finished lanes with the next scenarios, in lane order;
        # park them once the stream is drained
        cand = self.nxt + torch.cumsum(fin.long(), 0) - 1
        refill = fin & (cand < S)
        keep = ~fin & ~parked
        self.sid.copy_(torch.where(refill, cand, torch.where(fin, -1, self.sid)))
        for a in self.x + self.h:
            a.copy_(torch.where(keep[:, None], a, 0.0))
        self.mu.copy_(torch.where(keep[:, None], self.mu, self.mu0))
        self.iters.copy_(torch.where(keep, iters, 0))
        nfin = fin.sum()
        self.nxt.add_(nfin)
        self.harvested.add_(nfin)

    def _run_chunk(self, key, capture: bool, pool) -> None:
        """A step of the wave, its lane slots counted: B a wave iteration,
        the entry's iteration 0 and the chunks'."""
        super()._run_chunk(key, capture, pool)
        if key != "exit":
            telemetry.count("stream.slot_iters", self.sid.shape[0] * (1 if key == "entry" else key))

    def wave(self, capture: bool, pool) -> bool:
        """One wave (:meth:`run_group`); whether the stream is drained, from
        the wave's one host read of the harvested count, which also takes
        the failure flag of the factorizations (raised here).  Counts the
        wave and the scenarios it harvested."""
        with telemetry.span("admm.wave"):
            self.run_group(capture, pool)
            with telemetry.span("admm.flags_read"):
                telemetry.count("flag_reads")
                harvested, failures = torch.stack(
                    [self.harvested, self.failed.to(torch.int64)]).tolist()
            raise_if_not_pd(failures > 0)
            telemetry.count("waves")
            telemetry.count("scenarios_out", harvested - self.seen)
            self.seen = harvested
        return harvested >= self.S

    def buffers(self) -> Tuple[torch.Tensor, ...]:
        return super().buffers() + (self.sid, self.iters, self.nxt, self.harvested, self.mu0)

    @telemetry.spanned("admm.result")
    def results(self) -> StreamResult:
        """Every scenario's result, copied out of the outputs that the next
        run overwrites."""
        S, nx = self.S, len(self.x)
        outs = [o[:S].clone() for o in self.feed.out]
        mus, its, cvs = outs[nx:]
        return StreamResult(x=tuple(outs[:nx]), iterations=its, converged=cvs, final_mu=mus)
