"""``ScenarioScheduler.run_stacked`` in the workload's dtype (float64 by
default): a call drains one stream of ``lanes`` scenarios through
``solve.batch`` lanes of the wave program (``parallel/scheduler.py``), in
waves of ``solve.chunk`` iterations, a lane harvested once its scenario
reaches ``atol`` / ``rtol`` or ``solve.niter`` iterations and refilled with
the next.  Held to the plain reference in float64: each scenario solved
alone by one continuous run with the same rule.  Control: the program's own
float32 path (``BatchedSolver(dtype=float32)``) on the same calls."""
from __future__ import annotations

import torch

from ..references import admm


class Entry:
    problems = ("bp_stream",)
    control = "program_f32"

    def __init__(self, ctx, dtype=None) -> None:
        from admmsolver_tpu_torch.parallel import BatchedSolver, ScenarioScheduler

        self.ctx = ctx
        s = ctx.work["solve"]
        self.dtype = dtype or getattr(torch, s.get("dtype", "float64"))
        solver = BatchedSolver(ctx.problem.port_model(ctx.cfg, ctx.fix), dtype=self.dtype,
                               device=ctx.device)
        # the penalty interval is the wave: the reference's continuous run is
        # then the stream's answer (references/bp_stream.py)
        self.kw = dict(niter=int(s["niter"]), interval=int(s["chunk"]),
                       rtol=float(s.get("rtol", 0.0)), atol=float(s.get("atol", 0.0)),
                       mu0=float(s.get("mu0", 1.0)))
        # a stream shorter than the lanes takes a lane a scenario
        self.solver = ScenarioScheduler(
            solver, batch_size=min(int(s["batch"]), int(ctx.work["lanes"])),
            chunk_iters=self.kw["interval"], niter_max=self.kw["niter"], rtol=self.kw["rtol"],
            atol=self.kw["atol"], mu0=self.kw["mu0"], interval_update_mu=self.kw["interval"])

    def prepare(self, batch: dict) -> dict:
        return self.ctx.overrides(batch, self.dtype)

    def call(self, inputs: dict):
        return self.solver.run_stacked(inputs)

    @staticmethod
    def outputs(r) -> dict:
        return {"x": r.x, "iterations": r.iterations, "converged": r.converged}

    def reference(self, fix: dict, batch: dict) -> dict:
        kw = self.kw
        knobs = admm.Knobs(niter=kw["niter"], interval=kw["interval"], rtol=kw["rtol"],
                           atol=kw["atol"], checks="iteration")
        st = self.ctx.reference.solve(fix, batch, kw["mu0"], knobs)
        return {"x": st.x, "iterations": st.count, "converged": st.done}

    def control_entry(self):
        """The same calls through the program's float32 path."""
        return Entry(self.ctx, dtype=torch.float32)
