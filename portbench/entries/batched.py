"""``BatchedSolver.solve`` in the workload's dtype (float64 by default): the
batched engine, its entry and chunks captured graphs, the stopping rule read
after every iteration.  Held to the plain reference in float64 with the same
rule.  Control: the program's own float32 path (``BatchedSolver(dtype=
float32)``) on the same calls."""
from __future__ import annotations

import torch

from ..references import admm


class Entry:
    problems = ("basis_pursuit", "spm")
    control = "program_f32"

    def __init__(self, ctx, dtype=None) -> None:
        from admmsolver_tpu_torch.parallel import BatchedSolver

        self.ctx = ctx
        s = ctx.work["solve"]
        self.dtype = dtype or getattr(torch, s.get("dtype", "float64"))
        self.solver = BatchedSolver(ctx.problem.port_model(ctx.cfg, ctx.fix), dtype=self.dtype,
                                    device=ctx.device)
        self.kw = dict(niter=int(s["niter"]), rtol=float(s.get("rtol", 0.0)),
                       atol=float(s.get("atol", 0.0)), mu0=float(s.get("mu0", 1.0)),
                       interval_update_mu=int(s.get("interval", 100)))

    def prepare(self, batch: dict) -> dict:
        return self.ctx.overrides(batch, self.dtype)

    def call(self, inputs: dict):
        return self.solver.solve(inputs, **self.kw)

    @staticmethod
    def outputs(r) -> dict:
        return {"x": r.x, "iterations": r.iterations, "converged": r.converged}

    def reference(self, fix: dict, batch: dict) -> dict:
        kw = self.kw
        knobs = admm.Knobs(niter=kw["niter"], interval=kw["interval_update_mu"],
                           rtol=kw["rtol"], atol=kw["atol"], checks="iteration")
        st = self.ctx.reference.solve(fix, batch, kw["mu0"], knobs)
        return {"x": st.x, "iterations": st.count, "converged": st.done}

    def control_entry(self):
        """The same calls through the program's float32 path."""
        return Entry(self.ctx, dtype=torch.float32)
