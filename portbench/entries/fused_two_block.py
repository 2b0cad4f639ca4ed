"""``FusedTwoBlockSolver.solve``: every chunk one launch of the two-block chunk
kernel, the chunk a captured graph; float32.  Held to the plain reference in
float64 with the solver's chunk schedule (residuals, stopping rule and
penalty update read at the end of each chunk).  Control: the reference in
the program's place with TF32 products."""
from __future__ import annotations

import torch

from ..references import admm


class Entry:
    problems = ("basis_pursuit",)
    control = "tf32"

    def __init__(self, ctx) -> None:
        from admmsolver_tpu_torch.parallel import FusedTwoBlockSolver

        self.ctx = ctx
        self.solver = FusedTwoBlockSolver(ctx.problem.port_model(ctx.cfg, ctx.fix),
                                          device=ctx.device)
        s = ctx.work["solve"]
        self.kw = dict(niter=int(s["niter"]), rtol=float(s.get("rtol", 0.0)),
                       atol=float(s.get("atol", 0.0)), mu0=float(s.get("mu0", 1.0)),
                       interval_update_mu=int(s.get("interval", 100)))

    def prepare(self, batch: dict) -> dict:
        return self.ctx.overrides(batch, torch.float32)

    def call(self, inputs: dict):
        return self.solver.solve(inputs, **self.kw)

    @staticmethod
    def outputs(r) -> dict:
        return {"x": (r.x0, r.x1), "iterations": r.iterations, "converged": r.converged}

    def reference(self, fix: dict, batch: dict) -> dict:
        kw = self.kw
        knobs = admm.Knobs(niter=kw["niter"], interval=kw["interval_update_mu"],
                           rtol=kw["rtol"], atol=kw["atol"], checks="chunk")
        st = self.ctx.reference.solve(fix, batch, kw["mu0"], knobs)
        return {"x": st.x, "iterations": st.count, "converged": st.done}
