"""``FusedSpMSolver.solve_mixed(fused=True)``: the kernel phase in float32 (up
to ``niter_low`` iterations, a lane stopping once its summed residuals fall
below ``low_atol``), the hand-off on the card, then the float64 polish of the
batched engine to ``rtol``; one program.  Held to the plain reference of both
phases in float64.  Control: the program's own float32 path
(``FusedSpMSolver.solve`` with the same stopping rule and the whole budget)."""
from __future__ import annotations

import torch

from ..references import admm


class Entry:
    problems = ("spm",)
    control = "program_f32"

    def __init__(self, ctx) -> None:
        from admmsolver_tpu_torch.parallel import FusedSpMSolver

        self.ctx = ctx
        self.solver = FusedSpMSolver(ctx.problem.port_model(ctx.cfg, ctx.fix), device=ctx.device)
        s = ctx.work["solve"]
        self.kw = dict(niter_low=int(s["niter_low"]), niter=int(s["niter"]),
                       mu0=float(s.get("mu0", 1.0)), low_atol=float(s.get("low_atol", 1e-5)),
                       rtol=float(s.get("rtol", 1e-12)), atol=float(s.get("atol", 0.0)),
                       interval_update_mu=int(s.get("interval", 100)))

    def prepare(self, batch: dict) -> dict:
        return self.ctx.overrides(batch, torch.float64)

    def call(self, inputs: dict):
        return self.solver.solve_mixed(inputs, fused=True, **self.kw)

    @staticmethod
    def outputs(r) -> dict:
        return {"x": r.x, "iterations": r.iterations, "converged": r.converged}

    def reference(self, fix: dict, batch: dict) -> dict:
        kw = self.kw
        low = admm.Knobs(niter=kw["niter_low"], interval=kw["interval_update_mu"], rtol=0.0,
                         atol=kw["low_atol"], checks="chunk")
        polish = admm.Knobs(niter=kw["niter"], interval=kw["interval_update_mu"],
                            rtol=kw["rtol"], atol=kw["atol"], checks="iteration")
        st = self.ctx.reference.solve_mixed(fix, batch, kw["mu0"], low, polish)
        return {"x": st.x, "iterations": st.count, "converged": st.done}

    def control_entry(self):
        """The same calls through the program's float32 path: the kernel alone
        with the polish's stopping rule over both phases' budget."""
        return _Float32(self)


class _Float32:
    def __init__(self, entry: Entry) -> None:
        kw = entry.kw
        self.ctx, self.solver = entry.ctx, entry.solver
        self.kw = dict(niter=kw["niter_low"] + kw["niter"], mu0=kw["mu0"], rtol=kw["rtol"],
                       atol=kw["atol"], interval_update_mu=kw["interval_update_mu"])

    def prepare(self, batch: dict) -> dict:
        return self.ctx.overrides(batch, torch.float32)

    def call(self, inputs: dict):
        return self.solver.solve(inputs, **self.kw)

    outputs = staticmethod(Entry.outputs)
