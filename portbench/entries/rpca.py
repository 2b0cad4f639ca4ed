"""Robust PCA through ``BatchedSolver.solve`` in the workload's dtype (float64
by default), as the ``batched`` entry drives it: PCP background subtraction,
a camera's video a lane, its Y the L1 block's ``offset``; the engine's
captured entry and chunks, the stopping rule read after every iteration,
the nuclear-norm prox by the route ``svd_method="auto"`` takes (on the card
above the Jacobi boundary: ``ops.prox.svt_sign``), no residual histories.
Held to the plain reference in float64 with the same rule
(``references/rpca.py``: QR and SVD).  Control: the program's own float32
path on the same calls.  The model and the reference are of the video's size
on the run's device (``problems.rpca.size``): the published one on a card."""
from __future__ import annotations

import torch

from . import batched


class Entry(batched.Entry):
    problems = ("rpca",)

    def __init__(self, ctx, dtype=None) -> None:
        sized = type(ctx)(**dict(vars(ctx), fix=ctx.problem.size(ctx.cfg, ctx.device)))
        super().__init__(sized, dtype)
        self.kw["record_residuals"] = False

    def reference(self, fix: dict, batch: dict) -> dict:
        """The plain reference with the weight of the video's size."""
        return super().reference(self.ctx.fix, batch)

    def prepare(self, batch: dict) -> dict:
        Y = batch["Y"]
        return {(1, "offset"): Y.reshape(Y.shape[0], -1).to(self.dtype).contiguous()}

    def control_entry(self):
        """The same calls through the program's float32 path."""
        return Entry(self.ctx, dtype=torch.float32)
