"""Plain reference of the ragged stream deployment: basis pursuit / LASSO
scenarios of one shared ``A``, each with its own measurement ``y`` and L1
weight, drained through the lanes of a continuously batched solver.

Each scenario is solved alone, from zero state and ``mu0``, by one
continuous run of plain ADMM (``admm.run`` on ``basis_pursuit.
BasisPursuit``) of at most ``niter`` iterations with the stopping rule read
after every iteration.  That is the stream's answer: a lane of the stream
restarts the penalty schedule every wave, and with waves of ``interval``
iterations the restart falls on the iterations where one continuous run
updates the penalty anyway, so carrying a lane's state from wave to wave
changes nothing (a test holds the two equal).  Which lane, wave or batch
position a scenario takes does not enter.
"""
from __future__ import annotations

import torch

from . import admm
from .basis_pursuit import BasisPursuit


def solve(fix: dict, batch: dict, mu0, knobs: admm.Knobs) -> admm.State:
    """The scenarios of ``batch`` (``y``, ``alpha_ls``, ``alpha1``) each solved
    from zero by ``knobs``, in the dtype and on the device of ``fix["A"]``,
    products in the full precision of that dtype."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    A, ys = fix["A"], batch["y"]
    p = BasisPursuit(A, ys, batch["alpha_ls"], batch["alpha1"])
    state = admm.fresh_state(p.sizes, p.pair_sizes, ys.shape[0], mu0, A.dtype, A.device)
    return admm.run(p, state, knobs)
