"""Solver configuration.

The same knobs as :class:`admmsolver_tpu.config.ADMMConfig`, the loop
schedule of one ``solve()`` call.  PyTorch runs eagerly, so here they are
plain values read by the Python loop rather than static jit arguments.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ADMMConfig:
    """Knobs of the ADMM loop.

    Matches reference defaults: ``niter``/``interval_update_mu``/
    ``update_h`` (``optimizer.py:302-309``), ``fact_incr``/``th_change``
    (``optimizer.py:277``), ``max_mu`` (``optimizer.py:125``).
    Tolerances are ``solve()`` arguments, not fields.
    """

    niter: int = 10000
    interval_update_mu: int = 100
    update_h: bool = True
    fact_incr: float = 2.0
    th_change: float = 10.0
    max_mu: float = 1e3
    #: Over-relaxation factor (no reference counterpart).  1.0 = off,
    #: exactly the reference sweep.  Single-pair (2-block) models only;
    #: the engine raises otherwise.
    relax: float = 1.0
