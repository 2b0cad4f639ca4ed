"""Plain multi-block ADMM: the yardstick the benchmark holds the port to.

Plain PyTorch, written from the algorithm of SpM-lab/admmsolver
(``optimizer.py``: Gauss-Seidel block sweep, dual ascent, per-pair primal and
dual residuals, the relative stopping rule, residual-balancing penalty
updates every ``interval`` iterations).  It imports nothing of the code under
test and takes nothing it made: each problem module works out its own
factorizations from the raw inputs.

A problem supplies ``refresh(mu)`` (factorizations for the penalties ``mu``,
(B, npairs)), ``sweep(x, h, mu)`` (one Gauss-Seidel sweep and dual ascent:
new x and h) and ``pair_terms(x_new, x_old, mu)`` (per pair: primal norm,
dual norm, relative primal, relative dual; each (B,)).

``checks`` is where the stopping rule and the penalty update read the
residuals: ``"iteration"`` after every iteration (the reference's rule), or
``"chunk"`` only at the end of each chunk of the schedule (iteration 0, full
chunks of ``interval``, the remainder), as a solver that runs whole chunks
on the device does.  The penalty update fires after iteration 0 and after
every ``interval`` iterations, never after a lane's converging iteration.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch


@dataclass
class Knobs:
    niter: int
    interval: int = 100
    rtol: float = 1e-12
    atol: float = 0.0
    fact_incr: float = 2.0
    th_change: float = 10.0
    max_mu: float = 1e3
    checks: str = "iteration"


@dataclass
class State:
    x: List[torch.Tensor]
    h: List[torch.Tensor]
    mu: torch.Tensor          # (B, npairs)
    done: torch.Tensor        # (B,) bool
    count: torch.Tensor       # (B,) iterations run


def _check_points(niter: int, interval: int) -> set:
    """Iterations at which a chunked solver reads the residuals: the last
    iteration of each chunk."""
    ends, it = {0}, 0
    while it + interval <= niter - 1:
        it += interval
        ends.add(it)
    ends.add(niter - 1)
    return ends


def run(problem, state: State, knobs: Knobs) -> State:
    """``knobs.niter`` iterations of ``problem`` from ``state`` (lanes marked
    done stay as they are)."""
    x, h, mu, done, count = state.x, state.h, state.mu, state.done.clone(), state.count.clone()
    if knobs.checks not in ("iteration", "chunk"):
        raise ValueError(f"checks must be 'iteration' or 'chunk', got {knobs.checks!r}")
    reads = (set(range(knobs.niter)) if knobs.checks == "iteration"
             else _check_points(knobs.niter, knobs.interval))
    problem.refresh(mu)
    for it in range(knobs.niter):
        active = ~done
        am = active[:, None]
        x_new, h_new = problem.sweep(x, h, mu)
        x_old = x
        x = [torch.where(am, a, b) for a, b in zip(x_new, x)]
        h = [torch.where(am, a, b) for a, b in zip(h_new, h)]
        count = count + active.to(count.dtype)
        if it not in reads:
            continue
        terms = problem.pair_terms(x_new, x_old, mu)
        conv = torch.ones_like(done)
        for _, _, rp, rd in terms:
            conv = conv & (rp < knobs.rtol) & (rd < knobs.rtol)
        primal = sum(t[0] for t in terms)
        dual = sum(t[1] for t in terms)
        conv = conv | ((primal < knobs.atol) & (dual < knobs.atol))
        done_new = done | (active & conv)
        if it % knobs.interval == 0:
            cols = []
            for p, (pn, dn, _, _) in enumerate(terms):
                m = mu[:, p]
                m2 = torch.where(pn > knobs.th_change * dn, m * knobs.fact_incr, m)
                m2 = torch.where(dn > knobs.th_change * pn, m2 / knobs.fact_incr, m2)
                cols.append(torch.clamp_max(m2, knobs.max_mu))
            mu_new = torch.where(done_new[:, None], mu, torch.stack(cols, dim=1))
            if not torch.equal(mu_new, mu):
                mu = mu_new
                problem.refresh(mu)
        done = done_new
    return State(x, h, mu, done, count)


def fresh_state(sizes, pair_sizes, B: int, mu0, dtype, device,
                done0: Optional[torch.Tensor] = None) -> State:
    """Zero blocks and duals, the penalties ``mu0`` (a number or (B,))."""
    zeros = lambda n: torch.zeros((B, n), dtype=dtype, device=device)
    mu = torch.as_tensor(mu0, dtype=dtype, device=device)
    mu = (mu.reshape(-1, 1) if mu.ndim else mu.reshape(1, 1)).expand(B, len(pair_sizes))
    done = (torch.zeros(B, dtype=torch.bool, device=device) if done0 is None
            else done0.to(device=device, dtype=torch.bool))
    return State([zeros(n) for n in sizes], [zeros(n) for n in pair_sizes],
                 mu.contiguous(), done, torch.zeros(B, dtype=torch.long, device=device))


def norm(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(a, dim=1)


def soft(z: torch.Tensor, thr: torch.Tensor) -> torch.Tensor:
    return torch.sign(z) * torch.clamp_min(z.abs() - thr, 0.0)


def pair_terms(p1, p2, dp1, mu_p):
    """Norms of one pair: ``p1`` = E_ij x_j (the earlier block's image),
    ``p2`` = E_ji x_i, ``dp1`` = E_ij (x_j - x_j_old)."""
    pn = norm(p1 - p2)
    dn = mu_p * norm(dp1)
    rp = pn / torch.maximum(norm(p1), norm(p2))
    rd = dn / torch.maximum(mu_p * norm(p1), mu_p * norm(p1 - dp1))
    return pn, dn, rp, rd
