"""The work of robust PCA (PCP) by ADMM, counted from its shapes as the
algorithm needs it, whatever implements it.

One iteration of a lane, an (m, n) matrix of m n entries, m >= n (the plain
form, ``references/rpca.py``):

    v  = x1 + h / mu                          2 m n
    x0 = SVT(v, 1 / (2 mu))                   the threshold
    x1 = Y + soft(x0 - h / mu - Y, t)         7 m n
    h += mu (x1 - x0)                         3 m n
    residuals: the norms of x0 - x1, x0, x1,
    x0 - x0_old and x0_old                    12 m n

The threshold is counted as the least any route needs for it: a Gram
product V^T V and one product of V with an n x n factor of its spectrum,
2 m n^2 multiply-adds (4 m n^2 flops), timed at the card's float64 rate on
the tensor cores; the route's own extra work (a polynomial's steps, an
eigendecomposition of the n x n Gram) is not counted.  The elementwise
steps go at the float64 rate outside the tensor cores.  Bytes: every input
read once and every output written once a call, float64: Y, then x0, x1
and h.
"""
from __future__ import annotations

#: flops a lane-iteration per entry outside the threshold
ELEMENTWISE = 2 + 7 + 3 + 12


def work(m: int, n: int, lane_iters: float, lanes: int, calls: int) -> dict:
    """Operations and bytes of ``lane_iters`` lane-iterations over ``calls``
    calls of ``lanes`` lanes."""
    k = min(m, n)
    return {"threshold_flops": 4.0 * m * n * k * lane_iters,
            "other_flops": float(ELEMENTWISE) * m * n * lane_iters,
            "bytes": 8.0 * 4 * m * n * lanes * calls}


def bound_s(w: dict, peaks: dict) -> float:
    """The least time the card could take for ``w``: the largest of the
    threshold's products on the tensor cores, the elementwise steps on the
    float64 units and the bytes' time, since the three can overlap."""
    return max(w["threshold_flops"] / peaks["f64_tc_flops"],
               w["other_flops"] / peaks["f64_flops"], w["bytes"] / peaks["bytes_per_s"])
