"""The work of one launch of the two-block chunk kernel, counted from its
shapes as the algorithm needs it, whatever implements it.

One iteration of a lane (``admmsolver_tpu_torch.ops.kernels.
fused_two_block_chunk``, the plain form):

    v  = acy + h + mu x1                 3 N
    w  = (v U) * dinv                    2 N R shared, R
    x0 = w Ut  (+ v / mu, thin)          2 R N shared, (2 N)
    z  = x0 - h / mu                     2 N
    x1 = sign(z) max(|z| - thr, 0)       4 N  (non-negative: max(z, 0), 1 N)
    h += mu (x1 - x0)                    3 N

The products with the shared basis (4 N R a lane and iteration) are timed at
the card's dense TF32 rate, the fastest any float32-accurate product can
use; the rest at its float32 rate.  Bytes: every input read once, every
output written once, float32.
"""
from __future__ import annotations


def work(B: int, N: int, R: int, n_iters: int, prox: str = "l1", thin: bool = True) -> dict:
    """Operations and bytes of one launch over ``B`` lanes."""
    elementwise = (3 + (2 if thin else 0) + 2 + (4 if prox.startswith("l1") else 1) + 3) * N + R
    inputs = 2 * N * R + B * R + 4 * B * N + 2 * B     # U, Ut, dinv, acy, x0, x1, h, mu, thr
    outputs = 4 * B * N                                # x0, x1, h, x0_prev
    return {"shared_flops": 4 * B * N * R * n_iters,
            "other_flops": elementwise * B * n_iters,
            "bytes": 4 * (inputs + outputs)}


def bound_s(w: dict, peaks: dict) -> float:
    """The least time the card could take for ``w``: the largest of the
    shared products' time on the tensor cores, the other operations' time on
    the float32 units and the bytes' time, since the three can overlap."""
    return max(w["shared_flops"] / peaks["tf32_flops"], w["other_flops"] / peaks["f32_flops"],
               w["bytes"] / peaks["bytes_per_s"])
