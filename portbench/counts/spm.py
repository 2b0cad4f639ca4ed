"""The work of one launch of the SpM chunk kernel, counted from its shapes as
the algorithm needs it, whatever implements it.

One iteration of a lane (``admmsolver_tpu_torch.ops.kernels.
fused_spm_chunk``, the plain form):

    hk0 = -h10 - mu1 x1 - (h20 + mu2 x2) P    2 nw nl shared, 3 nl + 2 nw
    x0  = b2 - M hk0                          2 nl^2 (M is the lane's own), nl
    x1  = soft(-(h10 - mu1 x0) / mu1, thr)    3 nl + 4 nl
    Px0 = x0 P^T                              2 nw nl shared
    x2  = max(-(h20 - mu2 Px0) / mu2, 0)      3 nw + nw
    h10 += mu1 (x1 - x0); h20 += mu2 (x2 - Px0)   3 nl + 3 nw

The products with the shared P (4 nw nl a lane and iteration) are timed at
the card's dense TF32 rate; the lane's own product M hk0 and the rest at its
float32 rate.  Bytes: every input read once, every output written once,
float32.
"""
from __future__ import annotations


def work(B: int, nl: int, nw: int, n_iters: int) -> dict:
    """Operations and bytes of one launch over ``B`` lanes."""
    other = 2 * nl * nl + 14 * nl + 9 * nw
    # P, M, b2, mu (2), thr, x0, x1, x2, h10, h20
    inputs = nw * nl + B * (nl * nl + nl + 3 + 3 * nl + 2 * nw)
    outputs = B * (4 * nl + 2 * nw)                  # x0, x1, x2, h10, h20, x0_prev
    return {"shared_flops": 4 * B * nw * nl * n_iters,
            "other_flops": other * B * n_iters,
            "bytes": 4 * (inputs + outputs)}


def bound_s(w: dict, peaks: dict) -> float:
    """The least time the card could take for ``w``: the largest of the
    shared products' time on the tensor cores, the other operations' time on
    the float32 units and the bytes' time, since the three can overlap."""
    return max(w["shared_flops"] / peaks["tf32_flops"], w["other_flops"] / peaks["f32_flops"],
               w["bytes"] / peaks["bytes_per_s"])
