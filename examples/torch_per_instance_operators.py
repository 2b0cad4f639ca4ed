"""Per-instance operators with the PyTorch port (the port's version of
``per_instance_operators.py``): a different dense A in every batch lane.

The reference solves arbitrary per-problem operators one ``SimpleOptimizer``
at a time (``optimizer.py:121-152``).  Here a batch of compressed-sensing
problems with DIFFERENT measurement matrices runs as one batched solve
through the ``{(block, "A"): (B, M, N)}`` override (blocks with n <= 128;
per-lane factors by a batched Cholesky inverse).  Runs on the GPU;
``main(small=True)`` runs a small problem on the CPU.
"""
import os

import numpy as np

from admmsolver_tpu_torch import (L1Regularizer, LeastSquares, Model,
                                  SimpleOptimizer, identity)
from admmsolver_tpu_torch.parallel import BatchedSolver


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    device = "cpu" if small else "cuda"
    M, N, K, B = (12, 24, 3, 4) if small else (48, 96, 8, 64)
    niter = 200 if small else 1000
    rng = np.random.RandomState(11)

    # one K-sparse truth per lane, measured through a DIFFERENT A
    As = rng.randn(B, M, N) / np.sqrt(M)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, K, replace=False)] = rng.randn(K)
    ys = np.einsum("bmn,bn->bm", As, xt)

    template = Model(
        [LeastSquares(1.0, As[0], ys[0]), L1Regularizer(0.02, N)],
        [(1, 0, identity(N), identity(N))])
    res = BatchedSolver(template, device=device).solve({(0, "A"): As, (0, "y"): ys},
                                                       niter=niter, rtol=1e-10)
    x = res.x[0].cpu().numpy()
    print(f"batched x{B} (different A per lane): "
          f"max recovery err {np.abs(x - xt).max():.2e}, "
          f"median iters {int(np.median(res.iterations.cpu().numpy()))}")

    # cross-check one lane against its own single-instance solve
    b = B // 2
    o = SimpleOptimizer(Model(
        [LeastSquares(1.0, As[b], ys[b]), L1Regularizer(0.02, N)],
        [(1, 0, identity(N), identity(N))]), device=device)
    o.solve(niter, rtol=1e-10)
    d = np.abs(x[b] - o.x[0].cpu().numpy()).max()
    print(f"lane {b} vs independent SimpleOptimizer: max |dx| = {d:.2e}")


if __name__ == "__main__":
    main()
