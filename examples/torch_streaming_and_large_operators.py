"""Large per-instance operators and streaming with the PyTorch port (the
port's version of ``streaming_and_large_operators.py``).

1. ``solve_scan``: a batch of LARGE heterogeneous problems (a different
   dense A per instance, n > 128) whose per-lane factors would not all fit
   at once: groups of instances solve one after another.  The reference
   covers this only as one ``SimpleOptimizer`` per problem
   (``optimizer.py:121-152``).
2. ``ScenarioScheduler.run_compiled``: continuous batching over a stream of
   more problems than lanes, with ragged convergence; finished lanes are
   harvested and refilled on the card between chunks.

Runs on the GPU; ``main(small=True)`` runs small problems on the CPU.
"""
import os

import numpy as np

from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, identity
from admmsolver_tpu_torch.parallel import BatchedSolver, ScenarioScheduler


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    device = "cpu" if small else "cuda"
    rng = np.random.RandomState(12)

    # --- 1. solve_scan: distinct large operators ----------------------
    M, N, B = (16, 40, 3) if small else (64, 256, 16)
    niter = 60 if small else 400
    As = rng.randn(B, M, N) / np.sqrt(M)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 4, replace=False)] = rng.randn(4)
    ys = np.einsum("bmn,bn->bm", As, xt)
    bs = BatchedSolver(Model(
        [LeastSquares(1.0, As[0], ys[0]), L1Regularizer(0.02, N)],
        [(1, 0, identity(N), identity(N))]), device=device)
    res = bs.solve_scan({(0, "A"): As, (0, "y"): ys}, group_size=max(1, B // 4), niter=niter)
    fit = np.linalg.norm(np.einsum("bmn,bn->bm", As, res.x[0].cpu().numpy()) - ys,
                         axis=1) / np.linalg.norm(ys, axis=1)
    print(f"solve_scan x{B} (distinct A): median rel fit residual {np.median(fit):.2e}")

    # --- 2. continuous batching ----------------------------------------
    S = 6 if small else 48
    lanes = 2 if small else 8
    A = rng.randn(M, N) / np.sqrt(M)
    stream_y = []
    for i in range(S):
        x = np.zeros(N)
        x[rng.choice(N, 2 + i % 5, replace=False)] = rng.randn(2 + i % 5)
        stream_y.append(A @ x)
    bs2 = BatchedSolver(Model(
        [LeastSquares(1.0, A, stream_y[0]), L1Regularizer(0.02, N)],
        [(1, 0, identity(N), identity(N))]), device=device)
    sched = ScenarioScheduler(bs2, batch_size=lanes, chunk_iters=50, niter_max=2000, rtol=1e-8)
    results = sched.run_compiled({(0, "y"): y} for y in stream_y)
    conv = sum(r.converged for r in results)
    iters = np.array([r.iterations for r in results])
    print(f"stream: {S} scenarios over {lanes} lanes, {conv}/{S} converged, iterations "
          f"p5/p50/p95 = {int(np.percentile(iters, 5))}/{int(np.median(iters))}/"
          f"{int(np.percentile(iters, 95))}")


if __name__ == "__main__":
    main()
