"""Basis pursuit with the PyTorch port (the port's version of
``basis_pursuit.py``, the script form of the reference's
``notebooks/basis_pursuit.ipynb``).

Reconstruct a K-sparse signal x (N=1000) from M=100 noise-free random
projections by solving  min |y - Ax|^2 + alpha |z|_1  s.t. z = x, then sweep
the regularization path over 64 values of alpha in ONE batched solve.  Runs
on the GPU; ``main(small=True)`` runs a small problem on the CPU.
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
    # -- single instance (notebook cells 5-9) --------------------------
    N, M, K = (128, 32, 5) if small else (1000, 100, 20)
    niter = 200 if small else 1000
    nlam = 8 if small else 64
    rng = np.random.RandomState(1234)
    A = rng.randn(M, N)
    xanswer = np.zeros(N)
    xanswer[:K] = rng.randn(K)
    xanswer = rng.permutation(xanswer)
    y = A @ xanswer

    model = Model(
        [LeastSquares(1.0, A, y), L1Regularizer(0.1, N)],
        [(1, 0, identity(N), identity(N))])
    opt = SimpleOptimizer(model, device=device)
    opt.solve(niter, rtol=1e-10)
    err = np.abs(opt.x[0].cpu().numpy() - xanswer).max()
    print(f"single:  {opt.iterations} iterations, max recovery error {err:.2e}")

    # -- lambda-path sweep, one batched solve -------------------------
    lambdas = np.logspace(-3, 1, nlam)
    res = BatchedSolver(model, device=device).solve({(1, "alpha"): lambdas}, niter=niter,
                                                    rtol=1e-10)
    nnz = (res.x[1].abs() > 1e-6).sum(dim=1).cpu().numpy()
    iters = res.iterations.cpu().numpy()
    print("lambda path (alpha -> nnz):")
    step = max(1, nlam // 8)
    for a, n, it in zip(lambdas[::step], nnz[::step], iters[::step]):
        print(f"  alpha={a:9.4f}  nnz={n:4d}  iters={it}")


if __name__ == "__main__":
    main()
