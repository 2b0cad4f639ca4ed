"""Complex compressed sensing with the PyTorch port (the port's version of
``complex_basis_pursuit.py``).

The reference solver is complex128-first (``optimizer.py:151,159``).  The
port runs the complex model directly in complex128, and its real embedding
(``realify_model``: interleaved Re/Im lanes) through the float64 engine and,
batched over a λ-sweep, through the fused float32 CUDA kernel's ``l1_even``
mode.  Runs on the GPU; ``main(small=True)`` runs a small problem on the CPU
(the fused solver then runs the kernel's plain version).
"""
import os

import numpy as np
import torch

from admmsolver_tpu_torch import (L1Regularizer, LeastSquares, Model,
                                  SimpleOptimizer, identity, realify_model)
from admmsolver_tpu_torch.models.realify import decode, encode
from admmsolver_tpu_torch.parallel import FusedTwoBlockSolver


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    device = "cpu" if small else "cuda"
    rng = np.random.RandomState(0)
    M, N, K = (16, 64, 3) if small else (64, 256, 8)
    niter = 300 if small else 2000
    nlam = 4 if small else 8
    A = rng.randn(M, N) + 1j * rng.randn(M, N)
    # the reference L1 prox projects onto real vectors
    # (objectivefunc.py:193-194): recoverable signals are real-valued
    x_true = np.zeros(N)
    x_true[rng.choice(N, K, replace=False)] = rng.randn(K)
    y = A @ x_true  # complex measurements

    model = Model(
        [LeastSquares(1.0, A, y), L1Regularizer(0.05, N)],
        [(1, 0, identity(N), identity(N))])
    oc = SimpleOptimizer(model, device=device)
    oc.solve(niter, rtol=1e-10)
    print(f"complex128 engine: max|x - x_true| = "
          f"{np.abs(oc.x[0].cpu().numpy() - x_true).max():.2e}")

    re = realify_model(model)
    opt = SimpleOptimizer(re.model, device=device)
    opt.solve(niter, rtol=1e-10)
    x = decode(opt.x[0]).cpu().numpy()
    print(f"realified f64 engine: max|x - x_true| = {np.abs(x - x_true).max():.2e}")

    # batched lambda sweep through the fused f32 solver
    lams = np.logspace(-0.5, -2, nlam)
    fs = FusedTwoBlockSolver(re.model, tile_b=nlam, device=device)
    ys = encode(torch.as_tensor(np.broadcast_to(y, (nlam, M)).copy()))
    r = fs.solve({(0, "y"): ys, (1, "alpha"): lams}, niter=niter, rtol=1e-7)
    xs = decode(r.x0).real.cpu().numpy()
    for lam, e in zip(lams, np.abs(xs - x_true).max(axis=1)):
        print(f"fused solver λ={lam:7.4f}: max err {e:.2e}")


if __name__ == "__main__":
    main()
