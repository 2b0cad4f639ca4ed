"""1-D total-variation denoising with the PyTorch port (the port's version
of ``tv_denoise.py``).

Recover a piecewise-constant signal from noise by solving
``min_x 0.5 |x - y|^2 + lam |D x|_1`` with ``D`` the forward difference, a
*non-identity* coupling ``D x = z`` stored as a ``BandedMatrix``: the penalty
``D†D`` stays tridiagonal and every solve is a cyclic reduction, so no N × N
matrix is ever made.  A sweep of lam on one signal, then a batch of noisy
signals at once.  Runs on the GPU; ``main(small=True)`` runs small problems
on the CPU.
"""
import os

import numpy as np

from admmsolver_tpu_torch import SimpleOptimizer
from admmsolver_tpu_torch.models.applications import tv_denoise_model
from admmsolver_tpu_torch.parallel import BatchedSolver


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    device = "cpu" if small else "cuda"
    n, niter = (80, 500) if small else (400, 4000)
    rng = np.random.RandomState(0)
    # piecewise-constant truth, three levels
    truth = np.r_[np.zeros(n // 3), 1.5 * np.ones(n // 3), 0.5 * np.ones(n - 2 * (n // 3))]
    y = truth + 0.25 * rng.randn(n)

    for lam in (0.05, 0.5, 5.0):
        opt = SimpleOptimizer(tv_denoise_model(y, lam), device=device)
        opt.solve(niter)
        x = opt.x[0].cpu().numpy()
        jumps = int(np.sum(np.abs(np.diff(x)) > 1e-3))
        print(f"lam={lam:5.2f}  mean|x-truth|={np.abs(x - truth).mean():.4f}  "
              f"jumps={jumps:4d}  (noisy input err={np.abs(y - truth).mean():.4f})")

    B = 4 if small else 64
    ys = truth[None, :] + 0.25 * rng.randn(B, n)
    res = BatchedSolver(tv_denoise_model(ys[0], 0.5), device=device).solve(
        {(0, "y"): ys}, niter=niter, record_residuals=False)
    err = np.abs(res.x[0].cpu().numpy() - truth[None]).mean(axis=1)
    print(f"batched x{B} at lam=0.50: mean|x-truth| per signal "
          f"{err.min():.4f}..{err.max():.4f}, iterations {int(res.iterations.max())} (max)")


if __name__ == "__main__":
    main()
