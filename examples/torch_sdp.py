"""Semidefinite-constrained least squares with the PyTorch port (the port's
version of ``sdp.py``).

Recover a stack of positive-semidefinite k x k slices from noisy linear
measurements by solving  min |y - Ax|^2  s.t.  x ⪰ 0 slice-wise (z = x
coupling; the PSD-cone prox projects every slice of every lane in one
batched call, here the Jacobi eigh kernel on the GPU, where the reference
loops ``np.linalg.eigh`` over the slices, ``objectivefunc.py:320-327``).  A
single instance, then a batch of noisy replicas.  Runs on the GPU;
``main(small=True)`` runs a small problem on the CPU.
"""
import os

import numpy as np

from admmsolver_tpu_torch import SimpleOptimizer
from admmsolver_tpu_torch.models.applications import sdp_model
from admmsolver_tpu_torch.parallel import BatchedSolver


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    device = "cpu" if small else "cuda"
    k, rest = (4, 4) if small else (8, 16)   # PSD slices of k x k
    niter = 300 if small else 2000
    shape = (k, k, rest)
    N = k * k * rest
    M = 2 * N                # overdetermined: recovery is well-posed
    rng = np.random.RandomState(7)

    xtrue = np.zeros(shape)
    for r in range(rest):
        Q = rng.randn(k, k)
        xtrue[:, :, r] = Q @ Q.T / k
    A = rng.randn(M, N) / np.sqrt(M)     # unit-scale columns
    y = A @ xtrue.reshape(-1) + 0.01 * rng.randn(M)
    model = sdp_model(A, y, shape, axis=2)

    opt = SimpleOptimizer(model, device=device)
    opt.solve(niter, rtol=1e-10)
    x = opt.x[1].cpu().numpy().reshape(shape)
    lam_min = np.linalg.eigvalsh(np.moveaxis(x, 2, 0)).min()
    print(f"single:  {opt.iterations} iterations, max err {np.abs(x - xtrue).max():.2e}, "
          f"min eigenvalue {lam_min:+.1e}")

    B = 8 if small else 64
    ys = (A @ xtrue.reshape(-1))[None, :] + 0.01 * rng.randn(B, M)
    res = BatchedSolver(model, device=device).solve({(0, "y"): ys}, niter=niter, rtol=1e-10)
    xb = res.x[1].cpu().numpy().reshape(B, *shape)
    lam_min = np.linalg.eigvalsh(np.moveaxis(xb, 3, 1)).min()
    print(f"batch:   {B} instances, {int(res.iterations.max())} iterations (max), "
          f"max recovery err {np.abs(xb - xtrue[None]).max():.2e}, "
          f"min eigenvalue {lam_min:+.1e}")


if __name__ == "__main__":
    main()
