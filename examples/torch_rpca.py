"""Robust PCA with the PyTorch port (the port's version of ``rpca.py``).

Decompose a corrupted data matrix ``Y = L + S`` into a low-rank part ``L``
and a sparse outlier part ``S`` by solving ``min_L ||L||_* + lam |Y - L|_1``
(nuclear norm through the route ``svd_method`` names: on the GPU by default
the Gram SVD with the Jacobi eigh kernel, or the SVD-free polar route above
the Jacobi boundary; on the CPU ``torch.linalg.svd``; plus offset L1).  The
batched section decomposes many matrices at once with per-instance ``Y``
through the offset batch field.  Runs on the GPU; ``main(small=True)`` runs
small problems on the CPU.
"""
import os

import numpy as np

from admmsolver_tpu_torch import SimpleOptimizer
from admmsolver_tpu_torch.models.applications import rpca_model
from admmsolver_tpu_torch.parallel import BatchedSolver


def make_instance(rng, m=40, n=30, rank=3, p_corrupt=0.05):
    L0 = rng.randn(m, rank) @ rng.randn(rank, n)
    S0 = np.zeros((m, n))
    mask = rng.rand(m, n) < p_corrupt
    S0[mask] = 8.0 * rng.randn(mask.sum())
    return L0, S0, L0 + S0


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    device = "cpu" if small else "cuda"
    niter = 300 if small else 1500
    rng = np.random.RandomState(0)
    size = dict(m=12, n=10) if small else {}
    L0, S0, Y = make_instance(rng, **size)

    opt = SimpleOptimizer(rpca_model(Y), device=device)
    opt.solve(niter)
    L = opt.x[0].cpu().numpy().reshape(Y.shape)
    S = Y - L
    sv = np.linalg.svd(L, compute_uv=False)
    print(f"single: rel err(L) = {np.abs(L - L0).max() / np.abs(L0).max():.4f}, "
          f"effective rank = {int(np.sum(sv > 1e-6 * sv[0]))}, sparse support error = "
          f"{np.mean((np.abs(S) > 0.1) != (np.abs(S0) > 0)):.4f}")

    B = 3 if small else 8
    inst = [make_instance(rng, **size) for _ in range(B)]
    Ys = np.stack([Y_ for (_, _, Y_) in inst])
    res = BatchedSolver(rpca_model(Ys[0]), device=device).solve(
        {(1, "offset"): Ys.reshape(B, -1)}, niter=niter, record_residuals=False)
    Ls = res.x[0].cpu().numpy().reshape(Ys.shape)
    errs = [np.abs(Ls[b] - inst[b][0]).max() / np.abs(inst[b][0]).max() for b in range(B)]
    print(f"batched x{B}: max rel err(L) = {max(errs):.4f}, "
          f"converged = {int(res.converged.sum())}/{B}")


if __name__ == "__main__":
    main()
