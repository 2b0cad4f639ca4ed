"""Sparse-modeling (SpM) analytic continuation with the PyTorch port (the
port's version of ``spm.py``, the script form of the reference's
``notebooks/spm.ipynb``, hermetic: no sparse_ir download).

Recover a nonnegative, unit-weight spectral function rho(omega) from noisy
imaginary-time kernel data with the three-block model: ConstrainedLeastSquares
(sum rule) + L1 sparsity + NonNegativity through the real-frequency
projector.  Then many noisy replicas through the fused CUDA kernel.  Runs on
the GPU; ``main(small=True)`` runs a small problem on the CPU (the fused
solver then runs the kernel's plain version).
"""
import os

import numpy as np

from admmsolver_tpu_torch import SimpleOptimizer
from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu_torch.parallel import FusedSpMSolver
from admmsolver_tpu_torch.utils import convergence_report


def main(small=None):
    if small is None:
        small = os.environ.get("ADMM_EXAMPLES_SMALL") == "1"
    device = "cpu" if small else "cuda"
    nl, nw, niter = (12, 25, 500) if small else (30, 61, 10000)
    s, g, prj_sum, prj_w, omega, rho_true = synthetic_spm_data(nl=nl, nw=nw, noise=1e-5)

    model = spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-5, sum_value=1.0)
    opt = SimpleOptimizer(model, mu=0.1, device=device)
    opt.solve(niter)

    rho = opt.x[2].cpu().numpy()
    rep = convergence_report(opt.primal_residual_history, opt.dual_residual_history)
    print(f"iterations: {rep['iterations']}, final primal {rep['final_primal']:.2e}, "
          f"dual {rep['final_dual']:.2e}")
    print(f"sum rule: sum(rho) = {rho.sum():.6f} (target 1)")
    print(f"min(rho) = {rho.min():.2e} (>= 0)")
    print(f"correlation with ground truth: {np.corrcoef(rho, rho_true)[0, 1]:.4f}")

    # many noisy replicas in float32 through the fused solver
    B = 8 if small else 1024
    gs = g[None, :] + 1e-5 * np.random.RandomState(1).randn(B, nl)
    r = FusedSpMSolver(model, device=device).solve({(0, "y"): gs}, niter=min(niter, 2000),
                                                   mu0=0.1, atol=1e-4)
    sums = r.x[0].double().cpu().numpy() @ prj_sum
    print(f"fused x{B}: median |sum rule - 1| {np.median(np.abs(sums - 1.0)):.2e}, "
          f"min spectrum {float(r.x[2].min()):.2e}")


if __name__ == "__main__":
    main()
