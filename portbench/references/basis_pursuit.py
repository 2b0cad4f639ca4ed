"""Plain reference of the basis-pursuit / LASSO deployment.

``alpha_ls * ||y - A x0||^2 + alpha1 * |x1|_1`` subject to ``x1 = x0``
(SpM-lab/admmsolver ``notebooks/basis_pursuit.ipynb``: ``LeastSquares(1, A,
y)``, ``L1Regularizer(alpha, N)``, identity coupling), one lane a problem.
The x0 step solves ``(alpha_ls A^T A + mu I) x0 = alpha_ls A^T y + h + mu x1``
through the Woodbury identity with the inverse, by Cholesky, of the small
``mu I + alpha_ls A A^T`` of each lane, made anew whenever the lane's
penalty changes.
"""
from __future__ import annotations

import torch

from . import admm


class BasisPursuit:
    """The lanes ``ys`` (B, M) with weights ``alpha_ls``, ``alpha1`` (B,) of
    one shared ``A`` (M, N), in the dtype and on the device of ``A``."""

    sizes = property(lambda self: (self.N, self.N))
    pair_sizes = property(lambda self: (self.N,))

    def __init__(self, A: torch.Tensor, ys: torch.Tensor, alpha_ls: torch.Tensor,
                 alpha1: torch.Tensor) -> None:
        cast = dict(dtype=A.dtype, device=A.device)
        self.A = A
        self.M, self.N = A.shape
        self.alpha_ls = alpha_ls.to(**cast)[:, None]
        self.alpha1 = alpha1.to(**cast)[:, None]
        self.aty = self.alpha_ls * (ys.to(**cast) @ A)        # alpha A^T y, (B, N)
        self.G = A @ A.T                                       # (M, M)

    def refresh(self, mu: torch.Tensor) -> None:
        eye = torch.eye(self.M, dtype=self.A.dtype, device=self.A.device)
        H = mu[:, 0, None, None] * eye + self.alpha_ls[:, :, None] * self.G
        self.Hinv = torch.cholesky_inverse(torch.linalg.cholesky(H))

    def _solve_x0(self, r: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
        t = (self.Hinv @ (r @ self.A.T)[:, :, None])[:, :, 0]
        return (r - self.alpha_ls * (t @ self.A)) / mu

    def sweep(self, x, h, mu):
        x0, x1 = x
        (h10,) = h
        m = mu[:, :1]
        x0 = self._solve_x0(self.aty + h10 + m * x1, m)
        x1 = admm.soft(x0 - h10 / m, 0.5 * self.alpha1 / m)
        return [x0, x1], [h10 + m * (x1 - x0)]

    def pair_terms(self, x_new, x_old, mu):
        return [admm.pair_terms(x_new[0], x_new[1], x_new[0] - x_old[0], mu[:, 0])]


def solve(fix: dict, batch: dict, mu0, knobs: admm.Knobs) -> admm.State:
    """The lanes of ``batch`` (``y``, ``alpha_ls``, ``alpha1``) solved from zero
    by ``knobs``, in the dtype and on the device of ``fix["A"]``."""
    A, ys = fix["A"], batch["y"]
    p = BasisPursuit(A, ys, batch["alpha_ls"], batch["alpha1"])
    state = admm.fresh_state(p.sizes, p.pair_sizes, ys.shape[0], mu0, A.dtype, A.device)
    return admm.run(p, state, knobs)
