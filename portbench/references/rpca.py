"""Plain reference of the robust-PCA background-subtraction deployment.

Principal Component Pursuit (Candès, Li, Ma & Wright, J. ACM 58(3):11, 2011):
``min ||L||_* + lam |Y - L|_1`` over the (m, n) matrix ``L`` of each lane
(one column a frame), split as block 0 ``L = x0`` under the nuclear norm and
block 1 ``x1`` under ``lam |x1 - Y|_1``, coupled by ``x1 = x0``; both held
as row-major vectors of m n entries.  One sweep in the update order and sign
convention of SpM-lab/admmsolver (``optimizer.py``, as ``basis_pursuit.py``
writes its own):

    x0 = SVT(x1 + h / mu, 1 / (2 mu))               (singular-value soft-threshold)
    x1 = Y + soft(x0 - h / mu - Y, lam / (2 mu))
    h  = h + mu (x1 - x0)

The threshold is computed without the code under test's polynomial route:
a Householder QR of the tall matrix, ``X = Q R``, and the SVD of the small
``R = U s V^T`` (``torch.linalg.qr``, ``torch.linalg.svd``), so ``SVT(X,
tau) = Q U (s - tau)_+ V^T``, in the dtype of the inputs with TF32 off.
"""
from __future__ import annotations

import torch

from . import admm


def svt(X: torch.Tensor, tau: torch.Tensor) -> torch.Tensor:
    """``U (s - tau)_+ V^T`` of each matrix of ``X`` (B, m, n), ``tau`` (B,),
    by the QR of the tall side and the SVD of its triangle."""
    if X.shape[-2] < X.shape[-1]:
        return svt(X.mT, tau).mT
    Q, R = torch.linalg.qr(X)
    U, s, Vh = torch.linalg.svd(R)
    s = torch.clamp_min(s - tau[:, None], 0.0)
    return Q @ ((U * s[:, None, :]) @ Vh)


class RPCA:
    """The lanes ``Y`` (B, m, n) of PCP with weight ``lam``, in the dtype and
    on the device of ``Y``."""

    def __init__(self, Y: torch.Tensor, lam: float) -> None:
        self.B, self.m, self.n = Y.shape
        self.Y = Y.reshape(self.B, self.m * self.n)
        self.lam = float(lam)
        self.sizes = (self.m * self.n, self.m * self.n)
        self.pair_sizes = (self.m * self.n,)

    def refresh(self, mu: torch.Tensor) -> None:
        """Nothing to factorize: both updates are closed forms in mu."""

    def sweep(self, x, h, mu):
        _, x1 = x
        (h10,) = h
        m = mu[:, :1]
        v = (x1 + h10 / m).reshape(self.B, self.m, self.n)
        x0 = svt(v, 0.5 / m[:, 0]).reshape(self.B, -1)
        x1 = self.Y + admm.soft(x0 - h10 / m - self.Y, 0.5 * self.lam / m)
        return [x0, x1], [h10 + m * (x1 - x0)]

    def pair_terms(self, x_new, x_old, mu):
        return [admm.pair_terms(x_new[0], x_new[1], x_new[0] - x_old[0], mu[:, 0])]


def solve(fix: dict, batch: dict, mu0, knobs: admm.Knobs) -> admm.State:
    """The lanes of ``batch`` (``Y``, (B, m, n)) solved from zero by ``knobs``,
    in the dtype and on the device of ``Y``, products in its full precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Y = batch["Y"]
    p = RPCA(Y, fix["lam"])
    state = admm.fresh_state(p.sizes, p.pair_sizes, p.B, mu0, Y.dtype, Y.device)
    return admm.run(p, state, knobs)
