"""Plain reference of the SpM analytic-continuation deployment.

SpM-lab/admmsolver ``notebooks/spm.ipynb``: block 0 the IR coefficients,
``alpha_ls * ||g - (-diag(s)) x0||^2`` subject to the sum rule ``c x0 = d``
exactly; block 1 ``alpha1 * |x1|_1`` with ``x1 = x0``; block 2 the
non-negative spectrum ``x2 >= 0`` with ``x2 = P x0``.  The x0 step solves the
bordered system ``[[K, c^T], [c, 0]] [x0; nu] = [r; d]``, ``K = alpha_ls
diag(s^2) + mu1 I + mu2 P^T P``, through its inverse, made anew whenever a
lane's penalties change.
"""
from __future__ import annotations

import torch

from . import admm


class SpM:
    """The lanes ``gs`` (B, nl) with weights ``alpha_ls``, ``alpha1`` (B,) of
    one basis: singular values ``s`` (nl,), projector ``P`` (nw, nl), sum rule
    ``c`` (nl,) = ``d``; in the dtype and on the device of ``P``."""

    def __init__(self, s, P, c, d: float, gs, alpha_ls, alpha1) -> None:
        cast = dict(dtype=P.dtype, device=P.device)
        self.P = P
        self.nw, self.nl = P.shape
        self.sizes = (self.nl, self.nl, self.nw)
        self.pair_sizes = (self.nl, self.nw)
        s = s.to(**cast)
        self.alpha_ls = alpha_ls.to(**cast)[:, None]
        self.alpha1 = alpha1.to(**cast)[:, None]
        self.aty = self.alpha_ls * (-s * gs.to(**cast))       # alpha A^T y with A = -diag(s)
        self.s2 = s * s
        self.W = P.T @ P
        self.c = c.to(**cast)
        self.d = float(d)

    def refresh(self, mu: torch.Tensor) -> None:
        B, nl = mu.shape[0], self.nl
        K = (self.alpha_ls[:, :, None] * torch.diag(self.s2)
             + mu[:, 0, None, None] * torch.eye(nl, dtype=mu.dtype, device=mu.device)
             + mu[:, 1, None, None] * self.W)
        kkt = torch.zeros((B, nl + 1, nl + 1), dtype=mu.dtype, device=mu.device)
        kkt[:, :nl, :nl] = K
        kkt[:, :nl, nl] = self.c
        kkt[:, nl, :nl] = self.c
        Z = torch.linalg.inv(kkt)
        self.Z11 = Z[:, :nl, :nl]
        self.z = Z[:, :nl, nl] * self.d

    def sweep(self, x, h, mu):
        x0, x1, x2 = x
        h10, h20 = h
        m1, m2 = mu[:, :1], mu[:, 1:]
        hk0 = -h10 - m1 * x1 - (h20 + m2 * x2) @ self.P
        x0 = (self.Z11 @ (self.aty - hk0)[:, :, None])[:, :, 0] + self.z
        x1 = admm.soft(x0 - h10 / m1, 0.5 * self.alpha1 / m1)
        px0 = x0 @ self.P.T
        x2 = torch.clamp_min(px0 - h20 / m2, 0.0)
        return [x0, x1, x2], [h10 + m1 * (x1 - x0), h20 + m2 * (x2 - px0)]

    def pair_terms(self, x_new, x_old, mu):
        x0, x1, x2 = x_new
        dx0 = x0 - x_old[0]
        return [admm.pair_terms(x0, x1, dx0, mu[:, 0]),
                admm.pair_terms(x0 @ self.P.T, x2, dx0 @ self.P.T, mu[:, 1])]


def _problem(fix: dict, batch: dict) -> SpM:
    return SpM(fix["s"], fix["P"], fix["c"], fix["d"], batch["y"], batch["alpha_ls"],
               batch["alpha1"])


def solve(fix: dict, batch: dict, mu0, knobs: admm.Knobs) -> admm.State:
    """The lanes of ``batch`` (``y``, ``alpha_ls``, ``alpha1``) solved from zero
    by ``knobs``, in the dtype and on the device of ``fix["P"]``."""
    p = _problem(fix, batch)
    state = admm.fresh_state(p.sizes, p.pair_sizes, batch["y"].shape[0], mu0, p.P.dtype,
                             p.P.device)
    return admm.run(p, state, knobs)


def solve_mixed(fix: dict, batch: dict, mu0, low: admm.Knobs, polish: admm.Knobs) -> admm.State:
    """Two phases: ``low`` from zero, then ``polish`` from the state ``low``
    left, with every lane active again; the count is the sum of both."""
    p = _problem(fix, batch)
    state = admm.fresh_state(p.sizes, p.pair_sizes, batch["y"].shape[0], mu0, p.P.dtype,
                             p.P.device)
    first = admm.run(p, state, low)
    second = admm.run(p, admm.State(first.x, first.h, first.mu,
                                    torch.zeros_like(first.done), torch.zeros_like(first.count)),
                      polish)
    second.count = second.count + torch.clamp_max(first.count, low.niter)
    return second
