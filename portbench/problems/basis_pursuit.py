"""Inputs of the basis-pursuit / LASSO deployment, made from the seed.

A numpy copy of SpM-lab/admmsolver ``notebooks/basis_pursuit.ipynb`` cell 6
(``A = randn(M, N)``; a K-sparse ``xanswer`` of standard normal values at
random places; ``y = A @ xanswer``), made for every lane: the shared ``A`` on
the host from the seed, each lane's sparse answer and measurement on the
device from a generator seeded from it.  Every seed gives the same sizes.
"""
from __future__ import annotations

import numpy as np
import torch


def fixed(cfg: dict, seed: int) -> dict:
    """What every lane of a run shares: ``A`` (M, N), float64 numpy."""
    rng = np.random.default_rng([seed, 1])
    return {"A": rng.standard_normal((cfg["M"], cfg["N"]))}


def alphas(cfg: dict, spec, lanes: int) -> np.ndarray:
    """The lanes' L1 weights: a number for every lane, or ``{"logspace":
    [lo, hi, n]}`` (the notebook's lambda sweep), each value for ``lanes / n``
    consecutive lanes."""
    if isinstance(spec, dict):
        lo, hi, n = spec["logspace"]
        if lanes % n:
            raise ValueError(f"{lanes} lanes do not split into {n} weights")
        return np.repeat(np.logspace(lo, hi, n), lanes // n)
    return np.full(lanes, float(cfg["alpha1"] if spec is None else spec))


def batches(cfg: dict, inputs: dict, fix: dict, lanes: int, pool: int, gen: torch.Generator,
            device) -> list:
    """``pool`` batches of ``lanes`` lanes (float64, on ``device``): each lane
    the L1 weight of ``inputs["alpha1"]`` and a measurement ``y`` of a
    K-sparse answer; ``inputs["measurements"]`` = m answers a batch, lane l
    measuring answer ``l % m`` (with a weight sweep: every answer under every
    weight), else one answer a lane."""
    N, K = cfg["N"], cfg["K"]
    m = int(inputs.get("measurements", lanes))
    if lanes % m:
        raise ValueError(f"{lanes} lanes do not split into {m} measurements")
    A = torch.as_tensor(fix["A"], dtype=torch.float64, device=device)
    a1 = torch.as_tensor(alphas(cfg, inputs.get("alpha1"), lanes), dtype=torch.float64,
                         device=device)
    out = []
    for _ in range(pool):
        where = torch.rand((m, N), generator=gen, dtype=torch.float64,
                           device=device).argsort(dim=1)[:, :K]
        values = torch.randn((m, K), generator=gen, dtype=torch.float64, device=device)
        answer = torch.zeros((m, N), dtype=torch.float64, device=device)
        answer.scatter_(1, where, values)
        out.append({"y": (answer @ A.T).repeat(lanes // m, 1), "alpha1": a1,
                    "alpha_ls": torch.full((lanes,), float(cfg["alpha_ls"]),
                                           dtype=torch.float64, device=device)})
    return out


def port_model(cfg: dict, fix: dict):
    """The deployment's model in the code under test: ``LeastSquares(alpha,
    A, y) + L1Regularizer(alpha1, N)``, identity coupling (the lanes'
    ``y`` and weights come as overrides)."""
    from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, identity

    N, M = cfg["N"], cfg["M"]
    return Model([LeastSquares(float(cfg["alpha_ls"]), fix["A"], np.zeros(M)),
                  L1Regularizer(float(cfg["alpha1"]), N)],
                 [(1, 0, identity(N), identity(N))])
