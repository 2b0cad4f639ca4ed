"""Inputs of the ragged stream deployment, made from the seed.

Phase-transition trials as Donoho & Tanner draw them (a K-sparse answer of
standard normal values at random places, measured by a Gaussian A at
undersampling delta = M/N), each scenario with its own sparsity K, uniform
on ``inputs["K"]`` (lo, hi inclusive), and its own L1 weight,
``10 ** U(inputs["log10_alpha1"])``.  A is the basis-pursuit deployment's,
the same from the seed (``basis_pursuit.fixed``); each scenario's K, support,
values, y and weight are drawn on the device from the generator.
"""
from __future__ import annotations

import torch

from .basis_pursuit import fixed, port_model  # noqa: F401  (the same A and model)


def batches(cfg: dict, inputs: dict, fix: dict, lanes: int, pool: int, gen: torch.Generator,
            device) -> list:
    """``pool`` streams of ``lanes`` scenarios (float64, on ``device``): each
    the measurement ``y`` of its own K-sparse answer, its L1 weight
    ``alpha1`` and the configuration's ``alpha_ls``."""
    N = cfg["N"]
    klo, khi = inputs.get("K", cfg["K"])
    alo, ahi = inputs.get("log10_alpha1", cfg["log10_alpha1"])
    f64 = dict(dtype=torch.float64, device=device)
    A = torch.as_tensor(fix["A"], **f64)
    out = []
    for _ in range(pool):
        K = torch.randint(int(klo), int(khi) + 1, (lanes,), generator=gen, device=device)
        order = torch.rand((lanes, N), generator=gen, **f64).argsort(dim=1)
        first = torch.arange(N, device=device)[None, :] < K[:, None]
        support = torch.zeros((lanes, N), dtype=torch.bool, device=device).scatter_(
            1, order, first)
        values = torch.randn((lanes, N), generator=gen, **f64)
        answer = torch.where(support, values, torch.zeros((), **f64))
        u = torch.rand(lanes, generator=gen, **f64)
        out.append({"y": answer @ A.T, "alpha1": 10.0 ** (alo + (ahi - alo) * u),
                    "alpha_ls": torch.full((lanes,), float(cfg["alpha_ls"]), **f64)})
    return out
