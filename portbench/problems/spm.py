"""Inputs of the SpM analytic-continuation deployment, made from the seed.

SpM-lab/admmsolver ``notebooks/spm.ipynb`` takes its basis from
``sparse_ir``.  In its place stands a frozen numpy copy of the seeded
kernel SVD of ``admmsolver_tpu_torch.models.applications.
synthetic_spm_data`` (the fermionic kernel ``-exp(-tau w) / (1 + exp(-beta
w))`` on 2 nl imaginary times and nw real frequencies, weighted by d omega,
cut to its nl largest singular values; a two-peak unit-weight spectrum), so
that the benchmark's yardstick does not move with the code under test.  A
lane is one resample of the measurement: the clean data plus independent
noise of the configured size, drawn on the device from the seed.
"""
from __future__ import annotations

import numpy as np
import torch


def basis(nl: int, nw: int, beta: float, wmax: float):
    """(s, P, c, g): singular values (nl,), the coefficient-to-spectrum
    projector P (nw, nl), the sum-rule row c = 1 P (nl,) and the clean data
    g = -s (V rho dw) (nl,) of the two-peak spectrum; float64 numpy."""
    tau = np.linspace(0, beta, 2 * nl)
    omega = np.linspace(-wmax, wmax, nw)
    dw = np.gradient(omega)
    with np.errstate(over="ignore"):
        K = -np.exp(-tau[:, None] * omega[None, :]) / (1.0 + np.exp(-beta * omega[None, :]))
    _, S, Vh = np.linalg.svd(K * dw[None, :], full_matrices=False)
    s, V = S[:nl], Vh[:nl]
    rho = (np.exp(-0.5 * ((omega - 1.2) / 0.4) ** 2)
           + 0.7 * np.exp(-0.5 * ((omega + 1.0) / 0.6) ** 2))
    rho = rho / (rho * dw).sum()
    P = V.T
    return s, P, np.ones(nw) @ P, -s * (V @ (rho * dw))


def fixed(cfg: dict, seed: int) -> dict:
    """What every lane of a run shares (the seed does not change it)."""
    s, P, c, g = basis(cfg["nl"], cfg["nw"], cfg["beta"], cfg["wmax"])
    return {"s": s, "P": P, "c": c, "d": float(cfg["sum_value"]), "g": g}


def batches(cfg: dict, inputs: dict, fix: dict, lanes: int, pool: int, gen: torch.Generator,
            device) -> list:
    """``pool`` batches of ``lanes`` resamples ``g + noise * randn`` (float64,
    on ``device``)."""
    noise = float(inputs.get("noise", cfg["noise"]))
    g = torch.as_tensor(fix["g"], dtype=torch.float64, device=device)
    full = lambda v: torch.full((lanes,), float(v), dtype=torch.float64, device=device)
    return [{"y": g + noise * torch.randn((lanes, g.numel()), generator=gen,
                                          dtype=torch.float64, device=device),
             "alpha_ls": full(cfg["alpha_ls"]), "alpha1": full(cfg["alpha1"])}
            for _ in range(pool)]


def port_model(cfg: dict, fix: dict):
    """The deployment's model in the code under test, built as the notebook
    builds it (``spm_model``: constrained least squares with the sum rule,
    L1, non-negativity through the projector)."""
    from admmsolver_tpu_torch.models.applications import spm_model

    return spm_model(fix["s"], fix["g"], fix["c"], fix["P"], alpha_l1=float(cfg["alpha1"]),
                     sum_value=fix["d"])
