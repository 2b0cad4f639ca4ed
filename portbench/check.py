"""The numbers that decide ``correct``: what the timed calls returned,
against the plain reference run on the same inputs once the window has
closed.

Each number is a function of the port's outputs and the reference's for the
lanes of one sampled call; a run reads the worst over its sampled calls.  A
workload names the numbers it compares and their limits (``check.limits``).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch


def lane_gaps(port_x, ref_x, blocks) -> torch.Tensor:
    """Per lane, the widest gap between the port's and the reference's
    blocks ``blocks``, each over the larger of the lane's own largest
    reference value and the median lane's (a lane whose reference is all but
    zero is measured on the batch's scale).  A non-finite answer reads inf."""
    worst = None
    for k in blocks:
        xr = ref_x[k].double()
        xp = port_x[k].double()
        scale = xr.abs().amax(dim=1)
        scale = torch.maximum(scale, scale.median())
        gap = (xp - xr).abs().amax(dim=1) / scale
        gap = torch.where(torch.isfinite(xp).all(dim=1), gap, torch.full_like(gap, float("inf")))
        worst = gap if worst is None else torch.maximum(worst, gap)
    return worst


def x_gap(port, ref, fix, spec) -> float:
    """The widest gap of any lane (``lane_gaps``)."""
    return float(lane_gaps(port["x"], ref["x"], spec["blocks"]).max())


def x_gap_p90(port, ref, fix, spec) -> float:
    """The gap that 90% of the lanes stay within: steady where a few lanes'
    discrete penalty decisions part the two trajectories, and still failed
    by a tenth of the lanes gone wrong."""
    return float(torch.quantile(lane_gaps(port["x"], ref["x"], spec["blocks"]), 0.9))


def lanes_off_pct(port, ref, fix, spec) -> float:
    """The share of lanes, in percent, whose gap exceeds the check's
    ``lane_level``: a group of lanes gone wrong shows here however few they
    are, where a quantile of the gaps would pass them."""
    gaps = lane_gaps(port["x"], ref["x"], spec["blocks"])
    return float(100.0 * (gaps > float(spec["lane_level"])).double().mean())


def sum_rule(port, ref, fix, spec) -> float:
    """The widest breach of the configuration's equality ``c x0 = d`` by the
    port's x0 (the benchmark's own c and d)."""
    x0 = port["x"][0].double()
    c = torch.as_tensor(fix["c"], dtype=torch.float64, device=x0.device)
    r = (x0 @ c - float(fix["d"])).abs()
    return float(torch.where(torch.isfinite(r), r, torch.full_like(r, float("inf"))).max())


NUMBERS: Dict[str, Callable] = {"x_gap": x_gap, "x_gap_p90": x_gap_p90,
                                "lanes_off_pct": lanes_off_pct, "sum_rule": sum_rule}


def compare(port: dict, ref: dict, fix: dict, spec: dict) -> Dict[str, float]:
    """Every number that ``spec["limits"]`` names, for one call."""
    return {name: NUMBERS[name](port, ref, fix, spec) for name in spec["limits"]}


def lanes(batch: dict, lo: int, hi: int) -> dict:
    """Lanes ``lo:hi`` of a batch of per-lane tensors."""
    return {k: v[lo:hi] for k, v in batch.items()}


def on(d: dict, dtype, device) -> dict:
    """The values of ``d`` as tensors of ``dtype`` on ``device`` (numbers and
    strings as they are)."""
    out = {}
    for k, v in d.items():
        if isinstance(v, (int, float, str)):
            out[k] = v
        else:
            out[k] = torch.as_tensor(v).to(device=device, dtype=dtype)
    return out
