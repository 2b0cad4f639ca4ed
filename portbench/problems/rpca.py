"""Inputs of the robust-PCA background-subtraction deployment, made from the
seed on the device.

Candès, Li, Ma & Wright (J. ACM 58(3):11, 2011, §4.3) fit PCP to 200
grayscale frames of 176 × 144 pixels of an airport hall, one frame a column
of M (25,344 × 200).  Those frames are not in the repository; each camera
(lane) here is a synthetic video of the same shape and make-up:

- a background of rank 3: three smooth non-negative images (sums of broad
  Gaussian blobs), the first the scene in [0.3, 0.7], the other two
  lighting components up to 0.1, each under a slow per-frame gain
  (illumination drift);
- a foreground of 3 to 8 moving rectangles of person shape (2.5 times as
  tall as wide, together 6.5-9% of a frame), each at a constant speed,
  bouncing off the frame's edges, each with an intensity offset of
  ±U(0.2, 0.6) over the background (a later rectangle occludes an earlier);
- the frames clipped to [0, 1] (the sensor's range), then Gaussian noise of
  sigma 1e-3 (8-bit quantisation).
"""
from __future__ import annotations

import math

import numpy as np
import torch

#: Gaussian blobs in each background component
BLOBS = 6
#: rectangles a camera: the fewest and the most
MOVERS = (3, 8)
#: the share of a frame the rectangles cover together, before overlaps
COVER = (0.065, 0.09)
#: a rectangle's height over its width
ASPECT = 2.5
OFFSET = (0.2, 0.6)
NOISE = 1e-3


def size(cfg: dict, device) -> dict:
    """The video of a lane on ``device``: ``height``, ``width``, ``m`` pixels,
    ``n`` frames and PCP's weight ``lam`` = 1/sqrt(max(m, n)).  On a card the
    configuration's own; on the CPU, where only the benchmark's own tests run
    a cell, the configuration's ``cpu_size`` (the published video would take
    them tens of minutes a case)."""
    s = cfg if torch.device(device).type == "cuda" else cfg["cpu_size"]
    H, W, n = int(s["height"]), int(s["width"]), int(s["n"])
    return {"height": H, "width": W, "m": H * W, "n": n, "lam": 1.0 / math.sqrt(max(H * W, n))}


def fixed(cfg: dict, seed: int) -> dict:
    """Nothing: the lanes share only the video's size, which follows the
    device (:func:`size`)."""
    return {}


def _u(gen, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, dtype=torch.float64, device=device)


def _background(sz: dict, lanes: int, gen, device) -> torch.Tensor:
    """(lanes, frames, height, width): three smooth non-negative components
    under slow gains."""
    H, W, T = int(sz["height"]), int(sz["width"]), int(sz["n"])
    f64 = dict(dtype=torch.float64, device=device)
    shape = (lanes, 3, BLOBS)
    cy, cx = _u(gen, shape, 0, H, device), _u(gen, shape, 0, W, device)
    sy, sx = _u(gen, shape, 0.15 * H, 0.45 * H, device), _u(gen, shape, 0.15 * W, 0.45 * W, device)
    amp = _u(gen, shape, 0.2, 1.0, device)
    ys, xs = torch.arange(H, **f64), torch.arange(W, **f64)
    gy = torch.exp(-0.5 * ((ys - cy[..., None]) / sy[..., None]) ** 2)        # (l, 3, J, H)
    gx = torch.exp(-0.5 * ((xs - cx[..., None]) / sx[..., None]) ** 2)        # (l, 3, J, W)
    comp = torch.einsum("lkj,lkjh,lkjw->lkhw", amp, gy, gx)
    lo = comp.amin(dim=(-2, -1), keepdim=True)
    comp = (comp - lo) / (comp.amax(dim=(-2, -1), keepdim=True) - lo)         # [0, 1]
    scale = torch.tensor([0.4, 0.1, 0.1], **f64)[None, :, None, None]
    base = torch.tensor([0.3, 0.0, 0.0], **f64)[None, :, None, None]
    comp = base + scale * comp
    # gains: 1 + a sin(2 pi r t / T + phi), r in 0.25-1 cycles a window
    t = torch.arange(T, **f64)
    amp_g = torch.tensor([0.05, 0.5, 0.5], **f64)[None, :, None]
    r, phi = _u(gen, (lanes, 3, 1), 0.25, 1.0, device), _u(gen, (lanes, 3, 1), 0, 2 * math.pi,
                                                           device)
    gain = 1.0 + amp_g * torch.sin(2 * math.pi * r * t / T + phi)              # (l, 3, T)
    return torch.einsum("lkt,lkhw->lthw", gain, comp)


def _bounce(p0: torch.Tensor, v: torch.Tensor, t: torch.Tensor, span: torch.Tensor):
    """Integer positions of a point from ``p0`` at speed ``v`` reflected
    inside [0, span]: (..., T)."""
    span = torch.clamp_min(span, 1e-9)[..., None]
    q = torch.remainder(p0[..., None] + v[..., None] * t, 2 * span)
    return torch.floor(span - (q - span).abs())


def video(sz: dict, lanes: int, gen, device):
    """(Y, background, foreground mask) of ``lanes`` cameras of ``sz["height"]``
    × ``sz["width"]`` pixels and ``sz["n"]`` frames: Y (lanes, m, n), one
    column a frame, a pixel a row (row-major over height × width); the
    background (lanes, m, n) and the mask of the rectangles (lanes, m, n)
    as they were before clipping and noise."""
    H, W, T = int(sz["height"]), int(sz["width"]), int(sz["n"])
    f64 = dict(dtype=torch.float64, device=device)
    bg = _background(sz, lanes, gen, device)
    K = torch.randint(MOVERS[0], MOVERS[1] + 1, (lanes, 1), generator=gen, device=device)
    cover = _u(gen, (lanes, 1), *COVER, device)
    area = cover * H * W / K                                                   # (l, 1)
    w = torch.sqrt(area / ASPECT).round().clamp(1.0, W)
    h = (area / w).round().clamp(1.0, H)
    w = w.expand(lanes, MOVERS[1])
    h = h.expand(lanes, MOVERS[1])
    shape = (lanes, MOVERS[1])
    x0, y0 = _u(gen, shape, 0, 1, device) * (W - w), _u(gen, shape, 0, 1, device) * (H - h)
    sign = lambda: torch.where(torch.rand(shape, generator=gen, device=device) < 0.5, -1.0, 1.0
                               ).to(torch.float64)
    vx, vy = sign() * _u(gen, shape, 0.5, 2.0, device), sign() * _u(gen, shape, 0.0, 0.5, device)
    off = sign() * _u(gen, shape, *OFFSET, device)
    active = torch.arange(MOVERS[1], device=device)[None, :] < K               # (l, 8)
    t = torch.arange(T, **f64)
    px, py = _bounce(x0, vx, t, W - w), _bounce(y0, vy, t, H - h)              # (l, 8, T)
    ys, xs = torch.arange(H, **f64), torch.arange(W, **f64)
    fg = torch.zeros((lanes, T, H, W), **f64)
    mask = torch.zeros((lanes, T, H, W), dtype=torch.bool, device=device)
    for k in range(MOVERS[1]):
        rows = (ys >= py[:, k, :, None]) & (ys < py[:, k, :, None] + h[:, k, None, None])
        cols = (xs >= px[:, k, :, None]) & (xs < px[:, k, :, None] + w[:, k, None, None])
        inside = rows[..., :, None] & cols[..., None, :] & active[:, k, None, None, None]
        fg = torch.where(inside, off[:, k, None, None, None], fg)
        mask |= inside
    frames = torch.clamp(bg + fg, 0.0, 1.0)
    frames = frames + NOISE * torch.randn(frames.shape, generator=gen, **f64)
    cols = lambda a: a.reshape(lanes, T, H * W).transpose(1, 2).contiguous()
    return cols(frames), cols(bg), cols(mask)


def batches(cfg: dict, inputs: dict, fix: dict, lanes: int, pool: int, gen: torch.Generator,
            device) -> list:
    """``pool`` batches of ``lanes`` cameras (float64, on ``device``): each
    the video ``Y`` (lanes, m, n) of one window, of the device's size."""
    sz = size(cfg, device)
    return [{"Y": video(sz, lanes, gen, device)[0]} for _ in range(pool)]


def port_model(cfg: dict, sz: dict):
    """The deployment's model in the code under test for videos of size
    ``sz`` (:func:`size`): ``rpca_model(Y, lam)`` (nuclear norm of L plus
    ``lam |Y - L|_1``, identity coupling, the spectral route its default
    ``"auto"``); the lanes' Y come as the L1 block's ``offset`` overrides."""
    from admmsolver_tpu_torch.models.applications import rpca_model

    return rpca_model(np.zeros((sz["m"], sz["n"])), lam=sz["lam"])
