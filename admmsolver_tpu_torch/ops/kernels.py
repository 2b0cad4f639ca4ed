"""Fused multi-iteration ADMM for 2-block problems: Hopper kernel + plain version.

Counterpart of :func:`admmsolver_tpu.ops.kernels.fused_two_block_chunk`
(a Pallas TPU kernel).  The flagship identity-coupled family (basis
pursuit / LASSO / λ-sweeps) runs ``n_iters`` Gauss–Seidel iterations per
lane with the lane's state kept on chip:

    v   = acy + h + mu·x1
    x0  = ((v U) · dinv) Ut        (+ v/mu in the thin rank-R form)
    x1  = prox(x0 - h/mu)          # soft-threshold or nonneg clip
    h  += mu (x1 - x0)             # dual ascent

On CUDA tensors :func:`fused_two_block_chunk` launches the hand-written
kernel in ``csrc/fused_two_block.cu``; on CPU tensors it runs
:func:`fused_two_block_chunk_reference`, the same math in torch ops.
float32 only.  Penalty updates and convergence checks run between chunks
(:mod:`admmsolver_tpu_torch.parallel.fused`).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

__all__ = ["fused_two_block_chunk", "fused_two_block_chunk_reference"]

_PROX = {"l1": 0, "l1_even": 1, "nonneg": 2, "nonneg_even": 3}
# Lanes per thread block the CUDA kernel is instantiated for, largest first.
_TILES = (32, 16, 8, 4, 2, 1)

Chunk = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def fused_two_block_chunk_reference(U, Ut, dinv, acy, mu, thr, x0, x1, h,
                                    n_iters: int, prox: str = "l1",
                                    thin: bool = False) -> Chunk:
    """Plain torch version of :func:`fused_two_block_chunk`, on any device."""
    x0_prev = x0
    odd = torch.arange(x0.shape[1], device=x0.device) % 2 == 1
    for _ in range(n_iters):
        v = acy + h + mu * x1
        w = (v @ U) * dinv
        x0n = w @ Ut
        if thin:
            x0n = x0n + v / mu
        z = x0n - h / mu
        if prox.startswith("l1"):
            x1 = torch.sign(z) * torch.clamp_min(torch.abs(z) - thr, 0.0)
        else:
            x1 = torch.clamp_min(z, 0.0)
        if prox.endswith("_even"):
            x1 = torch.where(odd, torch.zeros((), dtype=x1.dtype, device=x1.device), x1)
        h = h + mu * (x1 - x0n)
        x0_prev, x0 = x0, x0n
    return x0, x1, h, x0_prev


def _check(U, Ut, dinv, acy, mu, thr, x0, x1, h, n_iters, prox):
    if prox not in _PROX:
        raise ValueError(f"prox must be one of {sorted(_PROX)}, got {prox!r}")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    B, N = x0.shape
    R = U.shape[1]
    if B == 0:
        raise ValueError("empty batch")
    shapes = {"U": (U, (N, R)), "Ut": (Ut, (R, N)), "dinv": (dinv, (B, R)),
              "acy": (acy, (B, N)), "mu": (mu, (B, 1)), "thr": (thr, (B, 1)),
              "x1": (x1, (B, N)), "h": (h, (B, N))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for t in (U, Ut, dinv, acy, mu, thr, x0, x1, h):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_two_block_chunk is float32 only, got {t.dtype}")
        if t.device != x0.device:
            raise ValueError(f"tensors on {t.device} and {x0.device}")


def _tile_lanes(lib, device: int, N: int, R: int) -> int:
    limit = ctypes.c_int()
    err = lib.fused_two_block_max_smem(device, ctypes.byref(limit))
    if err:
        raise RuntimeError(lib.fused_two_block_error_string(err).decode())
    for tb in _TILES:
        if lib.fused_two_block_smem_bytes(tb, N, R) <= limit.value:
            return tb
    raise ValueError(
        f"N={N}, R={R} needs {lib.fused_two_block_smem_bytes(1, N, R)} bytes of "
        f"shared memory for one lane, above this device's {limit.value}-byte "
        "limit per block")


def fused_two_block_chunk(U, Ut, dinv, acy, mu, thr, x0, x1, h,
                          n_iters: int, prox: str = "l1",
                          thin: bool = False) -> Chunk:
    """Run ``n_iters`` fused ADMM iterations on a batch of 2-block problems.

    Shapes: ``U`` (N, R) / ``Ut`` (R, N) shared eigenbasis — the full basis
    (R = N, ``thin=False``, ``dinv`` = 1/(alpha·lam + mu)) or the thin
    rank-R basis of a wide data matrix (``thin=True``, ``dinv`` =
    1/(alpha·lam + mu) − 1/mu, null space in closed form); ``dinv`` (B, R);
    ``acy`` = alpha·A†y (B, N); ``mu``/``thr`` (B, 1); state ``x0``/``x1``/
    ``h`` (B, N); all float32.  ``prox`` is ``l1``, ``nonneg`` or their
    ``_even`` forms, which zero the odd columns of x1.  Returns
    (x0, x1, h, x0_prev), ``x0_prev`` being the x0 the last iteration
    started from (for the dual residual).

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream without synchronising (and count it in
    ``fused_two_block_chunk.launches``); they must be contiguous.
    """
    _check(U, Ut, dinv, acy, mu, thr, x0, x1, h, n_iters, prox)
    device = x0.device
    if device.type == "cpu":
        return fused_two_block_chunk_reference(U, Ut, dinv, acy, mu, thr,
                                               x0, x1, h, n_iters, prox, thin)
    if device.type != "cuda":
        raise ValueError(f"no fused_two_block_chunk for device {device}")
    args = (U, Ut, dinv, acy, mu, thr, x0, x1, h)
    if not all(t.is_contiguous() for t in args):
        raise ValueError("fused_two_block_chunk needs contiguous tensors")
    B, N = x0.shape
    R = U.shape[1]
    lib = _build.load_library()
    index = device.index if device.index is not None else torch.cuda.current_device()
    tb = _tile_lanes(lib, index, N, R)
    outs = tuple(torch.empty_like(x0) for _ in range(4))
    err = lib.fused_two_block_chunk(
        index, *(t.data_ptr() for t in args + outs), B, N, R, int(n_iters),
        _PROX[prox], int(bool(thin)), tb, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("fused_two_block_chunk launch failed: "
                           + lib.fused_two_block_error_string(err).decode())
    fused_two_block_chunk.launches += 1
    return outs


#: Number of kernel launches (CUDA tensors only) since the last reset.
fused_two_block_chunk.launches = 0
