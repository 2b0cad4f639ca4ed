"""The port's Hopper kernels, each beside its plain version: the fused
multi-iteration ADMM chunks, counterparts of the two Pallas TPU kernels of
:mod:`admmsolver_tpu.ops.kernels`, and the batched Jacobi eigendecomposition
(:func:`jacobi_eigh`, the card's form of the JAX package's
``linop.jacobi_eigh``, no Pallas kernel there).

:func:`fused_two_block_chunk` — the flagship identity-coupled family (basis
pursuit / LASSO / λ-sweeps) runs ``n_iters`` Gauss–Seidel iterations per
lane with the lane's state kept on chip:

    v   = acy + h + mu·x1
    x0  = ((v U) · dinv) Ut        (+ v/mu in the thin rank-R form)
    x1  = prox(x0 - h/mu)          # soft-threshold or nonneg clip
    h  += mu (x1 - x0)             # dual ascent

:func:`fused_spm_chunk` — the 3-block SpM analytic-continuation family
(constrained least squares folded into a per-lane affine map ``x0 = b2 -
M hk0``, L1, nonnegativity through a shared projector ``P``):

    hk0 = -h10 - mu1·x1 - Pᵀ(h20 + mu2·x2)
    x0  = b2 - M hk0
    x1  = soft_threshold(-(h10 - mu1·x0)/mu1, thr1)
    x2  = max(-(h20 - mu2·P x0)/mu2, 0)
    h10 += mu1 (x1 - x0);  h20 += mu2 (x2 - P x0)

:func:`spm_factor_refresh` — the SpM chunk's per-lane factor ``M``, ``b2``
(an HPD inverse with the sum rule folded in), once a chunk before it.

On CUDA tensors each wrapper launches its hand-written kernel
(``csrc/fused_two_block.cu``, ``csrc/fused_spm.cu``,
``csrc/spm_factor_refresh.cu``); on CPU tensors it runs its
``*_reference``, the same math in torch ops.  float32 only.  Each chunk
source holds a kernel that runs the products shared by all lanes on the
tensor cores in split TF32 (every f32 operand as a TF32 head plus a TF32
tail, three products each, f32 sums: f32 accuracy, unlike plain TF32,
which stays banned) and one in f32 FMA for the shapes the first is not
built for; the two-block source also a wgmma kernel for the thin basis
(R <= 128).  The wrappers choose (``_two_block_tiling``, ``_spm_tiling``).
Penalty updates and convergence checks run between chunks
(:mod:`admmsolver_tpu_torch.parallel.fused`,
:mod:`admmsolver_tpu_torch.parallel.fused_spm`).
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .linop import defer_cholesky_info, inv_hpd

__all__ = ["fused_two_block_chunk", "fused_two_block_chunk_reference",
           "fused_spm_chunk", "fused_spm_chunk_reference",
           "spm_factor_refresh", "spm_factor_refresh_reference",
           "jacobi_eigh", "jacobi_eigh_reference"]

_PROX = {"l1": 0, "l1_even": 1, "nonneg": 2, "nonneg_even": 3}
# Lanes per thread block the two-block CUDA kernel is instantiated for,
# largest first, and the columns of a k-tile of U or Ut in its ring.
_TILES = (32, 16, 8, 4, 2, 1)
_TWO_BLOCK_CW = 256
# What the wrapper asks for: at most this many k-tiles in the ring, and
# clusters of this many blocks sharing each k-tile.
_TWO_BLOCK_STAGES = 4
_TWO_BLOCK_CLUSTER = 2
# The wgmma kernel (route 2): the widest thin basis it takes, and at most
# this many stages in each of its two rings.
_TWO_BLOCK_WG_MAX_R = 128
_TWO_BLOCK_WG_STAGES = 4
#: The routes of the two-block kernel by ``TwoBlockTiling.tensor_cores``.
TWO_BLOCK_ROUTES = {2: "wgmma", 1: "mma_sync", 0: "fma"}

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


class TwoBlockTiling(NamedTuple):
    """How one launch of the two-block CUDA kernel is cut."""
    lanes: int        # lanes (instances) per thread block
    kt: int           # rows of a k-tile of U or Ut
    stages: int       # k-tiles in the shared-memory ring
    cluster: int      # blocks that share each k-tile by multicast
    tensor_cores: int  # 2: wgmma (R <= 128), 1: mma.sync, both split TF32; 0: f32 FMA


def _two_block_smem_bytes(tb: int, N: int, R: int, kt: int, stages: int,
                          tensor_cores: int = 0) -> int:
    """Dynamic shared memory of one block of the CUDA kernel, in bytes (the
    kernel's own layout: the ring of k-tiles, then v, h and w k-major, mu
    and thr, two barriers per stage; see ``csrc/fused_two_block.cu``).
    The wgmma kernel (``tensor_cores`` 2): a 1024-byte alignment margin, v
    (N rounded up to 64), w and its tail (R rounded up to 32) and two tail
    slices of 64 k, all in 4 KiB atoms of 32 lanes; two rings of ``stages``
    8 KiB tiles; mu, 1/mu, thr; two barriers per stage and ring."""
    if tensor_cores == 2:
        atoms = 2 * -(-N // 64) + 2 * -(-R // 32) + 4
        return 1024 + 4 * (1024 * atoms + 2 * stages * 2048 + 96) + 32 * stages
    nk, rk = -(-N // kt) * kt, -(-R // kt) * kt
    # The tensor-core kernel pads a k-tile's rows and keeps h in device memory.
    row, state = (_TWO_BLOCK_CW + 8, nk + rk) if tensor_cores else (_TWO_BLOCK_CW, 2 * nk + rk)
    return 4 * (stages * kt * row + state * tb + 2 * max(tb, 4)) + 16 * stages


def _two_block_tiling(N: int, R: int, smem_limit: int, aligned: bool = True,
                      tensor_cores: bool = True) -> TwoBlockTiling:
    """The tiling for a launch.  A thin basis (R <= ``_TWO_BLOCK_WG_MAX_R``)
    runs the wgmma kernel (32 lanes a block, route 2, no cluster) with the
    deepest pair of rings up to ``_TWO_BLOCK_WG_STAGES`` that fits
    ``smem_limit`` bytes, where two stages fit and ``tensor_cores`` holds.
    Otherwise: the most lanes per block whose state fits beside a ring of
    at least two k-tiles (more lanes per block mean fewer passes of U and
    Ut through L2), the deeper k-tile of those the kernel is built for,
    then the deepest ring up to ``_TWO_BLOCK_STAGES``.  Blocks of 32 lanes
    run the mma.sync tensor-core kernel unless ``tensor_cores`` is false
    (the FMA kernel at 32 lanes is built for 32-row k-tiles only).
    A cluster shares each k-tile between its blocks by multicast; it needs
    bulk copies, hence N and R multiples of 4 and 16-byte aligned bases
    (``aligned``)."""
    cluster = _TWO_BLOCK_CLUSTER if aligned and N % 4 == 0 and R % 4 == 0 else 1
    if tensor_cores and R <= _TWO_BLOCK_WG_MAX_R:
        fits = [s for s in range(2, _TWO_BLOCK_WG_STAGES + 1)
                if _two_block_smem_bytes(32, N, R, 32, s, 2) <= smem_limit]
        if fits:
            return TwoBlockTiling(32, 32, max(fits), 1, 2)
    for tb in _TILES:
        tc = int(bool(tensor_cores) and tb == 32)
        for kt in ((32, 16) if tc else (32,) if tb == 32 else (16,)):
            fits = [s for s in range(2, _TWO_BLOCK_STAGES + 1)
                    if _two_block_smem_bytes(tb, N, R, kt, s, tc) <= smem_limit]
            if fits:
                return TwoBlockTiling(tb, kt, max(fits), cluster, tc)
    raise ValueError(
        f"N={N}, R={R} needs {_two_block_smem_bytes(1, N, R, 16, 2)} bytes of "
        f"shared memory for one lane, above this device's {smem_limit}-byte "
        "limit per block")


def _two_block_launch(args, n_iters: int, prox: str, thin: bool,
                      tiling: Optional[TwoBlockTiling] = None) -> Chunk:
    """Launch the CUDA kernel on checked, contiguous CUDA tensors.
    ``tiling`` overrides :func:`_two_block_tiling`; a tiling the kernel is
    not built for, or one that does not fit, fails at the launch."""
    x0 = args[6]
    device = x0.device
    B, N = x0.shape
    R = args[0].shape[1]
    lib = _build.load_libraries()["fused_two_block"]
    index = device.index if device.index is not None else torch.cuda.current_device()
    if tiling is None:
        limit = ctypes.c_int()
        err = lib.fused_two_block_max_smem(index, ctypes.byref(limit))
        if err:
            raise RuntimeError(lib.fused_two_block_error_string(err).decode())
        tiling = _two_block_tiling(N, R, limit.value,
                                   all(t.data_ptr() % 16 == 0 for t in args[:2]))
    outs = tuple(torch.empty_like(x0) for _ in range(4))
    err = lib.fused_two_block_launch(
        index, *(t.data_ptr() for t in tuple(args) + outs), B, N, R, int(n_iters),
        _PROX[prox], int(bool(thin)), *(int(t) for t in tiling),
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("fused_two_block_chunk launch failed: "
                           + lib.fused_two_block_error_string(err).decode())
    fused_two_block_chunk.launches += 1
    fused_two_block_chunk.routes[TWO_BLOCK_ROUTES[tiling.tensor_cores]].launches += 1
    return outs


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
    ``fused_two_block_chunk.launches`` and, by route, in
    ``fused_two_block_chunk.routes``); they must be contiguous.  The
    tensor-core kernels split every operand into a TF32 head and tail: a
    lane that holds an inf, a NaN or a value within 2^-12 of the largest
    float comes out as NaN where the plain version may give inf, and no
    other lane is touched.
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
    return _two_block_launch(args, n_iters, prox, thin)


class _Launches:
    """The launches of one route of a kernel's wrapper, counted apart;
    telemetry reports them as ``kernel.<__name__>.launches``."""

    def __init__(self, name: str) -> None:
        self.__name__ = name
        self.launches = 0


#: Number of kernel launches (CUDA tensors only) since the last reset.
fused_two_block_chunk.launches = 0
#: The same, by route (``TWO_BLOCK_ROUTES``).
fused_two_block_chunk.routes = {name: _Launches(f"fused_two_block_chunk.{name}")
                                for name in TWO_BLOCK_ROUTES.values()}


# ---------------------------------------------------------------------
# Fused 3-block SpM chunk
# ---------------------------------------------------------------------

SpMChunk = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                 torch.Tensor, torch.Tensor]

# Lanes per warp the FMA kernel is instantiated for, and its limit on warps
# per block; the widths up to which the tensor-core kernel is built, and the
# tiles of eight frequencies a warp of it may take (its instantiations: 8
# warps a block, so 64, 128 and 256 frequencies).
_SPM_LANES_PER_WARP = (1, 2, 4)
_SPM_MAX_WARPS = 16
_SPM_TC_MAX = (32, 256)   # nl, nw
_SPM_TC_TILES = (1, 2, 4)
#: The kernels of :func:`fused_spm_chunk` on a CUDA device, by route.
SPM_ROUTES = ("mma_sync", "fma")


def fused_spm_chunk_reference(P, M, b2, mu, thr, x0, x1, x2, h10, h20,
                              n_iters: int) -> SpMChunk:
    """Plain torch version of :func:`fused_spm_chunk`, on any device."""
    mu1, mu2 = mu[:, :1], mu[:, 1:]
    Pt = P.T
    x0_prev = x0
    for _ in range(n_iters):
        hk0 = -h10 - mu1 * x1 - (h20 + mu2 * x2) @ P
        x0n = b2 - (M @ hk0[:, :, None])[:, :, 0]
        z1 = -(h10 - mu1 * x0n) / mu1
        x1 = torch.sign(z1) * torch.clamp_min(torch.abs(z1) - thr, 0.0)
        Px0 = x0n @ Pt
        z2 = -(h20 - mu2 * Px0) / mu2
        x2 = torch.clamp_min(z2, 0.0)
        h10 = h10 + mu1 * (x1 - x0n)
        h20 = h20 + mu2 * (x2 - Px0)
        x0_prev, x0 = x0, x0n
    return x0, x1, x2, h10, h20, x0_prev


def _check_spm(P, M, b2, mu, thr, x0, x1, x2, h10, h20, n_iters):
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    if x0.ndim != 2 or P.ndim != 2:
        raise ValueError(f"x0 and P must be 2-D, got {tuple(x0.shape)}, {tuple(P.shape)}")
    B, nl = x0.shape
    nw = P.shape[0]
    if B == 0 or nl == 0 or nw == 0:
        raise ValueError(f"empty problem: B={B}, nl={nl}, nw={nw}")
    shapes = {"P": (P, (nw, nl)), "M": (M, (B, nl, nl)), "b2": (b2, (B, nl)),
              "mu": (mu, (B, 2)), "thr": (thr, (B, 1)), "x1": (x1, (B, nl)),
              "x2": (x2, (B, nw)), "h10": (h10, (B, nl)), "h20": (h20, (B, nw))}
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    for t in (P, M, b2, mu, thr, x0, x1, x2, h10, h20):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_spm_chunk is float32 only, got {t.dtype}")
        if t.device != x0.device:
            raise ValueError(f"tensors on {t.device} and {x0.device}")


def _spm_tc_tiling(nl: int, nw: int) -> Optional[Tuple[int, int]]:
    """The tensor-core kernel's tiling, (0, k), where it takes the widths
    (nl <= 32, nw <= 256), else None.  A block holds 16 lanes in 8 warps;
    warp w computes P x0 for the tiles of eight frequencies w, w + 8, ...,
    so k is the fewest instantiated tiles a warp (``_SPM_TC_TILES``) of at
    least ceil(nw / 64)."""
    if nl > _SPM_TC_MAX[0] or nw > _SPM_TC_MAX[1]:
        return None
    return 0, next(k for k in _SPM_TC_TILES if 64 * k >= nw)


def _spm_route(tiling: Tuple[int, int]) -> str:
    """The route (``SPM_ROUTES``) a tiling launches."""
    return SPM_ROUTES[int(tiling[0] != 0)]


def _spm_tiling(lib, device: int, B: int, nl: int, nw: int,
                tensor_cores: bool = True) -> Tuple[int, int]:
    """(lanes per warp, warps per block) for a launch; (0, k) is the
    tensor-core kernel (:func:`_spm_tc_tiling`), taken wherever nl and nw
    are within the widths it is built for unless ``tensor_cores`` is false.
    Otherwise the FMA kernel is cut so: a block should hold
    its multiprocessor's share of the batch, so that the batch runs as one
    wave, within the shared-memory limit; among the lane groups that hold
    the most of it, the one with the most warps wins (more warps hide more
    latency), then the narrower one."""
    limit = ctypes.c_int()
    err = lib.fused_spm_max_smem(device, ctypes.byref(limit))
    if err:
        raise RuntimeError(lib.fused_spm_error_string(err).decode())
    tc = _spm_tc_tiling(nl, nw) if tensor_cores else None
    if tc is not None and lib.fused_spm_smem_bytes(0, nl, nw) <= limit.value:
        return tc
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_sm = -(-B // sms)
    best = None
    for lpw in _SPM_LANES_PER_WARP:
        warps = min(_SPM_MAX_WARPS, -(-per_sm // lpw))
        while warps > 1 and lib.fused_spm_smem_bytes(warps * lpw, nl, nw) > limit.value:
            warps -= 1
        if lib.fused_spm_smem_bytes(warps * lpw, nl, nw) > limit.value:
            continue
        key = (min(warps * lpw, per_sm), warps, -lpw)
        if best is None or key > best[0]:
            best = (key, (lpw, warps))
    if best is None:
        raise ValueError(
            f"nl={nl}, nw={nw} needs {lib.fused_spm_smem_bytes(1, nl, nw)} bytes of "
            f"shared memory for P and one lane, above this device's {limit.value}-byte "
            "limit per block")
    return best[1]


def _spm_launch(args, n_iters: int, tiling: Optional[Tuple[int, int]] = None) -> SpMChunk:
    """Launch the CUDA kernel on checked, contiguous CUDA tensors.
    ``tiling`` = (lanes per warp, warps per block) overrides
    :func:`_spm_tiling` ((0, k): the tensor-core kernel with at most k
    tiles of frequencies a warp); a tiling that does not fit fails at the
    launch."""
    x0, x2 = args[5], args[7]
    device = x0.device
    B, nl = x0.shape
    nw = x2.shape[1]
    lib = _build.load_libraries()["fused_spm"]
    index = device.index if device.index is not None else torch.cuda.current_device()
    lpw, warps = tiling if tiling is not None else _spm_tiling(lib, index, B, nl, nw)
    outs = tuple(torch.empty_like(t) for t in (x0, x0, x2, x0, x2, x0))
    err = lib.fused_spm_launch(
        index, *(t.data_ptr() for t in tuple(args) + outs), B, nl, nw, int(n_iters),
        int(lpw), int(warps), torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("fused_spm_chunk launch failed: "
                           + lib.fused_spm_error_string(err).decode())
    fused_spm_chunk.launches += 1
    fused_spm_chunk.routes[_spm_route((lpw, warps))].launches += 1
    return outs


def fused_spm_chunk(P, M, b2, mu, thr, x0, x1, x2, h10, h20,
                    n_iters: int) -> SpMChunk:
    """Run ``n_iters`` fused SpM 3-block iterations on a batch.

    Batch-major shapes (the TPU kernel is feature-major and padded; this
    one takes nl, nw and B as they are): shared projector ``P`` (nw, nl);
    per-lane affine factor ``M`` (B, nl, nl) and ``b2`` (B, nl) with
    ``x0 = b2 - M hk0``; ``mu`` (B, 2) = [mu1, mu2] for the pairs (1, 0)
    and (2, 0); ``thr`` (B, 1) = alpha1 / (2 mu1); state ``x0``/``x1``/
    ``h10`` (B, nl), ``x2``/``h20`` (B, nw); all float32.  Returns
    (x0, x1, x2, h10, h20, x0_prev), ``x0_prev`` being the x0 the last
    iteration started from (for the dual residuals).

    CPU tensors run the plain version.  CUDA tensors launch the kernel on
    the current stream without synchronising (and count it in
    ``fused_spm_chunk.launches`` and, by route, in
    ``fused_spm_chunk.routes``); they must be contiguous.
    """
    args = (P, M, b2, mu, thr, x0, x1, x2, h10, h20)
    _check_spm(*args, n_iters)
    device = x0.device
    if device.type == "cpu":
        return fused_spm_chunk_reference(*args, n_iters)
    if device.type != "cuda":
        raise ValueError(f"no fused_spm_chunk for device {device}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("fused_spm_chunk needs contiguous tensors")
    return _spm_launch(args, n_iters)


#: Number of kernel launches (CUDA tensors only) since the last reset.
fused_spm_chunk.launches = 0
#: The same, by route (``SPM_ROUTES``).
fused_spm_chunk.routes = {name: _Launches(f"fused_spm_chunk.{name}") for name in SPM_ROUTES}


# ---------------------------------------------------------------------
# SpM factor refresh (the affine map the SpM chunk kernel reads)
# ---------------------------------------------------------------------

#: The widest nl and the most sum-rule rows the warp kernel takes.
_REFRESH_WARP_NL = 32
_REFRESH_WARP_NC = 4
#: The kernels of :func:`spm_factor_refresh` on a CUDA device.
REFRESH_ROUTES = ("warp", "block")


def spm_factor_refresh_reference(AcA, W, C, D, alpha_ls, mu1, mu2,
                                 acy) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`spm_factor_refresh`, on any device and
    in any dtype: batched Cholesky inverses (``inv_hpd``) and products."""
    eye = torch.eye(AcA.shape[0], dtype=AcA.dtype, device=AcA.device)
    Mpen = (alpha_ls[:, None, None] * AcA
            + mu1[:, None, None] * eye
            + mu2[:, None, None] * W)
    M = inv_hpd(Mpen)                                   # (B, nl, nl)
    b2 = None
    if C is not None:
        Bf = M
        xi2 = -(Bf @ C.T)                               # (B, nl, nc)
        Sinv = -inv_hpd(-(C @ xi2))                     # (B, nc, nc)
        M = Bf - xi2 @ (Sinv @ (C @ Bf))
        b2 = (xi2 @ (Sinv @ D)[:, :, None])[:, :, 0]
    aMy = alpha_ls[:, None] * (M @ acy[:, :, None])[:, :, 0]
    return M.contiguous(), (aMy if b2 is None else aMy + b2).contiguous()


def _refresh_route(device: torch.device, dtype: torch.dtype, nl: int, nc: int) -> str:
    """"plain" on the CPU; on a CUDA device, float32 only, the warp kernel
    ("warp", a warp a lane in registers) at nl <= 32 with at most 4 sum-rule
    rows and the block kernel ("block", a block a lane in shared memory) at
    any other shape."""
    if device.type == "cpu":
        return "plain"
    if device.type != "cuda":
        raise ValueError(f"no spm_factor_refresh for device {device}")
    if dtype != torch.float32:
        raise TypeError(f"spm_factor_refresh is float32 only on CUDA, got {dtype}")
    return "warp" if nl <= _REFRESH_WARP_NL and nc <= _REFRESH_WARP_NC else "block"


def _check_refresh(AcA, W, C, D, alpha_ls, mu1, mu2, acy) -> None:
    B, nl = acy.shape
    if B == 0 or nl == 0:
        raise ValueError(f"empty problem: B={B}, nl={nl}")
    shapes = {"AcA": (AcA, (nl, nl)), "W": (W, (nl, nl)), "alpha_ls": (alpha_ls, (B,)),
              "mu1": (mu1, (B,)), "mu2": (mu2, (B,))}
    if C is not None:
        shapes.update(C=(C, (C.shape[0], nl)), D=(D, (C.shape[0],)))
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != acy.dtype or t.device != acy.device:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, acy {acy.dtype} on "
                             f"{acy.device}")


def _refresh_launch(AcA, W, C, D, alpha_ls, mu1, mu2, acy, route: str):
    """Launch the CUDA kernel of ``route`` ("warp" or "block") on checked
    CUDA float32 tensors; returns (M, b2, info).  A route that does not take
    the shape fails at the launch."""
    B, nl = acy.shape
    device = acy.device
    lib = _build.load_libraries()["spm_factor_refresh"]
    index = device.index if device.index is not None else torch.cuda.current_device()
    nc = 0 if C is None else C.shape[0]
    block = int(route == "block")
    if block:
        limit = ctypes.c_int()
        err = lib.spm_factor_refresh_max_smem(index, ctypes.byref(limit))
        if err:
            raise RuntimeError(lib.spm_factor_refresh_error_string(err).decode())
        need = lib.spm_factor_refresh_smem_bytes(nl, nc, 1)
        if need > limit.value:
            raise ValueError(f"nl={nl}, nc={nc} needs {need} bytes of shared memory for one "
                             f"lane, above this device's {limit.value}-byte limit per block")
    if acy.stride(1) != 1:
        acy = acy.contiguous()
    shared = [t.contiguous() for t in (AcA, W)]
    if nc:
        shared += [C.contiguous(), D.contiguous()]
    M = torch.empty((B, nl, nl), dtype=acy.dtype, device=device)
    b2 = torch.empty((B, nl), dtype=acy.dtype, device=device)
    info = torch.empty((B,), dtype=torch.int32, device=device)
    ptrs = [t.data_ptr() for t in shared] + [None] * (4 - len(shared))
    err = lib.spm_factor_refresh_launch(
        index, *ptrs, *(t.data_ptr() for t in (alpha_ls, mu1, mu2, acy, M, b2, info)),
        B, nl, nc, alpha_ls.stride(0), mu1.stride(0), mu2.stride(0), acy.stride(0), block,
        torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError("spm_factor_refresh launch failed: "
                           + lib.spm_factor_refresh_error_string(err).decode())
    spm_factor_refresh.launches += 1
    spm_factor_refresh.routes[route].launches += 1
    return M, b2, info


def spm_factor_refresh(AcA, W, C, D, alpha_ls, mu1, mu2,
                       acy) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SpM chunk's per-lane affine factor ``x0 = b2 - M hk0``:

        Mpen = alpha AcA + mu1 I + mu2 W,   Bf = Mpen^{-1}
        M = Bf - xi2 Sinv (C Bf),  b2 = alpha M acy + xi2 Sinv D,
        xi2 = -Bf C^T,  Sinv = -(-C xi2)^{-1}

    (M = Bf, b2 = alpha Bf acy without a sum rule, ``C`` and ``D`` None).
    Shapes: ``AcA``, ``W`` (nl, nl) and ``C`` (nc, nl), ``D`` (nc,) shared
    by all lanes; ``alpha_ls``, ``mu1``, ``mu2`` (B,), ``acy`` (B, nl).
    Returns ``M`` (B, nl, nl) and ``b2`` (B, nl), contiguous.

    CPU tensors run the plain version.  CUDA tensors, float32 only, launch a
    kernel (``csrc/spm_factor_refresh.cu``) on the current stream without
    synchronising: the warp kernel at nl <= 32 with at most 4 sum-rule rows,
    the block kernel at any other shape (:func:`_refresh_route`); each
    launch counts in ``spm_factor_refresh.launches`` and in its route's
    ``.routes[...]``.  The kernels' not-positive-definite infos (one int32
    a lane) go where ``inv_hpd``'s go: inside ``deferred_cholesky_checks``
    into its list, else read at once, raising ``LinAlgError``.
    """
    nc = 0 if C is None else C.shape[0]
    route = _refresh_route(acy.device, acy.dtype, AcA.shape[0], nc)
    if route == "plain":
        return spm_factor_refresh_reference(AcA, W, C, D, alpha_ls, mu1, mu2, acy)
    _check_refresh(AcA, W, C, D, alpha_ls, mu1, mu2, acy)
    M, b2, info = _refresh_launch(AcA, W, C, D, alpha_ls, mu1, mu2, acy, route)
    defer_cholesky_info(info)
    return M, b2


#: Number of kernel launches (CUDA tensors only) since the last reset.
spm_factor_refresh.launches = 0
#: Launches by kernel (``REFRESH_ROUTES``).
spm_factor_refresh.routes = {name: _Launches(f"spm_factor_refresh.{name}")
                             for name in REFRESH_ROUTES}


# ---------------------------------------------------------------------
# Batched Jacobi eigendecomposition
# ---------------------------------------------------------------------

#: Largest slice the Jacobi kernel takes (the JAX package's envelope).
JACOBI_MAX = 256
# The kernel's paths (_jacobi_mode): the block kernel with A and V in
# shared memory or in device memory, the warp path (n <= 32, A and V in
# registers) and the tile path (34 <= n <= 128, one stored triangle of A).
_JACOBI_MODES = ("shared", "global", "warp", "tile")
#: Largest n the warp path takes by default (it takes no n above 32).
_JACOBI_WARP_MAX_N = 32
#: The n the tile path takes (it refuses any other).
_JACOBI_TILE_N = (34, 128)


def _jacobi_layout(n: int):
    """The circle-method schedule in its paired layout (JAX
    ``linop.py:_jacobi_eigh_scan``): ``d0`` lists the labels at physical
    positions 0..n-1 in round 0, round i's pairs sitting at (2i, 2i+1); the
    same permutation ``pi`` takes every round's layout to the next one's,
    and after the n-1 rounds of a sweep the layout is ``d0`` again."""
    m = n // 2
    arr = list(range(n))
    d0 = [lab for i in range(m) for lab in (arr[i], arr[n - 1 - i])]
    arr1 = [arr[0], arr[-1]] + arr[1:-1]
    d1 = [lab for i in range(m) for lab in (arr1[i], arr1[n - 1 - i])]
    pos0 = {lab: i for i, lab in enumerate(d0)}
    return d0, [pos0[lab] for lab in d1]


def _rot_cols(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x <- x @ blockdiag(G_i), G = [[c, s], [-s, c]] on column pairs (2i, 2i+1)."""
    x0, x1 = x[..., 0::2], x[..., 1::2]
    cc, ss = c[..., None, :], s[..., None, :]
    return torch.stack([x0 * cc - x1 * ss, x0 * ss + x1 * cc], dim=-1).reshape(x.shape)


def _rot_rows(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The same rotations applied to row pairs (2i, 2i+1)."""
    r0, r1 = x[..., 0::2, :], x[..., 1::2, :]
    cc, ss = c[..., :, None], s[..., :, None]
    return torch.stack([r0 * cc - r1 * ss, r0 * ss + r1 * cc], dim=-2).reshape(x.shape)


def jacobi_eigh_reference(a: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`jacobi_eigh`, on any device: the JAX
    package's per-round math (``linop.py:184-431``) in the paired layout,
    one permutation by ``pi`` a round."""
    n = a.shape[-1]
    d0, pi = _jacobi_layout(n)
    P0 = torch.as_tensor(d0, device=a.device)
    pi = torch.as_tensor(pi, device=a.device)
    a = a.index_select(-1, P0).index_select(-2, P0)
    v = torch.eye(n, dtype=a.dtype, device=a.device).index_select(-1, P0).expand(a.shape)
    for _ in range(sweeps * (n - 1)):
        d = torch.diagonal(a, dim1=-2, dim2=-1)
        app, aqq = d[..., 0::2], d[..., 1::2]
        apq = torch.diagonal(a[..., 0::2, 1::2], dim1=-2, dim2=-1)
        # tan 2θ = 2 a_pq / (a_qq − a_pp), folded to the inner root |θ| ≤ π/4
        th = 0.5 * torch.atan2(2.0 * apq, aqq - app)
        th = th - torch.where(torch.abs(th) > math.pi / 4, torch.sign(th) * (math.pi / 2), 0.0)
        c, s = torch.cos(th), torch.sin(th)
        a = _rot_rows(_rot_cols(a, c, s), c, s)
        v = _rot_cols(v, c, s)
        a = a.index_select(-1, pi).index_select(-2, pi)
        v = v.index_select(-1, pi)
    inv = torch.argsort(P0)
    w = torch.diagonal(a, dim1=-2, dim2=-1).index_select(-1, inv)
    return w, v.index_select(-1, inv)


def _check_jacobi(a: torch.Tensor, sweeps: int) -> None:
    if a.ndim != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"expected (batch, n, n), got {tuple(a.shape)}")
    n = a.shape[-1]
    if n % 2 or not 2 <= n <= JACOBI_MAX:
        raise ValueError(f"n must be even and in 2..{JACOBI_MAX}, got {n}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"jacobi_eigh is float32 or float64, got {a.dtype}")
    if sweeps < 0:
        raise ValueError(f"sweeps must be >= 0, got {sweeps}")


def _jacobi_threads(n: int, mode: int) -> int:
    """Threads a block.  Block kernel: one a 2x2 block of V's column pairs
    (n * n/2 of them), in whole warps, at most 1024.  Warp path: one warp
    (of 32 // n slices).  Tile path: 256 below n = 48, 512 to n = 96, 768
    above.  256 to 768 were timed on the H100 only at n = 34, 64, 96 and
    128 (chip_smoke.py 10d's shapes), where these counts were the fastest
    or within 4% of it; the switch points between them are not measured."""
    name = _JACOBI_MODES[mode]
    if name == "warp":
        return 32
    if name == "tile":
        return 256 if n < 48 else 512 if n <= 96 else 768
    return min(1024, max(32, -(-n * (n // 2) // 32) * 32))


def _jacobi_first_fit(lib, device: int, n: int, f64: bool, modes) -> int:
    """The first of ``modes`` whose shared memory fits one block."""
    limit = ctypes.c_int()
    err = lib.jacobi_eigh_max_smem(device, ctypes.byref(limit))
    if err:
        raise RuntimeError(lib.jacobi_eigh_error_string(err).decode())
    for mode in map(_JACOBI_MODES.index, modes):
        if lib.jacobi_eigh_smem_bytes(n, int(f64), mode) <= limit.value:
            return mode
    raise ValueError(f"n={n} does not fit this device's {limit.value}-byte shared memory")


def _jacobi_block_mode(lib, device: int, n: int, f64: bool) -> int:
    """The block kernel's mode at n: "shared" where A and V fit one block's
    shared memory, else "global"."""
    return _jacobi_first_fit(lib, device, n, f64, ("shared", "global"))


def _jacobi_mode(lib, device: int, n: int, f64: bool) -> int:
    """The warp path up to _JACOBI_WARP_MAX_N, the tile path on
    _JACOBI_TILE_N; above it the block kernel (:func:`_jacobi_block_mode`)."""
    if n <= _JACOBI_WARP_MAX_N:
        return _JACOBI_MODES.index("warp")
    lo, hi = _JACOBI_TILE_N
    if lo <= n <= hi:
        return _jacobi_first_fit(lib, device, n, f64, ("tile",))
    return _jacobi_block_mode(lib, device, n, f64)


def _jacobi_launch(a: torch.Tensor, sweeps: int,
                   mode: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on a checked, contiguous CUDA tensor.
    ``mode`` (an index of _JACOBI_MODES) overrides :func:`_jacobi_mode`; a
    mode that does not fit (the warp path above n = 32, the tile path
    outside _JACOBI_TILE_N) fails at the launch."""
    B, n, _ = a.shape
    lib = _build.load_libraries()["jacobi_eigh"]
    index = a.device.index if a.device.index is not None else torch.cuda.current_device()
    f64 = a.dtype == torch.float64
    if mode is None:
        mode = _jacobi_mode(lib, index, n, f64)
    w = torch.empty((B, n), dtype=a.dtype, device=a.device)
    v = torch.empty_like(a)
    work = torch.empty_like(a) if _JACOBI_MODES[mode] == "global" else a
    err = lib.jacobi_eigh_launch(
        index, a.data_ptr(), work.data_ptr(), w.data_ptr(), v.data_ptr(), B, n,
        int(sweeps), int(f64), int(mode), _jacobi_threads(n, mode),
        torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError("jacobi_eigh launch failed: "
                           + lib.jacobi_eigh_error_string(err).decode())
    jacobi_eigh.launches += 1
    return w, v


def jacobi_eigh(a: torch.Tensor, sweeps: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sweeps`` sweeps of parallel-order Jacobi on a batch of real
    symmetric slices ``a`` (B, n, n), n even (2..256), float32 or float64.

    Returns ``(w, V)``: ``w`` (B, n) the diagonal the rotations leave, ``V``
    (B, n, n) their product, both in the input's label order and unsorted,
    so that ``a ≈ V diag(w) Vᵀ``.  Each sweep is n − 1 rounds of the
    circle-method schedule, each round rotating n/2 disjoint pairs at once
    with the angle of the JAX package (|θ| ≤ π/4).  The public contract
    (odd n, sweep counts, sorting) is
    :func:`admmsolver_tpu_torch.ops.linop.jacobi_eigh`.

    CPU tensors run the plain version.  CUDA tensors launch the kernel
    (``csrc/jacobi_eigh.cu``: its warp path for n <= _JACOBI_WARP_MAX_N,
    its tile path on _JACOBI_TILE_N, its block kernel above) on the
    current stream without synchronising (and count it in
    ``jacobi_eigh.launches``); they must be contiguous.
    """
    _check_jacobi(a, sweeps)
    if a.device.type == "cpu":
        return jacobi_eigh_reference(a, sweeps)
    if a.device.type != "cuda":
        raise ValueError(f"no jacobi_eigh for device {a.device}")
    if not a.is_contiguous():
        raise ValueError("jacobi_eigh needs a contiguous tensor")
    if a.shape[0] == 0:
        return a.new_empty(a.shape[:2]), torch.empty_like(a)
    return _jacobi_launch(a, sweeps)


#: Number of kernel launches (CUDA tensors only) since the last reset.
jacobi_eigh.launches = 0


_LAUNCH_COUNTERS = (jacobi_eigh, fused_two_block_chunk, fused_spm_chunk, spm_factor_refresh,
                    *fused_two_block_chunk.routes.values(), *fused_spm_chunk.routes.values(),
                    *spm_factor_refresh.routes.values())


def launch_counters() -> tuple:
    """Every launch counter of the port's kernels, each with ``.launches``
    and a ``__name__``: the wrappers, then the routes of the two-block
    kernel, of the SpM chunk kernel and of the factor refresh.  Bound when
    the module loads, so that a wrapper replaced by its plain version (in a
    test) leaves them."""
    return _LAUNCH_COUNTERS
