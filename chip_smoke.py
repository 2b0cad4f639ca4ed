#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's paths at full width, one phase after another; a phase that
fails raises and the script exits non-zero without printing a result.

* basis pursuit: ``FusedTwoBlockSolver`` at the bench problem (A 256x512,
  B=4096, 20-sparse, seed 0, alpha=0.1), 401 iterations;
* SpM analytic continuation: ``FusedSpMSolver`` on ``spm_model`` at nl=30 IR
  coefficients, nw=201 frequencies, B=4096, 500 iterations, mu0=0.1;
* the batched engine: ``BatchedSolver.solve`` on the bench problem in
  float64, 200 iterations, and ``FusedSpMSolver.solve_mixed`` on the SpM
  problem (500 float32 iterations through the chunk kernel, then a float64
  ``BatchedSolver`` polish of 200);
* the stream drivers and complex problems: ``ScenarioScheduler`` over a
  stream of 1024 ragged basis-pursuit scenarios in 256 lanes,
  ``BatchedSolver.solve_resumable`` on the float64 bench problem, complex SpM
  through ``realify_model`` and ``BatchedSolver``, and complex basis pursuit
  through ``realify_model`` and ``FusedTwoBlockSolver`` (the kernel's
  ``l1_even`` mode);
* the added model families in float64 through ``BatchedSolver.solve``:
  covariance denoising, the SDP, RPCA, group lasso and Huber regression at
  the inputs of ``benches/bench_workloads.py``, and TV denoising at
  N = 100,000 (the PSD and nuclear proxes by the card's default routes:
  the Jacobi eigh kernel up to the boundary, the matrix sign above it;
  cyclic reduction and elementwise proxes in PyTorch);
* the spectral routes: covariance denoising, the SDP and RPCA at 32 x 32 and
  96 x 96 through each route of the PSD and nuclear proxes, and the Jacobi
  eigh kernel alone;
* multi-device (no kernel of its own): ``BatchedSolver`` sharded over a world
  of one rank through NCCL and over two gloo ranks on the one card,
  ``sharded_gram`` and ``LargeNTwoBlockSolver`` at M=1024, N=2^20 in float64,
  per-rank checkpoint shards.

1. Card and build: the card's name and power limit; the three CUDA sources
   are built from ``admmsolver_tpu_torch/csrc/`` (one nvcc per source,
   started together), timed, with ptxas' register and spill lines.
2. Each kernel against its plain version on the card, max abs difference of
   every output <= 5e-4 (f32 sums taken in another order): the two-block
   kernel over 21 iterations at the bench shape (thin basis, N=512, R=256)
   and at a full-basis shape (N=R=128), all four prox modes, through the
   kernel the wrapper chooses (split TF32 on the tensor cores) and through
   the FMA kernel beside it, and over 0, 1, 2 and 3 iterations at the bench
   shape (where ``x0_prev`` leaves the loop early); the SpM kernel over 21
   iterations at full width and at a ragged shape (nl=12, nw=25, B=37),
   again through the chosen kernel and the FMA kernel.  Where the chosen
   kernel runs on the tensor cores its difference to the plain version may
   be at most TC_ERR_RATIO times the FMA kernel's on the same inputs.
3. The slices.  Each solve goes through its kernel (launch count > 0, set
   to 0 just before and read just after) and agrees with the same solve
   through the plain version.  Basis pursuit recovers every lane's planted
   signal to 1e-2 * max|x*|; SpM gives finite outputs, a nonnegative
   spectrum and the sum rule (median |x0.prj_sum - 1| <= 1e-3).
4. ``SimpleOptimizer`` in float64 on the GPU, through its run program (each
   chunk a replay of a captured graph): one bench instance recovered; one
   SpM instance for 1000 iterations with the sum rule to 1e-6; each once
   more captured and once without graphs (the order flipped), x, x_old, h,
   mu, the count and both histories bitwise equal, ms a solve both ways.
5. The batched engine.  ``BatchedSolver`` in float64 on the bench problem, as
   bench.py runs it (rtol=0, no histories): every lane recovers its planted
   signal and runs 200 iterations; with rtol=1e-8, 4 lanes of the batch
   against 4 ``SimpleOptimizer`` solves on the card (x within 1e-9, equal
   iteration counts).  ``FusedSpMSolver.solve_mixed`` at full width: its
   float32 phase launches the chunk kernel, the result is float64 and
   finite, the spectrum nonnegative, the sum rule's median within 1e-6.
6. Times: medians of 3 timings after a warm-up, kernel against plain, the
   design each kernel replaced, and each kernel's bound: the larger of its
   bytes (inputs read once, outputs written once) over 3.35 TB/s and its
   operations over the peak rate of the units that do them (products in
   split TF32 count three times at the tensor cores' 495 TFLOP/s, the rest
   at the 67 TFLOP/s f32 peak of the CUDA cores), with the all-FMA bound
   beside it.  The ``BatchedSolver`` solve in float64 and float32 with its
   instance-iterations/s, the same solve with the host reading the done
   flags once per chunk, its two products alone as ``torch.matmul`` chained
   50 times, and ``solve_mixed`` with its two phases apart.
7. The stream drivers and complex problems, each phase timed by the host
   clock.  Scheduler (the stream of benches/scheduler_hw.py: A 256x512,
   S=1024, B=256, chunks of 100, atol 1e-9, float64; niter_max 3000, cut
   from the bench's 6000 to fit the phase in ~60 s): static batches, ``run``
   and ``run_compiled`` each once; every scenario comes back once, ``run``
   and ``run_compiled`` agree in iterations and flags and in x to 1e-9 of
   max|x|, 4 scenarios equal dedicated ``SimpleOptimizer`` solves to 1e-6.
   ``solve_resumable`` (B=4096, 200 iterations in segments of 100): stopped
   after one segment and resumed equals uninterrupted exactly; the
   checkpoint's size and its write and read times.  Complex SpM realified
   (benches/complex_spm_hw.py: B=2048, 500 iterations): finite, spectrum
   >= 0, median sum-rule error <= 1e-6, lane 0 equals a complex128
   ``SimpleOptimizer`` of the unrealified model to 1e-8 of max|x|.  Complex
   basis pursuit (A 128x256 complex, B=4096, real 20-sparse signals)
   realified through the kernel: it launches, every lane recovers, the Im
   lanes of x1 are 0, the solve agrees with the plain version within
   SOLVE_TOL; its time beside the real bench solve's.
8. The added families, each through ``BatchedSolver.solve`` in float64
   (rtol=0, no histories), timed by the host clock on a first and a second
   run, lane 0 (TV: lanes 0 and 1) against ``SimpleOptimizer`` on the card to
   1e-8 of max|x| (TV 1e-9).  8a covariance denoising (bench_sdp128: k=128,
   B=64, 50 iterations; every PSD slice's least eigenvalue >= -1e-9 max|x1|;
   ``--variants`` times batched eigh of its slices under cuSOLVER and MAGMA),
   8b the SDP (bench_sdp: k=8 x 16 slices, B=256, 100 iterations; PSD as
   8a), 8c RPCA (bench_rpca: 32x32, B=256, 200 iterations; max relative
   error of L, median effective rank), 8d group lasso (bench_group_lasso:
   A 256x512, groups of 8, B=1024, 200 iterations; support-recovery rate),
   8e Huber regression (bench_huber: A 256x128, delta 0.1, B=1024, 200
   iterations; max coefficient error), 8f TV denoising (N=100,000, B=64,
   lam 0.4, 20 jumps plus noise 0.1 from RandomState(11), 200 iterations;
   the device memory of the part below 1 GiB, where a dense factor would be
   80 GB a lane).  On the card 8a's PSD prox takes the matrix sign, 8b's the
   Jacobi kernel and 8c's nuclear prox the Gram route through the kernel.
10. The spectral routes (run before 9): the routes phase 8 does not take,
   each solve as in 8 with its gates, held against 8's solve on the same
   inputs.  10a covariance denoising at 8a's inputs through the library
   eigh (``USE_SIGN_ABOVE_JACOBI = False``) against 8a's sign route: ms,
   and from a profiled 2-iteration solve of each route the launches an
   iteration and busy share; x of the two within SIGN_VS_EIGH_TOL of
   max|x|.  10b the SDP of 8b through the library eigh against 8b's Jacobi
   kernel (x within JACOBI_VS_EIGH_TOL).  10c RPCA at 8c's 32x32 through
   ``"xla"`` against 8c's ``"auto"`` (the Gram route through the kernel),
   and at bench_rpca96's 96x96, B=128, 200 iterations through ``"sign"``,
   ``"gram"`` and ``"xla"`` (the last run once, ~0.35 s an iteration): max
   relative error of L, median effective rank, finiteness; x of each route
   within RPCA_ROUTE_TOL of the ``"xla"`` route's.  The Jacobi kernel's
   launches are counted in one solve of each part that takes it (8b, 8c,
   10c's 96x96 ``"gram"``; the count set to 0 just before, read just
   after, the ``SimpleOptimizer`` checks outside).  10d the kernel alone at
   JACOBI_SHAPES in float64 and float32, default sweeps: sorted eigenvalues
   within 10·n·eps·max|w| of its plain version's, its V reconstructing A to
   the same limit and orthogonal within 10·n·eps; its time, the plain
   version's (one call), ``torch.linalg.eigh``'s and the bound (9 n^2
   (n-1) flops a sweep and slice over the FMA peak of the type, or the
   bytes over 3.35 TB/s) with the SMs the grid covers.  Slices of n <= 32
   take the warp path, 34 <= n <= 128 the tile path, and the block kernel
   is held to the same limits and timed beside either in the same
   CUDA-graph turns (``prev_ms``); no warp or tile kernel may use local
   memory (ptxas's report in the build log).  10e: 8b and 8c through the
   warp path and through the block kernel, eight solves of each in turns
   whose order flips every pair; x of the two within WARP_VS_BLOCK_TOL.

9. Multi-device on the one card.  9a, a process group of one rank through
   NCCL (a TCP store on localhost, destroyed at the end): the sharded
   ``BatchedSolver`` on the float64 bench problem, 200 iterations at rtol 0
   and up to RANKS_NITER at rtol 1e-8 (the exit predicate's all_reduce then
   runs every chunk), bitwise equal to the unsharded solve; per-instance
   operators sharded (B=4096 lanes of A 64x128), lanes 0, 2048 and 4095
   against ``SimpleOptimizer`` to 1e-9 of max|x|; ``sharded_gram`` of the tall
   Ac (1,048,576 x 1024 float64, 8 GiB) against ``torch.matmul`` to 1e-12
   relative; ``LargeNTwoBlockSolver`` at M=1024, N=2^20 (A made on the card
   from a seeded generator, U as big: 16 GiB in all) recovering its 32-sparse
   planted signal to 1e-2 of max|x*| within LN_NITER iterations, and at
   M=256, N=65,536 equal to ``SimpleOptimizer`` on the card to 1e-9 of max|x|
   with equal iteration counts; both LargeN solves run their chunks as
   replays of captured graphs (the two all_reduces inside), and a
   LN_TURN_NITER solve at full width and the 256 x 65,536 solve run once
   more captured and once without graphs, bitwise equal with equal counts.
   Printed beside the card: LargeN's ms per
   iteration, its bound (U read twice over 3.35 TB/s) and its two GEMVs alone,
   ``sharded_gram`` against its DGEMM bound (67 TFLOP/s), a 1-rank NCCL
   all_reduce, the part's peak device memory, and under ``--profile`` the
   LargeN solve's busy share (``--variants``: its recovery after 1000
   iterations at five values of mu0, and after 2500 and 5000 at LN_MU0).
   9b, two ranks on ``cuda:0`` through gloo (NCCL
   refuses two ranks on one GPU), each a copy of this script run with
   ``--rank-of-two``: the bench problem at rtol 1e-8 (each rank's lanes
   bitwise a one-process solve of them, and within 1e-10 of max|x| of the
   unsharded solve with equal iteration counts), LargeN at M=256, N=65,536
   against world size 1 (1e-9, equal counts; its chunks without graphs by
   the declared rule: gloo's collectives run on the host), each rank's checkpoint shard
   reassembled against the unsharded solve, and a 2-rank gloo all_reduce.

Captured chunks against chunks without a graph: ``BatchedSolver``,
``FusedTwoBlockSolver``, ``FusedSpMSolver``, ``SimpleOptimizer`` and
``LargeNTwoBlockSolver`` run each chunk of a solve as a replay of a
captured CUDA graph; phase 4's two solves, 9a's LargeN solves and every
part of phases 6, 7, 8 and 10 that solves through them (the basis-pursuit
and SpM fused solves, both phases of ``solve_mixed``, the bench solve, one
wave of each stream mode, ``solve_resumable``, the realified SpM and basis
pursuit, 8a-8f, 10a-10c) solves once more through the captured chunks and
once with ``batch.CAPTURE_CHUNKS = False`` (the same chunk program run
directly, its working set taken from the solver's graph pool once the
program is warm), the order flipped every part, and gates x, h, mu,
iterations and flags of the two bitwise (the residual histories too where
a solve keeps them, and the fused chunk kernel's launches equal both
ways); it prints ms an iteration both ways, each graph's capture seconds
and the pool's bytes.  The lane checks against ``SimpleOptimizer`` (5, 7,
8, 9) run through its captured program.  The fused
solves' plain-version runs go through the same program without graphs.
A part whose route a graph cannot hold (the library eigh or SVD: 10a and
10b's eigh, 10c's ``xla``) runs its chunks without a graph and says so.
8f's memory gate covers every solve of the part (the timed ones, the
turn, ``--profile``'s): the peak of the bytes allocated outside the graph
pool plus the pool's reserved segments, from the allocator's trace.
``--profile`` profiles each such part both ways: device kernels and the
host's launch calls an iteration (a graph replay is one), busy share
(the fused solves, ``solve_mixed``'s f32 phase, 7d, phase 4's two solves
and a 20-iteration LargeN solve too).

``--variants`` also times both chunks at other tilings and routes, the
two-block chunk's two products as ``torch.matmul``, the card's L2 read rate,
the factor refresh's batched inverse by other routes and batched eigh by both
linear-algebra libraries; ``--profile`` prints a torch.profiler breakdown of
both fused solves, of the float64 ``BatchedSolver`` solve, of one scheduler
wave in each stream mode and of every family (8a and 8f in 5-iteration
solves), captured and eager, and times each stream mode a second time.  The
whole run's seconds are printed before the ``kernels`` line.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU,
``nvcc`` and no network.
"""
import gc
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np

M, N, B, SPARSITY, ALPHA = 256, 512, 4096, 20, 0.1
NITER = 401
NL, NW, SPM_NITER, SPM_MU0, SPM_ALPHA = 30, 201, 500, 0.1, 1e-4
BATCH_NITER = 200   # bench.py's float64 horizon
POLISH_NITER = 200  # float64 iterations after the SPM_NITER float32 ones
KERNEL_TOL = 5e-4   # tests/test_kernels.py, tests/test_fused_spm.py short-horizon bound
SOLVE_TOL = 2e-2    # benches/kernel_hw_check.py fixed-point bound
PROX_MODES = ("l1", "l1_even", "nonneg", "nonneg_even")
REPEATS = 3
INNER = 4           # calls in a row inside one CUDA-event timing
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# the runtime calls by which the host puts work on a stream (profiler keys)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync")
# Most that a split-TF32 kernel's max abs difference to the plain version may
# be, as a multiple of the f32 FMA kernel's on the same inputs.
TC_ERR_RATIO = {"two-block": 2.0, "SpM": 4.0}
# 7. the stream drivers and complex problems (benches/scheduler_hw.py,
# benches/complex_spm_hw.py, examples/complex_basis_pursuit.py)
SCHED_M, SCHED_N, SCHED_B, SCHED_S = 256, 512, 256, 1024
# niter_max: the bench's 6000 cut to 3000 so that the phase fits its ~60 s
SCHED_CHUNK, SCHED_NITER_MAX, SCHED_ATOL = 100, 3000, 1e-9
RESUME_EVERY, RESUME_NITER = 100, 200
CSPM_B, CSPM_NITER = 2048, 500
CBP_M, CBP_N = 128, 256   # complex; realified 256x512
# 8. the added model families, at the inputs of benches/bench_workloads.py
COV_K, COV_B, COV_NITER = 128, 64, 50                  # bench_sdp128, RandomState(15)
SDP_K, SDP_REST, SDP_B, SDP_NITER = 8, 16, 256, 100    # bench_sdp, RandomState(3)
RPCA_M, RPCA_N, RPCA_B, RPCA_NITER = 32, 32, 256, 200  # bench_rpca, RandomState(7)
GL_M, GL_N, GL_GS, GL_B, GL_NITER = 256, 512, 8, 1024, 200   # bench_group_lasso, (8)
HUB_M, HUB_N, HUB_B, HUB_NITER, HUB_DELTA = 256, 128, 1024, 200, 0.1   # bench_huber, (9)
# tv_denoise_model's own scale (admmsolver_tpu/models/applications.py:186-188)
TV_N, TV_B, TV_NITER, TV_LAM, TV_JUMPS = 100_000, 64, 200, 0.4, 20
TV_MEMORY_LIMIT = 1 << 30   # a dense N x N factor would be 80 GB a lane
TV_TRACE_ENTRIES = 8_000_000   # allocator events the TV part's memory reading keeps
# 9. multi-device on one card
PEAK_F64_TC_FLOPS = 67e12   # H100 SXM, float64 on the tensor cores (DGEMM)
RANKS_NITER, RANKS_RTOL = 1200, 1e-8  # lanes converge at different iterations, none before 800
RANKS_TIMEOUT = 300                   # seconds for the two ranks of 9b
OPS_B, OPS_M, OPS_N, OPS_NITER = B, 64, 128, 200   # per-instance operators
# LargeNTwoBlockSolver at full width: A 1024 x 2^20 float64 (8 GiB), U as big
LN_M, LN_N, LN_K, LN_SEED = 1024, 1 << 20, 32, 7
# The budget: at N/M = 1024 the error falls e-fold every ~2100 iterations
# (0.10-0.28 of max|x*| after 1000 for every mu0 in 1..100, 6.8e-3 after 7500)
LN_NITER, LN_MU0, LN_RTOL = 7500, 3.0, 1e-8
LNS_M, LNS_N, LNS_K, LNS_SEED, LNS_NITER = 256, 1 << 16, 8, 8, 300
LN_TURN_NITER = 300   # full width, captured against graph-less
# 10. the spectral routes
PEAK_F64_FLOPS = 34e12      # H100 SXM, float64 FMA outside the tensor cores
RPCA96_M, RPCA96_N, RPCA96_B, RPCA96_NITER = 96, 96, 128, 200   # bench_rpca96, (17)
# 10a: x of the sign route against the eigh route, as a multiple of max|x|
# (a CPU run at k = 128, B = 2 of the same 50 iterations: 1.9e-15)
SIGN_VS_EIGH_TOL = 1e-10
# 10b: x of the Jacobi kernel's route against the library eigh's
JACOBI_VS_EIGH_TOL = 1e-10
# 10c: x of the Gram and sign routes against the library SVD's (a CPU run of
# the same 200 iterations at B = 4 (32 x 32) and B = 2 (96 x 96): Gram
# 4.9e-13 and 6.4e-9, sign 9.4e-15; the Gram route's own error grows as the
# square of the condition of X)
RPCA_ROUTE_TOL = {"gram": 1e-6, "sign": 1e-10, "xla": 0.0}
# 10e: x of 8b and 8c through the block kernel against the warp path, as a
# multiple of max|x| (H100 runs: 2.5e-12 and 1.5e-12)
WARP_VS_BLOCK_TOL = 1e-10
# 10d: the Jacobi kernel alone, (slices, n) in float64 and float32
JACOBI_SHAPES = ((4096, 8), (1024, 12), (256, 32), (256, 34), (64, 64), (128, 96), (64, 128))
# the path the dispatch must take at each n of JACOBI_SHAPES, and beside the
# warp and tile paths the block kernel's own mode, "shared" (A and V in one
# block's shared memory: float64 to n = 120) but where listed
JACOBI_MODE = {8: "warp", 12: "warp", 32: "warp", 34: "tile", 64: "tile", 96: "tile",
               128: "tile"}
JACOBI_BLOCK_GLOBAL = {(128, "float64")}
JACOBI_MAIN = (128, 96, "float64")   # the kernels line's shape: 10c's Gram route


def bench_problem(seed=0, nb=B):
    """bench.py:34-42: A (M, N), nb planted 20-sparse signals, ys = x* A^T."""
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xtrue = np.zeros((nb, N))
    for b in range(nb):
        xtrue[b, rng.choice(N, SPARSITY, replace=False)] = rng.randn(SPARSITY)
    return A, xtrue @ A.T, xtrue


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def check_recovery(x, xtrue, what):
    err = np.abs(np.asarray(x, np.float64) - xtrue).reshape(-1, xtrue.shape[-1]).max(1)
    bound = 1e-2 * np.abs(xtrue).reshape(-1, xtrue.shape[-1]).max(1)
    bad = int((err > bound).sum())
    if bad or not np.all(np.isfinite(x)):
        raise AssertionError(f"{what}: {bad} lanes miss the planted signal "
                             f"(worst err/bound {float((err / bound).max()):.3g})")
    return float((err / bound).max())


def kernel_inputs(torch, solver, prox, seed):
    """Two-block chunk inputs on the card: the solver's own eigenbasis,
    unit-scale random data and state, and per-lane penalties.  (At the bench
    data's own scale, |alpha A^T y| ~ 500, f32 rounding alone moves either
    version by ~1e-3 from float64 over 21 iterations.)"""
    rng = np.random.RandomState(seed)
    f32 = dict(dtype=torch.float32, device="cuda")
    mu = torch.as_tensor(rng.uniform(0.5, 2.0, (B, 1)), **f32)
    dinv = 1.0 / (solver.lam[None, :] + mu)
    if solver.thin:
        dinv = dinv - 1.0 / mu
    thr = 0.5 * ALPHA / mu if prox.startswith("l1") else torch.zeros_like(mu)
    acy, x0, x1, h = (torch.as_tensor(s * rng.randn(B, solver.N), **f32)
                      for s in (1.0, 0.3, 0.3, 1.0))
    return (solver.U, solver.Ut, dinv.contiguous(), acy, mu, thr.contiguous(), x0, x1, h)


def spm_kernel_inputs(torch, solver, ys, seed):
    """SpM chunk inputs on the card: the solver's projector, its own factors
    for per-lane penalties in [0.5, 2], unit-scale random state."""
    rng = np.random.RandomState(seed)
    f32 = dict(dtype=torch.float32, device="cuda")
    nb = ys.shape[0]
    mu = torch.as_tensor(rng.uniform(0.5, 2.0, (nb, 2)), **f32)
    acy = torch.as_tensor(ys, **f32) @ solver.Ac.T
    Mf, b2 = solver._factors(mu[:, 0], mu[:, 1], torch.ones(nb, **f32), acy)
    thr = (0.5 * SPM_ALPHA / mu[:, :1]).contiguous()
    x0, x1, h10 = (torch.as_tensor(s * rng.randn(nb, solver.nl), **f32)
                   for s in (0.3, 0.3, 1.0))
    x2, h20 = (torch.as_tensor(s * rng.randn(nb, solver.nw), **f32) for s in (0.3, 1.0))
    return (solver.P, Mf, b2, mu, thr, x0, x1, x2, h10, h20)


def compare(torch, what, names, got, ref):
    """Max abs difference of each output, checked against KERNEL_TOL."""
    torch.cuda.synchronize()
    errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    print(f"kernel vs plain, {what}: max abs diff "
          + " ".join(f"{n} {e:.3e}" for n, e in zip(names, errs)), flush=True)
    if not all(e <= KERNEL_TOL for e in errs):
        raise AssertionError(f"kernel disagrees with its plain version: {errs}")
    return max(errs)


def check_ratio(what, family, chosen_err, fma_err):
    """Hold a tensor-core kernel's error to TC_ERR_RATIO times the FMA
    kernel's."""
    ratio = chosen_err / fma_err
    print(f"{what}: max abs diff to plain {chosen_err:.3e}, FMA kernel {fma_err:.3e} "
          f"(ratio {ratio:.2f}, limit {TC_ERR_RATIO[family]})", flush=True)
    if not ratio <= TC_ERR_RATIO[family]:
        raise AssertionError(f"{what}: the tensor-core kernel's error is {ratio:.2f} times "
                             "the FMA kernel's")


def median_ms(torch, fns, inner=INNER, per=1):
    """Median CUDA-event time in ms of one call of each of ``fns``: every
    timing spans ``inner`` calls in a row (so that the host's preparation of a
    launch overlaps the call before it), REPEATS timings of each taken in
    turns, after one warm-up turn; each call counts as ``per`` calls."""
    times = [[] for _ in fns]
    for rep in range(REPEATS + 1):
        for fn, t in zip(fns, times):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(inner):
                fn()
            stop.record()
            torch.cuda.synchronize()
            if rep:
                t.append(start.elapsed_time(stop) / (inner * per))
    return [float(np.median(t)) for t in times]


def graph_ms(torch, fns):
    """Median CUDA-event time in ms of one call of each of ``fns`` on the
    device alone: INNER calls captured in a CUDA graph after a warm-up call,
    the graph replayed REPEATS times in turns after one warm-up turn (a
    kernel of a few tens of microseconds is shorter than the host's path to
    its launch, which back-to-back eager calls would time instead)."""
    graphs = []
    for fn in fns:
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="relaxed"):
            for _ in range(INNER):
                fn()
        graphs.append(graph)
    return median_ms(torch, [graph.replay for graph in graphs], inner=1, per=INNER)


def median_wall(torch, fns):
    """Median host-clock seconds of each of ``fns``, ending in a device
    synchronize, over REPEATS runs taken in turns after a warm-up."""
    times = [[] for _ in fns]
    for rep in range(REPEATS + 1):
        for fn, t in zip(fns, times):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rep:
                t.append(time.perf_counter() - t0)
    return [float(np.median(t)) for t in times]


def plain_chunk_solve(plain_chunk, solve):
    """``solve()`` with the chunk kernel's wrapper patched to its plain
    version, through the run program without graphs (a replay would launch
    the kernel its graph holds)."""
    with plain_chunk:
        return with_capture(False, solve)


def bound_ms(t_ops, tensors):
    """(least time in ms the card could take, what bounds it): the larger of
    ``t_ops``, the seconds its operations take at the peak rate of their
    type, and the bytes of ``tensors`` (every input and output once) over the
    memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def profile_solve(torch, what, kernel_name, solve, iters=None):
    """torch.profiler over one solve: wall time, device time in the kernels
    whose name contains ``kernel_name`` and in everything else, and with
    ``iters`` the launches per iteration; returns the wall time, busy share,
    launches and the named kernels' time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        solve()   # the first profiled run pays for starting the tracer
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solve()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
            for e in events if getattr(e, "device_time_total", 0.0) > 0
            and e.device_type.name == "CUDA"]
    total = sum(r[1] for r in rows)
    kern = sum(r[1] for r in rows if kernel_name in r[0])
    launches = sum(r[2] for r in rows)
    # the host's calls that put work on the stream: a graph replay is one
    host = sum(e.count for e in events if e.key in HOST_LAUNCH_CALLS)
    print(f"profile, {what}: wall {wall:.2f} ms (profiled), device kernels {total:.2f} ms "
          f"(busy {total / wall:.2f}), {kernel_name} kernels {kern:.2f} ms, other kernels "
          f"{total - kern:.2f} ms in {launches} launches"
          + (f" = {launches / iters:.1f} per iteration" if iters else "")
          + f"; host launch calls {host}"
          + (f" = {host / iters:.2f} per iteration" if iters else ""))
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {ms:8.3f} ms  x{count:<5d} {key[:90]}")
    return {"wall_ms": wall, "busy": total / wall, "launches": launches,
            "host_launches": host, "kernel_ms": kern}


def l2_read_rate(torch, lib, nbytes, rotate, passes=50):
    """Bytes per second at which the card's multiprocessors together read one
    ``nbytes`` buffer that stays in L2: one block on each reads all of it
    ``passes`` times (the probe kernel beside the two-block chunk kernels), all
    from the same offset or (``rotate``) each from another."""
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    buf = torch.ones(nbytes // 4, dtype=torch.float32, device="cuda")
    out = torch.zeros(1, dtype=torch.float32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.fused_two_block_l2_probe(0, buf.data_ptr(), buf.numel(), passes, int(rotate),
                                           blocks, out.data_ptr(), stream)
        if err:
            raise RuntimeError(lib.fused_two_block_error_string(err).decode())

    (ms,) = median_ms(torch, [run])
    return blocks * nbytes * passes / (1e-3 * ms)


def scheduler_stream(S, m=SCHED_M, n=SCHED_N, seed=5):
    """benches/scheduler_hw.py:36-48: A (m, n) Gaussian, S planted signals of
    sparsity K in [8, 120) and alpha log-uniform on [10^-2.5, 10^-0.5]."""
    rng = np.random.RandomState(seed)
    A = rng.randn(m, n)
    K = rng.randint(8, 120, S)
    xt = np.zeros((S, n))
    for i in range(S):
        xt[i, rng.choice(n, K[i], replace=False)] = rng.randn(K[i])
    return A, xt @ A.T, 10.0 ** rng.uniform(-2.5, -0.5, S)


def phase_scheduler(torch, card, device="cuda", S=SCHED_S, B=SCHED_B, niter_max=SCHED_NITER_MAX,
                    m=SCHED_M, n=SCHED_N, again=False):
    """7a. A stream of S ragged basis-pursuit scenarios through B lanes, three
    ways: static batches of B through ``BatchedSolver.solve``, then
    ``ScenarioScheduler.run``, then ``run_compiled``; each once, timed by the
    host clock with a device synchronize at the end (with ``again`` the two
    streams once more, in the other order).  Returns the times and the
    solver and scenarios, for a profile of one wave."""
    from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, SimpleOptimizer, identity
    from admmsolver_tpu_torch.parallel import BatchedSolver, ScenarioScheduler

    A, ys, alphas = scheduler_stream(S, m, n)
    model = lambda y, alpha: Model([LeastSquares(1.0, A, y), L1Regularizer(alpha, n)],
                                   [(1, 0, identity(n), identity(n))])
    bs = BatchedSolver(model(ys[0], 0.1), dtype=torch.float64, device=device)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    sync()
    t0 = time.perf_counter()
    it_s, slots = np.zeros(S, np.int64), 0
    for g0 in range(0, S, B):
        r = bs.solve({(0, "y"): ys[g0:g0 + B], (1, "alpha"): alphas[g0:g0 + B]},
                     niter=niter_max, rtol=0.0, atol=SCHED_ATOL, record_residuals=False)
        it_s[g0:g0 + B] = r.iterations.cpu().numpy()
        slots += int(it_s[g0:g0 + B].max()) * B
    sync()
    t_static = time.perf_counter() - t0

    scen = [{(0, "y"): ys[i], (1, "alpha"): np.float64(alphas[i])} for i in range(S)]
    sched = ScenarioScheduler(bs, batch_size=B, chunk_iters=SCHED_CHUNK, niter_max=niter_max,
                              rtol=0.0, atol=SCHED_ATOL)
    out = {}
    for mode in ("run", "run_compiled"):
        sync()
        t0 = time.perf_counter()
        out[mode] = getattr(sched, mode)(iter(scen))
        sync()
        out[mode + "_s"] = time.perf_counter() - t0
    host, comp = out["run"], out["run_compiled"]
    for mode, res in (("run", host), ("run_compiled", comp)):
        if [r.scenario_id for r in res] != list(range(S)):
            raise AssertionError(f"{mode} did not return every scenario exactly once")
    worst = 0.0
    for a, b in zip(host, comp):
        if (a.iterations, a.converged) != (b.iterations, b.converged):
            raise AssertionError(f"scenario {a.scenario_id}: run gives {a.iterations} "
                                 f"iterations ({a.converged}), run_compiled {b.iterations} "
                                 f"({b.converged})")
        for xa, xb in zip(a.x, b.x):
            scale = max(float(np.abs(xa).max()), 1e-300)
            worst = max(worst, float(np.abs(xa - xb).max()) / scale)
    if not worst <= 1e-9:
        raise AssertionError(f"run and run_compiled differ by {worst:.3e} of max|x|")
    it_h = np.array([r.iterations for r in host])
    if not np.array_equal(it_h, it_s):
        print(f"note: static batches and the stream differ in the iterations of "
              f"{int((it_h != it_s).sum())} scenarios (the stream restarts the penalty "
              "clock every wave)")
    # four scenarios against dedicated solves with the same chunked schedule
    picks = [int(i) for i in np.argsort(it_h)[:4]]
    single_err = 0.0
    for i in picks:
        o = SimpleOptimizer(model(ys[i], float(alphas[i])), device=device)
        done = 0
        while done < niter_max:
            o.solve(SCHED_CHUNK, rtol=0.0, atol=SCHED_ATOL)
            done += SCHED_CHUNK
            if o.iterations < done:
                break
        d = float(np.abs(comp[i].x[0] - o.x[0].cpu().numpy()).max())
        single_err = max(single_err, d)
        if not d <= 1e-6 or o.iterations != comp[i].iterations:
            raise AssertionError(f"scenario {i}: {comp[i].iterations} iterations and "
                                 f"|dx| {d:.3e} against SimpleOptimizer's {o.iterations}")
    useful = int(it_h.sum())
    conv = sum(r.converged for r in comp)
    print(f"scheduler stream: S={S}, B={B}, A {m}x{n}, chunk {SCHED_CHUNK}, niter_max "
          f"{niter_max} (cut from the bench's 6000), atol {SCHED_ATOL}: {conv} converged, "
          f"iterations p5/median/p95/max {int(np.percentile(it_h, 5))}/"
          f"{int(np.median(it_h))}/{int(np.percentile(it_h, 95))}/{int(it_h.max())}; "
          f"run vs run_compiled max |dx|/max|x| {worst:.3e} (bound 1e-9), equal iterations and "
          f"flags; scenarios {picks} vs SimpleOptimizer max |dx| {single_err:.3e} (bound 1e-6)",
          flush=True)
    for mode, t, extra in (("static batches", t_static,
                            f", utilization {it_s.sum() / slots:.3f} "
                            f"({int(it_s.sum())} useful of {slots} lane-iterations)"),
                           ("run", out["run_s"], ""), ("run_compiled", out["run_compiled_s"], "")):
        print(f"[{card}] scheduler {mode}: {t:.2f} s = {S / t:.1f} scenarios/s = "
              f"{useful / t:.0f} useful inst-iters/s{extra}", flush=True)
    for mode in ("run_compiled", "run") if again else ():
        sync()
        t0 = time.perf_counter()
        getattr(sched, mode)(iter(scen))
        sync()
        print(f"[{card}] scheduler {mode}, second run: {time.perf_counter() - t0:.2f} s",
              flush=True)
    one_wave = ScenarioScheduler(bs, batch_size=B, chunk_iters=SCHED_CHUNK,
                                 niter_max=SCHED_CHUNK, rtol=0.0, atol=SCHED_ATOL)
    for mode in ("run", "run_compiled"):
        captured_vs_eager(
            torch, card, f"scheduler {mode}, one wave of {SCHED_CHUNK} iterations",
            lambda mode=mode: getattr(one_wave, mode)(iter(scen[:B])), SCHED_CHUNK, [bs],
            state=lambda res: [a for r in res for a in r.x]
            + [np.array([(r.iterations, r.converged) for r in res])])
    return {"static_s": t_static, "run_s": out["run_s"], "run_compiled_s": out["run_compiled_s"],
            "solver": bs, "scenarios": scen[:B]}


def phase_resumable(torch, card, A, ys, device="cuda", niter=RESUME_NITER):
    """7b. ``solve_resumable`` on the float64 bench problem in a temporary
    directory: stopped after one segment and resumed, against uninterrupted."""
    import os
    import tempfile

    from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, identity
    from admmsolver_tpu_torch.parallel import BatchedSolver
    from admmsolver_tpu_torch.utils import load_batch_result, save_batch_result

    n = A.shape[1]
    bs = BatchedSolver(Model([LeastSquares(1.0, A, ys[0]), L1Regularizer(ALPHA, n)],
                             [(1, 0, identity(n), identity(n))]), device=device)
    ov = {(0, "y"): torch.as_tensor(ys, dtype=torch.float64, device=device)}
    kw = dict(checkpoint_every=RESUME_EVERY, rtol=0.0, record_residuals=False)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    with tempfile.TemporaryDirectory() as tmp:
        whole, cut = os.path.join(tmp, "whole.npz"), os.path.join(tmp, "cut.npz")
        sync()
        t0 = time.perf_counter()
        straight = bs.solve_resumable(whole, ov, niter=niter, **kw)
        sync()
        t_solve = time.perf_counter() - t0
        first = bs.solve_resumable(cut, ov, niter=RESUME_EVERY, **kw)
        if int(first.iterations.max()) != RESUME_EVERY:
            raise AssertionError("the first segment ran another count of iterations")
        resumed = bs.solve_resumable(cut, ov, niter=niter, **kw)
        for a, b in zip(resumed.x + resumed.h, straight.x + straight.h):
            if not torch.equal(a, b):
                raise AssertionError("the resumed solve departs from the uninterrupted one: "
                                     f"max |diff| {float((a - b).abs().max()):.3e}")
        if not bool((resumed.iterations == niter).all()):
            raise AssertionError("the resumed solve did not count every iteration")
        size = os.path.getsize(whole)
        t_write, t_read = [], []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            save_batch_result(os.path.join(tmp, "w.npz"), straight)
            t_write.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back = load_batch_result(whole, device=device)
            sync()
            t_read.append(time.perf_counter() - t0)
        if not all(torch.equal(a, b) for a, b in zip(back.x, straight.x)):
            raise AssertionError("a checkpoint read back differs from what was written")
        fresh = iter(range(4))
        captured_vs_eager(
            torch, card, f"solve_resumable ({niter} iters in segments of {RESUME_EVERY})",
            lambda: bs.solve_resumable(os.path.join(tmp, f"turn{next(fresh)}.npz"), ov,
                                       niter=niter, **kw), niter, [bs])
    B = ys.shape[0]
    print(f"solve_resumable: A {A.shape[0]}x{n}, B={B}, f64, {niter} iterations in segments of "
          f"{RESUME_EVERY}: stopped after one segment and resumed == uninterrupted (atol 0)",
          flush=True)
    print(f"[{card}] solve_resumable {niter} iters: {t_solve * 1e3:.1f} ms = "
          f"{B * niter / t_solve:.0f} inst-iters/s, with 2 checkpoints; checkpoint {size} bytes, "
          f"write {np.median(t_write) * 1e3:.1f} ms, read to the card "
          f"{np.median(t_read) * 1e3:.1f} ms (medians of {REPEATS})", flush=True)
    return {"bytes": size, "write_s": float(np.median(t_write)), "read_s": float(np.median(t_read))}


def phase_complex_spm(torch, card, device="cuda", B=CSPM_B, niter=CSPM_NITER, nl=NL, nw=NW):
    """7c. Complex SpM (benches/complex_spm_hw.py:38-55) through
    ``realify_model`` and a float64 ``BatchedSolver``; lane 0 against a
    complex128 ``SimpleOptimizer`` of the unrealified model."""
    from admmsolver_tpu_torch import SimpleOptimizer, realify_model
    from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
    from admmsolver_tpu_torch.models.realify import decode, encode
    from admmsolver_tpu_torch.parallel import BatchedSolver

    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=nl, nw=nw, noise=1e-5)
    rng = np.random.RandomState(7)
    gs = g[None, :] + 1e-5 * (rng.randn(B, g.size) + 1j * rng.randn(B, g.size))
    model = spm_model(s, gs[0], prj_sum, prj_w, alpha_l1=1e-4)
    re = realify_model(model)
    bs = BatchedSolver(re.model, device=device)
    ov = {(0, "y"): encode(torch.as_tensor(gs, device=device))}
    solve = lambda: bs.solve(ov, mu0=0.1, niter=niter, rtol=0.0, record_residuals=False)
    res = solve()
    outs = [*res.x, *res.h, res.mu]
    if not all(t.dtype == torch.float64 and bool(torch.isfinite(t).all()) for t in outs):
        raise AssertionError("the realified SpM solve gave non-finite or non-float64 values")
    rho_l, _, spec = (decode(x) for x in res.x)
    min_spec = float(spec.real.min())
    spec_im = float(spec.imag.abs().max())
    sums = (rho_l @ torch.as_tensor(prj_sum, dtype=torch.complex128, device=rho_l.device)
            - 1.0).abs()
    med = float(sums.median())
    oc = SimpleOptimizer(model, mu=0.1, device=device)
    oc.solve(niter, rtol=0.0)
    lane0 = max(float((decode(x[0]) - xc).abs().max()) / max(float(xc.abs().max()), 1e-300)
                for x, xc in zip(res.x, oc.x))
    print(f"complex SpM realified: nl={nl} -> {2 * nl}, nw={nw} -> {2 * nw}, B={B}, {niter} "
          f"iterations, f64: min spectrum {min_spec:.3e} (Im lanes max {spec_im:.1e}), median "
          f"|sum rule - 1| {med:.3e} (bound 1e-6), lane 0 vs complex128 SimpleOptimizer max "
          f"|dx|/max|x| {lane0:.3e} (bound 1e-8)", flush=True)
    if min_spec < 0.0 or spec_im != 0.0 or not med <= 1e-6 or not lane0 <= 1e-8 \
            or oc.x[0].dtype != torch.complex128:
        raise AssertionError("the realified SpM solve misses the model's properties")
    (t,) = median_wall(torch, [solve])
    print(f"[{card}] realified complex SpM BatchedSolver solve (B={B}, {niter} iters, f64): "
          f"{t * 1e3:.1f} ms = {B * niter / t:.0f} inst-iters/s", flush=True)
    captured_vs_eager(torch, card, f"realified complex SpM (B={B}, {niter} iters)", solve,
                      niter, [bs])
    return {"s": t, "solve": solve}


def phase_complex_bp(torch, card, kernels, fused, plain_chunk, real_solve, device="cuda", B=B,
                     niter=NITER, m=CBP_M, n=CBP_N):
    """7d. Complex basis pursuit realified through ``FusedTwoBlockSolver``:
    the kernel's ``l1_even`` mode at the bench kernel's shape (N=2n=512,
    thin R=2m=256)."""
    from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, identity, realify_model
    from admmsolver_tpu_torch.models.realify import decode, encode

    rng = np.random.RandomState(0)
    A = rng.randn(m, n) + 1j * rng.randn(m, n)
    xt = np.zeros((B, n))
    for b in range(B):
        xt[b, rng.choice(n, SPARSITY, replace=False)] = rng.randn(SPARSITY)
    yc = xt @ A.T
    re = realify_model(Model([LeastSquares(1.0, A, yc[0]), L1Regularizer(ALPHA, n)],
                             [(1, 0, identity(n), identity(n))]))
    solver = fused.FusedTwoBlockSolver(re.model, device=device)
    if (solver.prox, solver.thin, solver.N, solver.U.shape[1]) != ("l1_even", True, 2 * n, 2 * m):
        raise AssertionError(f"realified solver: prox {solver.prox}, thin {solver.thin}, "
                             f"U {tuple(solver.U.shape)}")
    ys = encode(torch.as_tensor(yc, device=device)).float()
    solve = lambda: solver.solve({(0, "y"): ys}, niter=niter, rtol=0.0)
    kernels.fused_two_block_chunk.launches = 0
    res = solve()
    if device == "cuda":
        torch.cuda.synchronize()
    launches = kernels.fused_two_block_chunk.launches
    if device == "cuda" and launches == 0:
        raise AssertionError("the realified fused solve launched no kernel")
    worst = check_recovery(decode(res.x0).real.cpu().numpy(), xt, "realified fused solve")
    if not bool((res.x1[:, 1::2] == 0).all()):
        raise AssertionError("the Im lanes of x1 are not exactly 0")
    res_plain = plain_chunk_solve(plain_chunk, solve)
    dev = float((res.x0 - res_plain.x0).abs().max())
    print(f"complex basis pursuit realified through the kernel (l1_even): complex A {m}x{n} -> "
          f"real {2 * m}x{2 * n}, B={B}, {niter} iters: {launches} launches, worst lane "
          f"err/bound {worst:.4f}, Im lanes of x1 exactly 0, kernel vs plain max |x0 diff| "
          f"{dev:.3e} (bound {SOLVE_TOL})", flush=True)
    if not dev <= SOLVE_TOL:
        raise AssertionError(f"the realified kernel solve departs from the plain one by {dev}")
    t_re, t_real = median_wall(torch, [solve, real_solve])
    print(f"[{card}] realified complex fused solve (B={B}, {niter} iters): {t_re * 1e3:.1f} ms = "
          f"{B * niter / t_re:.0f} inst-iters/s; the real bench solve beside it "
          f"{t_real * 1e3:.1f} ms = {B * niter / t_real:.0f} inst-iters/s", flush=True)
    captured_vs_eager(torch, card, f"realified complex fused solve (B={B}, {niter} iters)", solve,
                      niter, [solver],
                      kernel=kernels.fused_two_block_chunk if device == "cuda" else None)
    return {"launches": launches, "s": t_re, "solve": solve}


def family_solve(torch, card, what, model, ov, niter, device, lanes=(0,), tol=1e-8,
                 single=None, runs=2, turn=True, profile_iters=None, kernel_name="gemm"):
    """One family through ``BatchedSolver.solve`` in float64 (rtol=0, no
    histories), timed by the host clock on its first run and on a second one
    (``runs=1``: the first only); ``lanes`` of it against ``SimpleOptimizer``
    solves on the same device, to ``tol`` of max|x|.  ``single(b)`` builds
    lane b's own model.  With ``turn``, one more solve through the captured
    chunks and one without graphs (:func:`captured_vs_eager`) where
    the model's routes are capturable; with ``--profile`` a profiled solve
    of ``profile_iters`` (default ``niter``; 0: none) iterations each way,
    ``kernel_name`` the kernels it sums apart.  Returns
    the result, the solver, the timings and the Jacobi kernel's launches in
    the last timed solve (the count set to 0 just before it and read just
    after)."""
    from admmsolver_tpu_torch import SimpleOptimizer
    from admmsolver_tpu_torch.ops import kernels
    from admmsolver_tpu_torch.parallel import BatchedSolver

    bs = BatchedSolver(model, device=device)
    solve = lambda: bs.solve(ov, niter=niter, rtol=0.0, record_residuals=False)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    times, res = [], None
    for _ in range(runs):
        res = None      # the first result does not sit beside the second solve
        sync()
        kernels.jacobi_eigh.launches = 0
        t0 = time.perf_counter()
        res = solve()
        sync()
        times.append(time.perf_counter() - t0)
        launches = kernels.jacobi_eigh.launches
    outs = [*res.x, *res.h, res.mu]
    # eight lanes at a time: the check's temporaries stay small beside 8f's
    # (B, N) arrays, whose memory the part reads
    if not all(t.dtype == torch.float64 and all(bool(torch.isfinite(t[b:b + 8]).all())
                                                for b in range(0, t.shape[0], 8))
               for t in outs):
        raise AssertionError(f"{what}: non-finite or non-float64 values")
    if not bool((res.iterations == niter).all()):
        raise AssertionError(f"{what}: not every lane ran {niter} iterations")
    worst = 0.0
    for b in lanes:
        o = SimpleOptimizer(single(b), device=device)
        o.solve(niter, rtol=0.0)
        for xb, xs in zip(res.x, o.x):
            scale = max(float(xs.abs().max()), 1e-300)
            worst = max(worst, float((xb[b] - xs).abs().max()) / scale)
    print(f"{what}: lanes {list(lanes)} vs SimpleOptimizer max |dx|/max|x| {worst:.3e} "
          f"(bound {tol:g})", flush=True)
    if not worst <= tol:
        raise AssertionError(f"{what}: the batch departs from its single solves by {worst:.3e}")
    print(f"[{card}] {what}: {niter} iterations in {times[0] * 1e3:.1f} ms (first run)"
          + (f", {times[1] * 1e3:.1f} ms (second)" if runs > 1 else "")
          + f" = {times[-1] * 1e3 / niter:.3f} ms per iteration"
          + (f"; Jacobi kernel launches in one solve {launches}" if launches else ""),
          flush=True)
    if device == "cuda" and not bs._captures(bs.model.functions, torch.float64):
        print(f"{what}: chunks without a graph by the declared rule (a route that a CUDA "
              "graph cannot hold)", flush=True)
    else:
        if turn:
            captured_vs_eager(torch, card, what, solve, niter, [bs])
        iters = niter if profile_iters is None else profile_iters
        if "--profile" in sys.argv and device == "cuda" and iters:
            profile_both(torch, what, lambda: bs.solve(ov, niter=iters, rtol=0.0,
                                                       record_residuals=False), iters,
                         kernel_name=kernel_name)
    return res, bs, times, launches


def check_psd(torch, what, x, k):
    """Every k x k slice (slices along the last axis of (k, k, rest)) of every
    lane of ``x`` (B, k*k*rest) has its least eigenvalue >= -1e-9 max|x|."""
    X = x.reshape(x.shape[0], k, k, -1)
    lam = torch.linalg.eigvalsh(torch.movedim(X, 3, 1))
    least, bound = float(lam.min()), -1e-9 * float(x.abs().max())
    print(f"{what}: least eigenvalue over every slice {least:.3e} (bound {bound:.3e})",
          flush=True)
    if not least >= bound:
        raise AssertionError(f"{what}: a slice is not PSD ({least:.3e})")
    return least


def cov_problem(torch, k, B, device):
    """bench_sdp128's inputs (benches/bench_workloads.py:362-375): the
    function that makes lane b's model, and the per-lane overrides."""
    from admmsolver_tpu_torch.models.applications import covariance_denoise_model

    rng = np.random.RandomState(15)
    N = k * k
    w = 1.0 + rng.rand(N)
    rw = np.sqrt(w)
    Q = rng.randn(k, k)
    xt = (Q @ Q.T / k).reshape(-1)
    ys = xt[None, :] + 0.1 * rng.randn(B, N)
    model = lambda b: covariance_denoise_model(ys[b].reshape(k, k), weights=w)
    return model, {(0, "y"): torch.as_tensor(ys * rw[None, :], device=device)}


def phase_cov_denoise(torch, card, device="cuda", k=COV_K, B=COV_B, niter=COV_NITER,
                      variants=False):
    """8a. Covariance denoising (bench_sdp128): a weighted nearest-PSD matrix
    of k x k, one slice a lane, the per-lane data through the (0, "y")
    override; with ``variants`` batched eigh of the phase's slices alone
    under each linear-algebra library."""
    model, ov = cov_problem(torch, k, B, device)
    rng = np.random.RandomState(16)
    # short solves for the profiles (the eigh route launches thousands of
    # kernels an iteration, and the profiler's bookkeeping grows with them)
    res, bs, times, launches = family_solve(torch, card, f"covariance denoising k={k} B={B}",
                                            model(0), ov, niter, device, single=model,
                                            profile_iters=5)
    out = {"res": res, "ms_per_iter": 1e3 * times[1] / niter, "jacobi_launches": launches,
           "least_eig": check_psd(torch, "covariance denoising", res.x[1], k),
           "profile": lambda iters: bs.solve(ov, niter=iters, rtol=0.0, record_residuals=False)}
    if variants and device == "cuda":
        x = torch.as_tensor(rng.randn(B, k, k), device=device)
        x = x + x.mT
        libs = {}
        prev = torch.backends.cuda.preferred_linalg_library()
        try:
            for lib in ("cusolver", "magma"):
                torch.backends.cuda.preferred_linalg_library(lib)
                (libs[lib],) = median_ms(torch, [lambda: torch.linalg.eigh(x)])
        finally:
            torch.backends.cuda.preferred_linalg_library(prev)
        print(f"[{card}] batched torch.linalg.eigh of ({B}, {k}, {k}) f64 alone: "
              + ", ".join(f"{lib} {t:.3f} ms" for lib, t in libs.items())
              + f" (default {prev}); the solve: {out['ms_per_iter']:.3f} ms per iteration",
              flush=True)
        out["eigh_ms"] = libs
    return out


def sdp_problem(torch, k, rest, B, device):
    """bench_sdp's inputs (benches/bench_workloads.py:237-250): LS data fit
    with a PSD cone on rest slices of k x k; the function that makes lane b's
    model, the per-lane overrides and a label."""
    from admmsolver_tpu_torch.models.applications import sdp_model

    shape = (k, k, rest)
    N = k * k * rest
    M = N // 2
    rng = np.random.RandomState(3)
    A = rng.randn(M, N)
    xt = np.zeros(shape)
    for r in range(rest):
        Q = rng.randn(k, k)
        xt[:, :, r] = Q @ Q.T / k
    y = A @ xt.reshape(-1)
    ys = y[None, :] + 1e-4 * rng.randn(B, M)
    return (lambda b: sdp_model(A, ys[b], shape, axis=2),
            {(0, "y"): torch.as_tensor(ys, device=device)}, f"A {M}x{N}")


def phase_sdp(torch, card, device="cuda", k=SDP_K, rest=SDP_REST, B=SDP_B, niter=SDP_NITER):
    """8b. The SDP (bench_sdp)."""
    model, ov, what = sdp_problem(torch, k, rest, B, device)
    res, bs, times, launches = family_solve(
        torch, card, f"SDP k={k} rest={rest} {what} B={B}", model(0), ov, niter, device,
        single=model)
    least = check_psd(torch, "SDP", res.x[1], k)
    return {"res": res, "ms_per_iter": 1e3 * times[1] / niter, "jacobi_launches": launches,
            "least_eig": least, "niter": niter,
            "solve": lambda: bs.solve(ov, niter=niter, rtol=0.0, record_residuals=False)}


def phase_rpca(torch, card, device="cuda", m=RPCA_M, n=RPCA_N, B=RPCA_B, niter=RPCA_NITER,
               rank=3, seed=7, method="auto", runs=2):
    """8c. Robust PCA (bench_rpca, benches/bench_workloads.py:438-445; 10c
    also bench_rpca96, :471-506, with ``rank=4, seed=17``): the nuclear-norm
    prox by ``svd_method``, per-lane Y through (1, "offset")."""
    from admmsolver_tpu_torch.models.applications import rpca_model

    rng = np.random.RandomState(seed)
    L0 = rng.randn(B, m, rank) @ rng.randn(rank, n)
    Ys = L0.copy()
    mask = rng.rand(B, m, n) < 0.05
    Ys[mask] += 6.0 * rng.randn(int(mask.sum()))
    ov = {(1, "offset"): torch.as_tensor(Ys.reshape(B, -1), device=device)}
    res, bs, times, launches = family_solve(
        torch, card, f"RPCA {m}x{n} B={B} svd_method={method}", rpca_model(Ys[0], svd_method=method),
        ov, niter, device, single=lambda b: rpca_model(Ys[b], svd_method=method), runs=runs)
    L = res.x[0].cpu().numpy().reshape(B, m, n)
    rel = float(np.abs(L - L0).max() / np.abs(L0).max())
    sv = np.linalg.svd(L, compute_uv=False)
    rank = int(np.median((sv > 1e-3 * sv[:, :1]).sum(axis=1)))
    print(f"RPCA {m}x{n} {method}: max rel error of L {rel:.4f}, median effective rank {rank}, "
          f"finite {bool(np.isfinite(L).all())}", flush=True)
    return {"res": res, "ms_per_iter": 1e3 * times[-1] / niter, "max_rel_err_L": rel,
            "rank": rank, "jacobi_launches": launches, "niter": niter,
            "solve": lambda: bs.solve(ov, niter=niter, rtol=0.0, record_residuals=False)}


def phase_group_lasso(torch, card, device="cuda", M=GL_M, N=GL_N, gs=GL_GS, B=GL_B,
                      niter=GL_NITER):
    """8d. Group lasso (bench_group_lasso, benches/bench_workloads.py:
    516-525): the group soft-threshold prox."""
    from admmsolver_tpu_torch.models.applications import group_lasso_model

    rng = np.random.RandomState(8)
    A = rng.randn(M, N)
    xt = np.zeros(N)
    on = rng.choice(N // gs, 6, replace=False)
    for g in on:
        xt[g * gs:(g + 1) * gs] = rng.randn(gs)
    ys = (A @ xt)[None, :] + 0.01 * rng.randn(B, M)
    res, _, times, _ = family_solve(
        torch, card, f"group lasso A {M}x{N} groups of {gs} B={B}",
        group_lasso_model(A, ys[0], 0.5, gs), {(0, "y"): torch.as_tensor(ys, device=device)},
        niter, device, single=lambda b: group_lasso_model(A, ys[b], 0.5, gs))
    X = res.x[1].cpu().numpy()
    gn = np.sqrt((X.reshape(B, -1, gs) ** 2).sum(-1))
    active = gn > 1e-3 * np.abs(X).max()
    hit = float(active[:, on].all(axis=1).mean())
    print(f"group lasso: support-recovery rate {hit:.3f}, median active groups "
          f"{int(np.median(active.sum(axis=1)))}", flush=True)
    return {"ms_per_iter": 1e3 * times[1] / niter, "support_recovery_rate": hit}


def phase_huber(torch, card, device="cuda", M=HUB_M, N=HUB_N, B=HUB_B, niter=HUB_NITER,
                delta=HUB_DELTA):
    """8e. Huber regression (bench_huber, benches/bench_workloads.py:
    547-556): the elementwise Huber prox through a dense A coupling."""
    from admmsolver_tpu_torch.models.applications import robust_regression_model

    rng = np.random.RandomState(9)
    A = rng.randn(M, N) / np.sqrt(M)
    xt = rng.randn(N)
    ys = (A @ xt)[None, :] + 0.01 * rng.randn(B, M)
    ys = ys + (rng.rand(B, M) < 0.05) * 8.0 * rng.randn(B, M)
    res, _, times, _ = family_solve(
        torch, card, f"Huber regression A {M}x{N} delta={delta} B={B}",
        robust_regression_model(A, ys[0], delta=delta),
        {(1, "y"): torch.as_tensor(ys, device=device)}, niter, device,
        single=lambda b: robust_regression_model(A, ys[b], delta=delta))
    err = float(np.abs(res.x[0].cpu().numpy() - xt).max())
    print(f"Huber regression: max coefficient error {err:.4f}", flush=True)
    return {"ms_per_iter": 1e3 * times[1] / niter, "max_coef_err": err}


def tv_signals(N, B, jumps=TV_JUMPS, seed=11):
    """A piecewise-constant signal with ``jumps`` jumps and B noisy copies
    (noise 0.1), from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    truth = np.zeros(N)
    for j in np.sort(rng.choice(np.arange(1, N), jumps, replace=False)):
        truth[j:] += rng.randn()
    return truth, truth[None, :] + 0.1 * rng.randn(B, N)


def device_footprint(torch, snap, pools):
    """The peak over a recorded window (``snap``: an allocator snapshot with
    its trace) of the device memory held: the bytes allocated outside the
    graph pools ``pools`` (MemPool ids) plus the bytes of those pools'
    segments, which stay reserved while their solver lives.  A pool's
    segment counts from its last ``segment_alloc`` in the trace on (an
    earlier segment at that address was the general allocator's).  Returns
    (peak bytes, the peak of the bytes live in the pools, trace entries)."""
    import bisect

    pools = {tuple(p) for p in pools}
    segs = sorted((s["address"], s["address"] + s["total_size"]) for s in snap["segments"]
                  if tuple(s.get("segment_pool_id", ())) in pools)
    trace = snap["device_traces"][torch.cuda.current_device()]
    since = {}
    for i, e in enumerate(trace):
        if e["action"] == "segment_alloc":
            since[e["addr"]] = i
    starts = [a for a, _ in segs]

    def in_pool(addr, i):
        k = bisect.bisect_right(starts, addr) - 1
        return k >= 0 and addr < segs[k][1] and since.get(segs[k][0], -1) <= i

    freed = "free_completed" if any(e["action"] == "free_completed" for e in trace) \
        else "free_requested"
    outside = reserved = peak = inside = inside_peak = 0
    live, pooled = {}, {}
    for i, e in enumerate(trace):
        action = e["action"]
        if action == "segment_alloc" and since.get(e["addr"]) == i and in_pool(e["addr"], i):
            reserved += e["size"]
        elif action == "alloc" and not in_pool(e["addr"], i):
            outside += e["size"]
            live[e["addr"]] = e["size"]
        elif action == "alloc":
            inside += e["size"]
            pooled[e["addr"]] = e["size"]
            inside_peak = max(inside_peak, inside)
        elif action == freed and e["addr"] in live:
            outside -= live.pop(e["addr"])
        elif action == freed and e["addr"] in pooled:
            inside -= pooled.pop(e["addr"])
        peak = max(peak, outside + reserved)
    return peak, inside_peak, len(trace)


def phase_tv(torch, card, device="cuda", N=TV_N, B=TV_B, niter=TV_NITER, lam=TV_LAM):
    """8f. TV denoising at the scale tv_denoise_model's docstring names: the
    banded penalty per lane and its cyclic-reduction factor; lanes 0 and 1
    against SimpleOptimizer, and the device memory the part takes, over
    every solve of it (the timed ones, the captured-against-eager turn and
    ``--profile``'s): the peak of what is allocated outside the solver's
    graph pool plus the pool's reserved segments, read from the allocator's
    trace (:func:`device_footprint`), under TV_MEMORY_LIMIT; beside it the
    peak allocated alone (the reading of the eager engine before the
    captured chunks) and the pool's bytes."""
    from admmsolver_tpu_torch.models.applications import tv_denoise_model

    truth, ys = tv_signals(N, B)
    ys_dev = torch.as_tensor(ys, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(enabled="all", context=None,
                                                  max_entries=TV_TRACE_ENTRIES)
    ov = {(0, "y"): ys_dev}
    what = f"TV denoising N={N} B={B} lam={lam}"
    res, bs, times, _ = family_solve(
        torch, card, what, tv_denoise_model(ys[0], lam), ov, niter, device, lanes=(0, 1),
        tol=1e-9, single=lambda b: tv_denoise_model(ys[b], lam), turn=False, profile_iters=0)
    # eight lanes at a time: the reading's own temporaries stay small
    truth_dev = torch.as_tensor(truth, device=device)
    err = sum(float((res.x[0][b:b + 8] - truth_dev).abs().sum()) for b in range(0, B, 8)) / (B * N)
    noisy = float(np.abs(ys - truth[None]).mean())
    # the turn and the profile inside the reading, without the timed result
    res = None
    solve = lambda iters: bs.solve(ov, niter=iters, rtol=0.0, record_residuals=False)
    captured_vs_eager(torch, card, what, lambda: solve(niter), niter, [bs])
    if "--profile" in sys.argv and device == "cuda":
        profile_both(torch, f"{what}, 5 iterations", lambda: solve(5), 5, kernel_name="pad")
    foot = peak = pool = pool_live = None
    if device == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        foot, pool_live, entries = device_footprint(torch, snap, [bs._pool.mempool.id])
        snap = None
        if entries >= TV_TRACE_ENTRIES:
            raise AssertionError("the allocator's trace of the TV part overflowed")
        pool = bs._pool.bytes
    print(f"TV denoising: mean |x - truth| {err:.4f} (noisy input {noisy:.4f})"
          + ("" if foot is None else f"; device memory over the part, the graph pool "
             f"included, {foot / 2**20:.0f} MiB (limit {TV_MEMORY_LIMIT / 2**20:.0f} MiB; one "
             f"(B, N) float64 array is {B * N * 8 / 2**20:.1f} MiB); the pool {pool / 2**20:.0f}"
             f" MiB, at most {pool_live / 2**20:.0f} MiB of it live; peak allocated "
             f"{peak / 2**20:.0f} MiB; trace of {entries} entries"),
          flush=True)
    if foot is not None and not foot < TV_MEMORY_LIMIT:
        raise AssertionError(f"the TV part took {foot / 2**20:.0f} MiB of device memory")
    if not err < noisy:
        raise AssertionError("TV denoising did not denoise")
    return {"ms_per_iter": 1e3 * times[1] / niter, "footprint_bytes": foot,
            "peak_bytes": peak, "pool_bytes": pool, "pool_live_bytes": pool_live}


# 10. the spectral routes: the Jacobi kernel, the Gram SVD and the matrix sign
def spectral_routes(**values):
    """Set the PSD dispatch constants (admmsolver_tpu_torch.ops.prox) for the
    span of a with-block, then restore them."""
    from admmsolver_tpu_torch.ops import prox

    return mock.patch.multiple(prox, **values)


def routed_solve(torch, card, what, model, ov, niter, device, k=None, profile_iters=0):
    """``family_solve`` through the routes the caller set (its Jacobi
    kernel launches counted in one solve), the PSD gate where ``k`` is
    given, and with ``profile_iters`` a profiled short solve's launches an
    iteration and busy share (on the card)."""
    res, bs, times, launches = family_solve(torch, card, what, model(0), ov, niter, device,
                                            single=model)
    out = {"res": res, "ms_per_iter": 1e3 * times[-1] / niter, "jacobi_launches": launches}
    if k is not None:
        out["least_eig"] = check_psd(torch, what, res.x[1], k)
    if profile_iters and device == "cuda":
        out.update(route_profile(torch, what, lambda: bs.solve(
            ov, niter=profile_iters, rtol=0.0, record_residuals=False), profile_iters))
    return out


def route_profile(torch, what, solve, iters):
    """Launches an iteration and busy share of a profiled ``iters``-iteration
    solve."""
    prof = profile_solve(torch, f"{what}, {iters} iterations", "gemm", solve, iters=iters)
    return {"launches_per_iter": prof["launches"] / iters, "busy": prof["busy"]}


# phases 6-10: the engine's chunks captured against the same chunks run directly
_TURN = [0]


def with_capture(capture, fn):
    """``fn()`` with ``admmsolver_tpu_torch.parallel.batch.CAPTURE_CHUNKS``
    set to ``capture`` for its span (False: the chunks without graphs)."""
    from admmsolver_tpu_torch.parallel import batch

    keep = batch.CAPTURE_CHUNKS
    batch.CAPTURE_CHUNKS = capture
    try:
        return fn()
    finally:
        batch.CAPTURE_CHUNKS = keep


def programs_of(solver):
    """(programs by key, graph pool) of a solver, or of a SimpleOptimizer's
    plan: one pool a solver or plan."""
    if hasattr(solver, "_programs"):
        return solver._programs, solver._pool
    return solver._plan._run_cache, solver._plan._pool


def program_stats(solvers):
    """(capture seconds by chunk key, graph pool bytes, bytes of the
    programs' buffers) of the chunk programs of ``solvers`` (BatchedSolver,
    FusedTwoBlockSolver, FusedSpMSolver, LargeNTwoBlockSolver or
    SimpleOptimizer objects): what the solvers hold between solves."""
    held = [programs_of(s) for s in solvers]
    programs = [p for progs, _ in held for p in progs.values()]
    nbytes = sum(t.untyped_storage().nbytes() for p in programs for t in p.buffers())
    return ({n: t for p in programs for n, t in p.capture_s.items()},
            sum(pool.bytes for _, pool in held if pool is not None), nbytes)


def chunk_name(key):
    """A chunk key of a program: its length (BatchedSolver, LargeN), the
    single-instance program's (length, penalty update) or the fused
    programs' (length, penalty update, A†y made in the chunk)."""
    if not isinstance(key, tuple):
        return f"{key} iterations"
    n, do_mu, prologue = key + (False,) * (3 - len(key))
    return (f"{n} iterations" + ("" if do_mu else " without a penalty update")
            + (" with A†y" if prologue else ""))


def restarted(opt, niter, mu0=1.0, **kw):
    """``opt`` (a SimpleOptimizer) after a solve of ``niter`` iterations from
    its initial state (x = h = 0, ``mu0``), its histories cleared: each such
    solve reuses the optimizer's warm run program."""
    opt._x, opt._h, opt._mu = opt._plan.make_initial_state(mu0=mu0, device=opt._mu.device)
    opt._primal_residual, opt._dual_residual = [], []
    opt.solve(niter, **kw)
    return opt


def single_state(opt):
    """x, the x before the last iteration, h, mu, the iteration count and both
    histories of a SimpleOptimizer."""
    return (tuple(opt.x) + tuple(opt._x_old) + tuple(opt.h)
            + (opt.mu, np.array(opt.iterations), np.array(opt.primal_residual_history),
               np.array(opt.dual_residual_history)))


def large_n_state(res):
    """x0, x1, h, mu, both histories, the iteration count and the flag of a
    LargeNResult."""
    return (res.x0, res.x1, res.h, res.mu, res.primal_residual, res.dual_residual,
            np.array([res.iterations, res.converged]))


def captured_vs_eager(torch, card, what, solve, niter, solvers, state=None, kernel=None):
    """One solve through the captured chunks and one without graphs,
    in an order that flips every call (captured first on even calls), each
    timed by the host clock with a device synchronize; ``state(result)`` of
    the two bitwise equal.  Prints ms an iteration both ways and the capture
    seconds and pool bytes of ``solvers``' chunk programs (``state``: x, h,
    mu, iterations and flags of a result, :func:`state_of`).  With
    ``kernel`` (a counted wrapper), its launches in each solve, which must
    be equal and not 0."""
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    turn, out, launches = _TURN[0], {}, {}
    _TURN[0] += 1
    state = state or state_of
    for capture in (True, False) if turn % 2 == 0 else (False, True):
        if kernel is not None:
            kernel.launches = 0
        sync()
        t0 = time.perf_counter()
        res = with_capture(capture, solve)
        sync()
        t = time.perf_counter() - t0
        if kernel is not None:
            launches[capture] = kernel.launches
        # the state on the host: one solve's result at a time on the card
        out[capture] = ([np.asarray(a.cpu() if hasattr(a, "cpu") else a) for a in state(res)], t)
        res = None
    got, want = (out[c][0] for c in (True, False))
    same = len(got) == len(want) and all(a.dtype == b.dtype and a.shape == b.shape
                                         and a.tobytes() == b.tobytes()
                                         for a, b in zip(got, want))
    diff = max(float(np.nanmax(np.abs(a.astype(np.float64) - b.astype(np.float64)), initial=0.0))
               for a, b in zip(got, want))
    capture_s, pool, held = program_stats(solvers)
    ms = {c: 1e3 * out[c][1] / niter for c in out}
    print(f"[{card}] {what}, captured against eager ({'captured' if turn % 2 == 0 else 'eager'} "
          f"first): {ms[True]:.3f} against {ms[False]:.3f} ms per iteration "
          f"({ms[False] / ms[True]:.2f}x; solve {1e3 * out[True][1]:.2f} against "
          f"{1e3 * out[False][1]:.2f} ms); captures "
          + ", ".join(f"{chunk_name(n)} {t:.3f} s"
                      for n, t in sorted(capture_s.items(), key=str))
          + f"; pool {pool / 2**20:.1f} MiB, buffers {held / 2**20:.1f} MiB "
          + f"({sum(len(programs_of(s)[0]) for s in solvers)} programs); "
          + (f"kernel launches {launches[True]} / {launches[False]}; " if kernel else "")
          + "states " + ("bitwise equal" if same else f"DIFFER by {diff:.3e}"), flush=True)
    if not same:
        raise AssertionError(f"{what}: the captured solve departs from the eager one by {diff:.3e}")
    if kernel is not None and not launches[True] == launches[False] > 0:
        raise AssertionError(f"{what}: kernel launches {launches} captured / eager")
    return {"ms_captured": ms[True], "ms_eager": ms[False], "capture_s": capture_s,
            "pool_bytes": pool, "held_bytes": held, "launches": launches.get(True)}


def profile_both(torch, what, solve, iters, kernel_name="gemm"):
    """The profiler over one solve through the captured chunks and one
    without graphs: launches an iteration and busy share of each."""
    return {mode: profile_solve(torch, f"{what}, {mode}", kernel_name,
                                lambda c=capture: with_capture(c, solve), iters=iters)
            for mode, capture in (("captured", True), ("eager", False))}


def max_rel_diff(xs, ys):
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
               for a, b in zip(xs, ys))


def phase_cov_routes(torch, card, cov, device="cuda", k=COV_K, B=COV_B, niter=COV_NITER):
    """10a. Covariance denoising at 8a's inputs through the library eigh
    (USE_SIGN_ABOVE_JACOBI = False) with 8a's gates, against 8a's solve
    ``cov`` through the card's default (the matrix sign above the Jacobi
    boundary): x of the two within SIGN_VS_EIGH_TOL of max|x|; each route's
    launches an iteration and busy share from a profiled 2-iteration
    solve."""
    model, ov = cov_problem(torch, k, B, device)
    out = {"sign": dict(cov)}
    if device == "cuda":
        out["sign"].update(route_profile(torch, "10a covariance, sign route (8a's solver)",
                                         lambda: cov["profile"](2), 2))
    with spectral_routes(USE_SIGN_ABOVE_JACOBI=False):
        out["eigh"] = routed_solve(torch, card, f"10a covariance k={k} B={B}, eigh route",
                                   model, ov, niter, device, k=k, profile_iters=2)
    d = max_rel_diff(cov["res"].x, out["eigh"]["res"].x)
    print(f"[{card}] 10a covariance: {cov['ms_per_iter']:.3f} ms per iteration (sign, 8a) "
          f"against {out['eigh']['ms_per_iter']:.3f} (eigh); x of the routes max |dx|/max|x| "
          f"{d:.3e} (bound {SIGN_VS_EIGH_TOL:g})", flush=True)
    if not d <= SIGN_VS_EIGH_TOL:
        raise AssertionError(f"10a: the sign route departs from the eigh route by {d:.3e}")
    out["sign_vs_eigh"] = d
    return out


def phase_sdp_routes(torch, card, sdp, device="cuda", k=SDP_K, rest=SDP_REST, B=SDP_B,
                     niter=SDP_NITER):
    """10b. The SDP at 8b's inputs through the library eigh (the boundary
    set below k, the sign route off) with 8b's gates, against 8b's solve
    ``sdp`` through the Jacobi kernel (the default at n <= JACOBI_MAX_N): x
    of the two within JACOBI_VS_EIGH_TOL."""
    model, ov, what = sdp_problem(torch, k, rest, B, device)
    with spectral_routes(JACOBI_MAX_N=k - 1, USE_SIGN_ABOVE_JACOBI=False):
        eigh = routed_solve(torch, card, f"10b SDP k={k} rest={rest} B={B}, eigh route",
                            model, ov, niter, device, k=k)
    d = max_rel_diff(sdp["res"].x, eigh["res"].x)
    print(f"[{card}] 10b SDP: {sdp['ms_per_iter']:.3f} ms per iteration (Jacobi kernel, 8b) "
          f"against {eigh['ms_per_iter']:.3f} (eigh); x of the routes max |dx|/max|x| "
          f"{d:.3e} (bound {JACOBI_VS_EIGH_TOL:g})", flush=True)
    if not d <= JACOBI_VS_EIGH_TOL:
        raise AssertionError(f"10b: the Jacobi route departs from the eigh route by {d:.3e}")
    return {"jacobi": sdp, "eigh": eigh, "jacobi_vs_eigh": d}


def phase_rpca_routes(torch, card, rpca, device="cuda", m=RPCA_M, n=RPCA_N, B=RPCA_B,
                      niter=RPCA_NITER, m96=RPCA96_M, n96=RPCA96_N, B96=RPCA96_B,
                      niter96=RPCA96_NITER):
    """10c. RPCA at 8c's 32 x 32 through "xla" against 8c's solve ``rpca``
    ("auto": on the card the Gram route through the kernel), and at
    bench_rpca96's 96 x 96 through "sign", "gram" and "xla" (run once: ~0.3 s
    an iteration); x of each other route within RPCA_ROUTE_TOL[route] of
    max|x| of the "xla" route's on the same inputs."""
    big = dict(m=m96, n=n96, B=B96, niter=niter96, rank=4, seed=17)
    out = {"32_auto": rpca,
           "32_xla": phase_rpca(torch, card, device, m=m, n=n, B=B, niter=niter, method="xla"),
           **{f"96_{method}": phase_rpca(torch, card, device, method=method, **big)
              for method in ("sign", "gram")},
           "96_xla": phase_rpca(torch, card, device, method="xla", runs=1, **big)}
    for part, ref, route in (("32_auto", "32_xla", "gram" if device == "cuda" else "xla"),
                             ("96_sign", "96_xla", "sign"), ("96_gram", "96_xla", "gram")):
        d = max_rel_diff(out[part]["res"].x, out[ref]["res"].x)
        out[part]["vs_xla"] = d
        print(f"[{card}] 10c RPCA {part}: {out[part]['ms_per_iter']:.3f} ms per iteration "
              f"against {out[ref]['ms_per_iter']:.3f} ({ref}); x of the routes max "
              f"|dx|/max|x| {d:.3e} (bound {RPCA_ROUTE_TOL[route]:g})", flush=True)
        if not d <= RPCA_ROUTE_TOL[route]:
            raise AssertionError(f"10c: RPCA {part} departs from {ref} by {d:.3e}")
    return out


def phase_warp_or_block(torch, card, fam, turns=8):
    """10e. 8b and 8c through the Jacobi kernel's warp path (their default)
    and through its block kernel (the warp path switched off for those
    turns: ``_JACOBI_WARP_MAX_N = 0``) in one process: after one warm-up
    solve of each, ``turns`` pairs of solves, the order flipped every pair
    (warp first, then block first), host-clock ms an iteration of each
    (median, min, max); x of a block solve against a warp solve within
    WARP_VS_BLOCK_TOL of max|x|."""
    from admmsolver_tpu_torch.ops import kernels

    def block(solve):
        keep = kernels._JACOBI_WARP_MAX_N
        kernels._JACOBI_WARP_MAX_N = 0
        try:
            return solve()
        finally:
            kernels._JACOBI_WARP_MAX_N = keep

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    out = {}
    for part, r in (("8b", fam["sdp"]), ("8c", fam["rpca"])):
        paths = {"warp": r["solve"], "block": lambda r=r: block(r["solve"])}
        d = max_rel_diff(paths["block"]().x, paths["warp"]().x)
        times = {"warp": [], "block": []}
        for turn in range(turns):
            for name in (("warp", "block") if turn % 2 == 0 else ("block", "warp")):
                times[name].append(1e3 * timed(paths[name]) / r["niter"])
        out[part] = {name: {"median": float(np.median(t)), "min": min(t), "max": max(t)}
                     for name, t in times.items()}
        out[part]["x_diff"] = d
        w, b = out[part]["warp"], out[part]["block"]
        print(f"[{card}] 10e {part}: ms per iteration through the warp path median "
              f"{w['median']:.3f} ({w['min']:.3f}-{w['max']:.3f}), through the block kernel "
              f"{b['median']:.3f} ({b['min']:.3f}-{b['max']:.3f}), {turns} solves each in "
              f"flipped turns; x of the two max |dx|/max|x| {d:.3e} (bound "
              f"{WARP_VS_BLOCK_TOL:g})", flush=True)
        if not d <= WARP_VS_BLOCK_TOL:
            raise AssertionError(f"10e: {part} through the block kernel departs from the "
                                 f"warp path by {d:.3e}")
    return out


def jacobi_bound_ms(B, n, sweeps, dtype_bits):
    """(least ms, what bounds it) for ``sweeps`` Jacobi sweeps of B slices:
    9 n^2 (n - 1) flops a sweep and slice over the FMA peak of the type, or
    the input read and w, V written once over the memory rate."""
    t_ops = 9.0 * n * n * (n - 1) * sweeps * B / (PEAK_F64_FLOPS if dtype_bits == 64
                                                   else PEAK_F32_FLOPS)
    t_bytes = B * (2 * n * n + n) * dtype_bits / 8 / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def jacobi_ptxas():
    """{"warp <f|d> N" | "tile <f|d>" | "block <f|d> MODE": (registers,
    stack frame bytes, spill bytes stored and loaded)} of every Jacobi
    kernel (the warp path, the tile path, the block kernel), from
    ptxas's report in the build log beside the Jacobi library."""
    from admmsolver_tpu_torch.ops import _build

    log = _build._lib_path(_build.SOURCE_DIR / "jacobi_eigh.cu").with_suffix(".log")
    kinds = (("warp", r"jacobi_warp_kernelI([df])Li(\d+)E"),
             ("tile", r"jacobi_tile_kernelI([df])E"), ("block", r"jacobi_kernelI([df])Li(\d+)E"))
    out, entry = {}, None
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            entry = None
            for kind, pattern in kinds:
                name = re.search(pattern, line)
                if name:
                    entry = " ".join((kind,) + name.groups())
                    out.setdefault(entry, [None, None, None])
        elif entry and "spill stores" in line:
            out[entry][1] = int(re.search(r"(\d+) bytes stack frame", line).group(1))
            out[entry][2] = sum(int(b) for b in re.findall(r"(\d+) bytes spill", line))
        elif entry and "Used" in line and "registers" in line:
            out[entry][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {key: tuple(val) for key, val in sorted(out.items())}


def phase_jacobi_alone(torch, card, device="cuda", shapes=JACOBI_SHAPES):
    """10d. The Jacobi kernel alone at each (slices, n) in float64 and
    float32, at the default sweeps: against its plain version (sorted
    eigenvalues within 10·n·eps·max|w|, inside the 100·n·eps·||A||_F asked
    of it) with its own V reconstructing A to the same limit and orthogonal
    within 10·n·eps; its time, the plain version's, the library eigh's and
    the bound, with the SMs its grid covers.  Each n must take the path
    JACOBI_MODE lists (the warp path to 32, the tile path from 34 to 128);
    beside it, the block kernel in its own mode at that n ("shared", or
    "global" at JACOBI_BLOCK_GLOBAL) is held to the same limits and timed
    in the same turns as ``prev_ms``.  On the card no warp or tile kernel
    may use local memory (ptxas's report); the block kernel's report is
    printed."""
    from admmsolver_tpu_torch.ops import _build, kernels
    from admmsolver_tpu_torch.ops.linop import _jacobi_sweeps

    if device == "cuda":
        ptxas = jacobi_ptxas()
        print(f"10d Jacobi kernels, ptxas (registers, stack frame, spill bytes): {ptxas}",
              flush=True)
        spilled = [key for key, (_, stack, spill) in ptxas.items()
                   if not key.startswith("block") and (stack or spill)]
        counts = {kind: sum(key.startswith(kind) for key in ptxas) for kind in ("warp", "tile")}
        if counts != {"warp": 32, "tile": 2} or spilled:
            raise AssertionError(f"10d: {counts} warp and tile kernels in the build log (32 "
                                 f"and 2 expected), using local memory: {spilled}")
        lib = _build.load_libraries()["jacobi_eigh"]
        n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows = []
    for B, n in shapes:
        for dtype in (torch.float64, torch.float32):
            rng = np.random.RandomState(n)
            a = rng.randn(B, n, n)
            a = torch.as_tensor(a + a.transpose(0, 2, 1), dtype=dtype, device=device)
            sweeps = _jacobi_sweeps(n, n <= 16, dtype)
            wr, _ = kernels.jacobi_eigh_reference(a, sweeps)
            eps = torch.finfo(dtype).eps
            tol, orth_tol = 10 * n * eps * float(wr.abs().max()), 10 * n * eps
            name = str(dtype).replace("torch.", "")

            def check(w, v, path):
                """Errors of (w, V) against the plain version; raises past the limits."""
                err = float((torch.sort(w).values - torch.sort(wr).values).abs().max())
                recon = float(((v * w[:, None, :]) @ v.mT - a).abs().max())
                orth = float((v.mT @ v - torch.eye(n, dtype=dtype, device=device)).abs().max())
                print(f"10d Jacobi ({B}, {n}, {n}) {name}{path}: eigenvalues {err:.3e}, "
                      f"reconstruction {recon:.3e} (bound {tol:.3e}: "
                      f"{max(err, recon) / tol:.3f} of it), orthogonality {orth:.3e} (bound "
                      f"{orth_tol:.3e}: {orth / orth_tol:.3f})", flush=True)
                if not (err <= tol and recon <= tol and orth <= orth_tol):
                    raise AssertionError(f"10d Jacobi ({B}, {n}, {n}) {name}{path} departs "
                                         "from its plain version")
                return err, recon, orth

            err, recon, orth = check(*kernels.jacobi_eigh(a, sweeps), "")
            row = {"B": B, "n": n, "dtype": name, "sweeps": sweeps, "max_abs_err": err,
                   "recon": recon, "orth": orth, "tol": tol, "mode": "plain", "prev_ms": None}
            if device == "cuda":
                f64, index = dtype == torch.float64, torch.cuda.current_device()
                row["mode"] = kernels._JACOBI_MODES[kernels._jacobi_mode(lib, index, n, f64)]
                if row["mode"] != JACOBI_MODE[n]:
                    raise AssertionError(f"10d: n={n} takes mode {row['mode']}, not "
                                         f"{JACOBI_MODE[n]}")
                fns = [lambda: kernels.jacobi_eigh(a, sweeps)]
                block = kernels._jacobi_block_mode(lib, index, n, f64)
                row["prev_mode"] = kernels._JACOBI_MODES[block]
                want = "global" if (n, name) in JACOBI_BLOCK_GLOBAL else "shared"
                if row["prev_mode"] != want:
                    raise AssertionError(f"10d: the block kernel takes mode {row['prev_mode']} "
                                         f"at n={n} {name}, not {want}")
                # the block kernel beside the warp and tile paths: held to the
                # same limits, then timed in the same turns
                prev = check(*kernels._jacobi_launch(a, sweeps, mode=block),
                             f" block kernel ({row['prev_mode']})")
                row["prev_max_abs_err"], row["prev_recon"], row["prev_orth"] = prev
                fns.append(lambda: kernels._jacobi_launch(a, sweeps, mode=block))
                times = graph_ms(torch, fns + fns[::-1])
                row["ms"] = 0.5 * (times[0] + times[-1])
                row["ms_turns"] = [times[0], times[-1]]
                row["prev_ms"] = 0.5 * (times[1] + times[2])
                row["prev_ms_turns"] = [times[1], times[2]]
                row["call_ms"], row["library_ms"] = median_ms(
                    torch, [lambda: kernels.jacobi_eigh(a, sweeps), lambda: torch.linalg.eigh(a)])
                # the plain version launches ~36 kernels a round: one timed call
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                kernels.jacobi_eigh_reference(a, sweeps)
                stop.record()
                torch.cuda.synchronize()
                row["plain_ms"] = start.elapsed_time(stop)
                row["bound_ms"], row["bound_by"] = jacobi_bound_ms(B, n, sweeps,
                                                                   torch.finfo(dtype).bits)
                blocks = -(-B // (32 // n)) if row["mode"] == "warp" else B
                row["sms"] = min(blocks, n_sms)
                print(f"[{card}] 10d Jacobi ({B}, {n}, {n}) {name}, {sweeps} sweeps: kernel "
                      f"mode {row['mode']} {row['ms_turns'][0]:.4f} / {row['ms_turns'][1]:.4f} "
                      f"ms (block kernel, mode {row['prev_mode']}: "
                      f"{row['prev_ms_turns'][0]:.4f} / {row['prev_ms_turns'][1]:.4f} ms), "
                      f"called eagerly {row['call_ms']:.4f} ms, plain "
                      f"{row['plain_ms']:.1f} ms, torch.linalg.eigh "
                      f"{row['library_ms']:.3f} ms, bound {row['bound_ms']:.4f} ms "
                      f"({row['bound_by']}) over all {n_sms} SMs, grid on {row['sms']} SMs",
                      flush=True)
            rows.append(row)
    return rows


def phase_spectral(torch, card, fam, device="cuda"):
    """Phase 10: 10a-10c drive the other spectral routes through
    BatchedSolver and hold each against phase 8's solve (``fam``: 8a-8c
    through the card's defaults) on the same inputs, 10d holds the kernel
    alone; returns the kernels line's entry for the kernel, with its
    launches in one solve of each part of the main path that takes it."""
    t0 = time.perf_counter()
    phase_cov_routes(torch, card, fam["cov"], device)
    phase_sdp_routes(torch, card, fam["sdp"], device)
    rpca = phase_rpca_routes(torch, card, fam["rpca"], device)
    parts = {"8b": (fam["sdp"], SDP_NITER), "8c": (fam["rpca"], RPCA_NITER),
             "10c_96_gram": (rpca["96_gram"], RPCA96_NITER)}
    by_part = {part: {"per_solve": r["jacobi_launches"],
                      "per_iteration": r["jacobi_launches"] / niter}
               for part, (r, niter) in parts.items()}
    print(f"Jacobi kernel launches in one solve: {by_part}", flush=True)
    if device == "cuda":
        missing = [part for part, count in by_part.items() if not count["per_solve"]]
        if missing:
            raise AssertionError(f"the Jacobi kernel was not launched in {missing}")
    if device == "cuda":
        phase_warp_or_block(torch, card, fam)
    rows = phase_jacobi_alone(torch, card, device)
    print(f"spectral phase: {time.perf_counter() - t0:.1f} s", flush=True)
    main = next(r for r in rows if (r["B"], r["n"], r["dtype"]) == JACOBI_MAIN)
    return {"name": "jacobi_eigh", "route": "cuda",
            "source": "admmsolver_tpu_torch/csrc/jacobi_eigh.cu",
            "replaces": "admmsolver_tpu/ops/linop.py:184",
            "launches": sum(count["per_solve"] for count in by_part.values()),
            "shape": list(JACOBI_MAIN),
            **{key: main.get(key) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                              "bound_by", "library_ms")},
            "launches_by_part": by_part,
            "shapes": [{key: r.get(key) for key in ("B", "n", "dtype", "mode", "ms", "prev_mode",
                                                    "prev_ms", "call_ms", "plain_ms",
                                                    "bound_ms", "sms", "library_ms",
                                                    "max_abs_err", "prev_max_abs_err")}
                       for r in rows]}


def phases_1_to_8(torch, card):
    """Phases 1 to 8 on the card; 8a-8c's results (for phase 10) and the
    ``kernels`` line of the run."""
    from admmsolver_tpu_torch import (L1Regularizer, LeastSquares, Model,
                                      SimpleOptimizer, identity)
    from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
    from admmsolver_tpu_torch.ops import _build, kernels
    from admmsolver_tpu_torch.parallel import (BatchedSolver, FusedSpMSolver,
                                               FusedTwoBlockSolver, fused, fused_spm)

    # 1. build
    t0 = time.perf_counter()
    libs = _build.load_libraries()
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(libs)} kernels", flush=True)
    if sorted(libs) != ["fused_spm", "fused_two_block", "jacobi_eigh"]:
        raise AssertionError(f"unexpected kernel libraries {sorted(libs)}")
    smem_limit = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    for name, lib in sorted(libs.items()):
        print(f"  {name}: {Path(lib._name).name}")
        for line in Path(lib._name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"    ptxas: {line.strip()}")

    A, ys, xtrue = bench_problem()
    model = Model([LeastSquares(1.0, A, ys[0]), L1Regularizer(ALPHA, N)],
                  [(1, 0, identity(N), identity(N))])
    solver = FusedTwoBlockSolver(model)
    assert solver.device.type == "cuda" and solver.thin
    assert tuple(solver.U.shape) == (N, M), solver.U.shape

    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=NL, nw=NW, noise=1e-5)
    gs = (g[None, :] + 1e-5 * np.random.RandomState(2).randn(B, g.size)).astype(np.float32)
    smodel = spm_model(s, g, prj_sum, prj_w, alpha_l1=SPM_ALPHA)
    spm = FusedSpMSolver(smodel)
    assert spm.device.type == "cuda" and (spm.nl, spm.nw) == (NL, NW)

    # 2. kernels against their plain versions
    Af = np.random.RandomState(1).randn(192, 128)
    full = FusedTwoBlockSolver(
        Model([LeastSquares(1.0, Af, np.zeros(192)), L1Regularizer(ALPHA, 128)],
              [(1, 0, identity(128), identity(128))]))
    assert not full.thin
    max_err, fma_err = 0.0, {}
    tb_names = ("x0", "x1", "h", "x0_prev")
    for name, sv in (("thin N=512 R=256", solver), ("full N=R=128", full)):
        chosen = kernels._two_block_tiling(sv.N, sv.U.shape[1], smem_limit)
        fma = kernels._two_block_tiling(sv.N, sv.U.shape[1], smem_limit, tensor_cores=False)
        errs = {"chosen": 0.0, "fma": 0.0}
        for k, prox in enumerate(PROX_MODES):
            args = kernel_inputs(torch, sv, prox, seed=10 + k)
            ref = kernels.fused_two_block_chunk_reference(*args, n_iters=21, prox=prox,
                                                          thin=sv.thin)
            got = kernels.fused_two_block_chunk(*args, n_iters=21, prox=prox, thin=sv.thin)
            errs["chosen"] = max(errs["chosen"], compare(
                torch, f"two-block {name}, {prox}, B={B}, 21 iters", tb_names, got, ref))
            # The FMA kernel on the same inputs, for the tensor-core route's
            # error beside it.
            got = kernels._two_block_launch(args, 21, prox, sv.thin, fma)
            errs["fma"] = max(errs["fma"], compare(
                torch, f"two-block {name}, {prox}, FMA kernel, 21 iters", tb_names, got, ref))
        if chosen.tensor_cores:
            check_ratio(f"two-block {name}, the wrapper chooses {tuple(chosen)}", "two-block",
                        errs["chosen"], errs["fma"])
        max_err = max(max_err, errs["chosen"])
        fma_err[name] = errs["fma"]
    # x0_prev comes from the iteration before the last: the short chunks.
    args = kernel_inputs(torch, solver, "l1", seed=14)
    for n_iters in (0, 1, 2, 3):
        got = kernels.fused_two_block_chunk(*args, n_iters=n_iters, prox="l1", thin=True)
        ref = kernels.fused_two_block_chunk_reference(*args, n_iters=n_iters, prox="l1",
                                                      thin=True)
        max_err = max(max_err, compare(
            torch, f"two-block thin N=512 R=256, l1, B={B}, {n_iters} iters", tb_names, got,
            ref))

    sr, gr, pr_sum, pr_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    ragged = FusedSpMSolver(spm_model(sr, gr, pr_sum, pr_w, alpha_l1=SPM_ALPHA))
    gr_b = gr[None, :] + 1e-4 * np.random.RandomState(0).randn(37, gr.size)
    spm_names = ("x0", "x1", "x2", "h10", "h20", "x0_prev")
    spm_err, spm_fma_err = 0.0, 0.0
    for what, sv, data in ((f"SpM nl={NL} nw={NW} B={B}", spm, gs),
                           ("SpM nl=12 nw=25 B=37", ragged, gr_b)):
        args = spm_kernel_inputs(torch, sv, data, seed=20)
        shape = (data.shape[0], sv.nl, sv.nw)
        chosen = kernels._spm_tiling(libs["fused_spm"], 0, *shape)
        fma = kernels._spm_tiling(libs["fused_spm"], 0, *shape, tensor_cores=False)
        got = kernels.fused_spm_chunk(*args, n_iters=21)
        ref = kernels.fused_spm_chunk_reference(*args, n_iters=21)
        err = compare(torch, what + ", 21 iters", spm_names, got, ref)
        got = kernels._spm_launch(args, 21, fma)
        err_fma = compare(torch, what + ", FMA kernel, 21 iters", spm_names, got, ref)
        if chosen[0] == 0:
            check_ratio(f"{what}, the wrapper chooses {chosen}", "SpM", err, err_fma)
        spm_err, spm_fma_err = max(spm_err, err), max(spm_fma_err, err_fma)

    # 3a. the basis-pursuit slice through the kernel, then through the plain version
    ys_dev = torch.as_tensor(ys, dtype=torch.float32, device="cuda")
    solve = lambda: solver.solve({(0, "y"): ys_dev}, niter=NITER, rtol=0.0)
    kernels.fused_two_block_chunk.launches = 0
    res = solve()
    torch.cuda.synchronize()
    launches = kernels.fused_two_block_chunk.launches
    if launches == 0:
        raise AssertionError("the fused solve launched no kernel")
    x_kernel = res.x0.cpu().numpy()
    worst = check_recovery(x_kernel, xtrue, "fused solve (kernel)")
    print(f"fused solve, kernel: {launches} launches, B={B}, {NITER} iters, "
          f"iterations {int(res.iterations.max())}, worst lane err/bound {worst:.4f}",
          flush=True)
    plain_chunk = mock.patch.object(fused.kernels, "fused_two_block_chunk",
                                    kernels.fused_two_block_chunk_reference)
    res_plain = plain_chunk_solve(plain_chunk, solve)
    dev = float(np.abs(x_kernel - res_plain.x0.cpu().numpy()).max())
    print(f"fused solve, kernel vs plain: max |x0 diff| {dev:.3e} (bound {SOLVE_TOL})",
          flush=True)
    if not dev <= SOLVE_TOL:
        raise AssertionError(f"kernel solve departs from plain solve by {dev}")

    # 3b. the SpM slice through the kernel, then through the plain version
    gs_dev = torch.as_tensor(gs, device="cuda")
    spm_solve = lambda: spm.solve({(0, "y"): gs_dev}, niter=SPM_NITER, mu0=SPM_MU0, rtol=0.0)
    kernels.fused_spm_chunk.launches = 0
    sres = spm_solve()
    torch.cuda.synchronize()
    spm_launches = kernels.fused_spm_chunk.launches
    if spm_launches == 0:
        raise AssertionError("the fused SpM solve launched no kernel")
    outs = [*sres.x, *sres.h, sres.mu]
    if not all(bool(torch.isfinite(t).all()) for t in outs):
        raise AssertionError("the fused SpM solve gave non-finite values")
    shapes = [tuple(t.shape) for t in outs]
    if shapes != [(B, NL), (B, NL), (B, NW), (B, NL), (B, NW), (B, 2)]:
        raise AssertionError(f"unexpected result shapes {shapes}")
    min_rho = float(sres.x[2].min())
    sum_dev = float(np.median(np.abs(sres.x[0].double().cpu().numpy() @ prj_sum - 1.0)))
    print(f"fused SpM solve, kernel: {spm_launches} launches, B={B}, {SPM_NITER} iters, "
          f"iterations {int(sres.iterations.max())}, min spectrum {min_rho:.3e}, "
          f"median |sum rule - 1| {sum_dev:.3e} (bound 1e-3)", flush=True)
    if min_rho < 0.0 or not sum_dev <= 1e-3 or int(sres.iterations.min()) != SPM_NITER:
        raise AssertionError("the fused SpM solve misses the model's properties")
    spm_plain_chunk = mock.patch.object(fused_spm.kernels, "fused_spm_chunk",
                                        kernels.fused_spm_chunk_reference)
    sres_plain = plain_chunk_solve(spm_plain_chunk, spm_solve)
    if kernels.fused_spm_chunk.launches != spm_launches:
        raise AssertionError("the plain SpM solve launched the kernel")
    for k in range(3):
        d = float((sres.x[k] - sres_plain.x[k]).abs().max())
        scale = float(sres_plain.x[k].abs().max())
        print(f"fused SpM solve, kernel vs plain: max |x{k} diff| {d:.3e} "
              f"(bound {SOLVE_TOL} * {scale:.3e})", flush=True)
        if not d <= SOLVE_TOL * scale:
            raise AssertionError(f"SpM kernel solve departs from plain solve in x{k} by {d}")
    ratio = (sres.mu / sres_plain.mu).cpu().numpy()
    print(f"fused SpM solve, kernel vs plain: mu ratio in [{ratio.min():.3f}, "
          f"{ratio.max():.3f}], final mu in [{float(sres.mu.min()):.4g}, "
          f"{float(sres.mu.max()):.4g}]", flush=True)
    if not np.all((ratio >= 0.49) & (ratio <= 2.01)):
        raise AssertionError("SpM penalties differ by more than one balancing step")

    # 4. single instances, float64, through the run program (each chunk a
    # replay of a captured graph; the solves after the first reuse it)
    opt = SimpleOptimizer(model)
    opt_run = lambda: restarted(opt, 200)
    opt_run()
    assert opt.x[0].dtype == torch.float64 and opt.x[0].is_cuda
    worst = check_recovery(opt.x[0].cpu().numpy()[None], xtrue[:1], "SimpleOptimizer")
    print(f"SimpleOptimizer f64 on cuda, 200 iters: worst err/bound {worst:.4f}", flush=True)

    sopt = SimpleOptimizer(smodel, mu=SPM_MU0)
    sopt_run = lambda: restarted(sopt, 1000, SPM_MU0)
    sopt_run()
    xs = [x.cpu().numpy() for x in sopt.x]
    sum_one = abs(float(xs[0] @ prj_sum) - 1.0)
    print(f"SimpleOptimizer f64 on cuda, SpM, 1000 iters: min spectrum {xs[2].min():.3e}, "
          f"|sum rule - 1| {sum_one:.3e} (bound 1e-6)", flush=True)
    if not (sopt.x[0].is_cuda and sopt.x[0].dtype == torch.float64
            and all(np.all(np.isfinite(x)) for x in xs) and xs[2].min() >= 0.0
            and sum_one <= 1e-6):
        raise AssertionError("SimpleOptimizer on the SpM model misses its properties")
    for what, run, niter, o in (("SimpleOptimizer f64 bench solve (1 instance, 200 iters)",
                                 opt_run, 200, opt),
                                ("SimpleOptimizer f64 SpM solve (1 instance, 1000 iters)",
                                 sopt_run, 1000, sopt)):
        captured_vs_eager(torch, card, what, run, niter, [o], state=single_state)
        if "--profile" in sys.argv:
            profile_both(torch, what, run, niter, kernel_name="gemv")

    # 5a. the batched engine in float64 at full width, as bench.py runs it
    batched = BatchedSolver(model)
    assert batched.device.type == "cuda" and batched.dtype == torch.float64
    ys64 = torch.as_tensor(ys, dtype=torch.float64, device="cuda")
    bsolve = lambda **kw: batched.solve({(0, "y"): ys64}, niter=BATCH_NITER,
                                        record_residuals=False, **kw)
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bres = bsolve(rtol=0.0)
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - before) / 1e6
    if not (bres.x[0].is_cuda and bres.x[0].dtype == torch.float64
            and tuple(bres.x[0].shape) == (B, N)):
        raise AssertionError("BatchedSolver gave another state than (B, N) float64 on cuda")
    worst = check_recovery(bres.x[0].cpu().numpy(), xtrue, "BatchedSolver f64")
    if not bool((bres.iterations == BATCH_NITER).all()):
        raise AssertionError("BatchedSolver lanes did not all run every iteration")
    print(f"BatchedSolver f64 on cuda: B={B}, {BATCH_NITER} iters, worst lane err/bound "
          f"{worst:.4f}, peak device memory of the solve {peak_mb:.0f} MB", flush=True)

    # 5b. lanes of the batch against single-instance solves on the card
    bres8 = bsolve(rtol=1e-8)
    for lane in range(4):
        single = SimpleOptimizer(Model(
            [LeastSquares(1.0, A, ys[lane]), L1Regularizer(ALPHA, N)],
            [(1, 0, identity(N), identity(N))]))
        single.solve(BATCH_NITER, rtol=1e-8)
        d = float((bres8.x[0][lane] - single.x[0]).abs().max())
        print(f"BatchedSolver lane {lane} vs SimpleOptimizer: max |x0 diff| {d:.3e} (bound "
              f"1e-9), iterations {int(bres8.iterations[lane])} / {single.iterations}",
              flush=True)
        if not d <= 1e-9 or int(bres8.iterations[lane]) != single.iterations:
            raise AssertionError(f"lane {lane} of the batch departs from its single solve")

    # 5c. the SpM mixed-precision solve: kernel phase in f32, polish in f64
    mixed_solve = lambda: spm.solve_mixed({(0, "y"): gs_dev}, niter_low=SPM_NITER,
                                          niter=POLISH_NITER, mu0=SPM_MU0, rtol=0.0,
                                          record_residuals=False)
    kernels.fused_spm_chunk.launches = 0
    mres = mixed_solve()
    torch.cuda.synchronize()
    mixed_launches = kernels.fused_spm_chunk.launches
    if mixed_launches == 0:
        raise AssertionError("solve_mixed's float32 phase launched no kernel")
    mouts = [*mres.x, *mres.h, mres.mu]
    if not all(t.dtype == torch.float64 and t.is_cuda and bool(torch.isfinite(t).all())
               for t in mouts):
        raise AssertionError("solve_mixed gave values that are not finite float64 on cuda")
    m_min_rho = float(mres.x[2].min())
    m_sum_dev = float(np.median(np.abs(mres.x[0].cpu().numpy() @ prj_sum - 1.0)))
    print(f"SpM solve_mixed: {mixed_launches} kernel launches in the f32 phase, B={B}, "
          f"{SPM_NITER} + {POLISH_NITER} iters, iterations "
          f"{int(mres.iterations.min())}..{int(mres.iterations.max())}, min spectrum "
          f"{m_min_rho:.3e}, median |sum rule - 1| {m_sum_dev:.3e} (bound 1e-6)", flush=True)
    if m_min_rho < 0.0 or not m_sum_dev <= 1e-6:
        raise AssertionError("solve_mixed misses the model's properties")

    # 6. times: kernel and plain version in turns on one card, after a warm-up
    args = kernel_inputs(torch, solver, "l1", seed=99)
    chunk = dict(n_iters=100, prox="l1", thin=True)
    run_kernel = lambda: kernels.fused_two_block_chunk(*args, **chunk)
    run_plain = lambda: kernels.fused_two_block_chunk_reference(*args, **chunk)
    ms, plain_ms = median_ms(torch, [run_kernel, run_plain])
    tiling = kernels._two_block_tiling(N, M, smem_limit)
    flops = 100 * B * (4 * N * M + 10 * N)
    gemm_flops, other_flops = 100 * B * 4 * N * M, 100 * B * 10 * N
    fma_bound, _ = bound_ms(flops / PEAK_F32_FLOPS, args + run_kernel())
    if tiling.tensor_cores:
        # Split TF32 does every product three times, at the tensor cores' rate.
        bound, bound_by = bound_ms(3 * gemm_flops / PEAK_TF32_FLOPS
                                   + other_flops / PEAK_F32_FLOPS, args + run_kernel())
    else:
        bound, bound_by = fma_bound, "operations"
    t_kernel, t_plain = median_wall(torch, [solve, lambda: plain_chunk_solve(plain_chunk, solve)])
    (t_opt,) = median_wall(torch, [opt_run])
    print(f"[{card}] one chunk (B={B}, N={N}, R={M}, 100 iters, l1, thin), tiling "
          f"{tuple(tiling)}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bound:.3f} ms "
          f"({bound_by}; as f32 FMA {fma_bound:.3f} ms)")
    print(f"[{card}] fused solve (B={B}, {NITER} iters): kernel {t_kernel * 1e3:.1f} ms = "
          f"{B * NITER / t_kernel:.0f} inst-iters/s, plain {t_plain * 1e3:.1f} ms = "
          f"{B * NITER / t_plain:.0f} inst-iters/s")
    captured_vs_eager(torch, card, f"basis-pursuit fused solve (B={B}, {NITER} iters)", solve,
                      NITER, [solver], kernel=kernels.fused_two_block_chunk)
    print(f"[{card}] SimpleOptimizer f64 solve (1 instance, 200 iters): "
          f"{t_opt * 1e3:.1f} ms")

    sargs = spm_kernel_inputs(torch, spm, gs, seed=98)
    run_spm = lambda: kernels.fused_spm_chunk(*sargs, n_iters=100)
    run_spm_plain = lambda: kernels.fused_spm_chunk_reference(*sargs, n_iters=100)
    mu = sargs[3]
    ones = torch.ones(B, dtype=torch.float32, device="cuda")
    acy = gs_dev @ spm.Ac.T
    run_factors = lambda: spm._factors(mu[:, 0], mu[:, 1], ones, acy)
    spm_fma = kernels._spm_tiling(libs["fused_spm"], 0, B, NL, NW, tensor_cores=False)
    run_spm_fma = lambda: kernels._spm_launch(sargs, 100, spm_fma)   # the design it replaced
    spm_ms, spm_plain_ms, factors_ms, spm_prev_ms = median_ms(
        torch, [run_spm, run_spm_plain, run_factors, run_spm_fma])
    spm_ops = 100 * B * (4 * NL * NW + 2 * NL * NL + 10 * (NL + NW))
    spm_tiling = kernels._spm_tiling(libs["fused_spm"], 0, B, NL, NW)
    spm_fma_bound, _ = bound_ms(spm_ops / PEAK_F32_FLOPS, sargs + run_spm())
    if spm_tiling[0] == 0:
        # The two products with P in split TF32 on the tensor cores, the rest f32 FMA.
        p_flops = 100 * B * 4 * NL * NW
        spm_bound, spm_bound_by = bound_ms(3 * p_flops / PEAK_TF32_FLOPS
                                           + (spm_ops - p_flops) / PEAK_F32_FLOPS,
                                           sargs + run_spm())
    else:
        spm_bound, spm_bound_by = spm_fma_bound, "operations"
    ts_kernel, ts_plain = median_wall(
        torch, [spm_solve, lambda: plain_chunk_solve(spm_plain_chunk, spm_solve)])
    (ts_opt,) = median_wall(torch, [sopt_run])
    print(f"[{card}] one SpM chunk (B={B}, nl={NL}, nw={NW}, 100 iters): kernel "
          f"{spm_ms:.3f} ms = {spm_ops / spm_ms / 1e9:.2f} TFLOP/s (the FMA kernel it replaced, "
          f"tiling {spm_fma}: {spm_prev_ms:.3f} ms), plain {spm_plain_ms:.3f} ms, bound {spm_bound:.3f} ms "
          f"({spm_bound_by}; as f32 FMA {spm_fma_bound:.3f} ms)")
    print(f"[{card}] one SpM factor refresh (B={B}, nl={NL}): {factors_ms:.3f} ms")
    print(f"[{card}] fused SpM solve (B={B}, {SPM_NITER} iters): kernel "
          f"{ts_kernel * 1e3:.1f} ms = {B * SPM_NITER / ts_kernel:.0f} inst-iters/s, plain "
          f"{ts_plain * 1e3:.1f} ms = {B * SPM_NITER / ts_plain:.0f} inst-iters/s")
    captured_vs_eager(torch, card, f"fused SpM solve (B={B}, {SPM_NITER} iters)", spm_solve,
                      SPM_NITER, [spm], kernel=kernels.fused_spm_chunk)
    print(f"[{card}] SimpleOptimizer f64 SpM solve (1 instance, 1000 iters): "
          f"{ts_opt * 1e3:.1f} ms")

    # the batched engine: the solve, and its two products alone as the ceiling
    t_b64, t_b64_sync, t_b32 = median_wall(torch, [
        lambda: bsolve(rtol=0.0), lambda: bsolve(rtol=0.0, atol=1e-300),
        lambda: bsolve(rtol=0.0, dtype=torch.float32)])
    print(f"[{card}] BatchedSolver f64 solve (B={B}, {BATCH_NITER} iters): "
          f"{t_b64 * 1e3:.1f} ms = {B * BATCH_NITER / t_b64:.0f} inst-iters/s; with the done "
          f"flags read once per chunk (atol=1e-300): {t_b64_sync * 1e3:.1f} ms; in f32: "
          f"{t_b32 * 1e3:.1f} ms = {B * BATCH_NITER / t_b32:.0f} inst-iters/s")
    captured_vs_eager(torch, card, f"BatchedSolver f64 solve (B={B}, {BATCH_NITER} iters)",
                      lambda: bsolve(rtol=0.0), BATCH_NITER, [batched])
    for dt in (torch.float64, torch.float32):
        rng = np.random.RandomState(1)
        xg, u1, u2 = (torch.as_tensor(rng.randn(*shape) / np.sqrt(shape[0] if i else N),
                                      dtype=dt, device="cuda")
                      for i, shape in enumerate(((B, N), (N, M), (M, N))))

        def chain(xg=xg, u1=u1, u2=u2):
            c = xg
            for _ in range(50):
                c = (c @ u1) @ u2
            return c

        (pair_ms,) = median_ms(torch, [chain])
        print(f"[{card}] the solve's two products alone, (B,N)@(N,R) and (B,R)@(R,N) as "
              f"{str(dt).split('.')[-1]} torch.matmul chained 50 times: {pair_ms:.3f} ms = "
              f"{50 * 4e-9 * B * N * M / pair_ms:.1f} TFLOP/s, so {BATCH_NITER} iterations' "
              f"products take {BATCH_NITER / 50 * pair_ms:.1f} ms")
    # solve_mixed's float32 phase: the SpM program where lanes can finish (atol)
    low_solve = lambda: spm.solve({(0, "y"): gs_dev}, niter=SPM_NITER, mu0=SPM_MU0, rtol=0.0,
                                  atol=1e-5)
    p1 = low_solve()
    p1_state = dict(x0=[a.double() for a in p1.x], h0=[a.double() for a in p1.h],
                    mu0=p1.mu.double())
    polish = lambda: spm._polish_solver.solve({(0, "y"): gs_dev}, niter=POLISH_NITER, rtol=0.0,
                                              record_residuals=False, **p1_state)
    tm_all, tm_low, tm_polish = median_wall(torch, [
        mixed_solve,
        low_solve,
        polish])
    print(f"[{card}] SpM solve_mixed (B={B}, {SPM_NITER} f32 + {POLISH_NITER} f64 iters): "
          f"{tm_all * 1e3:.1f} ms; its f32 kernel phase alone {tm_low * 1e3:.1f} ms "
          f"(iterations {int(p1.iterations.min())}..{int(p1.iterations.max())}), its f64 "
          f"polish alone {tm_polish * 1e3:.1f} ms = {B * POLISH_NITER / tm_polish:.0f} "
          "inst-iters/s")
    captured_vs_eager(torch, card, f"SpM solve_mixed's f32 phase (B={B}, {SPM_NITER} iters, "
                      "atol 1e-5)", low_solve, SPM_NITER, [spm], kernel=kernels.fused_spm_chunk)
    captured_vs_eager(torch, card, f"SpM solve_mixed's f64 polish (B={B}, {POLISH_NITER} iters)",
                      polish, POLISH_NITER, [spm._polish_solver])

    # 7. the stream drivers and complex problems through the real embedding
    sched = phase_scheduler(torch, card, again="--profile" in sys.argv)
    phase_resumable(torch, card, A, ys)
    complex_spm = phase_complex_spm(torch, card)
    realified = phase_complex_bp(torch, card, kernels, fused, plain_chunk, solve)

    # 8. the added model families at full width, float64
    cov = phase_cov_denoise(torch, card, variants="--variants" in sys.argv)
    fam = {"cov": cov, "sdp": phase_sdp(torch, card), "rpca": phase_rpca(torch, card)}
    phase_group_lasso(torch, card)
    phase_huber(torch, card)
    phase_tv(torch, card)

    if "--variants" in sys.argv:
        T = kernels.TwoBlockTiling
        sweep = [tiling, T(32, 32, 3, 1, 1), T(32, 32, 2, 2, 1), T(32, 16, 6, 2, 1),
                 T(32, 16, 4, 2, 1), T(32, 32, 3, 4, 1),
                 T(32, 32, 2, 2, 0), T(32, 32, 2, 1, 0), T(32, 32, 2, 4, 0),
                 T(16, 16, 4, 1, 0), T(16, 16, 4, 2, 0), T(8, 16, 4, 1, 0)]
        times = median_ms(torch, [lambda t=t: kernels._two_block_launch(args, 100, "l1", True, t)
                                  for t in sweep])
        print(f"[{card}] two-block chunk tilings (lanes per block, k-tile rows, stages, "
              f"cluster, tensor cores), 100 iters; the wrapper chooses {tuple(tiling)}:")
        for t, t_ms in zip(sweep, times):
            print(f"  {tuple(t)}: {t_ms:.3f} ms")
        gemms = lambda: ((args[3] @ args[0]) @ args[1])
        (gemm_ms,) = median_ms(torch, [gemms])
        print(f"[{card}] the chunk's two products alone as f32 torch.matmul, 100 times: "
              f"{100 * gemm_ms:.3f} ms = {4e-9 * B * N * M / gemm_ms:.1f} TFLOP/s "
              f"(allow_tf32 {torch.backends.cuda.matmul.allow_tf32})")
        print(f"[{card}] L2 read rate, one block per multiprocessor reading one buffer 50 "
              "times (all from the same offset / each from another):")
        rates = {}
        for nbytes in (8 * N * M, 16 << 20):
            rates[nbytes] = [l2_read_rate(torch, libs["fused_two_block"], nbytes, r)
                             for r in (0, 1)]
            print(f"  {nbytes / 2**20:.0f} MiB: {rates[nbytes][0] / 1e12:.3f} / "
                  f"{rates[nbytes][1] / 1e12:.3f} TB/s")
        passes = -(-B // tiling.lanes) // tiling.cluster
        print(f"  the chunk reads U and Ut ({8 * N * M / 2**20:.0f} MiB) {passes} times per "
              f"iteration = {100 * passes * 8 * N * M / 1e9:.2f} GB per chunk = "
              f"{100 * passes * 8 * N * M / rates[8 * N * M][0] * 1e3:.3f} ms at the first rate")
        chosen = kernels._spm_tiling(libs["fused_spm"], 0, B, NL, NW)
        print(f"[{card}] SpM chunk tilings (lanes per warp, warps per block), 100 iters; "
              f"the wrapper chooses {chosen}:")
        for other in ((0, 8), (4, 8), (4, 4), (2, 16), (2, 12), (2, 8), (1, 16), (1, 8)):
            (t_ms,) = median_ms(torch, [lambda: kernels._spm_launch(sargs, 100, other)])
            print(f"  {other}: {t_ms:.3f} ms")
        from admmsolver_tpu_torch.models.objectivefunc import inv_hpd
        pen = (spm.AcA + mu[:, :1, None] * torch.eye(NL, device="cuda")
               + mu[:, 1:, None] * spm.W).contiguous()
        routes = {"inv_hpd (Cholesky + triangular solve, the port's)": lambda: inv_hpd(pen),
                  "cholesky + cholesky_inverse": lambda: torch.cholesky_inverse(
                      torch.linalg.cholesky(pen)),
                  "linalg.inv (LU)": lambda: torch.linalg.inv(pen)}
        print(f"[{card}] inverse of the {B} penalty matrices ({NL}x{NL}, f32):")
        for (name, _), t_ms in zip(routes.items(), median_ms(torch, list(routes.values()))):
            print(f"  {name}: {t_ms:.3f} ms")
    if "--profile" in sys.argv:
        profile_both(torch, "basis-pursuit solve", solve, NITER, kernel_name="fused_two_block")
        profile_both(torch, "SpM solve", spm_solve, SPM_NITER, kernel_name="fused_spm")
        profile_both(torch, "SpM solve_mixed f32 phase", low_solve, SPM_NITER,
                     kernel_name="fused_spm")
        profile_both(torch, "BatchedSolver f64 solve", lambda: bsolve(rtol=0.0), BATCH_NITER)
        profile_solve(torch, "BatchedSolver f32 solve", "gemm",
                      lambda: bsolve(rtol=0.0, dtype=torch.float32), iters=BATCH_NITER)
        profile_both(torch, "SpM solve_mixed f64 polish", polish, POLISH_NITER)
        from admmsolver_tpu_torch.parallel import ScenarioScheduler
        one_wave = ScenarioScheduler(sched["solver"], batch_size=SCHED_B, chunk_iters=SCHED_CHUNK,
                                     niter_max=SCHED_CHUNK, rtol=0.0, atol=SCHED_ATOL)
        for mode in ("run", "run_compiled"):
            profile_both(torch, f"scheduler {mode}, one wave of {SCHED_CHUNK} iterations",
                         lambda mode=mode: getattr(one_wave, mode)(iter(sched["scenarios"])),
                         SCHED_CHUNK)
        profile_both(torch, "realified complex SpM solve", complex_spm["solve"], CSPM_NITER)
        profile_both(torch, "realified complex basis-pursuit fused solve", realified["solve"],
                     NITER, kernel_name="fused_two_block")

    # No single PyTorch call computes either chunk, so there is no library time.
    # prev_ms is the replaced design's time where this run still builds and
    # times it (the SpM FMA kernel); the two-block kernel's is no longer built.
    return fam, {"kernels": [
        {"name": "fused_two_block_chunk", "route": "cuda",
         "source": "admmsolver_tpu_torch/csrc/fused_two_block.cu",
         "replaces": "admmsolver_tpu/ops/kernels.py:119",
         "launches": launches, "launches_realified": realified["launches"],
         "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
         "fma_bound_ms": fma_bound,
         "fma_max_abs_err": max(fma_err.values())},
        {"name": "fused_spm_chunk", "route": "cuda",
         "source": "admmsolver_tpu_torch/csrc/fused_spm.cu",
         "replaces": "admmsolver_tpu/ops/kernels.py:271",
         "launches": spm_launches, "launches_solve_mixed": mixed_launches,
         "max_abs_err": spm_err, "ms": spm_ms,
         "plain_ms": spm_plain_ms, "bound_ms": spm_bound, "bound_by": spm_bound_by,
         "library_ms": None, "prev_ms": spm_prev_ms, "fma_bound_ms": spm_fma_bound,
         "fma_max_abs_err": spm_fma_err}]}


# 9. multi-device on the one card: world size 1 through NCCL, two ranks through gloo
def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def bp_model(A, y, alpha=ALPHA):
    from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, identity

    n = A.shape[1]
    return Model([LeastSquares(1.0, A, y), L1Regularizer(alpha, n)],
                 [(1, 0, identity(n), identity(n))])


def planted_wide(torch, M, N, K, seed, device):
    """A (M, N) standard normal and a K-sparse planted x* with standard normal
    entries, y = A x*: made on the device from a seeded generator, so that
    no host copy of A exists and every process makes the same."""
    g = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(M, N, generator=g, device=device, dtype=torch.float64)
    xt = torch.zeros(N, dtype=torch.float64, device=device)
    xt[torch.randperm(N, generator=g, device=device)[:K]] = torch.randn(
        K, generator=g, device=device, dtype=torch.float64)
    return A, xt, A @ xt


def same_tensors(torch, got, want):
    return all(torch.equal(a, b) for a, b in zip(got, want))


def state_of(res):
    """x, h, mu, iterations and flags of a ``BatchResult``, and of the fused
    solvers' results with their residual histories."""
    if hasattr(res, "x0"):   # FusedResult
        return (res.x0, res.x1, res.h, res.mu, res.iterations, res.converged,
                res.primal_residual, res.dual_residual)
    out = tuple(res.x) + tuple(res.h) + (res.mu, res.iterations, res.converged)
    if not hasattr(res, "lane_index"):   # FusedSpMResult
        out += (res.primal_residual, res.dual_residual)
    return out


def lanes_close(what, got_x, got_it, want_x, want_it, tol):
    """Host arrays: x of each block within tol * max|x|, equal iteration
    counts."""
    scale = max(float(np.abs(w).max()) for w in want_x)
    err = max(float(np.abs(g - w).max()) for g, w in zip(got_x, want_x))
    same_it = np.array_equal(got_it, want_it)
    print(f"{what}: max |x diff| {err:.3e} (bound {tol:g} * {scale:.3e}), iteration counts "
          f"{'equal' if same_it else 'DIFFER'}", flush=True)
    if not (err <= tol * scale and same_it):
        raise AssertionError(f"{what}: departs from its reference")


def large_n_small(torch, mesh, device, m=LNS_M, n=LNS_N, k=LNS_K):
    """The second large-N gate's problem, its solver on ``mesh`` and a
    solve of it (a function that solves again)."""
    from admmsolver_tpu_torch.parallel import LargeNTwoBlockSolver

    A, xt, y = planted_wide(torch, m, n, k, LNS_SEED, device)
    sol = LargeNTwoBlockSolver(A, mesh, prox="l1", alpha1=ALPHA)
    solve = lambda: sol.solve(y, niter=LNS_NITER, rtol=0.0)
    return A, y, solve(), sol, solve


def time_all_reduce(torch, mesh, n, calls=50):
    """Host-clock ms of one sum over the mesh of an (n,) float64 tensor, ending
    in a device synchronize, over ``calls`` calls after a warm-up."""
    t = torch.ones(n, dtype=torch.float64, device=mesh.device)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" else (lambda: None)
    for _ in range(5):
        mesh.all_reduce(t)
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        mesh.all_reduce(t)
    sync()
    return 1e3 * (time.perf_counter() - t0) / calls


def phase_world_one(torch, card, device="cuda", backend="nccl", nb=B, ops_b=OPS_B,
                    ln=(LN_M, LN_N, LN_K), profile=False, variants=False):
    """9a. A process group of one rank through NCCL (a TCP store on localhost,
    destroyed at the end): the sharded BatchedSolver on the bench problem
    bitwise the unsharded solve, per-instance operators sharded, the
    sharded Gram of the tall Ac at full width, LargeNTwoBlockSolver at full
    width recovering its planted signal, and at M=256, N=65536 equal to
    SimpleOptimizer; times beside the card's name and power limit."""
    import datetime

    import torch.distributed as dist

    from admmsolver_tpu_torch import SimpleOptimizer
    from admmsolver_tpu_torch.parallel import (BatchedSolver, LargeNTwoBlockSolver,
                                               batch_sharding, make_mesh, sharded_gram)

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(1, devices=device)
        if mesh.group is None or mesh.world_size != 1:
            raise AssertionError("the mesh has no process group")
        shard = batch_sharding(mesh)
        out = {}

        # the bench problem: rtol 0 as bench.py runs it, then rtol 1e-8 (the
        # exit predicate's all_reduce runs); both bitwise the unsharded solve
        A, ys, _ = bench_problem(nb=nb)
        model = bp_model(A, ys[0])
        ov = {(0, "y"): ys}
        for rtol, niter in ((0.0, BATCH_NITER), (RANKS_RTOL, RANKS_NITER)):
            kw = dict(niter=niter, rtol=rtol, record_residuals=False)
            plain = BatchedSolver(model, device=device).solve(ov, **kw)
            sharded = BatchedSolver(model, sharding=shard).solve(ov, **kw)
            same = same_tensors(torch, state_of(sharded), state_of(plain))
            its = sharded.iterations
            print(f"sharded BatchedSolver, world size 1 ({backend}): bench problem B={nb}, "
                  f"{niter} iters, rtol {rtol:g}: {'bitwise equal' if same else 'DIFFERS'} to "
                  f"the unsharded solve; iterations {int(its.min())}..{int(its.max())}",
                  flush=True)
            if not same or not torch.equal(sharded.lane_index.cpu(), torch.arange(nb)):
                raise AssertionError("the world-size-1 sharded solve departs from the unsharded")
        out["bench"] = plain   # the rtol 1e-8 solve: the two ranks' reference

        # per-instance operators, sharded
        rng = np.random.RandomState(3)
        As, ys_ops = rng.randn(ops_b, OPS_M, OPS_N), rng.randn(ops_b, OPS_M)
        res = BatchedSolver(bp_model(As[0], ys_ops[0]), sharding=shard).solve(
            {(0, "A"): As, (0, "y"): ys_ops}, niter=OPS_NITER, rtol=0.0, record_residuals=False)
        for lane in (0, ops_b // 2, ops_b - 1):
            o = SimpleOptimizer(bp_model(As[lane], ys_ops[lane]), device=device)
            o.solve(OPS_NITER, rtol=0.0)
            d, scale = float((res.x[0][lane] - o.x[0]).abs().max()), float(o.x[0].abs().max())
            print(f"sharded per-instance operators ({ops_b} lanes of A {OPS_M}x{OPS_N}), lane "
                  f"{lane} vs SimpleOptimizer: max |x0 diff| {d:.3e} (bound 1e-9 * {scale:.3e})",
                  flush=True)
            if not d <= 1e-9 * scale:
                raise AssertionError(f"lane {lane} of the per-instance batch departs")
        del res, As
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()

        # full width: the sharded Gram of the tall Ac = A^T, then the large-N solve
        M_, N_, K_ = ln
        t0 = time.perf_counter()
        A, xt, y = planted_wide(torch, M_, N_, K_, LN_SEED, device)
        sync()
        print(f"large-N data on the {device}: A {M_}x{N_} float64 "
              f"({A.numel() * 8 / 2**30:.2f} GiB), {K_}-sparse x*, made in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        Ac = A.T
        v = torch.ones(N_, dtype=torch.float64, device=device)
        G, r = sharded_gram(Ac, v, mesh)
        G_ref, r_ref = torch.matmul(Ac.T, Ac), torch.matmul(Ac.T, v)
        gerr = max(float((G - G_ref).abs().max() / G_ref.abs().max()),
                   float((r - r_ref).abs().max() / r_ref.abs().max()))
        print(f"sharded_gram of the tall Ac ({N_}x{M_}): max relative difference to "
              f"torch.matmul {gerr:.3e} (bound 1e-12)", flush=True)
        if not gerr <= 1e-12:
            raise AssertionError("sharded_gram departs from torch.matmul")
        del G_ref, r_ref
        t0 = time.perf_counter()
        sol = LargeNTwoBlockSolver(A, mesh, prox="l1", alpha1=ALPHA)
        sync()
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        lres = sol.solve(y, niter=LN_NITER, mu0=LN_MU0, rtol=LN_RTOL)
        sync()
        t_solve = time.perf_counter() - t0
        graphs = "captured chunks" if sol.captures else "chunks without graphs"
        err = float((lres.x1 - xt).abs().max())
        scale = float(xt.abs().max())
        print(f"LargeNTwoBlockSolver M={M_} N={N_} (R={sol.lam.numel()}, l1, alpha1 {ALPHA}, "
              f"mu0 {LN_MU0}, rtol {LN_RTOL:g}, budget {LN_NITER}): {lres.iterations} "
              f"iterations, converged {lres.converged}, final mu {float(lres.mu):g}; "
              f"max |x1 - x*| {err:.3e} (bound 1e-2 * {scale:.3e}); basis built in "
              f"{t_build:.2f} s", flush=True)
        if not err <= 1e-2 * scale:
            raise AssertionError("the large-N solve misses its planted signal")
        if cuda:
            peak = torch.cuda.max_memory_allocated() - before
            w = torch.ones(sol.lam.numel(), dtype=torch.float64, device=device)
            gram_ms, gemv_t_ms, gemv_ms = median_ms(torch, [
                lambda: sharded_gram(Ac, v, mesh), lambda: sol.U.T @ v, lambda: sol.U @ w])
            u_bytes = sol.U.numel() * sol.U.element_size()
            it_ms = 1e3 * t_solve / lres.iterations
            ln_bound = 1e3 * 2 * u_bytes / PEAK_BYTES_PER_S
            gram_flops = 2 * N_ * M_ * M_ + 2 * N_ * M_
            gram_bound = 1e3 * max(gram_flops / PEAK_F64_TC_FLOPS,
                                   (A.numel() + N_ + M_ * M_ + M_) * 8 / PEAK_BYTES_PER_S)
            nccl_ms = [time_all_reduce(torch, mesh, n) for n in (5, sol.lam.numel())]
            print(f"[{card}] LargeN solve ({graphs}): {it_ms:.3f} ms per iteration "
                  f"({lres.iterations} iterations in {t_solve:.3f} s); bound {ln_bound:.3f} ms (U, "
                  f"{u_bytes / 2**30:.2f} GiB, read twice over {PEAK_BYTES_PER_S / 1e12:.2f} "
                  f"TB/s); its two GEMVs alone as torch.matmul {gemv_t_ms:.3f} + {gemv_ms:.3f} "
                  f"= {gemv_t_ms + gemv_ms:.3f} ms", flush=True)
            print(f"[{card}] sharded_gram ({N_}x{M_} f64, {gram_flops / 1e12:.3f} TFLOP): "
                  f"{gram_ms:.3f} ms against its bound {gram_bound:.3f} ms (operations at "
                  f"{PEAK_F64_TC_FLOPS / 1e12:.0f} TFLOP/s f64 on the tensor cores)", flush=True)
            print(f"[{card}] all_reduce, 1 rank through NCCL: {nccl_ms[0]:.4f} ms for 5 "
                  f"float64, {nccl_ms[1]:.4f} ms for {sol.lam.numel()}", flush=True)
            print(f"[{card}] peak device memory of the full-width part: "
                  f"{peak / 2**30:.2f} GiB (A {A.numel() * 8 / 2**30:.2f} GiB, U "
                  f"{u_bytes / 2**30:.2f} GiB)", flush=True)
            # captured against graph-less on a shorter budget, after one solve
            # that captures its chunks
            turn = lambda: sol.solve(y, niter=LN_TURN_NITER, mu0=LN_MU0, rtol=0.0)
            turn()
            captured_vs_eager(torch, card, f"LargeN M={M_} N={N_}, {LN_TURN_NITER} iters",
                              turn, LN_TURN_NITER, [sol], state=large_n_state)
            if profile:
                profile_both(torch, "LargeN solve, 20 iterations",
                             lambda: sol.solve(y, niter=20, rtol=0.0), 20, kernel_name="gemv")
        if variants:
            # the recovery against the budget: what sets LN_NITER
            for mu0, n in [(m, 1000) for m in (1.0, 3.0, 10.0, 30.0, 100.0)] + [
                    (LN_MU0, 2500), (LN_MU0, 5000)]:
                r = sol.solve(y, niter=n, mu0=mu0, rtol=0.0)
                print(f"LargeN recovery after {n} iterations at mu0 {mu0:g}: max |x1 - x*| / "
                      f"max|x*| {float((r.x1 - xt).abs().max()) / scale:.3e}, final mu "
                      f"{float(r.mu):g}", flush=True)
        del A, Ac, sol, lres, G, r, v, xt, y
        if cuda:
            torch.cuda.empty_cache()

        # the second gate: M=256, N=65536 against SimpleOptimizer on the card,
        # and its captured chunks against graph-less
        A, y, sres, sol, ln_solve = large_n_small(torch, mesh, device)
        if cuda:
            captured_vs_eager(torch, card, f"LargeN M={LNS_M} N={LNS_N}, {LNS_NITER} iters",
                              ln_solve, LNS_NITER, [sol], state=large_n_state)
        o = SimpleOptimizer(bp_model(A, y), device=device)
        o.solve(LNS_NITER, rtol=0.0)
        d, scale = float((sres.x0 - o.x[0]).abs().max()), float(o.x[0].abs().max())
        print(f"LargeNTwoBlockSolver M={LNS_M} N={LNS_N} vs SimpleOptimizer: max |x0 diff| "
              f"{d:.3e} (bound 1e-9 * {scale:.3e}), iterations {sres.iterations} / "
              f"{o.iterations}", flush=True)
        if not (d <= 1e-9 * scale and sres.iterations == o.iterations):
            raise AssertionError("the large-N solve departs from SimpleOptimizer")
        out["large_n_small"] = sres
        return out
    finally:
        dist.destroy_process_group()


def phase_two_ranks(torch, card, world_one, device="cuda", nb=B):
    """9b. Two ranks on the one card through gloo (NCCL refuses two ranks on
    one GPU), each a process running this script with ``--rank-of-two``: the
    bench problem at rtol 1e-8 sharded over them (each rank's lanes bitwise
    a one-process solve of the same lanes, and within 1e-10 of the unsharded
    solve), the large-N solve at M=256, N=65536 against world size 1, and a
    scattered checkpoint reassembled from the two ranks' shards."""
    import os
    import tempfile

    from admmsolver_tpu_torch.utils.checkpoint import load_batch_result_scattered

    full, small = world_one["bench"], world_one["large_n_small"]
    with tempfile.TemporaryDirectory() as tmp:
        port = str(free_port())
        procs = [subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank-of-two", str(r), port, tmp,
             device, str(nb)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=RANKS_TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            raise AssertionError(f"the two ranks outlived {RANKS_TIMEOUT} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, log in enumerate(logs):
            for line in log.splitlines():
                print(f"  rank {r}: {line}", flush=True)
        if [p.returncode for p in procs] != [0, 0]:
            raise AssertionError(f"the two ranks exited {[p.returncode for p in procs]}")
        outs = [dict(np.load(os.path.join(tmp, f"rank{r}.npz"))) for r in range(2)]
        back = load_batch_result_scattered(
            [os.path.join(tmp, f"ckpt_p{r}.npz") for r in (1, 0)], device=device)
    host = lambda t: t.cpu().numpy()
    full_x, full_it = [host(a) for a in full.x], host(full.iterations)
    for r, o in enumerate(outs):
        if not o["bitwise"]:
            raise AssertionError(f"rank {r}'s lanes differ from a one-process solve of them")
        lanes = o["lanes"]
        lanes_close(f"rank {r} of 2 (lanes {lanes[0]}..{lanes[-1]}), bitwise its one-process "
                    "solve, vs the unsharded solve", (o["x0"], o["x1"]), o["it"],
                    [a[lanes] for a in full_x], full_it[lanes], 1e-10)
    lanes_close("scattered checkpoint of the two ranks, reassembled, vs the unsharded solve",
                [host(a) for a in back.x], host(back.iterations), full_x, full_it, 1e-10)
    if not np.array_equal(host(back.x[0]), np.concatenate([o["x0"] for o in outs])):
        raise AssertionError("the reassembled checkpoint differs from the ranks' lanes")
    ln = outs[0]
    d = max(float(np.abs(ln["ln_x0"] - host(small.x0)).max()),
            float(np.abs(ln["ln_x1"] - host(small.x1)).max()))
    scale = float(np.abs(host(small.x0)).max())
    graphs = "captured chunks" if bool(ln["ln_captures"]) else \
        "chunks without graphs: gloo's collectives run on the host"
    print(f"LargeNTwoBlockSolver M={LNS_M} N={LNS_N} on 2 ranks ({graphs}) vs world size 1: "
          f"max |x diff| {d:.3e} (bound 1e-9 * {scale:.3e}), iterations {int(ln['ln_it'])} / "
          f"{small.iterations}", flush=True)
    if not (d <= 1e-9 * scale and int(ln["ln_it"]) == small.iterations):
        raise AssertionError("the two-rank large-N solve departs from world size 1")
    if device == "cuda":
        print(f"[{card}] all_reduce, 2 ranks on one card through gloo: "
              f"{float(ln['gloo_ms'][0]):.4f} ms for 5 float64, {float(ln['gloo_ms'][1]):.4f} "
              f"ms for {int(ln['gloo_n'])}", flush=True)


def rank_of_two(rank, port, outdir, device, nb):
    """One of 9b's two ranks (``chip_smoke.py --rank-of-two rank port outdir
    device B``): writes rank<r>.npz and its checkpoint shard into outdir."""
    import os

    import torch
    import torch.distributed as dist

    from admmsolver_tpu_torch.parallel import (BatchedSolver, batch_sharding, init_distributed,
                                               make_mesh, process_allgather)
    from admmsolver_tpu_torch.utils.checkpoint import save_batch_result_local

    if device == "cuda":
        torch.cuda.set_device(0)
        device = "cuda:0"
    init_distributed(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        mesh = make_mesh(2, devices=device)
        A, ys, _ = bench_problem(nb=nb)
        model = bp_model(A, ys[0])
        kw = dict(niter=RANKS_NITER, rtol=RANKS_RTOL, record_residuals=False)
        t0 = time.perf_counter()
        res = BatchedSolver(model, sharding=batch_sharding(mesh)).solve({(0, "y"): ys}, **kw)
        t_solve = time.perf_counter() - t0
        lanes = res.lane_index.cpu().numpy()
        one = BatchedSolver(model, device=device).solve({(0, "y"): ys[lanes]}, **kw)
        bitwise = same_tensors(torch, state_of(res), state_of(one))
        its = res.iterations
        print(f"lanes {lanes[0]}..{lanes[-1]}: iterations {int(its.min())}..{int(its.max())}, "
              f"{'bitwise equal' if bitwise else 'DIFFERENT'} to a one-process solve of them; "
              f"sharded solve {t_solve:.3f} s", flush=True)
        save_batch_result_local(os.path.join(outdir, f"ckpt_p{rank}.npz"), res)
        _, _, ln, ln_solver, _ = large_n_small(torch, mesh, device)
        n = LNS_M
        gloo_ms = [time_all_reduce(torch, mesh, k) for k in (5, n)]
        host = lambda t: t.cpu().numpy()
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), lanes=lanes, bitwise=bitwise,
                 x0=host(res.x[0]), x1=host(res.x[1]), it=host(its),
                 ln_x0=host(process_allgather(ln.x0, mesh)),
                 ln_x1=host(process_allgather(ln.x1, mesh)), ln_it=ln.iterations,
                 ln_captures=ln_solver.captures,
                 gloo_ms=np.array(gloo_ms), gloo_n=n)
    finally:
        dist.destroy_process_group()
    return 0


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)
    fam, kernels_line = phases_1_to_8(torch, card)

    # 10. the spectral routes (before 9, whose 16 GiB part frees its tensors last)
    kernels_line["kernels"].append(phase_spectral(torch, card, fam))
    del fam

    # 9. multi-device, once the earlier phases' tensors are freed
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    world_one = phase_world_one(torch, card, profile="--profile" in sys.argv,
                                variants="--variants" in sys.argv)
    phase_two_ranks(torch, card, world_one)
    print(f"multi-device phase: {time.perf_counter() - t0:.1f} s", flush=True)

    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all", flush=True)
    print(json.dumps(kernels_line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-of-two"]:
        rank, port, outdir, device, nb = sys.argv[2:7]
        sys.exit(rank_of_two(int(rank), port, outdir, device, int(nb)))
    sys.exit(main())
