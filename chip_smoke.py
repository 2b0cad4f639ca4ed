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
  N = 100,000 (no kernel of their own: batched eigh, batched SVD, cyclic
  reduction and elementwise proxes in PyTorch).

1. Card and build: the card's name and power limit; both CUDA sources are
   built from ``admmsolver_tpu_torch/csrc/`` (one nvcc per source, started
   together), timed, with ptxas' register and spill lines.
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
4. ``SimpleOptimizer`` in float64 on the GPU: one bench instance recovered;
   one SpM instance for 1000 iterations with the sum rule to 1e-6.
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
   80 GB a lane).

``--variants`` also times both chunks at other tilings and routes, the
two-block chunk's two products as ``torch.matmul``, the card's L2 read rate,
the factor refresh's batched inverse by other routes and batched eigh by both
linear-algebra libraries; ``--profile`` prints a torch.profiler breakdown of
both fused solves, of the float64 ``BatchedSolver`` solve, of one scheduler
wave in each stream mode and of short covariance-denoising and TV solves,
and times each stream mode a second time.
The last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA GPU,
``nvcc`` and no network.
"""
import json
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


def bench_problem(seed=0):
    """bench.py:34-42: A (M, N), B planted 20-sparse signals, ys = x* A^T."""
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xtrue = np.zeros((B, N))
    for b in range(B):
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


def median_ms(torch, fns):
    """Median CUDA-event time in ms of one call of each of ``fns``: every
    timing spans INNER calls in a row (so that the host's preparation of a
    launch overlaps the call before it), REPEATS timings of each taken in
    turns, after one warm-up turn."""
    times = [[] for _ in fns]
    for rep in range(REPEATS + 1):
        for fn, t in zip(fns, times):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            for _ in range(INNER):
                fn()
            stop.record()
            torch.cuda.synchronize()
            if rep:
                t.append(start.elapsed_time(stop) / INNER)
    return [float(np.median(t)) for t in times]


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
    with plain_chunk:
        return solve()


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
    ``iters`` the launches per iteration."""
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
    rows = [(e.key, getattr(e, "device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages() if getattr(e, "device_time_total", 0.0) > 0
            and e.device_type.name == "CUDA"]
    total = sum(r[1] for r in rows)
    kern = sum(r[1] for r in rows if kernel_name in r[0])
    print(f"profile, {what}: wall {wall:.2f} ms (profiled), device kernels {total:.2f} ms "
          f"(busy {total / wall:.2f}), {kernel_name} kernels {kern:.2f} ms, other kernels "
          f"{total - kern:.2f} ms in {sum(r[2] for r in rows)} launches"
          + (f" = {sum(r[2] for r in rows) / iters:.1f} per iteration" if iters else ""))
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:12]:
        print(f"  {ms:8.3f} ms  x{count:<5d} {key[:90]}")


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
    return {"launches": launches, "s": t_re}


def family_solve(torch, card, what, model, ov, niter, device, lanes=(0,), tol=1e-8,
                 single=None):
    """One family through ``BatchedSolver.solve`` in float64 (rtol=0, no
    histories), timed by the host clock on its first run and on a second one;
    ``lanes`` of it against ``SimpleOptimizer`` solves on the same device, to
    ``tol`` of max|x|.  ``single(b)`` builds lane b's own model.  Returns the
    result, the solver and the two timings."""
    from admmsolver_tpu_torch import SimpleOptimizer
    from admmsolver_tpu_torch.parallel import BatchedSolver

    bs = BatchedSolver(model, device=device)
    solve = lambda: bs.solve(ov, niter=niter, rtol=0.0, record_residuals=False)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    times, res = [], None
    for _ in range(2):
        res = None      # the first result does not sit beside the second solve
        sync()
        t0 = time.perf_counter()
        res = solve()
        sync()
        times.append(time.perf_counter() - t0)
    outs = [*res.x, *res.h, res.mu]
    if not all(t.dtype == torch.float64 and bool(torch.isfinite(t).all()) for t in outs):
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
    print(f"[{card}] {what}: {niter} iterations in {times[0] * 1e3:.1f} ms (first run), "
          f"{times[1] * 1e3:.1f} ms (second) = {times[1] * 1e3 / niter:.3f} ms per iteration",
          flush=True)
    return res, bs, times


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


def phase_cov_denoise(torch, card, device="cuda", k=COV_K, B=COV_B, niter=COV_NITER,
                      variants=False):
    """8a. Covariance denoising (bench_sdp128, benches/bench_workloads.py:
    362-375): a weighted nearest-PSD matrix of k x k, one slice a lane, the
    per-lane data through the (0, "y") override; with ``variants`` batched
    eigh of the phase's slices alone under each linear-algebra library."""
    from admmsolver_tpu_torch.models.applications import covariance_denoise_model

    rng = np.random.RandomState(15)
    N = k * k
    w = 1.0 + rng.rand(N)
    rw = np.sqrt(w)
    Q = rng.randn(k, k)
    xt = (Q @ Q.T / k).reshape(-1)
    ys = xt[None, :] + 0.1 * rng.randn(B, N)
    wys = torch.as_tensor(ys * rw[None, :], device=device)
    model = lambda b: covariance_denoise_model(ys[b].reshape(k, k), weights=w)
    ov = {(0, "y"): wys}
    res, bs, times = family_solve(torch, card, f"covariance denoising k={k} B={B}",
                                  model(0), ov, niter, device, single=model)
    check_psd(torch, "covariance denoising", res.x[1], k)
    # a short solve for the profile: cuSOLVER's eigh launches thousands of
    # kernels an iteration, and the profiler's bookkeeping grows with them
    out = {"ms_per_iter": 1e3 * times[1] / niter, "profile_iters": 5,
           "profile": lambda: bs.solve(ov, niter=5, rtol=0.0, record_residuals=False)}
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


def phase_sdp(torch, card, device="cuda", k=SDP_K, rest=SDP_REST, B=SDP_B, niter=SDP_NITER):
    """8b. The SDP (bench_sdp, benches/bench_workloads.py:237-250): LS data
    fit with a PSD cone on rest slices of k x k."""
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
    res, _, times = family_solve(
        torch, card, f"SDP k={k} rest={rest} A {M}x{N} B={B}", sdp_model(A, y, shape, axis=2),
        {(0, "y"): torch.as_tensor(ys, device=device)}, niter, device,
        single=lambda b: sdp_model(A, ys[b], shape, axis=2))
    check_psd(torch, "SDP", res.x[1], k)
    return {"ms_per_iter": 1e3 * times[1] / niter}


def phase_rpca(torch, card, device="cuda", m=RPCA_M, n=RPCA_N, B=RPCA_B, niter=RPCA_NITER):
    """8c. Robust PCA (bench_rpca, benches/bench_workloads.py:438-445): the
    nuclear-norm prox by batched SVD, per-lane Y through (1, "offset")."""
    from admmsolver_tpu_torch.models.applications import rpca_model

    rng = np.random.RandomState(7)
    L0 = rng.randn(B, m, 3) @ rng.randn(3, n)
    Ys = L0.copy()
    mask = rng.rand(B, m, n) < 0.05
    Ys[mask] += 6.0 * rng.randn(int(mask.sum()))
    res, _, times = family_solve(
        torch, card, f"RPCA {m}x{n} B={B}", rpca_model(Ys[0]),
        {(1, "offset"): torch.as_tensor(Ys.reshape(B, -1), device=device)}, niter, device,
        single=lambda b: rpca_model(Ys[b]))
    L = res.x[0].cpu().numpy().reshape(B, m, n)
    rel = float(np.abs(L - L0).max() / np.abs(L0).max())
    sv = np.linalg.svd(L, compute_uv=False)
    rank = int(np.median((sv > 1e-3 * sv[:, :1]).sum(axis=1)))
    print(f"RPCA: max rel error of L {rel:.4f}, median effective rank {rank}", flush=True)
    return {"ms_per_iter": 1e3 * times[1] / niter, "max_rel_err_L": rel, "rank": rank}


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
    res, _, times = family_solve(
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
    res, _, times = family_solve(
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


def phase_tv(torch, card, device="cuda", N=TV_N, B=TV_B, niter=TV_NITER, lam=TV_LAM):
    """8f. TV denoising at the scale tv_denoise_model's docstring names: the
    banded penalty per lane and its cyclic-reduction factor; lanes 0 and 1
    against SimpleOptimizer, and the device memory the solve takes."""
    from admmsolver_tpu_torch.models.applications import tv_denoise_model

    truth, ys = tv_signals(N, B)
    ys_dev = torch.as_tensor(ys, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    ov = {(0, "y"): ys_dev}
    res, bs, times = family_solve(
        torch, card, f"TV denoising N={N} B={B} lam={lam}", tv_denoise_model(ys[0], lam),
        ov, niter, device, lanes=(0, 1), tol=1e-9,
        single=lambda b: tv_denoise_model(ys[b], lam))
    peak = torch.cuda.max_memory_allocated() - before if device == "cuda" else None
    err = float((res.x[0] - torch.as_tensor(truth, device=device)).abs().mean())
    noisy = float(np.abs(ys - truth[None]).mean())
    print(f"TV denoising: mean |x - truth| {err:.4f} (noisy input {noisy:.4f})"
          + ("" if peak is None else f"; peak device memory over the part {peak / 2**20:.0f} MiB "
             f"(limit {TV_MEMORY_LIMIT / 2**20:.0f} MiB; one (B, N) float64 array is "
             f"{B * N * 8 / 2**20:.1f} MiB)"), flush=True)
    if peak is not None and not peak < TV_MEMORY_LIMIT:
        raise AssertionError(f"the TV solve took {peak / 2**20:.0f} MiB of device memory")
    if not err < noisy:
        raise AssertionError("TV denoising did not denoise")
    return {"ms_per_iter": 1e3 * times[1] / niter, "peak_bytes": peak, "profile_iters": 5,
            "profile": lambda: bs.solve(ov, niter=5, rtol=0.0, record_residuals=False)}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from admmsolver_tpu_torch import (L1Regularizer, LeastSquares, Model,
                                      SimpleOptimizer, identity)
    from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
    from admmsolver_tpu_torch.ops import _build, kernels
    from admmsolver_tpu_torch.parallel import (BatchedSolver, FusedSpMSolver,
                                               FusedTwoBlockSolver, fused, fused_spm)

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    libs = _build.load_libraries()
    print(f"build: {time.perf_counter() - t0:.3f} s for {len(libs)} kernels", flush=True)
    if sorted(libs) != ["fused_spm", "fused_two_block"]:
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

    # 4. single instances, float64
    opt_run = lambda: SimpleOptimizer(model).solve(200)
    opt = SimpleOptimizer(model)
    opt.solve(200)
    assert opt.x[0].dtype == torch.float64 and opt.x[0].is_cuda
    worst = check_recovery(opt.x[0].cpu().numpy()[None], xtrue[:1], "SimpleOptimizer")
    print(f"SimpleOptimizer f64 on cuda, 200 iters: worst err/bound {worst:.4f}", flush=True)

    sopt_run = lambda: SimpleOptimizer(smodel, mu=SPM_MU0).solve(1000)
    sopt = SimpleOptimizer(smodel, mu=SPM_MU0)
    sopt.solve(1000)
    xs = [x.cpu().numpy() for x in sopt.x]
    sum_one = abs(float(xs[0] @ prj_sum) - 1.0)
    print(f"SimpleOptimizer f64 on cuda, SpM, 1000 iters: min spectrum {xs[2].min():.3e}, "
          f"|sum rule - 1| {sum_one:.3e} (bound 1e-6)", flush=True)
    if not (sopt.x[0].is_cuda and sopt.x[0].dtype == torch.float64
            and all(np.all(np.isfinite(x)) for x in xs) and xs[2].min() >= 0.0
            and sum_one <= 1e-6):
        raise AssertionError("SimpleOptimizer on the SpM model misses its properties")

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
    p1 = spm.solve({(0, "y"): gs_dev}, niter=SPM_NITER, mu0=SPM_MU0, rtol=0.0, atol=1e-5)
    p1_state = dict(x0=[a.double() for a in p1.x], h0=[a.double() for a in p1.h],
                    mu0=p1.mu.double())
    polish = lambda: spm._polish_solver.solve({(0, "y"): gs_dev}, niter=POLISH_NITER, rtol=0.0,
                                              record_residuals=False, **p1_state)
    tm_all, tm_low, tm_polish = median_wall(torch, [
        mixed_solve,
        lambda: spm.solve({(0, "y"): gs_dev}, niter=SPM_NITER, mu0=SPM_MU0, rtol=0.0,
                          atol=1e-5),
        polish])
    print(f"[{card}] SpM solve_mixed (B={B}, {SPM_NITER} f32 + {POLISH_NITER} f64 iters): "
          f"{tm_all * 1e3:.1f} ms; its f32 kernel phase alone {tm_low * 1e3:.1f} ms "
          f"(iterations {int(p1.iterations.min())}..{int(p1.iterations.max())}), its f64 "
          f"polish alone {tm_polish * 1e3:.1f} ms = {B * POLISH_NITER / tm_polish:.0f} "
          "inst-iters/s")

    # 7. the stream drivers and complex problems through the real embedding
    sched = phase_scheduler(torch, card, again="--profile" in sys.argv)
    phase_resumable(torch, card, A, ys)
    complex_spm = phase_complex_spm(torch, card)
    realified = phase_complex_bp(torch, card, kernels, fused, plain_chunk, solve)

    # 8. the added model families at full width, float64
    cov = phase_cov_denoise(torch, card, variants="--variants" in sys.argv)
    phase_sdp(torch, card)
    phase_rpca(torch, card)
    phase_group_lasso(torch, card)
    phase_huber(torch, card)
    tv = phase_tv(torch, card)

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
        profile_solve(torch, "basis-pursuit solve", "fused_two_block", solve)
        profile_solve(torch, "SpM solve", "fused_spm", spm_solve)
        profile_solve(torch, "BatchedSolver f64 solve", "gemm", lambda: bsolve(rtol=0.0),
                      iters=BATCH_NITER)
        profile_solve(torch, "BatchedSolver f32 solve", "gemm",
                      lambda: bsolve(rtol=0.0, dtype=torch.float32), iters=BATCH_NITER)
        profile_solve(torch, "SpM solve_mixed f64 polish", "gemm", polish, iters=POLISH_NITER)
        from admmsolver_tpu_torch.parallel import ScenarioScheduler
        one_wave = ScenarioScheduler(sched["solver"], batch_size=SCHED_B, chunk_iters=SCHED_CHUNK,
                                     niter_max=SCHED_CHUNK, rtol=0.0, atol=SCHED_ATOL)
        for mode in ("run", "run_compiled"):
            profile_solve(torch, f"scheduler {mode}, one wave of {SCHED_CHUNK} iterations", "gemm",
                          lambda: getattr(one_wave, mode)(iter(sched["scenarios"])),
                          iters=SCHED_CHUNK)
        profile_solve(torch, "realified complex SpM solve", "gemm", complex_spm["solve"],
                      iters=CSPM_NITER)
        for what, part, name in (("covariance denoising", cov, "stedc"),
                                 ("TV denoising", tv, "pad")):
            profile_solve(torch, f"{what} solve, {part['profile_iters']} iterations", name,
                          part["profile"], iters=part["profile_iters"])

    # No single PyTorch call computes either chunk, so there is no library time.
    # prev_ms is the replaced design's time where this run still builds and
    # times it (the SpM FMA kernel); the two-block kernel's is no longer built.
    print(json.dumps({"kernels": [
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
         "fma_max_abs_err": spm_fma_err}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
