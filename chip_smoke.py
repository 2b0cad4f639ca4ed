#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Drives the port's main path, the fused two-block basis-pursuit solver, at
the bench problem (A 256x512, B=4096, 20-sparse, seed 0, alpha=0.1), one
phase after another; a phase that fails raises and the script exits
non-zero without printing a result.

1. Card and build: the card's name and power limit; the CUDA kernel is
   built from ``admmsolver_tpu_torch/csrc/`` at first use, and timed.
2. Kernel against its plain version at the bench shape (thin basis,
   N=512, R=256) and at a full-basis shape (N=R=128), all four prox
   modes, 21 iterations: max abs difference of every output <= 5e-4
   (f32 sums taken in another order).
3. The slice: ``FusedTwoBlockSolver.solve`` for 401 iterations goes through
   the kernel (launch count > 0), recovers every lane's planted signal to
   1e-2 * max|x*| of the lane, and agrees with the same solve through the
   plain version within 2e-2.
4. ``SimpleOptimizer`` in float64 on the GPU recovers one bench instance.
5. Times: medians of 3 repeats after a warm-up, kernel against plain.

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
KERNEL_TOL = 5e-4   # tests/test_kernels.py short-horizon bound
SOLVE_TOL = 2e-2    # benches/kernel_hw_check.py fixed-point bound
PROX_MODES = ("l1", "l1_even", "nonneg", "nonneg_even")
REPEATS = 3


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
    """Chunk inputs on the card: the solver's own eigenbasis, unit-scale
    random data and state, and per-lane penalties.  (At the bench data's
    own scale, |alpha A^T y| ~ 500, f32 rounding alone moves either version
    by ~1e-3 from float64 over 21 iterations.)"""
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


def median_ms(torch, fns):
    """Median CUDA-event time in ms of each of ``fns`` over REPEATS runs
    taken in turns, after one warm-up run of each."""
    times = [[] for _ in fns]
    for rep in range(REPEATS + 1):
        for fn, t in zip(fns, times):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            fn()
            stop.record()
            torch.cuda.synchronize()
            if rep:
                t.append(start.elapsed_time(stop))
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from admmsolver_tpu_torch import (L1Regularizer, LeastSquares, Model,
                                      SimpleOptimizer, identity)
    from admmsolver_tpu_torch.ops import _build, kernels
    from admmsolver_tpu_torch.parallel import FusedTwoBlockSolver, fused

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}", flush=True)

    # 1. build
    t0 = time.perf_counter()
    lib = _build.load_library()
    print(f"build: {time.perf_counter() - t0:.3f} s ({Path(lib._name).name})", flush=True)
    for line in Path(lib._name).with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    A, ys, xtrue = bench_problem()
    model = Model([LeastSquares(1.0, A, ys[0]), L1Regularizer(ALPHA, N)],
                  [(1, 0, identity(N), identity(N))])
    solver = FusedTwoBlockSolver(model, device="cuda")
    assert solver.thin and tuple(solver.U.shape) == (N, M), solver.U.shape

    # 2. kernel against its plain version
    Af = np.random.RandomState(1).randn(192, 128)
    full = FusedTwoBlockSolver(
        Model([LeastSquares(1.0, Af, np.zeros(192)), L1Regularizer(ALPHA, 128)],
              [(1, 0, identity(128), identity(128))]), device="cuda")
    assert not full.thin
    max_err = 0.0
    for name, s in (("thin N=512 R=256", solver), ("full N=R=128", full)):
        for k, prox in enumerate(PROX_MODES):
            args = kernel_inputs(torch, s, prox, seed=10 + k)
            got = kernels.fused_two_block_chunk(*args, n_iters=21, prox=prox, thin=s.thin)
            ref = kernels.fused_two_block_chunk_reference(*args, n_iters=21, prox=prox,
                                                          thin=s.thin)
            torch.cuda.synchronize()
            errs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
            print(f"kernel vs plain, {name}, {prox}, B={B}, 21 iters: max abs diff "
                  f"x0 {errs[0]:.3e} x1 {errs[1]:.3e} h {errs[2]:.3e} x0_prev {errs[3]:.3e}",
                  flush=True)
            if not all(e <= KERNEL_TOL for e in errs):
                raise AssertionError(f"kernel disagrees with its plain version: {errs}")
            max_err = max(max_err, *errs)

    # 3. the slice through the kernel, then through the plain version
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

    # 4. single instance, float64
    opt_run = lambda: SimpleOptimizer(model, device="cuda").solve(200)
    opt = SimpleOptimizer(model, device="cuda")
    opt.solve(200)
    assert opt.x[0].dtype == torch.float64 and opt.x[0].is_cuda
    worst = check_recovery(opt.x[0].cpu().numpy()[None], xtrue[:1], "SimpleOptimizer")
    print(f"SimpleOptimizer f64 on cuda, 200 iters: worst err/bound {worst:.4f}", flush=True)

    # 5. times: kernel and plain version in turns on one card, after a warm-up
    args = kernel_inputs(torch, solver, "l1", seed=99)
    chunk = dict(n_iters=100, prox="l1", thin=True)
    run_kernel = lambda: kernels.fused_two_block_chunk(*args, **chunk)
    run_plain = lambda: kernels.fused_two_block_chunk_reference(*args, **chunk)
    ms, plain_ms = median_ms(torch, [run_kernel, run_plain])
    t_kernel, t_plain = median_wall(torch, [solve, lambda: plain_chunk_solve(plain_chunk, solve)])
    (t_opt,) = median_wall(torch, [opt_run])
    print(f"[{card}] one chunk (B={B}, N={N}, R={M}, 100 iters, l1, thin): "
          f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    print(f"[{card}] fused solve (B={B}, {NITER} iters): kernel {t_kernel * 1e3:.1f} ms = "
          f"{B * NITER / t_kernel:.0f} inst-iters/s, plain {t_plain * 1e3:.1f} ms = "
          f"{B * NITER / t_plain:.0f} inst-iters/s")
    print(f"[{card}] SimpleOptimizer f64 solve (1 instance, 200 iters): "
          f"{t_opt * 1e3:.1f} ms")

    print(json.dumps({"kernels": [{
        "name": "fused_two_block_chunk", "route": "cuda",
        "source": "admmsolver_tpu_torch/csrc/fused_two_block.cu",
        "replaces": "admmsolver_tpu/ops/kernels.py:116",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
