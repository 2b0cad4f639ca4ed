"""Tests of the port that need a CUDA card: the hand-written chunk kernels
against their plain versions, and the solvers on the card against the same
solvers on the CPU.  They import torch only (no jax), so on a machine with
a card they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

and everywhere else they skip (the last test is the reverse: it checks
that without a card the default device raises).  Kernel tolerance 5e-4 absolute (f32 sums in
another order over 21 iterations, as in tests/test_kernels.py)."""
import numpy as np
import pytest
import torch

import admmsolver_tpu_torch as T
from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu_torch.ops.kernels import (fused_spm_chunk, fused_spm_chunk_reference,
                                              fused_two_block_chunk,
                                              fused_two_block_chunk_reference)
from admmsolver_tpu_torch.parallel import FusedSpMSolver, FusedTwoBlockSolver

pytestmark = pytest.mark.gpu

ATOL = 5e-4
PROX = ("l1", "l1_even", "nonneg", "nonneg_even")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(thin, prox, B, N, device, seed=3):
    """Chunk inputs from the thin basis of a wide A or the full eigenbasis
    of a tall one, with unit-scale random data and state."""
    rng = np.random.RandomState(seed)
    A = rng.randn(N // 2 if thin else N + 40, N)
    if thin:
        lam, W = np.linalg.eigh(A @ A.T)
        U = A.T @ W / np.sqrt(lam)
    else:
        lam, U = np.linalg.eigh(A.T @ A)
    mu = rng.uniform(0.5, 2.0, (B, 1))
    dinv = 1.0 / (lam[None, :] + mu) - (1.0 / mu if thin else 0.0)
    thr = 0.05 / mu if prox.startswith("l1") else np.zeros_like(mu)
    acy, x0, x1, h = (s * rng.randn(B, N) for s in (1.0, 0.3, 0.3, 1.0))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
            for a in (U, U.T, dinv, acy, mu, thr, x0, x1, h)]


@pytest.mark.parametrize("thin", [True, False], ids=["thin", "full"])
@pytest.mark.parametrize("prox", PROX)
@pytest.mark.parametrize("B,N", [(37, 100), (64, 512)])
def test_cuda_kernel_matches_plain_version(cuda, prox, thin, B, N):
    """Ragged B, N and R (no multiple of the lane tile or of 128), and the
    bench width N=512."""
    args = _inputs(thin, prox, B, N, cuda)
    launches = fused_two_block_chunk.launches
    got = fused_two_block_chunk(*args, n_iters=21, prox=prox, thin=thin)
    want = fused_two_block_chunk_reference(*args, n_iters=21, prox=prox, thin=thin)
    torch.cuda.synchronize()
    assert fused_two_block_chunk.launches == launches + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


def test_cuda_kernel_zero_iterations_and_checks(cuda):
    args = _inputs(True, "l1", 5, 64, cuda)
    x0, x1, h, prev = fused_two_block_chunk(*args, n_iters=0)
    torch.cuda.synchronize()
    for a, b in ((x0, args[6]), (x1, args[7]), (h, args[8]), (prev, args[6])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_two_block_chunk(args[0], args[1], *args[2:6], args[6].T.contiguous().T,
                              *args[7:], n_iters=1)
    with pytest.raises(ValueError, match="tensors on"):
        fused_two_block_chunk(*args[:8], args[8].cpu(), n_iters=1)


def _bp(A, y, block1="l1"):
    N = A.shape[1]
    b1 = T.L1Regularizer(0.1, N) if block1 == "l1" else T.NonNegativePenalty(N)
    return T.Model([T.LeastSquares(1.0, A, y), b1], [(1, 0, T.identity(N), T.identity(N))])


@pytest.mark.parametrize("block1", ["l1", "nonneg"])
def test_fused_solver_on_cuda_matches_cpu(cuda, block1):
    rng = np.random.RandomState(0)
    A = rng.randn(64, 128)
    xt = np.zeros((8, 128))
    for b in range(8):
        xt[b, rng.choice(128, 8, replace=False)] = rng.randn(8)
    ys = xt @ A.T if block1 == "l1" else np.abs(xt @ A.T)
    launches = fused_two_block_chunk.launches
    rc = FusedTwoBlockSolver(_bp(A, ys[0], block1), tile_b=4, device=cuda).solve(
        {(0, "y"): ys}, niter=21)
    assert fused_two_block_chunk.launches == launches + 2
    rh = FusedTwoBlockSolver(_bp(A, ys[0], block1), tile_b=4, device="cpu").solve(
        {(0, "y"): ys}, niter=21)
    for f in ("x0", "x1", "h"):
        np.testing.assert_allclose(getattr(rc, f).cpu().numpy(), getattr(rh, f).numpy(),
                                   rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rc.iterations.cpu().numpy(), rh.iterations.numpy())


def test_simple_optimizer_on_cuda_matches_cpu(cuda):
    rng = np.random.RandomState(1234)
    A = rng.randn(20, 60)
    y = A @ np.where(rng.rand(60) < 0.1, rng.randn(60), 0.0)
    oc = T.SimpleOptimizer(_bp(A, y), device=cuda)
    oh = T.SimpleOptimizer(_bp(A, y), device="cpu")
    oc.solve(200, interval_update_mu=20)
    oh.solve(200, interval_update_mu=20)
    assert oc.x[0].is_cuda and oc.iterations == oh.iterations
    np.testing.assert_allclose(oc.x[0].cpu().numpy(), oh.x[0].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(oc.mu.cpu().numpy(), oh.mu.numpy())


# ---------------------------------------------------------------------
# SpM slice
# ---------------------------------------------------------------------

def _spm_solver(device, nl=12, nw=25, B=6):
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=nl, nw=nw)
    gs = g[None, :] + 1e-4 * np.random.RandomState(0).randn(B, g.size)
    kw = {} if device is None else {"device": device}   # None: the solver's default
    return FusedSpMSolver(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), **kw), gs


def _spm_inputs(nl, nw, B, device, seed=3):
    """Chunk inputs: the projector of the synthetic SpM basis, the solver's
    own factors for per-lane penalties in [0.5, 2], unit-scale state."""
    solver, gs = _spm_solver(device, nl, nw, B)
    rng = np.random.RandomState(seed)
    f32 = dict(dtype=torch.float32, device=device)
    mu = torch.as_tensor(rng.uniform(0.5, 2.0, (B, 2)), **f32)
    acy = torch.as_tensor(gs, **f32) @ solver.Ac.T
    M, b2 = solver._factors(mu[:, 0], mu[:, 1], torch.ones(B, **f32), acy)
    thr = (0.05 / mu[:, :1]).contiguous()
    x0, x1, h10 = (torch.as_tensor(s * rng.randn(B, nl), **f32) for s in (0.3, 0.3, 1.0))
    x2, h20 = (torch.as_tensor(s * rng.randn(B, nw), **f32) for s in (0.3, 1.0))
    return [solver.P, M, b2, mu, thr, x0, x1, x2, h10, h20]


@pytest.mark.parametrize("nl,nw,B", [(12, 25, 37), (30, 201, 64), (33, 70, 5), (2, 3, 3),
                                     (40, 130, 300)])
def test_cuda_spm_kernel_matches_plain_version(cuda, nl, nw, B):
    """Ragged nl, nw and B (no multiple of 4, of the warp or of the lanes
    per block), nl above one warp, and the full width nl=30, nw=201."""
    args = _spm_inputs(nl, nw, B, cuda)
    launches = fused_spm_chunk.launches
    got = fused_spm_chunk(*args, n_iters=21)
    want = fused_spm_chunk_reference(*args, n_iters=21)
    torch.cuda.synchronize()
    assert fused_spm_chunk.launches == launches + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("tiling", [(1, 1), (1, 5), (2, 3), (4, 2), (4, 16)])
def test_cuda_spm_kernel_tilings_agree(cuda, tiling):
    """Every instantiation (lanes per warp) and block size gives the result
    of the wrapper's own choice, bit for bit: a lane's sums do not depend on
    its neighbours."""
    from admmsolver_tpu_torch.ops.kernels import _spm_launch

    args = _spm_inputs(12, 25, 37, cuda)
    want = fused_spm_chunk(*args, n_iters=7)
    got = _spm_launch(args, 7, tiling)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cuda_spm_kernel_zero_iterations_and_checks(cuda):
    args = _spm_inputs(12, 25, 5, cuda)
    out = fused_spm_chunk(*args, n_iters=0)
    torch.cuda.synchronize()
    for got, want in zip(out, (*args[5:], args[5])):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        fused_spm_chunk(*args[:5], args[5].T.contiguous().T, *args[6:], n_iters=1)
    with pytest.raises(ValueError, match="tensors on"):
        fused_spm_chunk(*args[:9], args[9].cpu(), n_iters=1)
    with pytest.raises(ValueError, match="shared memory"):
        big = _spm_inputs(250, 300, 2, cuda)
        fused_spm_chunk(*big, n_iters=1)


def test_fused_spm_solver_on_cuda_matches_cpu(cuda):
    sc, gs = _spm_solver(cuda)
    sh, _ = _spm_solver("cpu")
    launches = fused_spm_chunk.launches
    rc = sc.solve({(0, "y"): gs}, niter=21, mu0=0.1, interval_update_mu=10)
    assert fused_spm_chunk.launches == launches + 3   # 1 + 10 + 10 iterations
    rh = sh.solve({(0, "y"): gs}, niter=21, mu0=0.1, interval_update_mu=10)
    for k in range(3):
        assert rc.x[k].is_cuda
        np.testing.assert_allclose(rc.x[k].cpu().numpy(), rh.x[k].numpy(), rtol=0, atol=ATOL)
    for k in range(2):
        np.testing.assert_allclose(rc.h[k].cpu().numpy(), rh.h[k].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rc.mu.cpu().numpy(), rh.mu.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(rc.iterations.cpu().numpy(), rh.iterations.numpy())


def test_simple_optimizer_spm_on_cuda_matches_cpu(cuda):
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    model = spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    oc = T.SimpleOptimizer(model, mu=0.1)   # the default device is the card
    oh = T.SimpleOptimizer(model, mu=0.1, device="cpu")
    oc.solve(200)
    oh.solve(200)
    assert oc.x[0].is_cuda and oc.iterations == oh.iterations
    for a, b in zip(oc.x, oh.x):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(oc.mu.cpu().numpy(), oh.mu.numpy())


@pytest.mark.parametrize("entry", ["FusedTwoBlockSolver", "FusedSpMSolver", "SimpleOptimizer"])
def test_default_device_raises_without_cuda(entry):
    """Entry points run on the card unless the caller asks for the CPU:
    with no CUDA device the default raises, nothing carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rng = np.random.RandomState(0)
    A = rng.randn(6, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        if entry == "FusedTwoBlockSolver":
            FusedTwoBlockSolver(_bp(A, rng.randn(6)))
        elif entry == "FusedSpMSolver":
            _spm_solver(None)
        else:
            T.SimpleOptimizer(_bp(A, rng.randn(6)))
