"""Tests of the port that need a CUDA card: the hand-written chunk kernel
against its plain version, and the solvers on the card against the same
solvers on the CPU.  They import torch only (no jax), so on a machine with
a card they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

and everywhere else they skip.  Kernel tolerance 5e-4 absolute (f32 sums in
another order over 21 iterations, as in tests/test_kernels.py)."""
import numpy as np
import pytest
import torch

import admmsolver_tpu_torch as T
from admmsolver_tpu_torch.ops.kernels import (fused_two_block_chunk,
                                              fused_two_block_chunk_reference)
from admmsolver_tpu_torch.parallel import FusedTwoBlockSolver

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
    rh = FusedTwoBlockSolver(_bp(A, ys[0], block1), tile_b=4).solve({(0, "y"): ys}, niter=21)
    for f in ("x0", "x1", "h"):
        np.testing.assert_allclose(getattr(rc, f).cpu().numpy(), getattr(rh, f).numpy(),
                                   rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rc.iterations.cpu().numpy(), rh.iterations.numpy())


def test_simple_optimizer_on_cuda_matches_cpu(cuda):
    rng = np.random.RandomState(1234)
    A = rng.randn(20, 60)
    y = A @ np.where(rng.rand(60) < 0.1, rng.randn(60), 0.0)
    oc = T.SimpleOptimizer(_bp(A, y), device=cuda)
    oh = T.SimpleOptimizer(_bp(A, y))
    oc.solve(200, interval_update_mu=20)
    oh.solve(200, interval_update_mu=20)
    assert oc.x[0].is_cuda and oc.iterations == oh.iterations
    np.testing.assert_allclose(oc.x[0].cpu().numpy(), oh.x[0].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(oc.mu.cpu().numpy(), oh.mu.numpy())
