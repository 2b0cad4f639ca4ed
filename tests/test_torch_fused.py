"""The port's FusedTwoBlockSolver against admmsolver_tpu's, on the problems
of tests/test_kernels.py (the JAX chunk kernel in interpret mode, the
port's plain version on the CPU).  Short horizons agree to 5e-4 (f32 sums
in another order); long horizons land at the same fixed point, to 1e-3,
with penalties at most one residual-balancing step apart."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver as JaxFused
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.parallel import FusedTwoBlockSolver, FusedResult

torch.set_num_threads(1)


def _setup(B=8, M=64, N=128, seed=0):
    """tests/test_kernels.py:_setup."""
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 8, replace=False)] = rng.randn(8)
    return A, xt @ A.T, xt


def _bp(P, A, y, alpha=0.1, block1="l1"):
    N = A.shape[1]
    b1 = P.L1Regularizer(alpha, N) if block1 == "l1" else P.NonNegativePenalty(N)
    return P.Model([P.LeastSquares(1.0, A, y), b1],
                   [(1, 0, P.identity(N), P.identity(N))])


def _pair(block1="l1", B=8, seed=0, tile_b=4):
    A, ys, xt = _setup(B=B, seed=seed)
    if block1 == "nonneg":
        ys = np.abs(ys)
    jm = _bp(J, A, ys[0], block1=block1)
    return (JaxFused(jm, tile_b=tile_b),
            FusedTwoBlockSolver(interop.from_jax_model(jm), tile_b=tile_b), ys, xt)


def _close(rt: FusedResult, rj, atol, fields=("x0", "x1", "h")):
    for f in fields:
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=0, atol=atol, err_msg=f)


@pytest.mark.parametrize("block1", ["l1", "nonneg"])
def test_fused_short_horizon_matches_jax(block1):
    fj, ft, ys, _ = _pair(block1)
    assert ft.prox == fj.prox and ft.thin == fj.thin
    rj = fj.solve({(0, "y"): ys}, niter=21)
    rt = ft.solve({(0, "y"): ys}, niter=21)
    _close(rt, rj, 5e-4)
    np.testing.assert_array_equal(rt.mu.numpy(), np.asarray(rj.mu))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert rt.primal_residual.shape == tuple(rj.primal_residual.shape)
    np.testing.assert_allclose(rt.primal_residual.numpy(), np.asarray(rj.primal_residual),
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("block1", ["l1", "nonneg"])
def test_fused_long_horizon_matches_jax(block1):
    fj, ft, ys, xt = _pair(block1, seed=0 if block1 == "l1" else 3)
    rj = fj.solve({(0, "y"): ys}, niter=201)
    rt = ft.solve({(0, "y"): ys}, niter=201)
    _close(rt, rj, 1e-3)
    ratio = rt.mu.numpy() / np.asarray(rj.mu)
    assert np.all((ratio >= 0.49) & (ratio <= 2.01)), ratio
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    if block1 == "nonneg":
        assert rt.x1.min() >= 0


def test_fused_convergence_and_early_exit_match_jax():
    fj, ft, ys, _ = _pair()
    rj = fj.solve({(0, "y"): ys}, niter=2001, atol=1e-3)
    rt = ft.solve({(0, "y"): ys}, niter=2001, atol=1e-3)
    assert rt.converged.all() and rt.iterations.max() < 2001
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(np.isnan(rt.primal_residual.numpy()),
                                  np.isnan(np.asarray(rj.primal_residual)))
    _close(rt, rj, 1e-3)


def test_fused_lambda_sweep_with_batch_padding():
    """Per-lane L1 strengths and a batch that is no tile multiple (6 -> 8):
    padding lanes start done and are trimmed."""
    fj, ft, ys, _ = _pair(B=6)
    lam = np.logspace(-2, 0, 6)
    ov = {(0, "y"): ys, (1, "alpha"): lam, (0, "alpha"): np.full(6, 1.0)}
    rj = fj.solve(ov, niter=301)
    rt = ft.solve(ov, niter=301)
    assert tuple(rt.x0.shape) == (6, 128) and tuple(rt.mu.shape) == (6,)
    _close(rt, rj, 1e-3)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))


def test_fused_warm_start_continues_like_jax():
    """A JAX result carried over through interop.state_from_numpy continues
    in the port as the JAX solver continues it."""
    fj, ft, ys, _ = _pair()
    r1 = fj.solve({(0, "y"): ys}, niter=21)
    state = interop.state_from_numpy(*(np.asarray(a) for a in (r1.x0, r1.x1, r1.h, r1.mu)))
    assert state["x0"].dtype == torch.float32
    rj = fj.solve({(0, "y"): ys}, niter=21, x0=r1.x0, x1=r1.x1, h0=r1.h, mu0=r1.mu)
    rt = ft.solve({(0, "y"): ys}, niter=21, **state)
    _close(rt, rj, 5e-4)
    np.testing.assert_array_equal(rt.mu.numpy(), np.asarray(rj.mu))
    done = np.array([True, False] * 4)
    rj = fj.solve({(0, "y"): ys}, niter=21, done0=done, **{
        "x0": r1.x0, "x1": r1.x1, "h0": r1.h, "mu0": r1.mu})
    rt = ft.solve({(0, "y"): ys}, niter=21, done0=done, **state)
    _close(rt, rj, 5e-4)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.x0.numpy()[done], state["x0"].numpy()[done])


def test_fused_without_overrides_solves_the_template():
    fj, ft, ys, _ = _pair()
    rj = fj.solve(batch_size=3, niter=21)
    rt = ft.solve(batch_size=3, niter=21)
    _close(rt, rj, 5e-4)
    with pytest.raises(ValueError, match="batch_size"):
        ft.solve(niter=5)


def test_fused_rejects_unsupported():
    A, ys, _ = _setup()
    B, N = ys.shape[0], A.shape[1]
    ft = FusedTwoBlockSolver(_bp(T, A, ys[0]), tile_b=2)
    with pytest.raises(ValueError, match="supports per-instance"):
        ft.solve({(0, "y"): ys, (0, "A"): np.zeros((B,) + A.shape)}, niter=5)
    with pytest.raises(ValueError, match="leading batch axis"):
        ft.solve({(1, "alpha"): 0.1}, batch_size=B, niter=5)
    with pytest.raises(ValueError, match="inconsistent batch"):
        ft.solve({(0, "y"): ys, (1, "alpha"): np.ones(B + 1)}, niter=5)
    coupled = T.Model([T.LeastSquares(1.0, A, ys[0]), T.L1Regularizer(0.1, N)],
                      [(1, 0, T.DiagonalMatrix(np.full(N, 2.0)), T.identity(N))])
    with pytest.raises(ValueError, match="identity couplings"):
        FusedTwoBlockSolver(coupled)
    three = T.Model([T.LeastSquares(1.0, A, ys[0]), T.L1Regularizer(0.1, N),
                     T.NonNegativePenalty(N)],
                    [(1, 0, T.identity(N), T.identity(N)),
                     (2, 0, T.identity(N), T.identity(N))])
    with pytest.raises(ValueError, match="2-block"):
        FusedTwoBlockSolver(three)
    offset = T.Model([T.LeastSquares(1.0, A, ys[0]), T.L1Regularizer(0.1, N, np.ones(N))],
                     [(1, 0, T.identity(N), T.identity(N))])
    with pytest.raises(ValueError, match="offsets"):
        FusedTwoBlockSolver(offset)


def test_from_jax_model_rejects_missing_counterparts():
    A, ys, _ = _setup()
    N = A.shape[1]
    jm = J.Model([J.LeastSquares(1.0, A, ys[0]), J.L2Regularizer(0.1, np.eye(N))],
                 [(1, 0, J.identity(N), J.identity(N))])
    with pytest.raises(TypeError, match="L2Regularizer"):
        interop.from_jax_model(jm)
    jm = J.Model([J.LeastSquares(1.0, A, ys[0]), J.L1Regularizer(0.1, N)],
                 [(1, 0, J.PartialDiagonalMatrix(jnp.eye(N // 2), (2,)), J.identity(N))])
    with pytest.raises(TypeError, match="PartialDiagonalMatrix"):
        interop.from_jax_model(jm)
