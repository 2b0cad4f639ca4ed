"""The port's SimpleOptimizer against admmsolver_tpu's in float64: basis
pursuit and a 3-block LS + L1 + NonNegative model.  Trajectories agree:
x and h to 1e-8, identical penalties and iteration counts, residual
histories to rtol 1e-6.  Also: the package never imports jax."""
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu_torch import interop

torch.set_num_threads(1)


def _bp_data(M=20, N=60, K=5, seed=1234):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros(N)
    xt[rng.choice(N, K, replace=False)] = rng.randn(K)
    return A, A @ xt, xt


def _model(P, kind):
    A, y, _ = _bp_data()
    N = A.shape[1]
    I = P.identity(N)
    if kind == "bp":
        return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(0.1, N)],
                       [(1, 0, I, I)])
    if kind == "3block":
        return P.Model([P.LeastSquares(1.0, A, np.abs(y)), P.L1Regularizer(0.05, N),
                        P.NonNegativePenalty(N)],
                       [(1, 0, I, I), (2, 0, I, I)])
    if kind == "diag_coupling":
        # a non-scalar penalty on block 0: the Cholesky factor path
        d = np.random.RandomState(5).uniform(0.5, 2.0, N)
        D = P.DiagonalMatrix(jnp.asarray(d) if P is J else d)
        return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(0.1, N)],
                       [(1, 0, I, D)])
    raise ValueError(kind)


def _assert_same_run(ot, oj, xtol=1e-8):
    for a, b in zip(ot.x, oj.x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=xtol)
    for a, b in zip(ot.h, oj.h):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=xtol)
    np.testing.assert_array_equal(ot.mu.numpy(), np.asarray(oj.mu))
    assert ot.iterations == oj.iterations
    np.testing.assert_allclose(ot.primal_residual_history, oj.primal_residual_history,
                               rtol=1e-6)
    np.testing.assert_allclose(ot.dual_residual_history, oj.dual_residual_history,
                               rtol=1e-6)


@pytest.mark.parametrize("kind", ["bp", "3block", "diag_coupling"])
@pytest.mark.parametrize("rtol", [1e-12, 1e-6])
def test_simple_optimizer_matches_jax(kind, rtol):
    oj = J.SimpleOptimizer(_model(J, kind))
    ot = T.SimpleOptimizer(_model(T, kind), device="cpu")
    oj.solve(300, rtol=rtol, interval_update_mu=20)
    ot.solve(300, rtol=rtol, interval_update_mu=20)
    assert ot.x[0].dtype == torch.float64 and ot.mu.dtype == torch.float64
    _assert_same_run(ot, oj)
    # a second solve continues from the state, as in the JAX package
    oj.solve(40)
    ot.solve(40)
    _assert_same_run(ot, oj)


def test_basis_pursuit_recovers_signal():
    A, y, xt = _bp_data(M=100, N=300, K=10, seed=7)
    N = A.shape[1]
    opt = T.SimpleOptimizer(T.Model([T.LeastSquares(1.0, A, y), T.L1Regularizer(0.1, N)],
                                    [(1, 0, T.identity(N), T.identity(N))]),
                            device="cpu")
    opt.solve(200)
    err = np.abs(opt.x[0].numpy() - xt).max()
    assert err <= 1e-2 * np.abs(xt).max(), err


def test_callback_relax_and_reference_api_match_jax():
    oj = J.SimpleOptimizer(_model(J, "bp"), mu=0.7)
    ot = T.SimpleOptimizer(_model(T, "bp"), mu=0.7, device="cpu")
    seen = []
    kw = dict(interval_update_mu=5, relax=1.5)
    oj.solve(30, callback=lambda: None, **kw)
    ot.solve(30, callback=lambda: seen.append(ot.iterations), **kw)
    assert seen == list(range(1, 31))
    _assert_same_run(ot, oj)
    for o in (oj, ot):
        o.one_sweep()
    np.testing.assert_allclose(ot.residual(), oj.residual(), rtol=1e-8)
    assert ot.check_convergence(1e-3) == oj.check_convergence(1e-3)
    oj.update_mu(th_change=1.01)
    ot.update_mu(th_change=1.01)
    np.testing.assert_array_equal(ot.mu.numpy(), np.asarray(oj.mu))
    x = [np.asarray(v) for v in oj.x]
    assert abs(ot(x) - oj(x)) < 1e-9


def test_plan_sweep_takes_the_jax_argument_order():
    """``ADMMPlan.sweep(x, h, mu, factors, update_h, functions)`` called
    positionally in both packages on basis pursuit (A 20 x 60, mu0 = 1):
    ``functions`` is the sixth argument in each, and three sweeps give the
    same x and h to 1e-12."""
    from admmsolver_tpu.optimizer import ADMMPlan as JPlan
    from admmsolver_tpu_torch.optimizer import ADMMPlan as TPlan

    jp, tp = JPlan(_model(J, "bp")), TPlan(_model(T, "bp"), device="cpu")
    jx, jh, jmu = jp.make_initial_state(mu0=1.0)
    tx, th, tmu = tp.make_initial_state(mu0=1.0, device="cpu")
    jf, tf = jp.compute_factors(jmu), tp.compute_factors(tmu)
    for _ in range(3):
        jx, jh, _ = jp.sweep(jx, jh, jmu, jf, True, jp.model.functions)
        tx, th, _ = tp.sweep(tx, th, tmu, tf, True, tp.model.functions)
    for a, b in zip(tx + th, jx + jh):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def test_converged_solve_stops_and_skips_mu_update():
    oj = J.SimpleOptimizer(_model(J, "bp"))
    ot = T.SimpleOptimizer(_model(T, "bp"), device="cpu")
    oj.solve(2000, atol=1e-6)
    ot.solve(2000, atol=1e-6)
    assert ot.iterations < 2000
    _assert_same_run(ot, oj)


def test_float32_state_keeps_float32_histories():
    ot = T.SimpleOptimizer(_model(T, "bp"), dtype=torch.float32, device="cpu")
    ot.solve(20)
    assert ot.x[0].dtype == torch.float32 and ot.mu.dtype == torch.float32
    assert ot.iterations == 20 and np.all(np.isfinite(ot.primal_residual_history))


def test_from_jax_model_gives_the_same_trajectory():
    jm = _model(J, "3block")
    oj = J.SimpleOptimizer(jm)
    ot = T.SimpleOptimizer(interop.from_jax_model(jm, device="cpu"), device="cpu")
    oj.solve(100)
    ot.solve(100)
    _assert_same_run(ot, oj)


def test_engine_rejects_what_the_reference_rejects():
    A, y, _ = _bp_data()
    N = A.shape[1]
    lonely = T.Model([T.LeastSquares(1.0, A, y), T.L1Regularizer(0.1, N)])
    with pytest.raises(ValueError, match="no couplings"):
        T.SimpleOptimizer(lonely, device="cpu")
    three = T.SimpleOptimizer(_model(T, "3block"), device="cpu")
    with pytest.raises(ValueError, match="single-pair"):
        three.solve(5, relax=1.5)
    with pytest.raises(RuntimeError, match="one_sweep"):
        T.SimpleOptimizer(_model(T, "bp"), device="cpu").residual()
    opt = T.SimpleOptimizer(_model(T, "bp"), device="cpu")
    opt.solve(0)
    assert opt.iterations == 0


def test_port_never_imports_jax():
    """Every module of the port, imported in a fresh interpreter, leaves
    jax and the JAX package out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import admmsolver_tpu_torch as P\n"
        "names = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 20, names\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'admmsolver_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
