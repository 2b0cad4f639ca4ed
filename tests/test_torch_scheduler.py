"""The port's ScenarioScheduler against admmsolver_tpu.parallel.scheduler,
on the CPU in float64.  The cases mirror tests/test_scheduler.py (its
sharded-solver fallback has no counterpart: the port has no sharding).
For every scenario, the port's ``run`` and ``run_compiled`` equal the JAX
package's ``run``: x and the final penalties to 1e-10, equal iteration
counts and convergence flags."""
import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.parallel import BatchedSolver as JaxBatched
from admmsolver_tpu.parallel import ScenarioScheduler as JaxScheduler
from admmsolver_tpu_torch.parallel import BatchedSolver, ScenarioScheduler

torch.set_num_threads(1)

TOL = 1e-10


def _template(P, A, y):
    N = A.shape[1]
    return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(0.1, N)],
                   [(1, 0, P.identity(N), P.identity(N))])


def _schedulers(A, y0, dtype=None, **kw):
    bt = BatchedSolver(_template(T, A, y0), dtype=dtype, device="cpu")
    bj = JaxBatched(_template(J, A, y0), dtype=dtype and np.dtype(str(dtype).split(".")[-1]))
    return ScenarioScheduler(bt, **kw), JaxScheduler(bj, **kw)


def _same(got, want, atol=TOL):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.scenario_id == b.scenario_id
        assert a.iterations == b.iterations, (a.scenario_id, a.iterations, b.iterations)
        assert a.converged == b.converged
        for xa, xb in zip(a.x, b.x):
            assert isinstance(xa, np.ndarray) and xa.dtype == np.asarray(xb).dtype
            np.testing.assert_allclose(xa, np.asarray(xb), rtol=0, atol=atol)
        np.testing.assert_allclose(a.final_mu, np.asarray(b.final_mu), rtol=atol)


def test_scheduler_drains_stream():
    rng = np.random.RandomState(0)
    M, N, n_scen = 10, 24, 11
    A = rng.randn(M, N)
    ys = rng.randn(n_scen, M)
    st, sj = _schedulers(A, ys[0], batch_size=4, chunk_iters=100, niter_max=3000, rtol=1e-8)
    results = st.run({(0, "y"): ys[i]} for i in range(n_scen))

    assert [r.scenario_id for r in results] == list(range(n_scen))
    assert all(r.converged for r in results)
    _same(results, sj.run({(0, "y"): ys[i]} for i in range(n_scen)))

    # each scenario's solution matches a dedicated single-instance solve
    # run with the same chunked schedule (repeated solve() restarts the
    # penalty counter, reference optimizer.py:310,319)
    for r in results[:4]:
        o = T.SimpleOptimizer(_template(T, A, ys[r.scenario_id]), device="cpu")
        done = 0
        while done < 3000:
            o.solve(100, rtol=1e-8)
            done += 100
            if o.iterations < done:
                break
        assert o.iterations == r.iterations
        np.testing.assert_allclose(r.x[0], o.x[0].numpy(), atol=1e-6)


def test_scheduler_niter_budget():
    """Scenarios that never converge are harvested at the budget."""
    rng = np.random.RandomState(1)
    A = rng.randn(8, 16)
    ys = rng.randn(3, 8)
    st, sj = _schedulers(A, ys[0], batch_size=2, chunk_iters=50, niter_max=100, rtol=0.0)
    results = st.run({(0, "y"): ys[i]} for i in range(3))
    assert len(results) == 3
    assert all(not r.converged for r in results)
    assert all(r.iterations == 100 for r in results)
    _same(results, sj.run({(0, "y"): ys[i]} for i in range(3)))


def test_scheduler_empty_and_mismatched():
    rng = np.random.RandomState(2)
    A = rng.randn(6, 12)
    bs = BatchedSolver(_template(T, A, rng.randn(6)), device="cpu")
    sched = ScenarioScheduler(bs, batch_size=2, chunk_iters=10, niter_max=20)
    assert sched.run(iter([])) == []
    with pytest.raises(ValueError, match="keys"):
        sched.run(iter([{(0, "y"): rng.randn(6)}, {(1, "alpha"): 0.5}]))
    with pytest.raises(ValueError, match="keys"):
        sched.run_compiled(iter([{(0, "y"): rng.randn(6)}, {(1, "alpha"): 0.5}]))


def test_run_compiled_matches_host_loop():
    """The device-side drain reproduces the host wave loop scenario for
    scenario: the same solutions, iteration counts, convergence flags and
    final penalties; both equal the JAX package's host loop."""
    rng = np.random.RandomState(3)
    M, N, n_scen = 10, 24, 11
    A = rng.randn(M, N)
    ys = rng.randn(n_scen, M)
    st, sj = _schedulers(A, ys[0], batch_size=4, chunk_iters=100, niter_max=3000, rtol=1e-8)
    stream = lambda: ({(0, "y"): ys[i]} for i in range(n_scen))
    host, comp, jax_host = st.run(stream()), st.run_compiled(stream()), sj.run(stream())
    _same(host, jax_host)
    _same(comp, jax_host)
    _same(comp, host)


def test_run_compiled_ragged_stream_matches_jax():
    """A ragged stream as benches/scheduler_hw.py draws it (sparsity and
    alpha per scenario, absolute stop): lanes finish in different waves and
    are refilled in lane order; the compiled drain, the host loop and the
    JAX package agree."""
    rng = np.random.RandomState(5)
    M, N, S = 12, 24, 13
    A = rng.randn(M, N)
    K = rng.randint(2, 10, S)
    xt = np.zeros((S, N))
    for i in range(S):
        xt[i, rng.choice(N, K[i], replace=False)] = rng.randn(K[i])
    ys = xt @ A.T
    alphas = 10.0 ** rng.uniform(-2.5, -0.5, S)
    st, sj = _schedulers(A, ys[0], batch_size=4, chunk_iters=50, niter_max=1500, rtol=0.0,
                         atol=1e-9)
    stream = lambda: ({(0, "y"): ys[i], (1, "alpha"): np.float64(alphas[i])} for i in range(S))
    jax_host = sj.run(stream())
    assert len({r.iterations for r in jax_host}) > 3
    _same(st.run(stream()), jax_host)
    _same(st.run_compiled(stream()), jax_host)


def test_run_compiled_budget_and_empty():
    rng = np.random.RandomState(4)
    A = rng.randn(8, 16)
    ys = rng.randn(5, 8)
    st, sj = _schedulers(A, ys[0], batch_size=2, chunk_iters=50, niter_max=100, rtol=0.0)
    res = st.run_compiled({(0, "y"): ys[i]} for i in range(5))
    assert len(res) == 5
    assert all(not r.converged for r in res)
    assert all(r.iterations == 100 for r in res)
    _same(res, sj.run({(0, "y"): ys[i]} for i in range(5)))
    assert st.run_compiled(iter([])) == []


def test_run_compiled_other_solve_kw_falls_back_to_run():
    """solve_kw the device-side drain does not carry (here chunked_checks)
    take the host loop."""
    rng = np.random.RandomState(6)
    A = rng.randn(8, 16)
    ys = rng.randn(5, 8)
    bs = BatchedSolver(_template(T, A, ys[0]), device="cpu")
    sched = ScenarioScheduler(bs, batch_size=2, chunk_iters=50, niter_max=100, rtol=0.0,
                              chunked_checks=True)
    calls = []
    run = sched.run
    sched.run = lambda scen: calls.append(1) or run(scen)
    res = sched.run_compiled({(0, "y"): ys[i]} for i in range(5))
    assert calls == [1] and len(res) == 5
    assert all(r.iterations == 100 for r in res)


def test_run_compiled_f32_solver_casts_scenarios():
    """float64 scenario values are cast into a float32 solver: the drain
    stays float32 and agrees with the host loop and the JAX package's."""
    rng = np.random.RandomState(7)
    A = rng.randn(8, 16)
    ys = rng.randn(4, 8)          # float64 scenario values
    st, sj = _schedulers(A, ys[0], dtype=torch.float32, batch_size=2, chunk_iters=50,
                         niter_max=100, rtol=0.0)
    stream = lambda: ({(0, "y"): ys[i]} for i in range(4))
    comp, host = st.run_compiled(stream()), st.run(stream())
    for a in comp + host:
        assert a.x[0].dtype == np.float32 and a.final_mu.dtype == np.float32
    _same(comp, host, atol=1e-6)
    _same(comp, sj.run(stream()), atol=1e-5)


def test_run_compiled_mu0():
    """Two schedulers with different mu0 on one solver start their lanes
    from their own penalty: different final penalties, and each equals the
    JAX package's scheduler with the same mu0."""
    rng = np.random.RandomState(8)
    A = rng.randn(8, 16)
    ys = rng.randn(3, 8)
    bs = BatchedSolver(_template(T, A, ys[0]), device="cpu")
    bj = JaxBatched(_template(J, A, ys[0]))
    scen = lambda: ({(0, "y"): ys[i]} for i in range(3))
    kw = dict(batch_size=2, chunk_iters=50, niter_max=100, rtol=0.0)
    r1 = ScenarioScheduler(bs, mu0=1.0, **kw).run_compiled(scen())
    r10 = ScenarioScheduler(bs, mu0=10.0, **kw).run_compiled(scen())
    assert not np.allclose(r1[0].final_mu, r10[0].final_mu)
    _same(r1, JaxScheduler(bj, mu0=1.0, **kw).run(scen()))
    _same(r10, JaxScheduler(bj, mu0=10.0, **kw).run(scen()))


def test_run_compiled_across_program_keys():
    """Streams of two lengths and two chunk lengths on one solver take
    three keys of the wave program; each run equals the host loop and the
    JAX package's, a program of a new key drops the other's stacks (the
    solver keeps one stream program), and mu0 is a value of the program,
    not part of its key."""
    rng = np.random.RandomState(9)
    A = rng.randn(10, 20)
    ys = rng.randn(9, 10)
    bt = BatchedSolver(_template(T, A, ys[0]), device="cpu")
    bj = JaxBatched(_template(J, A, ys[0]))
    kw = dict(batch_size=3, niter_max=400, rtol=1e-8)
    stream = lambda S: ({(0, "y"): ys[i]} for i in range(S))
    streams = lambda: [k for k in bt._programs if k[0] == "stream"]
    seen = []
    for S, chunk, mu0 in ((9, 50, 1.0), (7, 50, 1.0), (9, 40, 1.0), (9, 50, 1.0), (9, 50, 4.0)):
        st = ScenarioScheduler(bt, chunk_iters=chunk, mu0=mu0, **kw)
        sj = JaxScheduler(bj, chunk_iters=chunk, mu0=mu0, **kw)
        comp = st.run_compiled(stream(S))
        _same(comp, sj.run(stream(S)))
        _same(comp, st.run(stream(S)))
        (key,) = streams()
        seen.append((key, bt._programs[key]))
    keys = [key for key, _ in seen]
    assert len(set(keys)) == 3 and keys[0] == keys[3] == keys[4]
    # the first key's program was dropped for the second and made anew
    assert seen[3][1] is not seen[0][1] and seen[4][1] is seen[3][1]
