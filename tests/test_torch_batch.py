"""The port's BatchedSolver against admmsolver_tpu's, on the CPU in float64.

Every case builds one model in the JAX package, carries it over with
``interop.from_jax_model`` and sends the same numpy inputs through both
``BatchedSolver``s.  Trajectories agree: x and h to 1e-9, penalties to rtol
1e-12, equal iteration counts and convergence flags, residual histories to
rtol 1e-6 (atol 1e-12, as tests/test_batch.py compares them) with NaN in the
same places.  The port's histories are float64 like the JAX package's.  The
cases mirror tests/test_batch.py and tests/test_batch_workloads.py; what
needs an objective the port does not have (PSD, complex data) is left out.
"""
import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import spm_model as jax_spm_model
from admmsolver_tpu.models.applications import synthetic_spm_data
from admmsolver_tpu.parallel import BatchedSolver as JaxBatched
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.parallel import BatchedSolver, BatchResult

torch.set_num_threads(1)


def _bp(P, A, y0, alpha0=0.1):
    N = A.shape[1]
    return P.Model([P.LeastSquares(1.0, A, y0), P.L1Regularizer(alpha0, N)],
                   [(1, 0, P.identity(N), P.identity(N))])


def _three_block(P, A, y0):
    N = A.shape[1]
    I = P.identity(N)
    return P.Model([P.LeastSquares(1.0, A, y0), P.L1Regularizer(0.1, N),
                    P.NonNegativePenalty(N)], [(1, 0, I, I), (2, 0, I, I)])


def _cls(P, A, y0):
    N = A.shape[1]
    I = P.identity(N)
    return P.Model([P.ConstrainedLeastSquares(1.0, A, y0, np.ones((1, N)), np.ones(1)),
                    P.L1Regularizer(0.05, N), P.NonNegativePenalty(N)],
                   [(1, 0, I, I), (2, 0, I, I)])


def _solvers(jm, **kw):
    return JaxBatched(jm, **kw), BatchedSolver(interop.from_jax_model(jm, device="cpu"),
                                               device="cpu", **kw)


def _assert_same(rt: BatchResult, rj, xtol=1e-9, histories=True):
    assert len(rt.x) == len(rj.x) and len(rt.h) == len(rj.h)
    for a, b in zip(rt.x + rt.h, tuple(rj.x) + tuple(rj.h)):
        assert tuple(a.shape) == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=xtol)
    np.testing.assert_allclose(rt.mu.numpy(), np.asarray(rj.mu), rtol=1e-12)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    for a, b in ((rt.primal_residual, rj.primal_residual),
                 (rt.dual_residual, rj.dual_residual)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        if histories:
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


def _data(seed, M, N, B):
    rng = np.random.RandomState(seed)
    return rng, rng.randn(M, N), rng.randn(B, M)


# ---------------------------------------------------------------------
# parity of plain solves
# ---------------------------------------------------------------------

@pytest.mark.parametrize("model", ["two_block", "three_block"])
@pytest.mark.parametrize("chunked", [False, True], ids=["per_iteration", "chunked_checks"])
def test_batched_matches_jax(model, chunked):
    """Two- and three-block models, y and alpha per lane, through several
    penalty updates, with and without chunked checks."""
    _, A, ys = _data(7, 12, 30, 4)
    alphas = np.linspace(0.05, 0.5, 4)
    jm = _bp(J, A, ys[0]) if model == "two_block" else _three_block(J, A, ys[0])
    bj, bt = _solvers(jm)
    kw = dict(niter=230, interval_update_mu=20, chunked_checks=chunked)
    ov = {(0, "y"): ys, (1, "alpha"): alphas}
    _assert_same(bt.solve(ov, **kw), bj.solve(ov, **kw))


@pytest.mark.parametrize("lane", range(4))
def test_batched_matches_single(lane):
    """Every lane of a batched solve reproduces the port's single-instance
    engine (tests/test_batch.py:25)."""
    _, A, ys = _data(7, 12, 30, 4)
    alphas = np.linspace(0.05, 0.5, 4)
    res = BatchedSolver(_bp(T, A, ys[0], float(alphas[0])), device="cpu").solve(
        {(0, "y"): ys, (1, "alpha"): alphas}, niter=200)
    o = T.SimpleOptimizer(_bp(T, A, ys[lane], float(alphas[lane])), device="cpu")
    o.solve(200)
    np.testing.assert_allclose(res.x[0][lane].numpy(), o.x[0].numpy(), atol=1e-9)
    nit = int(res.iterations[lane])
    assert nit == o.iterations
    np.testing.assert_allclose(res.primal_residual[lane].numpy()[:nit],
                               o.primal_residual_history, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(res.mu[lane].numpy(), o.mu.numpy(), rtol=1e-12)


def test_per_lane_convergence_masking():
    """Lanes that converge early freeze while others keep iterating
    (tests/test_batch.py:52)."""
    rng = np.random.RandomState(3)
    A = rng.randn(4, 2)
    ys = np.stack([0.1 * A @ np.ones(2), 10 * rng.randn(4)])
    ov = {(0, "y"): ys, (1, "alpha"): np.array([1e-3, 10.0])}
    bj, bt = _solvers(_bp(J, A, ys[0]))
    rt = bt.solve(ov, niter=3000, rtol=1e-8)
    _assert_same(rt, bj.solve(ov, niter=3000, rtol=1e-8))
    it0, it1 = rt.iterations.tolist()
    assert it0 != it1 and bool(rt.converged.all())
    early, late = (0, it0) if it0 < it1 else (1, it1)
    hist = rt.primal_residual[early].numpy()
    assert np.isnan(hist[late:]).all() and np.isfinite(hist[:late]).all()


def test_lambda_path_sweep():
    """Only alpha per lane: larger L1 penalties give sparser solutions
    (tests/test_batch.py:74)."""
    rng = np.random.RandomState(11)
    A = rng.randn(16, 40)
    xtrue = np.zeros(40)
    xtrue[:4] = rng.randn(4)
    ov = {(1, "alpha"): np.logspace(-3, 1.0, 8)}
    bj, bt = _solvers(_bp(J, A, A @ xtrue))
    rt = bt.solve(ov, niter=500)
    _assert_same(rt, bj.solve(ov, niter=500))
    nnz = (rt.x[1].abs() > 1e-6).sum(1).tolist()
    assert nnz[0] >= nnz[-1] and nnz[-1] <= 8


@pytest.mark.parametrize("mu0_kind", ["lanes", "lanes_by_pairs", "scalar"])
def test_x0_mu0_batched(mu0_kind):
    """Warm starts: complex x0 with a zero imaginary part is accepted, mu0
    as a scalar, (B,) or (B, npairs) (tests/test_batch.py:91)."""
    rng, A, ys = _data(5, 6, 10, 3)
    x0 = tuple((0.1 * rng.randn(3, 10)).astype(np.complex128) for _ in range(2))
    h0 = (0.1 * rng.randn(3, 10),)
    mu0 = {"lanes": np.array([0.5, 1.0, 2.0]),
           "lanes_by_pairs": np.array([[0.5], [1.0], [2.0]]), "scalar": 0.7}[mu0_kind]
    kw = dict(x0=x0, h0=h0, mu0=mu0, niter=50, interval_update_mu=1000)
    bj, bt = _solvers(_bp(J, A, ys[0]))
    rt = bt.solve({(0, "y"): ys}, **kw)
    _assert_same(rt, bj.solve({(0, "y"): ys}, **kw))
    assert rt.x[0].dtype == torch.float64


def test_complex_state_into_real_solve_raises():
    rng, A, ys = _data(5, 6, 10, 3)
    bt = BatchedSolver(_bp(T, A, ys[0]), device="cpu")
    x0 = tuple(np.full((3, 10), 1j) for _ in range(2))
    with pytest.raises(TypeError, match="discard its imaginary part"):
        bt.solve({(0, "y"): ys}, x0=x0, niter=5)
    with pytest.raises(ValueError, match="x0 needs shapes"):
        bt.solve({(0, "y"): ys}, x0=(np.zeros((2, 10)), np.zeros((3, 10))), niter=5)
    with pytest.raises(ValueError, match="mu0 has 2 lanes"):
        bt.solve({(0, "y"): ys}, mu0=np.ones(2), niter=5)


def test_three_block_lanes_match_single():
    """tests/test_batch.py:110, inside the port."""
    _, A, ys = _data(9, 10, 12, 3)
    res = BatchedSolver(_three_block(T, A, ys[0]), device="cpu").solve(
        {(0, "y"): ys}, niter=300)
    for b in range(3):
        o = T.SimpleOptimizer(_three_block(T, A, ys[b]), device="cpu")
        o.solve(300)
        for k in range(3):
            np.testing.assert_allclose(res.x[k][b].numpy(), o.x[k].numpy(), atol=1e-9)
        assert int(res.iterations[b]) == o.iterations
    assert float(res.x[2].min()) >= 0.0


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_override_validation(package):
    """Both packages refuse the same overrides with the same words
    (tests/test_batch.py:151)."""
    rng = np.random.RandomState(0)
    A = rng.randn(4, 6)
    bj, bt = _solvers(_bp(J, A, rng.randn(4)))
    bs = bj if package == "jax" else bt
    with pytest.raises(ValueError, match="no batchable field 'y'; available: "
                                         r"\('alpha', 'offset'\)"):
        bs.solve({(1, "y"): rng.randn(3, 4)}, niter=5)
    with pytest.raises(ValueError, match=r"inconsistent batch sizes: 3 vs 5 for override "
                                         r"\(1, 'alpha'\)"):
        bs.solve({(0, "y"): rng.randn(3, 4), (1, "alpha"): np.ones(5)}, niter=5)
    with pytest.raises(ValueError, match="batch size is undetermined"):
        bs.solve({}, niter=5)
    with pytest.raises(ValueError, match="must have a leading batch axis, got a scalar"):
        bs.solve({(1, "alpha"): 0.1}, batch_size=3, niter=5)
    with pytest.raises(ValueError, match="batch_size=2 != override batch 3"):
        bs.solve({(0, "y"): rng.randn(3, 4)}, batch_size=2, niter=5)
    with pytest.raises(ValueError, match="niter must be positive"):
        bs.solve({(0, "y"): rng.randn(3, 4)}, niter=0)


def test_clone_with_rejects_unknown_fields():
    """The objectives' own guard, with the JAX package's words."""
    rng = np.random.RandomState(0)
    for P in (J, T):
        ls = P.LeastSquares(1.0, rng.randn(4, 6), rng.randn(4))
        assert ls.batch_fields == ("alpha", "y", "Acy", "A")
        with pytest.raises(ValueError, match=r"has no batchable fields \['C'\]; available"):
            ls.clone_with(C=np.ones(3))
        with pytest.raises(ValueError, match="accepts no batch overrides"):
            P.NonNegativePenalty(6)._apply_updates({"alpha": 1.0})
        assert P.NonNegativePenalty(6).batch_fields == ()
        assert P.L1Regularizer(0.1, 6).batch_fields == ("alpha", "offset")
        assert P.L2Regularizer(0.1, rng.randn(3, 6)).batch_fields == ("alpha",)
    assert T.ConstrainedLeastSquares.batch_fields == J.ConstrainedLeastSquares.batch_fields


def test_empty_overrides_with_batch_size():
    """Identical lanes via batch_size= only (tests/test_batch.py:164)."""
    rng = np.random.RandomState(2)
    A, y = rng.randn(6, 8), rng.randn(6)
    bj, bt = _solvers(_bp(J, A, y))
    rt = bt.solve(batch_size=3, niter=100)
    _assert_same(rt, bj.solve(batch_size=3, niter=100))
    assert torch.equal(rt.x[0][0], rt.x[0][2])


def test_chunked_checks_identical_at_fixed_iterations():
    """With no early exit possible the sweep-only iterations give the same
    bits as the checked ones (tests/test_batch.py:177); the budget ends
    inside a chunk."""
    _, A, ys = _data(13, 12, 30, 4)
    bt = BatchedSolver(_bp(T, A, ys[0]), device="cpu")
    r1 = bt.solve({(0, "y"): ys}, niter=250, rtol=0.0)
    r2 = bt.solve({(0, "y"): ys}, niter=250, rtol=0.0, chunked_checks=True)
    assert torch.equal(r1.x[0], r2.x[0]) and torch.equal(r1.mu, r2.mu)
    assert r2.iterations.tolist() == [250] * 4
    # one history sample per chunk boundary: iterations 0, 100, 200
    filled = (~torch.isnan(r2.primal_residual[0])).nonzero().ravel().tolist()
    assert filled == [0, 100, 200]


def test_chunked_checks_converges():
    """tests/test_batch.py:193: convergence granularity is the interval."""
    _, A, ys = _data(14, 12, 30, 3)
    bj, bt = _solvers(_bp(J, A, ys[0]))
    kw = dict(niter=5000, atol=1e-8, chunked_checks=True)
    rt = bt.solve({(0, "y"): ys}, **kw)
    _assert_same(rt, bj.solve({(0, "y"): ys}, **kw))
    assert bool(rt.converged.all())
    assert (rt.iterations.numpy() % 100 <= 1).all()


def test_record_residuals_off():
    rng, A, ys = _data(1, 4, 6, 2)
    bj, bt = _solvers(_bp(J, A, ys[0]))
    rt = bt.solve({(0, "y"): ys}, niter=50, record_residuals=False)
    _assert_same(rt, bj.solve({(0, "y"): ys}, niter=50, record_residuals=False),
                 histories=False)
    assert tuple(rt.primal_residual.shape) == (2, 1)
    assert int(rt.iterations.max()) <= 50


def test_record_residuals_strided():
    """record_residuals=s records ceil(niter/s) samples; slot k holds the
    last in-window value (tests/test_batch.py:287)."""
    _, A, ys = _data(3, 10, 20, 3)
    bj, bt = _solvers(_bp(J, A, ys[0]))
    full = bt.solve({(0, "y"): ys}, niter=100, rtol=0)
    strided = bt.solve({(0, "y"): ys}, niter=100, rtol=0, record_residuals=7)
    _assert_same(strided, bj.solve({(0, "y"): ys}, niter=100, rtol=0, record_residuals=7))
    nslots = -(-100 // 7)
    assert tuple(strided.primal_residual.shape) == (3, nslots)
    for k in range(nslots):
        last = min((k + 1) * 7 - 1, 99)
        assert torch.equal(strided.primal_residual[:, k], full.primal_residual[:, last])
    assert torch.equal(strided.x[0], full.x[0])
    with pytest.raises(ValueError, match="stride must be >= 1"):
        bt.solve({(0, "y"): ys}, niter=10, record_residuals=0)


def test_done0_freezes_lanes():
    """done0 lanes keep their initial state, execute 0 iterations and do not
    hold up the exit (tests/test_batch.py:314)."""
    rng, A, ys = _data(4, 10, 20, 4)
    x0 = tuple(rng.randn(4, 20) for _ in range(2))
    done0 = np.array([False, True, False, True])
    bj, bt = _solvers(_bp(J, A, ys[0]))
    kw = dict(x0=x0, niter=50, rtol=0, done0=done0)
    rt = bt.solve({(0, "y"): ys}, **kw)
    _assert_same(rt, bj.solve({(0, "y"): ys}, **kw))
    assert rt.iterations.tolist() == [50, 0, 50, 0]
    np.testing.assert_array_equal(rt.x[0][1].numpy(), x0[0][1])
    assert rt.converged.tolist() == [False, True, False, True]
    # all lanes parked: nothing runs
    none = bt.solve({(0, "y"): ys}, x0=x0, niter=50, done0=np.ones(4, bool))
    assert none.iterations.tolist() == [0] * 4
    with pytest.raises(ValueError, match="done0 has shape"):
        bt.solve({(0, "y"): ys}, niter=5, done0=done0[:3])


def test_penalty_knobs_passthrough():
    """fact_incr/th_change/max_mu reach the penalty update
    (tests/test_batch.py:333)."""
    rng = np.random.RandomState(5)
    A, y = rng.randn(8, 16), rng.randn(8)
    bj, bt = _solvers(_bp(J, A, y))
    base = bt.solve({(0, "y"): y[None]}, niter=2, rtol=0)
    assert torch.all(base.mu == 1.0)
    kw = dict(niter=2, rtol=0, fact_incr=8.0, th_change=1.0 + 1e-9)
    tuned = bt.solve({(0, "y"): y[None]}, **kw)
    _assert_same(tuned, bj.solve({(0, "y"): y[None]}, **kw))
    assert float(tuned.mu) in (8.0, 0.125)
    capped = bt.solve({(0, "y"): y[None]}, max_mu=0.05, **kw)
    assert float(capped.mu) == 0.05


@pytest.mark.parametrize("case", ["update_h_off", "relax", "l1_offset", "l2_alpha",
                                  "diag_coupling", "uncoupled_block", "float32"])
def test_other_knobs_and_objectives_match_jax(case):
    """update_h=False, over-relaxation, a per-lane L1 offset, a per-lane
    L2Regularizer weight, a diagonal coupling (per-lane diagonal penalty, no
    spectral path), a quadratic block without couplings (zero penalty, full
    eigenbasis), and a float32 solve."""
    rng, A, ys = _data(21, 8, 14, 3)
    N, I = 14, J.identity(14)
    kw, ov, jm, xtol, skw = dict(niter=120, interval_update_mu=10), {(0, "y"): ys}, None, 1e-9, {}
    if case == "update_h_off":
        kw["update_h"] = False
    elif case == "relax":
        kw["relax"] = 1.5
    elif case == "l1_offset":
        jm = J.Model([J.LeastSquares(1.0, A, ys[0]), J.L1Regularizer(0.1, N, 0.1 * np.ones(N))],
                     [(1, 0, I, I)])
        ov[(1, "offset")] = 0.2 * rng.randn(3, N)
    elif case == "l2_alpha":
        jm = J.Model([J.LeastSquares(1.0, A, ys[0]), J.L2Regularizer(0.3, rng.randn(5, N))],
                     [(1, 0, I, I)])
        ov[(1, "alpha")] = np.array([0.1, 0.5, 2.0])
        ov[(0, "alpha")] = np.array([1.0, 2.0, 0.5])
    elif case == "diag_coupling":
        import jax.numpy as jnp
        jm = J.Model([J.LeastSquares(1.0, A, ys[0]), J.L1Regularizer(0.1, N)],
                     [(1, 0, I, J.DiagonalMatrix(jnp.asarray(rng.uniform(0.5, 2.0, N))))])
    elif case == "uncoupled_block":
        jm = J.Model([J.LeastSquares(1.0, A, ys[0]), J.L1Regularizer(0.1, N),
                      J.LeastSquares(1.0, rng.randn(9, 5), rng.randn(9))], [(1, 0, I, I)])
    elif case == "float32":
        skw, xtol = dict(dtype=np.float32), 2e-4
    bj, bt = _solvers(jm or _bp(J, A, ys[0]), **skw)
    rt, rj = bt.solve(ov, **kw), bj.solve(ov, **kw)
    if case == "float32":
        assert rt.x[0].dtype == rt.h[0].dtype == rt.mu.dtype == torch.float32
        for a, b in zip(rt.x + rt.h, tuple(rj.x) + tuple(rj.h)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=xtol)
        np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    else:
        _assert_same(rt, rj, xtol)


def test_relax_needs_a_single_pair():
    _, A, ys = _data(9, 10, 12, 3)
    with pytest.raises(ValueError, match="single-pair"):
        BatchedSolver(_three_block(T, A, ys[0]), device="cpu").solve(
            {(0, "y"): ys}, niter=5, relax=1.5)


# ---------------------------------------------------------------------
# solve_path
# ---------------------------------------------------------------------

def test_solve_path_warm_started():
    """Same solutions as cold batched solves at a fraction of the iterations
    (tests/test_batch.py:235), and the JAX package's path lane for lane."""
    rng = np.random.RandomState(21)
    A = rng.randn(14, 40)
    xt = np.zeros(40)
    xt[:4] = rng.randn(4)
    lams = np.logspace(1, -3, 16)
    bj, bt = _solvers(_bp(J, A, A @ xt))
    cold = bt.solve({(1, "alpha"): lams}, niter=3000, rtol=1e-8)
    path = bt.solve_path((1, "alpha"), lams, group_size=4, niter=3000, rtol=1e-8)
    np.testing.assert_allclose(path.x[0].numpy(), cold.x[0].numpy(), atol=1e-5)
    assert int(path.iterations.sum()) < 0.7 * int(cold.iterations.sum())
    assert tuple(path.x[0].shape) == (16, 40)
    _assert_same(path, bj.solve_path((1, "alpha"), lams, group_size=4, niter=3000, rtol=1e-8))


def test_solve_path_requires_monotone_grid():
    rng = np.random.RandomState(6)
    A, y = rng.randn(8, 16), rng.randn(8)
    bt = BatchedSolver(_bp(T, A, y), device="cpu")
    shuffled = np.array([0.5, 0.01, 0.2, 0.1])
    ys = np.broadcast_to(y, (4, 8))
    with pytest.raises(ValueError, match="requires a monotone `values` grid"):
        bt.solve_path((1, "alpha"), shuffled, overrides={(0, "y"): ys}, group_size=2, niter=5)
    # one group needs no warm start and takes any order
    bt.solve_path((1, "alpha"), shuffled, overrides={(0, "y"): ys}, niter=5)
    res = bt.solve_path((1, "alpha"), np.sort(shuffled)[::-1], overrides={(0, "y"): ys},
                        group_size=2, niter=5, rtol=0, record_residuals=False)
    assert tuple(res.x[0].shape) == (4, 16)
    with pytest.raises(ValueError, match=r"must be per-value \(length 4\)"):
        bt.solve_path((1, "alpha"), np.sort(shuffled), overrides={(0, "y"): ys[:3]},
                      group_size=2, niter=5)


@pytest.mark.parametrize("nlam", [12, 11], ids=["divisible", "ragged"])
def test_solve_path_fused_matches_loop(nlam):
    """fused=True (last group padded by its final value, then trimmed)
    against the plain group loop, and against the JAX package
    (tests/test_batch.py:383)."""
    rng = np.random.RandomState(33)
    A = rng.randn(10, 24)
    y = A @ np.concatenate([rng.randn(3), np.zeros(21)])
    lams = np.logspace(0.5, -2, nlam)
    kw = dict(overrides={(0, "y"): np.broadcast_to(y, (nlam, 10))}, group_size=4,
              niter=400, rtol=1e-9)
    bj, bt = _solvers(_bp(J, A, y))
    loop = bt.solve_path((1, "alpha"), lams, fused=False, **kw)
    fused = bt.solve_path((1, "alpha"), lams, fused=True, **kw)
    np.testing.assert_allclose(fused.x[0].numpy(), loop.x[0].numpy(), atol=1e-12)
    assert torch.equal(fused.iterations, loop.iterations)
    assert torch.equal(fused.mu, loop.mu)
    np.testing.assert_allclose(fused.primal_residual.numpy(), loop.primal_residual.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert tuple(fused.x[0].shape) == (nlam, 24)
    _assert_same(fused, bj.solve_path((1, "alpha"), lams, fused=True, **kw))


def test_solve_path_strided_recording():
    rng = np.random.RandomState(34)
    A, y = rng.randn(8, 16), rng.randn(8)
    kw = dict(overrides={(0, "y"): np.broadcast_to(y, (8, 8))}, group_size=4, niter=40,
              rtol=0, record_residuals=10)
    bj, bt = _solvers(_bp(J, A, y))
    res = bt.solve_path((1, "alpha"), np.logspace(0, -1, 8), **kw)
    assert tuple(res.primal_residual.shape) == (8, 4)
    assert bool(torch.isfinite(res.primal_residual).all())
    _assert_same(res, bj.solve_path((1, "alpha"), np.logspace(0, -1, 8), **kw))


# ---------------------------------------------------------------------
# per-instance operators, solve_scan
# ---------------------------------------------------------------------

@pytest.mark.parametrize("model", ["least_squares", "constrained"])
def test_per_instance_A_matches_jax_and_independent_solves(model):
    """A different dense A per lane (tests/test_batch.py:434, :453): per-lane
    dense factors; each lane matches the JAX package and its own
    SimpleOptimizer run; the constrained block keeps every lane's sum rule."""
    rng = np.random.RandomState(22)
    M, N, B = 7, 9, 3
    As, ys = rng.randn(B, M, N), rng.randn(B, M)
    mk = (lambda P, A, y: _bp(P, A, y)) if model == "least_squares" else _cls
    bj, bt = _solvers(mk(J, As[0], ys[0]))
    ov = {(0, "A"): As, (0, "y"): ys}
    rt = bt.solve(ov, niter=120)
    _assert_same(rt, bj.solve(ov, niter=120))
    for b in range(B):
        o = T.SimpleOptimizer(mk(T, As[b], ys[b]), device="cpu")
        o.solve(120)
        for k in range(len(rt.x)):
            np.testing.assert_allclose(rt.x[k][b].numpy(), o.x[k].numpy(), atol=1e-9)
    if model == "constrained":
        np.testing.assert_allclose(rt.x[0].numpy().sum(1), 1.0, atol=1e-8)
    # A alone: A†y comes from the template's y and every lane's own A
    only_A = bt.solve({(0, "A"): As}, niter=30)
    _assert_same(only_A, bj.solve({(0, "A"): As}, niter=30))


def test_per_instance_A_guards():
    """tests/test_batch.py:486, with the JAX package's messages."""
    rng = np.random.RandomState(23)
    A = rng.randn(4, 6)
    bt = BatchedSolver(_bp(T, A, rng.randn(4)), device="cpu")
    with pytest.raises(ValueError, match=r"must be \(B, 4, 6\) matching the template"):
        bt.solve({(0, "A"): rng.randn(2, 4, 7)}, niter=5)
    bt2 = BatchedSolver(_bp(T, rng.randn(4, 200), rng.randn(4)), device="cpu")
    with pytest.raises(ValueError, match=r"limited to blocks with n <= 128 \(block 0 has "
                                         "n=200\\).*use solve_scan"):
        bt2.solve({(0, "A"): rng.randn(2, 4, 200)}, niter=5)
    # solve_scan takes them, one group's factors at a time
    res = bt2.solve_scan({(0, "A"): rng.randn(3, 4, 200), (0, "y"): rng.randn(3, 4)},
                         group_size=2, niter=12)
    assert tuple(res.x[0].shape) == (3, 200) and bool(torch.isfinite(res.x[0]).all())
    assert not torch.allclose(res.x[0][0], res.x[0][1])


@pytest.mark.parametrize("group_size,B", [(2, 5), (2, 4), (1, 3), (8, 5)])
def test_solve_scan_matches_solve(group_size, B):
    """Where both solve and solve_scan apply they agree lane for lane, also when the last
    group is shorter (TestSolveScan in tests/test_batch.py)."""
    rng = np.random.RandomState(30)
    As, ys = rng.randn(B, 8, 12), rng.randn(B, 8)
    bt = BatchedSolver(_bp(T, As[0], ys[0]), device="cpu")
    ov = {(0, "A"): As, (0, "y"): ys}
    a = bt.solve(ov, niter=150, record_residuals=False)
    b = bt.solve_scan(ov, group_size=group_size, niter=150)
    for xa, xb in zip(a.x + a.h, b.x + b.h):
        np.testing.assert_allclose(xa.numpy(), xb.numpy(), rtol=0, atol=1e-12)
    assert torch.equal(a.iterations, b.iterations)
    np.testing.assert_allclose(a.mu.numpy(), b.mu.numpy())
    assert tuple(b.primal_residual.shape) == (B, 1)


def test_solve_scan_matches_jax_with_warm_start_and_histories():
    rng = np.random.RandomState(32)
    B = 5
    As, ys = rng.randn(B, 6, 10), rng.randn(B, 6)
    bj, bt = _solvers(_bp(J, As[0], ys[0]))
    ov = {(0, "A"): As, (0, "y"): ys}
    kw = dict(group_size=2, niter=60, mu0=np.linspace(0.5, 2.0, B), record_residuals=True,
              x0=tuple(0.1 * rng.randn(B, 10) for _ in range(2)))
    _assert_same(bt.solve_scan(ov, **kw), bj.solve_scan(ov, **kw))
    with pytest.raises(ValueError, match="solve_scan needs overrides"):
        bt.solve_scan({}, niter=5)
    with pytest.raises(TypeError, match="unexpected keyword"):
        bt.solve_scan(ov, niter=5, dtype=torch.float32)


# ---------------------------------------------------------------------
# workloads, configuration, recipes, state hand-over
# ---------------------------------------------------------------------

@pytest.mark.parametrize("override_D", [False, True], ids=["y", "y_and_D"])
def test_batched_spm_per_frequency(override_D):
    """tests/test_batch_workloads.py:13: per-dataset SpM solves sharing the
    kernel (per-lane dense factors of a ConstrainedLeastSquares block,
    coupled through a dense projector); every lane keeps its sum rule and a
    nonnegative spectrum."""
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=16, nw=33, noise=1e-6)
    jm = jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-6)
    gs = np.stack([g + 1e-6 * np.random.RandomState(0).randn(g.size) for _ in range(4)])
    ov = {(0, "y"): gs}
    want = np.ones(4)
    if override_D:
        want = np.linspace(0.9, 1.2, 4)
        ov[(0, "D")] = want[:, None]
    bj, bt = _solvers(jm)
    rt = bt.solve(ov, mu0=0.1, niter=800)
    _assert_same(rt, bj.solve(ov, mu0=0.1, niter=800))
    np.testing.assert_allclose(rt.x[0].numpy() @ prj_sum, want, atol=1e-6)
    assert float(rt.x[2].min()) >= -1e-10


def test_config_loading(tmp_path):
    """tests/test_batch.py:257."""
    c = T.ADMMConfig.from_dict({"niter": 5, "max_mu": 10.0})
    assert c.niter == 5 and c.max_mu == 10.0
    assert c == T.ADMMConfig(niter=5, max_mu=10.0)
    with pytest.raises(ValueError, match=r"unknown ADMMConfig keys: \['bogus'\]"):
        T.ADMMConfig.from_dict({"bogus": 1})
    path = tmp_path / "cfg.yaml"
    path.write_text("niter: 7\nrelax: 1.5\n")
    try:
        import yaml  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="needs pyyaml"):
            T.ADMMConfig.from_yaml(str(path))
    else:
        assert T.ADMMConfig.from_yaml(str(path)) == T.ADMMConfig(niter=7, relax=1.5)


def test_recipe_rules():
    """recipe: unknown names raise; 'auto' is the plain solve; 'mixed' splits
    the budget 3/4 : 1/4 and reaches the plain solution, honours dtype=, and
    refuses a budget that cannot be split (tests/test_batch.py:697 runs that
    one plain)."""
    rng = np.random.RandomState(18)
    A = rng.randn(30, 80)
    xt = np.zeros((3, 80))
    for b in range(3):
        xt[b, rng.choice(80, 6, replace=False)] = rng.randn(6)
    ov = {(0, "y"): xt @ A.T}
    bt = BatchedSolver(_bp(T, A, ov[(0, "y")][0]), device="cpu")
    with pytest.raises(ValueError, match="recipe must be auto|plain|mixed"):
        bt.solve(ov, niter=10, recipe="fast")
    kw = dict(niter=400, rtol=0.0, record_residuals=False)
    plain = bt.solve(ov, recipe="plain", **kw)
    auto = bt.solve(ov, **kw)
    assert torch.equal(auto.x[0], plain.x[0])
    mixed = bt.solve(ov, recipe="mixed", **kw)
    assert mixed.x[0].dtype == torch.float64
    np.testing.assert_allclose(mixed.x[0].numpy(), plain.x[0].numpy(), atol=2e-5)
    assert mixed.iterations.tolist() == [400] * 3
    bt32 = BatchedSolver(_bp(T, A, ov[(0, "y")][0]), dtype=torch.float32, device="cpu")
    assert bt32.solve(ov, niter=40, record_residuals=False).x[0].dtype == torch.float32
    res = bt32.solve(ov, niter=40, dtype=torch.float64, recipe="mixed",
                     record_residuals=False)
    assert res.x[0].dtype == torch.float64
    with pytest.raises(ValueError, match="needs niter >= 2"):
        bt.solve(ov, niter=1, recipe="mixed")
    assert int(bt.solve(ov, niter=1).iterations.max()) == 1


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_state_hand_over_between_packages(direction):
    """A solve stopped in one package and continued in the other ends where
    the JAX package's two-segment solve ends."""
    _, A, ys = _data(41, 10, 18, 3)
    bj, bt = _solvers(_three_block(J, A, ys[0]))
    ov = {(0, "y"): ys}
    first_j = bj.solve(ov, niter=60)
    want = bj.solve(ov, x0=first_j.x, h0=first_j.h, mu0=first_j.mu, niter=60)
    if direction == "jax_to_torch":
        state = interop.batch_state_from_numpy(
            [np.asarray(a) for a in first_j.x], [np.asarray(a) for a in first_j.h],
            np.asarray(first_j.mu), device="cpu")
        assert state["x0"][0].dtype == torch.float64
        _assert_same(bt.solve(ov, niter=60, **state), want)
    else:
        out = interop.batch_result_to_numpy(bt.solve(ov, niter=60))
        assert out["iterations"].dtype == np.int32 and out["converged"].dtype == bool
        assert out["primal_residual"].shape == (3, 60)
        got = bj.solve(ov, x0=out["x"], h0=out["h"], mu0=out["mu"], niter=60)
        for a, b in zip(tuple(got.x) + tuple(got.h), tuple(want.x) + tuple(want.h)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-9)
        np.testing.assert_array_equal(np.asarray(got.iterations), np.asarray(want.iterations))


def test_constructor_checks_and_exports():
    assert T.BatchedSolver is BatchedSolver and T.BatchResult is BatchResult
    with pytest.raises(TypeError, match="expected a Model"):
        BatchedSolver("model", device="cpu")
    rng = np.random.RandomState(0)
    bt = BatchedSolver(_bp(T, rng.randn(4, 6), rng.randn(4)), device="cpu")
    assert bt.dtype == torch.float64 and bt.device.type == "cpu"
    assert bt.sharding is None   # unsharded unless a sharding is given
    for name in ("solve", "solve_mixed", "solve_path", "solve_scan"):
        assert callable(getattr(bt, name))
