"""Parity of the port's added families with admmsolver_tpu: the box, Huber,
group-L1 and nuclear-norm proxes against the JAX package on the same numpy
inputs (float64; box, Huber and group L1 to 1e-13, the nuclear prox to
1e-10 relative: it compares U soft(s) Vᴴ, never the singular vectors), the
eager checks that refuse a non-uniform penalty, each builder's model through
``SimpleOptimizer`` and ``BatchedSolver`` in both packages (x, h, mu and the
residual histories to 1e-9·max|x| after 20 iterations at mu0 = 1), and
``interop.from_jax_model`` on every new objective and ``BandedMatrix``.
Oracles mirrored: tests/test_model_families.py, tests/test_contracts.py:30-66.
The repairs of earlier slices are here too: ``FusedSpMSolver`` takes
``tile_b``, and basis pursuit at ``mu0 = 0.1`` converges to the JAX
package's x."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models import applications as JA
from admmsolver_tpu.parallel import BatchedSolver as JBatched
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.models import applications as TA
from admmsolver_tpu_torch.optimizer import ADMMPlan
from admmsolver_tpu_torch.parallel import BatchedSolver, FusedSpMSolver

torch.set_num_threads(1)

EXACT = 1e-13
RUN_TOL = 1e-9


def _h_mu(n, seed, uniform=False):
    rng = np.random.RandomState(seed)
    h = 2.0 * rng.randn(n)
    mu = np.full(n, 1.3) if uniform else rng.uniform(0.5, 2.0, n)
    return h, mu


def _prox_pair(ft, fj, h, mu):
    got = ft.solve(torch.as_tensor(h), T.DiagonalMatrix(mu)).numpy()
    want = np.asarray(fj.solve(jnp.asarray(h), J.DiagonalMatrix(jnp.asarray(mu))))
    return got, want


@pytest.mark.parametrize("bounds", [(-0.3, 0.7), "vector"])
def test_box_prox_matches_jax(bounds):
    n = 9
    h, mu = _h_mu(n, 0)
    if bounds == "vector":
        rng = np.random.RandomState(1)
        bounds = (-np.abs(rng.randn(n)), np.abs(rng.randn(n)))
    got, want = _prox_pair(T.BoxProjectionPenalty(n, *bounds), J.BoxProjectionPenalty(n, *bounds),
                           h, mu)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    np.testing.assert_allclose(got, np.clip(-h / mu, *bounds), rtol=0, atol=EXACT)
    with pytest.raises(ValueError, match="empty box"):
        T.BoxProjectionPenalty(3, 1.0, 0.0)
    with pytest.raises(ValueError, match="neither a scalar"):
        T.BoxProjectionPenalty(3, np.zeros(2), 1.0)


def test_box_batched_bounds_per_lane():
    """(B,) overrides are one bound a lane, (B, n) per coordinate."""
    n, B = 6, 3
    rng = np.random.RandomState(2)
    h = rng.randn(B, n) * 2
    mu = np.full((B, n), 1.5)
    f = T.BoxProjectionPenalty(n, -0.5, 0.5)
    lo = np.array([-0.1, -0.2, -0.3])
    hi = rng.uniform(0.1, 1.0, (B, n))
    got = f.clone_with(lo=lo, hi=hi).prox_diag(torch.as_tensor(h), torch.as_tensor(mu),
                                               batched=True).numpy()
    np.testing.assert_allclose(got, np.clip(-h / mu, lo[:, None], hi), rtol=0, atol=EXACT)


@pytest.mark.parametrize("delta", [0.1, 1.0, 10.0])
def test_huber_prox_and_value_match_jax(delta):
    n = 12
    h, mu = _h_mu(n, 3)
    y = np.random.RandomState(4).randn(n)
    ft, fj = T.HuberLoss(0.8, y, delta), J.HuberLoss(0.8, y, delta)
    got, want = _prox_pair(ft, fj, h, mu)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    x = np.random.RandomState(5).randn(n) * 3
    assert abs(ft(torch.as_tensor(x)) - float(fj(jnp.asarray(x)))) <= EXACT * abs(float(fj(x)))
    # batched alpha and y per lane
    ys = np.stack([y, -y])
    hb, mub = np.stack([h, 0.5 * h]), np.stack([mu, mu])
    got_b = ft.clone_with(alpha=np.array([0.8, 2.0]), y=ys).prox_diag(
        torch.as_tensor(hb), torch.as_tensor(mub), batched=True).numpy()
    for b, a in enumerate((0.8, 2.0)):
        want_b = np.asarray(J.HuberLoss(a, ys[b], delta).prox_diag(jnp.asarray(hb[b]),
                                                                    jnp.asarray(mub[b])))
        np.testing.assert_allclose(got_b[b], want_b, rtol=0, atol=EXACT)


def test_group_l1_prox_value_and_checks():
    gs, ng = 3, 5
    n = gs * ng
    rng = np.random.RandomState(2)
    h = rng.randn(n) * np.repeat([2.0, 0.1, 2.0, 0.05, 1.0], gs)
    mu = np.repeat(rng.uniform(0.5, 2.0, ng), gs)                 # blockwise uniform
    ft, fj = T.GroupL1Regularizer(0.8, gs, ng), J.GroupL1Regularizer(0.8, gs, ng)
    got, want = _prox_pair(ft, fj, h, mu)
    np.testing.assert_allclose(got, want, rtol=0, atol=EXACT)
    assert (np.abs(got.reshape(ng, gs)).sum(1) == 0).any()          # a group set to zero
    assert np.isclose(T.GroupL1Regularizer(2.0, 2, 2)(torch.tensor([3.0, 4.0, 0.0, 0.0])), 10.0)
    with pytest.raises(ValueError, match="blockwise-uniform"):
        T.GroupL1Regularizer(1.0, 2, 2).solve(torch.zeros(4), T.DiagonalMatrix(
            np.array([1.0, 2.0, 1.0, 1.0])))
    # batched: per-lane alpha
    hb = np.stack([h, -h])
    mub = np.stack([mu, 2 * mu])
    got_b = ft.clone_with(alpha=np.array([0.8, 0.3])).prox_diag(
        torch.as_tensor(hb), torch.as_tensor(mub), batched=True).numpy()
    for b, a in enumerate((0.8, 0.3)):
        want_b = np.asarray(J.GroupL1Regularizer(a, gs, ng).prox_diag(jnp.asarray(hb[b]),
                                                                       jnp.asarray(mub[b])))
        np.testing.assert_allclose(got_b[b], want_b, rtol=0, atol=EXACT)


@pytest.mark.parametrize("shape", [(5, 4), (3, 7), (6, 6)])
def test_nuclear_prox_matches_jax(shape):
    m, n = shape
    h, mu = _h_mu(m * n, 6, uniform=True)
    ft = T.NuclearNormPenalty(1.3, shape)
    fj = J.NuclearNormPenalty(1.3, shape, svd_method="xla")
    got, want = _prox_pair(ft, fj, h, mu)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    x = np.random.RandomState(7).randn(m * n)
    assert np.isclose(ft(torch.as_tensor(x)), float(fj(jnp.asarray(x))), rtol=1e-12)
    # batched: per-lane alpha and penalty
    hb = np.stack([h, 0.3 * h])
    mub = np.stack([mu, 2.0 * mu])
    got_b = ft.clone_with(alpha=np.array([1.3, 0.5])).prox_diag(
        torch.as_tensor(hb), torch.as_tensor(mub), batched=True).numpy()
    for b, a in enumerate((1.3, 0.5)):
        want_b = np.asarray(J.NuclearNormPenalty(a, shape, svd_method="xla").prox_diag(
            jnp.asarray(hb[b]), jnp.asarray(mub[b])))
        np.testing.assert_allclose(got_b[b], want_b, rtol=0, atol=1e-10 * np.abs(want_b).max())


def test_nuclear_checks_and_svd_methods():
    with pytest.raises(ValueError, match="uniform penalty"):
        T.NuclearNormPenalty(1.0, (2, 3)).solve(torch.zeros(6), T.DiagonalMatrix(
            np.r_[np.ones(3), 2 * np.ones(3)]))
    for method in ("auto", "xla", "gram", "sign"):     # every method of the JAX package
        assert T.NuclearNormPenalty(1.0, (2, 3), svd_method=method)._svd_method == method
    with pytest.raises(ValueError, match="unknown svd_method"):
        T.NuclearNormPenalty(1.0, (2, 3), svd_method="lapack")


@pytest.mark.parametrize("method,shape", [("gram", (8, 6)), ("gram", (5, 9)),
                                          ("sign", (24, 20)), ("sign", (18, 30))])
def test_nuclear_gram_and_sign_routes_match_jax(method, shape):
    """tests/test_model_families.py:281-305 and 587-610: the Gram-SVD and
    polar (sign) routes, each against the same route of the JAX package
    (1e-10 relative) and against the exact SVD (1e-9: the Gram route's
    sqrt(eps) floor and the sign route's delta·||X||_F floor sit in the
    threshold's dead zone), eagerly and batched with per-lane alpha and
    penalty; the value (the Gram singular values for both routes)."""
    m, n = shape
    h, mu = _h_mu(m * n, 13, uniform=True)
    ft = T.NuclearNormPenalty(0.9, shape, svd_method=method)
    fj = J.NuclearNormPenalty(0.9, shape, svd_method=method)
    got, want = _prox_pair(ft, fj, h, mu)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10 * np.abs(want).max())
    exact, _ = _prox_pair(T.NuclearNormPenalty(0.9, shape, svd_method="xla"), fj, h, mu)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-9)
    x = np.random.RandomState(7).randn(m * n)
    assert np.isclose(ft(torch.as_tensor(x)), float(fj(jnp.asarray(x))), rtol=1e-12)
    hb = np.stack([h, 0.3 * h])
    mub = np.stack([mu, 2.0 * mu])
    got_b = ft.clone_with(alpha=np.array([0.9, 0.4])).prox_diag(
        torch.as_tensor(hb), torch.as_tensor(mub), batched=True).numpy()
    for b, a in enumerate((0.9, 0.4)):
        want_b = np.asarray(J.NuclearNormPenalty(a, shape, svd_method=method).prox_diag(
            jnp.asarray(hb[b]), jnp.asarray(mub[b])))
        np.testing.assert_allclose(got_b[b], want_b, rtol=0, atol=1e-10 * np.abs(want_b).max())


def _rpca_data(m, n, seed):
    rng = np.random.RandomState(seed)
    L0 = rng.randn(m, 2) @ rng.randn(2, n)
    Ys = np.stack([L0, 0.5 * L0])
    mask = rng.rand(*Ys.shape) < 0.08
    Ys[mask] += 5.0 * rng.randn(int(mask.sum()))
    return Ys


@pytest.mark.parametrize("method", ["auto", "xla", "gram", "sign"])
def test_rpca_model_solves_per_method_match_jax(method):
    """rpca_model(svd_method=...) through BatchedSolver in both packages
    (per-lane Y through (1, "offset"), 60 iterations): x, h, mu and the
    residual histories to 1e-9·max|x|; and through SimpleOptimizer, at 8 x 6,
    the route's solve equals the exact-SVD solve to 5e-7 after 400
    iterations (tests/test_model_families.py:308-331)."""
    m, n = 12, 10
    Ys = _rpca_data(m, n, 14)
    ov = {(1, "offset"): Ys.reshape(2, -1)}
    rt = BatchedSolver(TA.rpca_model(Ys[0], svd_method=method), device="cpu").solve(ov, niter=60)
    rj = JBatched(JA.rpca_model(Ys[0], svd_method=method)).solve(
        {k: jnp.asarray(v) for k, v in ov.items()}, niter=60)
    _assert_batches_match(rt, rj)

    Y = _rpca_data(8, 6, 15)[0]

    def run(meth):
        o = T.SimpleOptimizer(TA.rpca_model(Y, svd_method=meth), device="cpu")
        o.solve(400)
        return o.x[0].numpy()
    np.testing.assert_allclose(run(method), run("xla"), rtol=0, atol=5e-7)


@pytest.mark.parametrize("method", ["auto", "xla", "gram", "sign"])
def test_from_jax_model_carries_the_svd_method(method):
    """interop.from_jax_model keeps the JAX model's svd_method and runs its
    trajectory."""
    Ys = _rpca_data(6, 5, 3)
    mj = JA.rpca_model(Ys[0], svd_method=method)
    mt = interop.from_jax_model(mj, device="cpu")
    assert mt.functions[0]._svd_method == method
    ot, oj = T.SimpleOptimizer(mt, device="cpu"), J.SimpleOptimizer(mj)
    ot.solve(20)
    oj.solve(20)
    _assert_runs_match(ot, oj)


def _ls(rng, M, N):
    A = rng.randn(M, N)
    return T.LeastSquares(1.0, A, A @ rng.randn(N))


@pytest.mark.parametrize("obj,diag,ok", [
    ("group", np.arange(1.0, 9.0), False),
    ("group", np.r_[np.full(4, 2.0), np.full(4, 3.0)], True),
    ("nuclear", np.r_[np.ones(3), 2 * np.ones(3)], False),
    ("nuclear", np.full(6, 2.0), True),
])
def test_uniform_penalty_contract_checked_at_plan_build(obj, diag, ok):
    """tests/test_contracts.py:30-66: the engine checks the group contract
    once, when the plan is built."""
    rng = np.random.RandomState(0)
    n = diag.size
    f = T.GroupL1Regularizer(1.0, 4, 2) if obj == "group" else T.NuclearNormPenalty(1.0, (2, 3))
    m = T.Model([_ls(rng, 6, n), f], [(1, 0, T.DiagonalMatrix(diag), T.identity(n))])
    if ok:
        ADMMPlan(m, "cpu")
    else:
        with pytest.raises(ValueError, match="constant within each group"):
            ADMMPlan(m, "cpu")


def _assert_runs_match(ot, oj, tol=RUN_TOL):
    scale = max(float(np.abs(np.asarray(x)).max()) for x in oj.x)
    for a, b in zip(list(ot.x) + list(ot.h), list(oj.x) + list(oj.h)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol * scale)
    np.testing.assert_allclose(ot.mu.numpy(), np.asarray(oj.mu), rtol=0, atol=tol * scale)
    assert ot.iterations == oj.iterations
    for a, b in ((ot.primal_residual_history, oj.primal_residual_history),
                 (ot.dual_residual_history, oj.dual_residual_history)):
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


def _assert_batches_match(rt, rj, tol=RUN_TOL):
    scale = max(float(np.abs(np.asarray(x)).max()) for x in rj.x)
    for a, b in zip(list(rt.x) + list(rt.h), list(rj.x) + list(rj.h)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol * scale)
    np.testing.assert_allclose(rt.mu.numpy(), np.asarray(rj.mu), rtol=0, atol=tol * scale)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    for a, b in ((rt.primal_residual, rj.primal_residual), (rt.dual_residual, rj.dual_residual)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol * scale)


def _family(name, P, A):
    """(model builder args in package P's module, batched overrides)."""
    rng = np.random.RandomState(21)
    B = 3
    apps = TA if P is T else JA
    if name == "bounded_lsq":
        A, y = rng.randn(16, 10), rng.randn(16)
        return apps.bounded_lsq_model(A, y, -0.2, 0.4), \
            {(0, "y"): y[None] + 0.1 * rng.randn(B, 16), (1, "hi"): np.array([0.4, 0.2, 1.0])}
    if name == "group_lasso":
        A, y = rng.randn(12, 16), rng.randn(12)
        return apps.group_lasso_model(A, y, 0.5, 4), \
            {(0, "y"): y[None] + 0.1 * rng.randn(B, 12), (1, "alpha"): np.array([0.5, 0.1, 2.0])}
    if name == "robust_regression":
        A, y = rng.randn(20, 8) / np.sqrt(20), rng.randn(20)
        return apps.robust_regression_model(A, y, delta=0.1), \
            {(1, "y"): y[None] + 0.5 * rng.randn(B, 20)}
    if name == "rpca":
        L0 = rng.randn(6, 2) @ rng.randn(2, 5)
        Y = L0 + (rng.rand(6, 5) < 0.1) * 4.0
        return apps.rpca_model(Y), {(1, "offset"): Y.reshape(1, -1) + 0.1 * rng.randn(B, 30)}
    if name == "portfolio":
        Q = rng.randn(8, 8)
        return apps.portfolio_model(Q @ Q.T / 8 + 0.1 * np.eye(8), rng.randn(8)), \
            {(0, "alpha"): np.array([1.0, 0.5, 2.0])}
    raise ValueError(name)


FAMILIES = ["bounded_lsq", "group_lasso", "robust_regression", "rpca", "portfolio"]


@pytest.mark.parametrize("name", FAMILIES)
def test_builder_runs_match_jax(name):
    mt, ov = _family(name, T, None)
    mj, _ = _family(name, J, None)
    ot, oj = T.SimpleOptimizer(mt, device="cpu"), J.SimpleOptimizer(mj)
    ot.solve(20)
    oj.solve(20)
    _assert_runs_match(ot, oj)
    rt = BatchedSolver(mt, device="cpu").solve(ov, niter=20)
    rj = JBatched(mj).solve({k: jnp.asarray(v) for k, v in ov.items()}, niter=20)
    _assert_batches_match(rt, rj)


def test_builders_reach_their_oracles():
    """Long solves against what each family guarantees: the box holds, the
    portfolio is on the simplex, the group lasso zeroes whole groups, RPCA
    recovers the low-rank part."""
    from scipy.optimize import lsq_linear

    rng = np.random.RandomState(0)
    A, y = rng.randn(20, 8), rng.randn(20)
    o = T.SimpleOptimizer(TA.bounded_lsq_model(A, y, 0.0, 0.5), device="cpu")
    o.solve(3000, rtol=1e-10)
    np.testing.assert_allclose(o.x[1].numpy(), lsq_linear(A, y, bounds=(0.0, 0.5)).x, atol=1e-5)
    Q = rng.randn(6, 6)
    o = T.SimpleOptimizer(TA.portfolio_model(Q @ Q.T / 6 + 0.1 * np.eye(6), rng.randn(6)),
                          device="cpu")
    o.solve(3000, rtol=1e-10)
    x = o.x[1].numpy()
    assert x.min() >= 0.0 and abs(x.sum() - 1.0) < 1e-6
    with pytest.raises(ValueError, match="groups of"):
        TA.group_lasso_model(rng.randn(4, 6), rng.randn(4), 0.5, 4)
    # tests/test_model_families.py:359-384
    rng = np.random.RandomState(5)
    m, n, r = 20, 16, 2
    L0 = rng.randn(m, r) @ rng.randn(r, n)
    S0 = np.zeros((m, n))
    mask = rng.rand(m, n) < 0.06
    S0[mask] = 5.0 * rng.randn(mask.sum())
    o = T.SimpleOptimizer(TA.rpca_model(L0 + S0), device="cpu")
    o.solve(800)
    L = o.x[0].numpy().reshape(m, n)
    assert np.abs(L - L0).max() < 0.15 * np.abs(L0).max()
    assert np.abs(L0 + S0 - L)[~mask].max() < 0.3
    sv = np.linalg.svd(L, compute_uv=False)
    assert sv[r:].max() < 0.05 * sv[0]


def test_from_jax_model_carries_every_new_objective():
    """Box (vector bounds), GroupL1, Huber, Nuclear, the PSD cone and a
    banded coupling come across and run the JAX package's trajectory."""
    rng = np.random.RandomState(9)
    A, y = rng.randn(16, 8), rng.randn(16)
    k = 3
    cases = [
        JA.bounded_lsq_model(A, y, -np.abs(rng.randn(8)), np.abs(rng.randn(8))),
        JA.group_lasso_model(A, y, 0.5, 2),
        JA.robust_regression_model(A, y, delta=0.3),
        JA.rpca_model(rng.randn(4, 3)),
        JA.sdp_model(rng.randn(2 * k * k, k * k), rng.randn(2 * k * k), (k, k, 1), axis=2),
        JA.tv_denoise_model(rng.randn(12), 0.3),
    ]
    for mj in cases:
        mt = interop.from_jax_model(mj, device="cpu")
        assert [type(f).__name__ for f in mt.functions] == \
            [type(f).__name__ for f in mj.functions]
        for key, op in mj.E.items():
            assert type(mt.E[key]).__name__ == type(op).__name__
        ot, oj = T.SimpleOptimizer(mt, device="cpu"), J.SimpleOptimizer(mj)
        ot.solve(20)
        oj.solve(20)
        _assert_runs_match(ot, oj)


def test_fused_spm_takes_tile_b():
    """The JAX constructor's tile_b is accepted; the real lanes do not
    depend on it (one value that divides the batch, one that does not)."""
    s, g, prj_sum, prj_w, _, _ = TA.synthetic_spm_data(nl=12, nw=25)
    model = TA.spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    gs = g[None, :] + 1e-4 * np.random.RandomState(0).randn(10, 12)
    outs = [FusedSpMSolver(model, tile_b=tb, device="cpu").solve(
        {(0, "y"): gs}, niter=250, mu0=0.1, rtol=0.0) for tb in (5, 256)]
    for a, b in zip(outs[0].x + outs[0].h, outs[1].x + outs[1].h):
        assert torch.equal(a, b)
    assert torch.equal(outs[0].iterations, outs[1].iterations)
    with pytest.raises(ValueError, match="tile_b"):
        FusedSpMSolver(model, tile_b=0, device="cpu")


def test_mu_ties_converge_to_the_same_x():
    """Basis pursuit at mu0 = 0.1 = 1/th_change: after iteration 0 with x1 = 0
    the balancing test meets an exact tie (pn == 10 dn), which the last bits
    of the two norms decide; torch and XLA round the norms differently, so a
    lane may take another penalty path and another iteration count (one lane
    of 256 differed by 101).  Both packages still converge, to the same x."""
    rng = np.random.RandomState(0)
    M, N, B = 32, 64, 32
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 8, replace=False)] = rng.randn(8)
    ys = xt @ A.T
    kw = dict(niter=3000, mu0=0.1, rtol=1e-8, record_residuals=False)
    rt = BatchedSolver(TA.basis_pursuit_model(A, ys[0], 0.1), device="cpu").solve(
        {(0, "y"): ys}, **kw)
    rj = JBatched(JA.basis_pursuit_model(A, ys[0], 0.1)).solve({(0, "y"): jnp.asarray(ys)}, **kw)
    assert bool(rt.converged.all()) and bool(np.asarray(rj.converged).all())
    xj = np.asarray(rj.x[0])
    for b in range(B):
        np.testing.assert_allclose(rt.x[0][b].numpy(), xj[b], rtol=0,
                                   atol=1e-8 * np.abs(xj[b]).max())
