"""The port's model constructors, grid helpers and the objectives of the SpM
slice against the JAX package, in float64 on the CPU: the numpy-only
helpers to 1e-14, the proxes of ConstrainedLeastSquares and L2Regularizer
to 1e-10 relative, and SimpleOptimizer on the models they construct with the
trajectory parity of tests/test_torch_optimizer.py (x, h to 1e-8, equal
penalties and iteration counts, residual histories to rtol 1e-6 above the
rounding level of 1e-12)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models import applications as japp
from admmsolver_tpu.utils import grids as jgrids
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.models import applications as tapp
from admmsolver_tpu_torch.utils import grids as tgrids

torch.set_num_threads(1)


def _assert_same_run(ot, oj, xtol=1e-8):
    for a, b in zip(ot.x, oj.x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=xtol)
    for a, b in zip(ot.h, oj.h):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=xtol)
    np.testing.assert_array_equal(ot.mu.numpy(), np.asarray(oj.mu))
    assert ot.iterations == oj.iterations
    # atol: a residual that has fallen to rounding level differs in its digits
    np.testing.assert_allclose(ot.primal_residual_history, oj.primal_residual_history,
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(ot.dual_residual_history, oj.dual_residual_history,
                               rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------
# numpy-only helpers
# ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(), dict(nl=12, nw=25), dict(nl=30, nw=201, noise=1e-5),
                                dict(nl=8, nw=19, beta=4.0, wmax=3.0, seed=3)])
def test_synthetic_spm_data_equals_jax_package(kw):
    got, want = tapp.synthetic_spm_data(**kw), japp.synthetic_spm_data(**kw)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray) and g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-14)


def _mesh(kind):
    if kind == "uniform":
        return np.linspace(-2.0, 2.0, 17)
    return np.cumsum(np.random.RandomState(0).uniform(0.1, 1.0, 23))


@pytest.mark.parametrize("kind", ["uniform", "random"])
@pytest.mark.parametrize("fn", ["second_deriv_prj", "smooth_regularizer_coeff"])
def test_grid_stencils_equal_jax_package(fn, kind):
    x = _mesh(kind)
    got, want = getattr(tgrids, fn)(x), getattr(jgrids, fn)(x)
    assert got.shape == (x.size - 2, x.size)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-14)


def test_grid_helpers_second_derivative_and_errors():
    x = _mesh("random")
    np.testing.assert_allclose(tgrids.second_deriv_prj(x) @ x**2, 2.0, atol=1e-10)
    assert tgrids.norm([3.0, 4.0]) == 5.0 == jgrids.norm(np.array([3.0, 4.0]))
    with pytest.raises(ValueError, match="increasing"):
        tgrids.second_deriv_prj(x[::-1])
    with pytest.raises(ValueError, match="increasing"):
        tgrids.smooth_regularizer_coeff(np.array([0.0, 1.0, 1.0, 2.0]))


# ---------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------

def _penalty(P, kind, N):
    if kind == "si":
        return P.ScaledIdentityMatrix(N, 0.7)
    if kind == "diag":
        d = np.random.RandomState(1).uniform(0.5, 2.0, N)
        return P.DiagonalMatrix(jnp.asarray(d) if P is J else d)
    G = np.random.RandomState(2).randn(N + 3, N)
    return P.DenseMatrix(jnp.asarray(G.T @ G) if P is J else G.T @ G)


@pytest.mark.parametrize("kind", ["si", "diag", "dense"])
@pytest.mark.parametrize("shape", [(20, 9), (6, 9)], ids=["tall", "wide"])
def test_constrained_least_squares_prox_matches_jax(shape, kind):
    M, N = shape
    rng = np.random.RandomState(0)
    A, y, C, D, h = rng.randn(M, N), rng.randn(M), rng.randn(2, N), rng.randn(2), rng.randn(N)
    fj = J.ConstrainedLeastSquares(0.8, A, y, C, D)
    ft = T.ConstrainedLeastSquares(0.8, A, y, C, D)
    want = np.asarray(fj.solve(jnp.asarray(h), _penalty(J, kind, N)))
    got = ft.solve(torch.as_tensor(h), _penalty(T, kind, N))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(C @ got.numpy(), D, rtol=0, atol=1e-10)  # the constraint holds
    facs = ft.make_factors(_penalty(T, kind, N))
    assert len(facs) == 3 and tuple(facs[1].shape) == (N, 2) and tuple(facs[2].shape) == (2, 2)
    x = rng.randn(N)
    assert abs(ft(x) - fj(jnp.asarray(x))) < 1e-9


def test_constrained_least_squares_defaults_and_errors():
    rng = np.random.RandomState(3)
    A, y, C, D = rng.randn(12, 5), rng.randn(12), rng.randn(1, 5), rng.randn(1)
    fj = J.ConstrainedLeastSquares(1.0, A, y, C, D)
    ft = T.ConstrainedLeastSquares(1.0, A, y, C, D)
    np.testing.assert_allclose(ft.solve().numpy(), np.asarray(fj.solve()), rtol=1e-10)
    with pytest.raises(ValueError, match="constraint"):
        T.ConstrainedLeastSquares(1.0, A, y, rng.randn(1, 4), D)
    with pytest.raises(ValueError, match="constraint"):
        T.ConstrainedLeastSquares(1.0, A, y, C, rng.randn(2))


@pytest.mark.parametrize("kind", ["si", "diag", "dense"])
def test_l2_regularizer_prox_matches_jax(kind):
    N = 11
    rng = np.random.RandomState(4)
    A, h = tgrids.smooth_regularizer_coeff(np.linspace(0.0, 1.0, N)), rng.randn(N)
    fj, ft = J.L2Regularizer(0.3, A), T.L2Regularizer(0.3, A)
    want = np.asarray(fj.solve(jnp.asarray(h), _penalty(J, kind, N)))
    got = ft.solve(torch.as_tensor(h), _penalty(T, kind, N))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    x = rng.randn(N)
    assert abs(ft(x) - fj(jnp.asarray(x))) < 1e-9 * max(1.0, abs(ft(x)))
    assert not ft.solve().any() and tuple(ft.solve().shape) == (N,)
    with pytest.raises(ValueError, match="alpha"):
        T.L2Regularizer(0.0, A)


def test_batched_hpd_inverse():
    from admmsolver_tpu_torch.models.objectivefunc import inv_hpd

    G = np.random.RandomState(5).randn(4, 9, 6)
    a = torch.as_tensor(np.einsum("bki,bkj->bij", G, G))
    inv = inv_hpd(a)
    assert tuple(inv.shape) == (4, 6, 6)
    np.testing.assert_allclose((inv @ a).numpy(), np.broadcast_to(np.eye(6), (4, 6, 6)),
                               atol=1e-10)
    np.testing.assert_allclose(inv_hpd(a[0]).numpy(), inv[0].numpy(), atol=1e-12)
    with pytest.raises(RuntimeError):
        inv_hpd(-a)


# ---------------------------------------------------------------------
# model constructors through the engine
# ---------------------------------------------------------------------

def _spm(P, nl=12, nw=25, alpha=1e-3):
    s, g, prj_sum, prj_w, _, _ = tapp.synthetic_spm_data(nl=nl, nw=nw)
    mod = japp if P is J else tapp
    return mod.spm_model(s, g, prj_sum, prj_w, alpha_l1=alpha), prj_sum


def test_spm_model_structure():
    m, _ = _spm(T)
    assert m.num_func == 3 and m.pairs == [(1, 0), (2, 0)]
    f0, f1, f2 = m.functions
    assert isinstance(f0, T.ConstrainedLeastSquares) and isinstance(f0._A, T.DiagonalMatrix)
    assert isinstance(f1, T.L1Regularizer) and isinstance(f2, T.NonNegativePenalty)
    assert (f0.size_x, f1.size_x, f2.size_x) == (12, 12, 25)
    assert tuple(m.E[(2, 0)].shape) == (25, 12)
    s, g, prj_sum, prj_w, _, _ = tapp.synthetic_spm_data(nl=12, nw=25)
    with pytest.raises(ValueError, match="does not match"):
        tapp.spm_model(s, g, prj_sum, prj_w[:, :-1], alpha_l1=1e-3)


@pytest.mark.parametrize("carried", [False, True], ids=["built", "from_jax_model"])
def test_simple_optimizer_on_spm_model_matches_jax(carried):
    """The 3-block SpM model puts a dense mu2·PᵀP into block 0's penalty
    (the Cholesky factor path) under the hard sum-rule constraint."""
    jm, prj_sum = _spm(J)
    tm = interop.from_jax_model(jm, device="cpu") if carried else _spm(T)[0]
    oj = J.SimpleOptimizer(jm, mu=0.1)
    ot = T.SimpleOptimizer(tm, mu=0.1, device="cpu")
    oj.solve(300)
    ot.solve(300)
    assert ot.x[0].dtype == torch.float64 and ot.iterations == 300
    _assert_same_run(ot, oj)
    assert abs(float(ot.x[0].numpy() @ prj_sum) - 1.0) < 1e-9  # hard constraint
    assert float(ot.x[2].min()) >= 0.0


@pytest.mark.parametrize("kw", [dict(alpha_l1=0.1), dict(alpha_l1=0.1, alpha_l2=0.5),
                                dict(alpha_l1=0.05, nonneg=True),
                                dict(alpha_l1=0.05, alpha_l2=0.2, nonneg=True, smooth="stencil")],
                         ids=["lasso", "elastic_net", "nonneg", "smooth_nonneg"])
def test_lasso_model_variants_match_jax(kw):
    rng = np.random.RandomState(1)
    A = rng.randn(15, 10)
    y = A @ np.abs(rng.randn(10))
    kw = dict(kw)
    if kw.pop("smooth", None):
        kw["smooth_A"] = tgrids.smooth_regularizer_coeff(np.linspace(0.0, 1.0, 10))
    jm, tm = japp.lasso_model(A, y, **kw), tapp.lasso_model(A, y, **kw)
    assert tm.num_func == jm.num_func and tm.pairs == jm.pairs
    oj, ot = J.SimpleOptimizer(jm), T.SimpleOptimizer(tm, device="cpu")
    oj.solve(150, interval_update_mu=20)
    ot.solve(150, interval_update_mu=20)
    _assert_same_run(ot, oj)


def test_basis_pursuit_model_matches_jax_and_recovers():
    rng = np.random.RandomState(0)
    A = rng.randn(20, 50)
    xt = np.zeros(50)
    xt[:5] = rng.randn(5)
    oj = J.SimpleOptimizer(japp.basis_pursuit_model(A, A @ xt, 0.1))
    ot = T.SimpleOptimizer(tapp.basis_pursuit_model(A, A @ xt, 0.1), device="cpu")
    oj.solve(300)
    ot.solve(300)
    _assert_same_run(ot, oj)
    np.testing.assert_allclose(ot.x[0].numpy(), xt, atol=1e-2 * np.abs(xt).max())


def test_from_jax_model_carries_the_spm_objectives():
    jm, _ = _spm(J)
    tm = interop.from_jax_model(jm, device="cpu")
    f0 = tm.functions[0]
    assert isinstance(f0, T.ConstrainedLeastSquares)
    np.testing.assert_array_equal(f0._C.asmatrix().numpy(), np.asarray(jm.functions[0]._C.asmatrix()))
    np.testing.assert_array_equal(f0._D.numpy(), np.asarray(jm.functions[0]._D))
    A = np.random.RandomState(6).randn(4, 7)
    l2 = interop._objective(J.L2Regularizer(0.3, A), "cpu", None)
    assert isinstance(l2, T.L2Regularizer) and l2._alpha == 0.3
    np.testing.assert_array_equal(l2._A.asmatrix().numpy(), A)
