"""Parity of the port's objectives with admmsolver_tpu.models.objectivefunc:
the least-squares prox by the spectral (full basis), thin-basis and
Cholesky paths, and the L1 / nonnegative proxes, on the same numpy inputs
in float64, to 1e-10.  The thin eigenbasis is built in numpy by both
packages, so U and λ must be bit-identical."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu_torch.models.objectivefunc import SpectralShift

torch.set_num_threads(1)

TOL = 1e-10


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _ls(P, M, N, seed=0, alpha=0.7):
    rng = np.random.RandomState(seed)
    return P.LeastSquares(alpha, rng.randn(M, N), rng.randn(M))


def _penalty(P, kind, N, seed=1):
    """A penalty operator of the given structure in package P."""
    rng = np.random.RandomState(seed)
    if kind == "si":
        return P.ScaledIdentityMatrix(N, 1.3)
    d = rng.uniform(0.5, 2.0, N)
    return P.DiagonalMatrix(jnp.asarray(d) if P is J else d)


@pytest.mark.parametrize("M,N,kind,path", [
    (30, 12, "si", "spectral"),      # tall A: full-basis eigendecomposition
    (8, 20, "si", "thin"),           # wide A: thin basis from A A†
    (30, 12, "diag", "cholesky"),    # non-scalar penalty: dense inverse
    (8, 20, "diag", "cholesky"),
])
def test_least_squares_prox_paths_match_jax(M, N, kind, path):
    fj, ft = _ls(J, M, N), _ls(T, M, N)
    mj, mt = _penalty(J, kind, N), _penalty(T, kind, N)
    h = np.random.RandomState(2).randn(N)
    facj, fact = fj.make_factors(mj), ft.make_factors(mt)
    if path == "cholesky":
        assert isinstance(fact, T.DenseMatrix)
    else:
        assert isinstance(fact, SpectralShift) and fact.thin == (path == "thin")
    got = ft.prox_with_factors(fact, torch.as_tensor(h))
    want = fj.prox_with_factors(facj, jnp.asarray(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    # eager reference API, and the closed form it solves
    np.testing.assert_allclose(ft.solve(torch.as_tensor(h), mt).numpy(), np.asarray(want),
                               rtol=0, atol=TOL)
    A, y = ft._A.data.numpy(), ft._y.numpy()
    Mu = _np(mt.asmatrix())
    x = np.linalg.solve(0.7 * A.T @ A + Mu, 0.7 * A.T @ y - h)
    np.testing.assert_allclose(got.numpy(), x, rtol=0, atol=1e-9)


def test_thin_eigenbasis_is_identical():
    fj, ft = _ls(J, 8, 20), _ls(T, 8, 20)
    (lj, Uj), (lt, Ut) = fj._get_eig_thin(), ft._get_eig_thin()
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_array_equal(Ut, Uj)
    assert _ls(T, 30, 12)._get_eig_thin() is False


def test_thin_zero_shift_takes_full_basis():
    """The thin form divides by the shift; a zero shift solves through the
    full basis, as in the JAX package."""
    fj, ft = _ls(J, 30, 12), _ls(T, 30, 12)
    h = np.random.RandomState(3).randn(12)
    mj, mt = J.ScaledIdentityMatrix(12, 0.0), T.ScaledIdentityMatrix(12, 0.0)
    got = ft.prox_with_factors(ft.make_factors(mt), torch.as_tensor(h)).numpy()
    want = np.asarray(fj.prox_with_factors(fj.make_factors(mj), jnp.asarray(h)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    fac = _ls(T, 8, 20).make_factors(T.ScaledIdentityMatrix(20, 0.0))
    assert isinstance(fac, SpectralShift) and not fac.thin


@pytest.mark.parametrize("offset", [None, "vec"])
@pytest.mark.parametrize("kind", ["si", "diag"])
def test_l1_prox_matches_jax(kind, offset):
    N = 16
    rng = np.random.RandomState(4)
    off = None if offset is None else rng.randn(N)
    h = rng.randn(N)
    fj = J.L1Regularizer(0.4, N, None if off is None else jnp.asarray(off))
    ft = T.L1Regularizer(0.4, N, off)
    got = ft.solve(torch.as_tensor(h), _penalty(T, kind, N))
    want = fj.solve(jnp.asarray(h), _penalty(J, kind, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    x = rng.randn(N)
    assert abs(ft(x) - fj(jnp.asarray(x))) < TOL


@pytest.mark.parametrize("kind", ["si", "diag"])
def test_nonneg_prox_matches_jax(kind):
    N = 16
    h = np.random.RandomState(5).randn(N)
    got = T.NonNegativePenalty(N).solve(torch.as_tensor(h), _penalty(T, kind, N))
    want = J.NonNegativePenalty(N).solve(jnp.asarray(h), _penalty(J, kind, N))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert (got >= 0).all()


def test_objective_values_and_errors():
    fj, ft = _ls(J, 8, 20), _ls(T, 8, 20)
    x = np.random.RandomState(6).randn(20)
    assert abs(ft(x) - fj(jnp.asarray(x))) < 1e-9
    assert T.NonNegativePenalty(3)(np.ones(3)) == 0.0
    with pytest.raises(TypeError, match="diagonal"):
        T.L1Regularizer(0.1, 4).solve(torch.ones(4), T.DenseMatrix(np.eye(4)))
    with pytest.raises(ValueError):
        T.L1Regularizer(-1.0, 4)
    with pytest.raises(ValueError):
        T.LeastSquares(1.0, np.ones((3, 4)), np.ones(5))


def test_eager_factor_cache_keys_on_penalty():
    ft = _ls(T, 30, 12)
    h = torch.as_tensor(np.random.RandomState(7).randn(12))
    a = ft.solve(h, T.ScaledIdentityMatrix(12, 1.0))
    key = ft._B_cache[0]
    ft.solve(h, T.ScaledIdentityMatrix(12, 1.0))
    assert ft._B_cache[0] == key
    b = ft.solve(h, T.ScaledIdentityMatrix(12, 2.0))
    assert ft._B_cache[0] != key and not torch.allclose(a, b)
