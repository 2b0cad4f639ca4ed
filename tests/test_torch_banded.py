"""Parity of the port's banded operators with admmsolver_tpu.ops.linop: the
band algebra against dense matrices (exact to 1e-14), the cyclic-reduction
solve against the JAX one and numpy.linalg.solve (1e-12), unbatched and one
system per lane, the banded stencils, the engine's per-lane banded penalty,
and TV denoising structured against dense (x to 1e-10, primal residuals to
1e-8 relative, as tests/test_model_families.py:500-545 asserts)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models import applications as JA
from admmsolver_tpu.ops import linop as JL
from admmsolver_tpu_torch.models import applications as TA
from admmsolver_tpu_torch.ops import linop as TL
from admmsolver_tpu_torch.optimizer import ADMMPlan
from admmsolver_tpu_torch.parallel import BatchedSolver

torch.set_num_threads(1)

EXACT = 1e-14
CR_TOL = 1e-12


def _fwd_diff(N):
    D = np.zeros((N - 1, N))
    i = np.arange(N - 1)
    D[i, i] = -1.0
    D[i, i + 1] = 1.0
    return D


def _dense(op):
    return op.asmatrix().numpy()


def test_banded_roundtrip_matvec_transpose():
    rng = np.random.RandomState(0)
    Dd = _fwd_diff(11)
    D = T.BandedMatrix.from_dense(Dd)
    assert D.offsets == (0, 1) and D.shape == (10, 11)
    np.testing.assert_array_equal(_dense(D), Dd)
    np.testing.assert_array_equal(_dense(D.T), Dd.T)
    v, h, vb = rng.randn(11), rng.randn(10), rng.randn(11, 3)
    np.testing.assert_allclose((D @ torch.as_tensor(v)).numpy(), Dd @ v, rtol=0, atol=EXACT)
    np.testing.assert_allclose((D.T @ torch.as_tensor(h)).numpy(), Dd.T @ h, rtol=0, atol=EXACT)
    # trailing columns, and one instance per row
    np.testing.assert_allclose((D @ torch.as_tensor(vb)).numpy(), Dd @ vb, rtol=0, atol=EXACT)
    rows = rng.randn(4, 11)
    np.testing.assert_allclose(D.matvec_rows(torch.as_tensor(rows)).numpy(), rows @ Dd.T,
                               rtol=0, atol=EXACT)
    # the JAX operator's bands and transpose are the same arrays
    Dj = JL.BandedMatrix.from_dense(Dd)
    np.testing.assert_array_equal(D.bands.numpy(), np.asarray(Dj.bands))
    np.testing.assert_array_equal(D.T.bands.numpy(), np.asarray(Dj.T.bands))


@pytest.mark.parametrize("offsets", [(0,), (-1, 0, 1), (-3, 0, 2)])
def test_banded_bandwidth_matches_jax(offsets):
    """``bandwidth`` is max |offset| in both packages, an asymmetric band
    set included."""
    rng = np.random.RandomState(3)
    a = sum(np.diag(rng.randn(8 - abs(o)), o) for o in offsets)
    tb, jb = TL.BandedMatrix.from_dense(a, offsets), JL.BandedMatrix.from_dense(a, offsets)
    assert tb.bandwidth == jb.bandwidth == max(abs(o) for o in offsets)


def test_banded_invariant_and_shift_fill():
    with pytest.raises(ValueError, match="outside the valid row range"):
        T.BandedMatrix((1,), np.ones((1, 4)), (4, 4))        # row 3 has no column 4
    with pytest.raises(ValueError, match="sorted and unique"):
        T.BandedMatrix((1, 0), np.zeros((2, 4)), (4, 4))
    v = np.arange(1.0, 6.0)
    for s, L in [(0, 5), (2, 5), (-2, 5), (1, 7), (-6, 4), (9, 3)]:
        got = TL._shift_fill(torch.as_tensor(v), s, L).numpy()
        want = np.asarray(JL._shift_fill(jnp.asarray(v), s, L))
        np.testing.assert_array_equal(got, want)


def test_band_algebra_matches_dense():
    rng = np.random.RandomState(1)
    Dd = _fwd_diff(9)
    D = T.BandedMatrix.from_dense(Dd)
    G = TL.matmul(D.conjugate().T, D)
    Gd = Dd.T @ Dd
    assert isinstance(G, T.BandedMatrix) and G.offsets == (-1, 0, 1)
    np.testing.assert_allclose(_dense(G), Gd, rtol=0, atol=EXACT)
    np.testing.assert_allclose(_dense(D.gram()), Gd, rtol=0, atol=EXACT)
    A2 = TL.add(G * 0.7, T.ScaledIdentityMatrix(9, 0.5))
    assert isinstance(A2, T.BandedMatrix)
    np.testing.assert_allclose(_dense(A2), 0.7 * Gd + 0.5 * np.eye(9), rtol=0, atol=EXACT)
    dvec = rng.rand(9) + 1.0
    A3 = TL.add(G, T.DiagonalMatrix(dvec))
    assert isinstance(A3, T.BandedMatrix)
    np.testing.assert_allclose(_dense(A3), Gd + np.diag(dvec), rtol=0, atol=EXACT)
    rs = TL.matmul(T.DiagonalMatrix(dvec), G)
    cs = TL.matmul(G, T.DiagonalMatrix(dvec))
    assert isinstance(rs, T.BandedMatrix) and isinstance(cs, T.BandedMatrix)
    np.testing.assert_allclose(_dense(rs), np.diag(dvec) @ Gd, rtol=0, atol=EXACT)
    np.testing.assert_allclose(_dense(cs), Gd @ np.diag(dvec), rtol=0, atol=EXACT)
    E = np.zeros((8, 9))
    E[np.arange(8), np.arange(8)] = dvec[:8]
    B2 = TL.add(D * 2.0, T.BandedMatrix.from_dense(E))
    assert isinstance(B2, T.BandedMatrix)
    np.testing.assert_allclose(_dense(B2), 2.0 * Dd + E, rtol=0, atol=EXACT)
    # a band missing the diagonal gains one; products with dense stay dense
    off = T.BandedMatrix((1,), np.r_[np.ones(8), 0.0][None], (9, 9))
    np.testing.assert_allclose(_dense(TL.add(off, T.DiagonalMatrix(dvec))),
                               np.diag(np.ones(8), 1) + np.diag(dvec), rtol=0, atol=EXACT)
    M = rng.randn(9, 4)
    P = TL.matmul(G, T.DenseMatrix(M))
    assert isinstance(P, T.DenseMatrix)
    np.testing.assert_allclose(P.data.numpy(), Gd @ M, rtol=0, atol=EXACT)


def test_banded_plus_diagonal_promotes():
    n = 8
    rng = np.random.RandomState(4)
    Dd = np.zeros((n, n), np.float32)
    Dd[np.arange(n), np.arange(n)] = rng.rand(n).astype(np.float32)
    Dd[np.arange(n - 1), np.arange(1, n)] = 1.0
    Bm = T.BandedMatrix.from_dense(Dd)
    dv = rng.rand(n)
    out = TL.add(Bm, T.DiagonalMatrix(dv))
    assert isinstance(out, T.BandedMatrix) and out.bands.dtype == torch.float64
    np.testing.assert_allclose(_dense(out), Dd.astype(np.float64) + np.diag(dv), rtol=1e-6)
    off = T.BandedMatrix((1,), Bm.bands[1:2], (n, n))
    assert TL.add(off, T.DiagonalMatrix(dv)).bands.dtype == torch.float64


def _tridiag(rng, n, lanes=()):
    dl = np.zeros(lanes + (n,))
    du = np.zeros(lanes + (n,))
    if n > 1:
        dl[..., 1:] = rng.randn(*(lanes + (n - 1,)))
        du[..., :-1] = rng.randn(*(lanes + (n - 1,)))
    d = np.abs(rng.randn(*(lanes + (n,)))) + 2.0 + np.abs(dl) + np.abs(du)
    return dl, d, du


def _dense_tridiag(dl, d, du):
    T_ = np.diag(d)
    if d.size > 1:
        T_ += np.diag(dl[1:], -1) + np.diag(du[:-1], 1)
    return T_


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 33, 100, 257])
def test_tridiag_cr_solve_matches_lapack_and_jax(n):
    rng = np.random.RandomState(2)
    dl, d, du = _tridiag(rng, n)
    Td = _dense_tridiag(dl, d, du)
    f = TL.tridiag_cr_factor(dl, d, du)
    fj = JL.tridiag_cr_factor(dl, d, du)
    assert f.sizes == fj.sizes
    for rhs in (rng.randn(n), rng.randn(n, 4)):
        got = (f @ torch.as_tensor(rhs)).numpy()
        np.testing.assert_allclose(got, np.linalg.solve(Td, rhs), rtol=0, atol=CR_TOL)
        np.testing.assert_allclose(got, np.asarray(fj @ jnp.asarray(rhs)), rtol=0, atol=CR_TOL)


def test_tridiag_cr_one_system_per_lane():
    """Batched: lane b's factor solves row b (matvec_rows) and lane b's
    columns (matmat); a shared factor (leading axis 1) broadcasts."""
    rng = np.random.RandomState(3)
    n, B = 37, 6
    dl, d, du = _tridiag(rng, n, (B,))
    f = TL.tridiag_cr_factor(dl, d, du)
    assert f.batch_shape == (B,)
    rows, cols = rng.randn(B, n), rng.randn(n, 3)
    got_rows = f.matvec_rows(torch.as_tensor(rows)).numpy()
    got_cols = f.matmat(torch.as_tensor(cols)).numpy()
    for b in range(B):
        Tb = _dense_tridiag(dl[b], d[b], du[b])
        np.testing.assert_allclose(got_rows[b], np.linalg.solve(Tb, rows[b]), rtol=0, atol=CR_TOL)
        np.testing.assert_allclose(got_cols[b], np.linalg.solve(Tb, cols), rtol=0, atol=CR_TOL)
        fj = JL.tridiag_cr_factor(dl[b], d[b], du[b])
        np.testing.assert_allclose(got_rows[b], np.asarray(fj @ jnp.asarray(rows[b])),
                                   rtol=0, atol=CR_TOL)
    shared = TL.tridiag_cr_factor(dl[:1], d[:1], du[:1])
    np.testing.assert_allclose(shared.matvec_rows(torch.as_tensor(rows)).numpy(),
                               np.linalg.solve(_dense_tridiag(dl[0], d[0], du[0]), rows.T).T,
                               rtol=0, atol=CR_TOL)


def test_tridiag_solve_follows_rhs_precision():
    rng = np.random.RandomState(3)
    dl, d, du = _tridiag(rng, 17)
    f = TL.tridiag_cr_factor(dl, d, du)
    assert (f @ torch.as_tensor(rng.randn(17), dtype=torch.float32)).dtype == torch.float32
    assert (f @ torch.as_tensor(rng.randn(17))).dtype == torch.float64


def test_banded_stencils_match_dense_and_jax():
    from admmsolver_tpu_torch.utils import (second_deriv_banded, second_deriv_prj,
                                            smooth_regularizer_banded, smooth_regularizer_coeff)
    from admmsolver_tpu.utils import smooth_regularizer_banded as jax_smooth

    x = np.cumsum(0.1 + np.random.RandomState(0).rand(40))
    np.testing.assert_allclose(_dense(second_deriv_banded(x)), second_deriv_prj(x),
                               rtol=0, atol=1e-13)
    P = smooth_regularizer_banded(x)
    np.testing.assert_allclose(_dense(P), smooth_regularizer_coeff(x), rtol=0, atol=1e-13)
    np.testing.assert_array_equal(P.bands.numpy(), np.asarray(jax_smooth(x).bands))
    G = P.gram()
    assert isinstance(G, T.BandedMatrix) and G.offsets == (-2, -1, 0, 1, 2)
    Pd = smooth_regularizer_coeff(x)
    np.testing.assert_allclose(_dense(G), Pd.T @ Pd, rtol=0, atol=1e-12)


def test_lane_operators_banded():
    """The engine's per-lane banded penalty: scale and + with scalar and
    diagonal lanes stay banded, its rows match dense, and the HPD inverse of
    a tridiagonal one is the batched cyclic-reduction factor."""
    rng = np.random.RandomState(5)
    n, B = 12, 3
    G = T.BandedMatrix.from_dense(_fwd_diff(n)).gram()              # n×n, offsets -1..1
    Gd = _dense(G)
    mu = torch.as_tensor(rng.uniform(0.5, 2.0, B))
    pen = TL.LaneOperators.shared(G).scale(mu)
    assert pen.kind == "banded" and pen.offsets == (-1, 0, 1)
    tot = TL.LaneOperators.shared(T.ScaledIdentityMatrix(n, 0.5)) + pen
    diag = TL.LaneOperators("diag", torch.as_tensor(rng.rand(B, n)), n)
    tot2 = tot + diag
    assert tot.kind == "banded" and tot2.kind == "banded"
    v, cols = rng.randn(B, n), rng.randn(n, 2)
    want = [mu[b].item() * Gd + 0.5 * np.eye(n) + np.diag(diag.data[b].numpy()) for b in range(B)]
    got = tot2.matvec_rows(torch.as_tensor(v)).numpy()
    got_cols = tot2.matmat(torch.as_tensor(cols)).numpy()
    np.testing.assert_allclose(tot2._as("dense").numpy(), np.stack(want), rtol=0, atol=EXACT)
    from admmsolver_tpu_torch.models.objectivefunc import _inv_hpd

    fac = _inv_hpd(tot2)
    assert isinstance(fac, TL.TridiagFactor) and fac.batch_shape == (B,)
    sol = fac.matvec_rows(torch.as_tensor(v)).numpy()
    for b in range(B):
        np.testing.assert_allclose(got[b], want[b] @ v[b], rtol=0, atol=EXACT)
        np.testing.assert_allclose(got_cols[b], want[b] @ cols, rtol=0, atol=EXACT)
        np.testing.assert_allclose(sol[b], np.linalg.solve(want[b], v[b]), rtol=0, atol=CR_TOL)
    # a wider band set densifies its inverse; a dense addend densifies the sum
    P = TL.LaneOperators.shared(G._matmul_banded(G)).scale(mu)
    wide = _inv_hpd(TL.LaneOperators.shared(T.ScaledIdentityMatrix(n, 1.0)) + P)
    assert wide.kind == "dense"
    dense = TL.LaneOperators("dense", torch.as_tensor(np.stack(want)), n)
    assert (tot2 + dense).kind == "dense"


def _tv_signal(n, seed, B=None):
    rng = np.random.RandomState(seed)
    truth = np.r_[np.zeros(n // 2), np.ones(n - n // 2)]
    if B is None:
        return truth + 0.2 * rng.randn(n)
    return truth[None, :] + 0.2 * rng.randn(B, n)


def test_tv_structured_matches_dense_trajectory():
    """The banded D and the CR factor drive the same trajectory as the dense
    construction, in the port and against the JAX package."""
    y = _tv_signal(60, 41)
    mb = TA.tv_denoise_model(y, 0.4, structured=True)
    assert isinstance(mb.E[(1, 0)], T.BandedMatrix)
    factors = ADMMPlan(mb, "cpu").compute_factors(torch.ones(1, dtype=torch.float64))
    assert isinstance(factors[0], TL.TridiagFactor)
    o1 = T.SimpleOptimizer(mb, device="cpu")
    o1.solve(200)
    o2 = T.SimpleOptimizer(TA.tv_denoise_model(y, 0.4, structured=False), device="cpu")
    o2.solve(200)
    np.testing.assert_allclose(o1.x[0].numpy(), o2.x[0].numpy(), rtol=0, atol=1e-10)
    np.testing.assert_allclose(o1.primal_residual_history, o2.primal_residual_history,
                               rtol=1e-8, atol=1e-12)
    oj = J.SimpleOptimizer(JA.tv_denoise_model(y, 0.4, structured=True))
    oj.solve(200)
    scale = np.abs(np.asarray(oj.x[0])).max()
    for a, b in zip(o1.x, oj.x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(o1.primal_residual_history, oj._primal_residual,
                               rtol=1e-8, atol=1e-12)


def test_tv_batched_lanes_match_single_and_jax():
    ys = _tv_signal(40, 42, B=3)
    bs = BatchedSolver(TA.tv_denoise_model(ys[0], 0.4), device="cpu")
    res = bs.solve({(0, "y"): ys}, niter=150)
    from admmsolver_tpu.parallel import BatchedSolver as JBatched

    rj = JBatched(JA.tv_denoise_model(ys[0], 0.4)).solve({(0, "y"): jnp.asarray(ys)}, niter=150)
    scale = np.abs(np.asarray(rj.x[0])).max()
    for k in range(2):
        np.testing.assert_allclose(res.x[k].numpy(), np.asarray(rj.x[k]), rtol=0,
                                   atol=1e-9 * scale)
    np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(rj.iterations))
    for b in range(3):
        o = T.SimpleOptimizer(TA.tv_denoise_model(ys[b], 0.4), device="cpu")
        o.solve(150)
        np.testing.assert_allclose(res.x[0][b].numpy(), o.x[0].numpy(), rtol=0, atol=1e-9)


def test_tv_batched_never_materializes_n_by_n():
    """At N = 4096 the batched penalty stays banded and its factor is the
    batched CR cascade: O(N) state a lane, no (B, N, N) tensor."""
    N, B = 4096, 2
    ys = _tv_signal(N, 43, B=B)
    bs = BatchedSolver(TA.tv_denoise_model(ys[0], 0.4), device="cpu")
    mu = torch.full((B, 1), 1.0, dtype=torch.float64)
    fns = bs._bind(bs._prologue_overrides({(0, "y"): torch.as_tensor(ys)}))
    factors = bs.plan.compute_factors(mu, fns, batched=True)
    fac = factors[0]
    assert isinstance(fac, TL.TridiagFactor) and fac.batch_shape == (B,)
    tensors = [t for lvl in fac.levels for t in lvl] + [fac.d_final]
    assert max(t.numel() for t in tensors) <= B * N
    assert sum(t.numel() for t in tensors) <= 6 * B * N
    res = bs.solve({(0, "y"): ys}, niter=20, rtol=0.0, record_residuals=False)
    assert all(bool(torch.isfinite(x).all()) for x in res.x)
