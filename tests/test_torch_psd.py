"""Parity of the port's PSD cone with admmsolver_tpu: ``psd_project`` and
``SemiPositiveDefinitePenalty`` against the JAX package on the same numpy
inputs (float64; the JAX package sends real slices of n <= 64 through its
Jacobi eigh on the CPU, so single applications agree to eigensolver accuracy,
1e-10 relative, and the projection is unique even where eigenvectors are
not), complex Hermitian slices, the lower-triangle semantics of the
reference's ``eigh``, ``sdp_model`` and ``covariance_denoise_model`` through
``SimpleOptimizer`` and ``BatchedSolver`` (x, h, mu and the residual
histories to 1e-9·max|x| after 20 iterations at mu0 = 1), the mixed SDP
recipe, and a realified complex SDP against its complex128 solve."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models import applications as JA
from admmsolver_tpu.ops.prox import psd_project as jax_psd_project
from admmsolver_tpu.parallel import BatchedSolver as JBatched
from admmsolver_tpu_torch.models import applications as TA
from admmsolver_tpu_torch.models.realify import RealPartProx, decode, realify_model
from admmsolver_tpu_torch.ops.prox import psd_project
from admmsolver_tpu_torch.parallel import BatchedSolver

torch.set_num_threads(1)

PROX_RTOL = 1e-10
RUN_TOL = 1e-9


def _close(got, want, rtol=PROX_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("shape,axis", [((6, 6, 5), 2), ((4, 7, 7), 0), ((20, 20, 2), 2),
                                        ((3, 3, 1), 2)])
def test_psd_project_matches_jax(shape, axis):
    """Non-Hermitian input: both build each slice from its lower triangle."""
    x = np.random.RandomState(7).randn(int(np.prod(shape)))
    got = psd_project(torch.as_tensor(x), shape, axis).numpy()
    _close(got, jax_psd_project(jnp.asarray(x), shape, axis))
    # the reference's semantics: np.linalg.eigh reads the lower triangle only
    x3 = np.moveaxis(x.reshape(shape), axis, 0)
    w, V = np.linalg.eigh(x3, UPLO="L")
    want = np.moveaxis((V * np.maximum(w, 0)[:, None, :]) @ np.swapaxes(V, -1, -2), 0, axis)
    _close(got, want.ravel())


def test_psd_project_complex_hermitian_slices():
    """Complex slices stay complex128 (the JAX package realifies them); only
    the lower triangle and the real part of the diagonal are read."""
    rng = np.random.RandomState(8)
    n, K = 5, 3
    x = rng.randn(n * n * K) + 1j * rng.randn(n * n * K)
    got = psd_project(torch.as_tensor(x), (n, n, K), 2)
    assert got.dtype == torch.complex128
    _close(got.numpy(), jax_psd_project(jnp.asarray(x), (n, n, K), 2))
    x3 = np.moveaxis(x.reshape(n, n, K), 2, 0)
    w, V = np.linalg.eigh(x3, UPLO="L")
    want = (V * np.maximum(w, 0)[:, None, :]) @ np.conj(np.swapaxes(V, -1, -2))
    _close(np.moveaxis(got.numpy().reshape(n, n, K), 2, 0), want)


def test_psd_project_rows_join_one_batch():
    """Leading axes (one instance a row) give each row's own projection."""
    rng = np.random.RandomState(9)
    shape = (4, 4, 3)
    xs = rng.randn(5, 48)
    got = psd_project(torch.as_tensor(xs), shape, 2).numpy()
    for b in range(5):
        np.testing.assert_allclose(got[b], psd_project(torch.as_tensor(xs[b]), shape, 2).numpy(),
                                   rtol=0, atol=1e-14)


def test_semi_positive_definite_penalty_matches_jax():
    """tests/test_objectivefunc.py:190-205: complex h (real part taken),
    scaled-identity and Kronecker penalties; every slice PSD."""
    rng = np.random.RandomState(100)
    K, N = 6, 7
    h = rng.randn(N * N * K) + 1j * rng.randn(N * N * K)
    for make in (lambda P: P.identity(N * N * K),
                 lambda P: P.PartialDiagonalMatrix(P.ScaledIdentityMatrix(N * N, 1.3), (K,))):
        pt = T.SemiPositiveDefinitePenalty((N, N, K), axis=2)
        pj = J.SemiPositiveDefinitePenalty((N, N, K), axis=2)
        got = pt.solve(torch.as_tensor(h), make(T)).numpy()
        assert not np.iscomplexobj(got)
        _close(got, pj.solve(jnp.asarray(h), make(J)))
        x = got.reshape(N, N, K)
        for k in range(K):
            assert np.linalg.eigvalsh(x[:, :, k]).min() > -1e-10
    assert pt(got) == 0.0
    with pytest.raises(ValueError, match="3 axes"):
        T.SemiPositiveDefinitePenalty((4, 4), 0)


def test_penalty_batched_prox_is_per_lane():
    rng = np.random.RandomState(10)
    p = T.SemiPositiveDefinitePenalty((3, 3, 4), 2)
    h, mu = rng.randn(4, 36), rng.uniform(0.5, 2.0, (4, 1)) * np.ones((1, 36))
    got = p.prox_diag(torch.as_tensor(h), torch.as_tensor(mu), batched=True).numpy()
    for b in range(4):
        np.testing.assert_allclose(
            got[b], p.prox_diag(torch.as_tensor(h[b]), torch.as_tensor(mu[b])).numpy(),
            rtol=0, atol=1e-14)


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


def _sdp_data(k=4, rest=3, B=3, seed=3):
    rng = np.random.RandomState(seed)
    shape = (k, k, rest)
    N = k * k * rest
    xt = np.zeros(shape)
    for r in range(rest):
        Q = rng.randn(k, k)
        xt[:, :, r] = Q @ Q.T / k
    A = rng.randn(2 * N, N)
    y = A @ xt.ravel()
    return A, y, shape, y[None, :] + 0.01 * rng.randn(B, 2 * N), xt


@pytest.mark.parametrize("alpha_l1", [0.0, 0.1])
def test_sdp_model_runs_match_jax(alpha_l1):
    A, y, shape, ys, _ = _sdp_data()
    mt = TA.sdp_model(A, y, shape, axis=2, alpha_l1=alpha_l1)
    mj = JA.sdp_model(A, y, shape, axis=2, alpha_l1=alpha_l1)
    assert mt.num_func == (3 if alpha_l1 else 2)
    ot, oj = T.SimpleOptimizer(mt, device="cpu"), J.SimpleOptimizer(mj)
    ot.solve(20)
    oj.solve(20)
    _assert_runs_match(ot, oj)
    rt = BatchedSolver(mt, device="cpu").solve({(0, "y"): ys}, niter=20)
    rj = JBatched(mj).solve({(0, "y"): jnp.asarray(ys)}, niter=20)
    _assert_batches_match(rt, rj)


def test_sdp_recovers_psd_slices():
    """tests/test_applications.py:83-103: PSD slices that fit the data."""
    A, y, shape, _, xt = _sdp_data(seed=3)
    opt = T.SimpleOptimizer(TA.sdp_model(A, y, shape, axis=2), device="cpu")
    opt.solve(1500)
    x = opt.x[1].numpy().reshape(shape)
    for k in range(shape[2]):
        assert np.linalg.eigvalsh(x[:, :, k]).min() > -1e-8
    np.testing.assert_allclose(x, xt, atol=5e-2)


def test_covariance_denoise_runs_match_jax():
    rng = np.random.RandomState(5)
    k, B = 8, 3
    Q = rng.randn(k, k)
    C = Q @ Q.T / k
    Ys = C[None] + 0.25 * rng.randn(B, k, k)
    Ys = (Ys + Ys.swapaxes(-1, -2)) / 2
    w = 1.0 + rng.rand(k * k)
    mt = TA.covariance_denoise_model(Ys[0], weights=w)
    mj = JA.covariance_denoise_model(Ys[0], weights=w)
    ot, oj = T.SimpleOptimizer(mt, device="cpu"), J.SimpleOptimizer(mj)
    ot.solve(20)
    oj.solve(20)
    _assert_runs_match(ot, oj)
    wys = Ys.reshape(B, -1) * np.sqrt(w)[None, :]
    rt = BatchedSolver(mt, device="cpu").solve({(0, "y"): wys}, niter=20)
    rj = JBatched(mj).solve({(0, "y"): jnp.asarray(wys)}, niter=20)
    _assert_batches_match(rt, rj)
    with pytest.raises(ValueError, match="positive"):
        TA.covariance_denoise_model(Ys[0], weights=-w)


def test_covariance_denoise_solution_is_psd_and_denoises():
    """tests/test_model_families.py:547-584 at a smaller k."""
    rng = np.random.RandomState(5)
    k = 10
    Q = rng.randn(k, k)
    C = Q @ Q.T / k
    Y = C + 0.25 * rng.randn(k, k)
    Y = (Y + Y.T) / 2
    o = T.SimpleOptimizer(TA.covariance_denoise_model(Y, weights=1.0 + rng.rand(k * k)),
                          device="cpu")
    o.solve(2000, rtol=1e-10)
    X = o.x[1].numpy().reshape(k, k)
    assert np.linalg.eigvalsh(0.5 * (X + X.T)).min() > -1e-9
    assert np.linalg.norm(X - C) < np.linalg.norm(Y - C)


def test_mixed_sdp_preserves_psd_and_quality():
    """tests/test_mixed_precision.py:77: the float32 phase hands off through
    the PSD prox without losing feasibility, and the polish matches the
    float64 fit."""
    k, rest, B = 4, 6, 5
    shape = (k, k, rest)
    N = k * k * rest
    rng = np.random.RandomState(7)
    A = rng.randn(N // 2, N)
    xt = np.zeros(shape)
    for r in range(rest):
        Q = rng.randn(k, k)
        xt[:, :, r] = Q @ Q.T / k
    y = A @ xt.reshape(-1)
    ys = y[None, :] + 1e-4 * rng.randn(B, N // 2)
    bs = BatchedSolver(TA.sdp_model(A, y, shape, axis=2), device="cpu")
    rm = bs.solve_mixed({(0, "y"): ys}, niter_low=300, niter=100, rtol=0.0, low_rtol=0.0,
                        record_residuals=False)
    rf = bs.solve({(0, "y"): ys}, niter=400, rtol=0.0, record_residuals=False)
    for res in (rm, rf):
        X = res.x[1].numpy().reshape(B, k, k, rest)
        assert res.x[1].dtype == torch.float64 and np.isfinite(X).all()
        assert np.linalg.eigvalsh(np.moveaxis(X, (1, 2), (-2, -1))).min() >= -1e-10
    fit_m = np.median(np.abs(rm.x[0].numpy() @ A.T - ys))
    fit_f = np.median(np.abs(rf.x[0].numpy() @ A.T - ys))
    assert fit_m <= fit_f * 1.05 + 1e-12, (fit_m, fit_f)


def test_realified_complex_sdp_matches_complex128():
    """A complex data fit with a PSD block: its real embedding (the PSD
    block wrapped in RealPartProx) follows the complex128 solve."""
    rng = np.random.RandomState(11)
    k, rest = 3, 2
    N = k * k * rest
    A = rng.randn(2 * N, N) + 1j * rng.randn(2 * N, N)
    xt = np.zeros((k, k, rest))
    for r in range(rest):
        Q = rng.randn(k, k)
        xt[:, :, r] = Q @ Q.T / k
    y = A @ xt.ravel()
    model = TA.sdp_model(A, y, (k, k, rest), axis=2)
    re = realify_model(model)
    assert isinstance(re.model.functions[1], RealPartProx)
    oc = T.SimpleOptimizer(model, device="cpu")
    orl = T.SimpleOptimizer(re.model, device="cpu")
    oc.solve(200)
    orl.solve(200)
    assert oc.x[0].dtype == torch.complex128 and orl.x[0].dtype == torch.float64
    scale = max(float(x.abs().max()) for x in oc.x)
    for xc, xr in zip(oc.x, orl.x):
        np.testing.assert_allclose(decode(xr).numpy(), xc.numpy(), rtol=0, atol=1e-9 * scale)
    assert oc.iterations == orl.iterations
