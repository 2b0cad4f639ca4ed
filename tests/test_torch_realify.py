"""The port's complex→real embedding against admmsolver_tpu.models.realify,
on the CPU.  The cases mirror tests/test_realify.py (its reference-import
and TPU-guard tests are JAX-only).  The same numpy data go through both
packages: the embedded operators agree with the JAX package's, in value and
structure, to 1e-12; a complex128 model solved directly by the port equals
its realified model solved by the port and by the JAX package (x, h, mu,
residual histories, iteration counts) to 1e-10; the fused solver on a
realified model (plain version of the `_even` kernel modes) agrees with the
JAX fused solver in interpret mode to 5e-4 over 21 iterations."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import spm_model as jax_spm_model
from admmsolver_tpu.models.applications import synthetic_spm_data
from admmsolver_tpu.models.realify import encode as jax_encode
from admmsolver_tpu.models.realify import realify_matrix as jax_realify_matrix
from admmsolver_tpu.parallel import BatchedSolver as JaxBatched
from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver as JaxFused
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.models.applications import spm_model
from admmsolver_tpu_torch.models.realify import (RealPartProx, decode, encode,
                                                 realify_matrix)
from admmsolver_tpu_torch.ops.linop import InterleavedComplexDiagonalMatrix
from admmsolver_tpu_torch.parallel import BatchedSolver, FusedTwoBlockSolver

torch.set_num_threads(1)

TOL = 1e-10


def _randn_cmplx(rng, *shape):
    return rng.randn(*shape) + 1j * rng.randn(*shape)


def _bp(P, A, y, alpha=0.15, E=None):
    N = A.shape[1]
    return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(alpha, N)],
                   [(1, 0, E if E is not None else P.identity(N), P.identity(N))])


def _complex_bp_data(rng, M=8, N=16):
    A = _randn_cmplx(rng, M, N)
    x_true = np.zeros(N, dtype=complex)
    x_true[rng.choice(N, 3, replace=False)] = _randn_cmplx(rng, 3)
    return A, A @ x_true


def _three_ways(tm, jm, niter, mu=None, **kw):
    """The port's complex solve, the port's realified solve and the JAX
    package's realified solve of one model."""
    oc = T.SimpleOptimizer(tm, mu=mu, device="cpu")
    oc.solve(niter, **kw)
    tre = T.realify_model(tm)
    orr = T.SimpleOptimizer(tre.model, mu=mu, device="cpu")
    orr.solve(niter, **kw)
    jre = J.realify_model(jm)
    oj = J.SimpleOptimizer(jre.model, mu=mu)
    oj.solve(niter, **kw)
    return oc, orr, oj, tre


def _assert_isomorphic(oc, orr, oj, tre, atol=TOL):
    assert oc.x[0].dtype == torch.complex128 and orr.x[0].dtype == torch.float64
    for xc, xr, xj in zip(oc.x, orr.x, oj.x):
        np.testing.assert_allclose(decode(xr).numpy(), xc.numpy(), rtol=0, atol=atol)
        np.testing.assert_allclose(xr.numpy(), np.asarray(xj), rtol=0, atol=atol)
    for hc, hr, hj in zip(oc.h, orr.h, oj.h):
        np.testing.assert_allclose(decode(hr).numpy(), hc.numpy(), rtol=0, atol=atol)
        np.testing.assert_allclose(hr.numpy(), np.asarray(hj), rtol=0, atol=atol)
    for a in (oc, orr):
        np.testing.assert_array_equal(a.mu.numpy(), np.asarray(oj.mu))
        assert a.iterations == len(oj._primal_residual)
        for mine, theirs in ((a.primal_residual_history, oj._primal_residual),
                             (a.dual_residual_history, oj._dual_residual)):
            np.testing.assert_allclose(mine, theirs, rtol=TOL, atol=TOL)
    assert tre.decode_x(tre.encode_x(oc.x))[0].dtype == torch.complex128


def test_encode_decode_roundtrip():
    rng = np.random.RandomState(0)
    v = _randn_cmplx(rng, 7)
    np.testing.assert_array_equal(decode(encode(v)).numpy(), v)
    np.testing.assert_array_equal(encode(v).numpy(), np.asarray(jax_encode(v)))
    vb = _randn_cmplx(rng, 3, 5)
    np.testing.assert_array_equal(decode(encode(vb)).numpy(), vb)
    np.testing.assert_array_equal(encode(vb).numpy(), np.asarray(jax_encode(vb)))
    # real input: imaginary lanes are zero
    r = encode(rng.randn(4))
    assert r.dtype == torch.float64 and np.all(r.numpy()[1::2] == 0)
    # float32 stays float32 / complex64
    assert decode(torch.zeros(6, dtype=torch.float32)).dtype == torch.complex64


def _operators(P, rng):
    """The ten operators of tests/test_realify.py, in package ``P``."""
    wrap = jnp.asarray if P is J else (lambda a: a)
    return [
        (P.DenseMatrix(wrap(rng.randn(4, 6))), 6),
        (P.DenseMatrix(wrap(_randn_cmplx(rng, 4, 6))), 6),
        (P.DiagonalMatrix(wrap(rng.randn(5))), 5),
        (P.DiagonalMatrix(wrap(_randn_cmplx(rng, 5))), 5),
        (P.DiagonalMatrix(wrap(rng.randn(3)), (6, 3)), 3),
        (P.DiagonalMatrix(wrap(rng.randn(3)), (3, 6)), 6),
        (P.ScaledIdentityMatrix(5, 2.5), 5),
        (P.ScaledIdentityMatrix(5, 1.0 + 2.0j), 5),
        (P.ScaledIdentityMatrix((7, 4), 0.5), 4),
        (P.PartialDiagonalMatrix(P.DenseMatrix(wrap(rng.randn(3, 3))), (2,)), 6),
    ]


@pytest.mark.parametrize("case", range(10))
def test_realify_matrix_equivalence(case):
    """R(M) encode(v) == encode(M v) for every operator structure, and the
    port's embedding equals the JAX package's in structure and value."""
    op, n = _operators(T, np.random.RandomState(42))[case]
    jop, _ = _operators(J, np.random.RandomState(42))[case]
    R, RJ = realify_matrix(op), jax_realify_matrix(jop)
    assert R.shape == (2 * op.shape[0], 2 * op.shape[1])
    assert type(R).__name__ == type(RJ).__name__
    np.testing.assert_allclose(R.asmatrix().numpy(), np.asarray(RJ.asmatrix()), rtol=0,
                               atol=1e-12)
    v = _randn_cmplx(np.random.RandomState(1), n)
    got = (R @ encode(v)).numpy()
    want = encode(op.asmatrix().numpy() @ v).numpy()
    np.testing.assert_allclose(got, want, atol=1e-12)
    # rows of a batch, as the batched engine applies it
    rows = encode(_randn_cmplx(np.random.RandomState(2), 3, n))
    np.testing.assert_allclose(R.matvec_rows(rows).numpy(),
                               rows.numpy() @ R.asmatrix().numpy().T, atol=1e-12)
    # structure: real operators stay non-dense
    if not op.asmatrix().is_complex():
        assert not isinstance(R, T.DenseMatrix), type(R)


def test_complex_trajectory_isomorphism():
    """Complex solve == realified solve == the JAX package's realified
    solve, iteration for iteration, through penalty-update boundaries."""
    rng = np.random.RandomState(3)
    A, y = _complex_bp_data(rng)
    _assert_isomorphic(*_three_ways(_bp(T, A, y), _bp(J, A, y), 130,
                                    interval_update_mu=50, rtol=0))


def test_complex_trajectory_isomorphism_converging():
    """The same with the relative stop on: equal iteration counts."""
    rng = np.random.RandomState(7)
    A, y = _randn_cmplx(rng, 6, 12), _randn_cmplx(rng, 6)
    oc, orr, oj, tre = _three_ways(_bp(T, A, y, alpha=0.2), _bp(J, A, y, alpha=0.2), 800,
                                   rtol=1e-9)
    assert oc.iterations < 800
    _assert_isomorphic(oc, orr, oj, tre)


def test_realified_spectral_structure():
    """A realified real-A least-squares block keeps the spectral solve path:
    its Gram is G ⊗ I_2 and the eigensystem is of the small G."""
    rng = np.random.RandomState(1)
    A = rng.randn(5, 9)  # real wide
    y = _randn_cmplx(rng, 5)  # complex data
    re = T.realify_model(_bp(T, A.astype(complex), y, alpha=0.1))
    f0 = re.model.functions[0]
    gram, rest = f0._spectral_inner()
    assert rest == 2 and tuple(gram.shape) == (9, 9)
    assert f0._get_eig_thin() is not False
    fac = f0.make_factors(T.ScaledIdentityMatrix(18, 0.8))
    v = _randn_cmplx(rng, 9)
    want = encode(np.linalg.solve(A.T @ A + 0.8 * np.eye(9), v)).numpy()
    np.testing.assert_allclose(f0._apply_B(fac, encode(v)).numpy(), want, atol=1e-11)
    jf0 = J.realify_model(_bp(J, A.astype(complex), y, alpha=0.1)).model.functions[0]
    jfac = jf0.make_factors(J.ScaledIdentityMatrix(18, 0.8))
    np.testing.assert_allclose(want, np.asarray(jf0._apply_B(jfac, jax_encode(v))),
                               atol=1e-11)


def _complex_spm_data(nl=12, nw=25):
    s, g, prj_sum, prj_w, omega, rho = synthetic_spm_data(nl=nl, nw=nw)
    g = g + 1e-3j * np.random.RandomState(5).randn(g.size)  # genuinely complex data
    return s, g, prj_sum, prj_w


def test_realified_spm_three_block():
    """The SpM model (constrained LS + L1 + nonneg) with complex data:
    realified trajectory == complex trajectory == the JAX package's."""
    s, g, prj_sum, prj_w = _complex_spm_data()
    tm = spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    jm = jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    _assert_isomorphic(*_three_ways(tm, jm, 150, mu=0.1, rtol=0))


def test_realified_batched_solver():
    """Batched realified solves: every lane equals its single-instance
    complex solve, and the batch equals the JAX package's."""
    rng = np.random.RandomState(9)
    M, N, B = 6, 10, 4
    A = _randn_cmplx(rng, M, N)
    ys = _randn_cmplx(rng, B, M)
    ys_enc = encode(ys).numpy()
    tre = T.realify_model(_bp(T, A, ys[0], alpha=0.3))
    res = BatchedSolver(tre.model, device="cpu").solve(
        {(0, "y"): ys_enc}, niter=80, rtol=0, record_residuals=False)
    jres = JaxBatched(J.realify_model(_bp(J, A, ys[0], alpha=0.3)).model).solve(
        {(0, "y"): ys_enc}, niter=80, rtol=0, record_residuals=False)
    for a, b in zip(res.x + res.h, tuple(jres.x) + tuple(jres.h)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    np.testing.assert_array_equal(res.mu.numpy(), np.asarray(jres.mu))
    for b in range(B):
        ob = T.SimpleOptimizer(_bp(T, A, ys[b], alpha=0.3), device="cpu")
        ob.solve(80, rtol=0)
        np.testing.assert_allclose(decode(res.x[0][b]).numpy(), ob.x[0].numpy(), atol=1e-9)


def test_realified_batched_spm_kronecker_penalty():
    """Realified SpM through the batched engine: the coupling prj_w ⊗ I_2
    gives block 0 a Kronecker penalty, which the lane operators keep as
    ``kron``; the batch equals the JAX package's and its lane 0 the complex
    single-instance solve."""
    s, g, prj_sum, prj_w = _complex_spm_data()
    gs = g[None, :] + 1e-4 * _randn_cmplx(np.random.RandomState(4), 3, g.size)
    ov = {(0, "y"): encode(gs).numpy()}
    bs = BatchedSolver(T.realify_model(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)).model,
                       device="cpu")
    factors = bs.plan.compute_factors(torch.ones(3, 2, dtype=torch.float64), batched=True)
    assert factors[0][0].kind == "kron" and factors[0][0].rest == 2
    res = bs.solve(ov, niter=120, mu0=0.1, rtol=0)
    jm = J.realify_model(jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)).model
    jres = JaxBatched(jm).solve(ov, niter=120, mu0=0.1, rtol=0)
    for a, b in zip(res.x + res.h, tuple(jres.x) + tuple(jres.h)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9)
    np.testing.assert_allclose(res.primal_residual.numpy(), np.asarray(jres.primal_residual),
                               rtol=1e-6, atol=1e-12)
    one = T.SimpleOptimizer(spm_model(s, gs[0], prj_sum, prj_w, alpha_l1=1e-3), mu=0.1,
                            device="cpu")
    one.solve(120, rtol=0)
    for xb, x1 in zip(res.x, one.x):
        np.testing.assert_allclose(decode(xb[0]).numpy(), x1.numpy(), atol=1e-9)


def test_realified_complex_diagonal_coupling():
    """A genuinely complex diagonal coupling keeps a diagonal E†E in the
    realified model: realified trajectory == complex trajectory."""
    rng = np.random.RandomState(11)
    M, N = 6, 8
    A = _randn_cmplx(rng, M, N)
    y = _randn_cmplx(rng, M)
    d = _randn_cmplx(rng, N) + 2.0   # complex, well-conditioned
    tm = _bp(T, A, y, alpha=0.2, E=T.DiagonalMatrix(d))
    jm = _bp(J, A, y, alpha=0.2, E=J.DiagonalMatrix(jnp.asarray(d)))
    emb = T.realify_model(tm).model.E[(0, 1)]
    assert isinstance(emb, InterleavedComplexDiagonalMatrix), type(emb)
    _assert_isomorphic(*_three_ways(tm, jm, 120, rtol=0), atol=1e-9)


def test_realified_complex_scaled_identity_coupling():
    """Complex scaled-identity couplings stay structured too."""
    op = T.ScaledIdentityMatrix(5, 1.0 - 0.5j)
    R = realify_matrix(op)
    assert isinstance(R, InterleavedComplexDiagonalMatrix)
    v = _randn_cmplx(np.random.RandomState(0), 5)
    np.testing.assert_allclose((R @ encode(v)).numpy(), encode((1.0 - 0.5j) * v).numpy(),
                               atol=1e-13)
    np.testing.assert_allclose(R.asmatrix().numpy(),
                               np.asarray(jax_realify_matrix(
                                   J.ScaledIdentityMatrix(5, 1.0 - 0.5j)).asmatrix()))
    # a 0-d coefficient tensor: the embedding stays on its device
    R2 = realify_matrix(T.ScaledIdentityMatrix(5, torch.tensor(1.0 - 0.5j)))
    assert R2.re.device == R2.im.device == torch.device("cpu")
    np.testing.assert_array_equal(R2.asmatrix().numpy(), R.asmatrix().numpy())


def test_realify_partial_diagonal_complex_dtype_inner():
    """A real-valued but complex-dtype PartialDiagonalMatrix inner is cast to
    a real dtype in the realified operator."""
    rng = np.random.RandomState(2)
    op = T.PartialDiagonalMatrix(T.DenseMatrix(rng.randn(3, 3).astype(complex)), (2,))
    R = realify_matrix(op)
    assert isinstance(R, T.PartialDiagonalMatrix) and R.rest_dims == (2, 2)
    assert not R.matrix.data.is_complex()
    assert not R.asmatrix().is_complex()


def test_from_jax_model_carries_realified_models():
    """A realified JAX model carries over with its structure and computes
    what the JAX package computes."""
    rng = np.random.RandomState(13)
    M, N = 6, 8
    A, y = _randn_cmplx(rng, M, N), _randn_cmplx(rng, M)
    d = _randn_cmplx(rng, N) + 2.0
    jre = J.realify_model(_bp(J, A, y, alpha=0.2, E=J.DiagonalMatrix(jnp.asarray(d))))
    tm = interop.from_jax_model(jre.model, device="cpu")
    assert isinstance(tm.functions[1], RealPartProx)
    assert isinstance(tm.E[(0, 1)], InterleavedComplexDiagonalMatrix)
    ot = T.SimpleOptimizer(tm, device="cpu")
    ot.solve(60, rtol=0)
    oj = J.SimpleOptimizer(jre.model)
    oj.solve(60, rtol=0)
    for a, b in zip(ot.x, oj.x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    # complex arrays keep a complex dtype under an explicit precision
    jm = _bp(J, A, y)
    tm32 = interop.from_jax_model(jm, device="cpu", dtype=torch.float32)
    assert tm32.functions[0]._A.data.dtype == torch.complex64


@pytest.mark.parametrize("block1", ["l1", "nonneg"])
def test_fused_realified_complex(block1):
    """Complex basis pursuit through the fused solver: realified, the
    separable block is RealPartProx and the kernel runs its `_even` mode;
    over 21 iterations the port (plain version of the kernel) agrees with
    the JAX fused solver in interpret mode, and the Im lanes of x1 are 0."""
    rng = np.random.RandomState(11)
    M, N, B = 24, 64, 4
    A = _randn_cmplx(rng, M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 4, replace=False)] = np.abs(rng.randn(4))
    ys = xt @ A.T
    mk = lambda P: P.Model([P.LeastSquares(1.0, A, ys[0]),
                            P.L1Regularizer(0.05, N) if block1 == "l1"
                            else P.NonNegativePenalty(N)],
                           [(1, 0, P.identity(N), P.identity(N))])
    fs = FusedTwoBlockSolver(T.realify_model(mk(T)).model, tile_b=4, device="cpu")
    fj = JaxFused(J.realify_model(mk(J)).model, tile_b=4)
    assert fs.prox == fj.prox == block1 + "_even"
    assert fs.thin and fj.thin
    ys_enc = encode(ys).numpy()
    rt = fs.solve({(0, "y"): ys_enc}, niter=21)
    rj = fj.solve({(0, "y"): ys_enc}, niter=21)
    for f in ("x0", "x1", "h"):
        np.testing.assert_allclose(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                   rtol=0, atol=5e-4, err_msg=f)
    np.testing.assert_array_equal(rt.mu.numpy(), np.asarray(rj.mu))
    assert np.all(rt.x1.numpy()[:, 1::2] == 0)
    # a real A realified has a Kronecker Gram, which the kernel cannot take
    Ar = rng.randn(M, N)
    real_re = T.realify_model(_bp(T, Ar.astype(complex), ys[0]))
    with pytest.raises(ValueError, match="Kronecker"):
        FusedTwoBlockSolver(real_re.model, device="cpu")
