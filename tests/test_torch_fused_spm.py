"""The SpM slice of the port against the JAX package, on the CPU in float32.

* the chunk's plain version against the Pallas kernel in interpret mode, on
  the same numpy inputs (the JAX kernel is feature-major and padded, the
  port batch-major and unpadded, so inputs and outputs are transposed);
* ``FusedSpMSolver.solve`` against the JAX ``FusedSpMSolver`` on one model
  carried over with ``from_jax_model``;
* ``FusedSpMSolver`` against the port's own float64 ``SimpleOptimizer``
  lane by lane, which holds the affine fold ``x0 = b2 - M hk0`` to the
  engine's block elimination inside the port.

Tolerances are those of tests/test_fused_spm.py: 5e-4 absolute over 21
iterations (the two sides take the same f32 sums in another order), 1e-3
over 80-120 iterations.  The CUDA kernel itself is held against the plain
version on a card in tests/test_torch_gpu.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import spm_model as jax_spm_model
from admmsolver_tpu.ops.kernels import fused_spm_chunk as jax_chunk
from admmsolver_tpu.parallel import FusedSpMSolver as JaxFusedSpM
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu_torch.ops.kernels import fused_spm_chunk, fused_spm_chunk_reference
from admmsolver_tpu_torch.parallel import FusedSpMSolver, FusedSpMResult

torch.set_num_threads(1)

ATOL = 5e-4


def _chunk_inputs(B=8, nl=16, nw=32, seed=0):
    """Batch-major numpy chunk inputs (P, M, b2, mu, thr, x0, x1, x2, h10,
    h20): M is the inverse of a per-lane positive-definite penalty matrix,
    as the solver makes it; unit-scale random state."""
    rng = np.random.RandomState(seed)
    P = 0.3 * rng.randn(nw, nl)
    G = rng.randn(nl + 4, nl)
    mu = rng.uniform(0.5, 2.0, (B, 2))
    pen = (G.T @ G)[None] + mu[:, :1, None] * np.eye(nl) + mu[:, 1:, None] * (P.T @ P)
    M = np.linalg.inv(pen)
    b2 = rng.randn(B, nl)
    thr = 0.05 / mu[:, :1]
    x0, x1, h10 = (s * rng.randn(B, nl) for s in (0.3, 0.3, 1.0))
    x2, h20 = (s * rng.randn(B, nw) for s in (0.3, 1.0))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return [f32(a) for a in (P, M, b2, mu, thr, x0, x1, x2, h10, h20)]


def _jax_chunk(args, n_iters):
    """The Pallas kernel in interpret mode on batch-major inputs; outputs
    back in batch-major."""
    P, M, b2, mu, thr, x0, x1, x2, h10, h20 = args
    B, nl = x0.shape
    scal = np.zeros((8, B), np.float32)
    scal[0], scal[1], scal[2] = mu[:, 0], mu[:, 1], thr[:, 0]
    Mf = M.transpose(1, 2, 0).reshape(nl * nl, B)
    out = jax_chunk(*map(jnp.asarray, (P.T.copy(), P, Mf, b2.T, scal, x0.T, x1.T, x2.T,
                                       h10.T, h20.T)),
                    n_iters=n_iters, tile_b=B, interpret=True)
    return [np.asarray(a).T for a in out]


@pytest.mark.parametrize("n_iters", [1, 21])
def test_plain_version_matches_jax_kernel(n_iters):
    args = _chunk_inputs()
    want = _jax_chunk(args, n_iters)
    launches = fused_spm_chunk.launches
    got = fused_spm_chunk(*map(torch.as_tensor, args), n_iters=n_iters)
    assert fused_spm_chunk.launches == launches  # CPU: no kernel launch
    assert len(got) == 6
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=ATOL)
    assert (got[2] >= 0).all()


def test_chunk_returns_previous_iterate():
    """x0_prev is the x0 the last iteration started from; zero iterations
    return the input state."""
    args = [torch.as_tensor(a) for a in _chunk_inputs(B=3, nl=5, nw=7)]
    two = fused_spm_chunk(*args, n_iters=2)
    three = fused_spm_chunk(*args, n_iters=3)
    assert torch.equal(three[5], two[0])
    zero = fused_spm_chunk(*args, n_iters=0)
    for got, want in zip(zero, (*args[5:], args[5])):
        assert torch.equal(got, want)
    # chunks compose: 2 + 1 iterations are 3 iterations
    again = fused_spm_chunk_reference(*args[:5], *two[:5], n_iters=1)
    for a, b in zip(again, three):
        assert torch.equal(a, b)


def test_chunk_rejects_bad_arguments():
    args = [torch.as_tensor(a) for a in _chunk_inputs(B=3, nl=5, nw=7)]
    with pytest.raises(TypeError, match="float32"):
        fused_spm_chunk(*args[:9], args[9].double(), n_iters=1)
    with pytest.raises(ValueError, match="M has shape"):
        fused_spm_chunk(args[0], args[1][:, :, :-1], *args[2:], n_iters=1)
    with pytest.raises(ValueError, match="mu has shape"):
        fused_spm_chunk(*args[:3], args[3][:, :1], *args[4:], n_iters=1)
    with pytest.raises(ValueError, match="x2 has shape"):
        fused_spm_chunk(*args[:7], args[7][:, :-1], *args[8:], n_iters=1)
    with pytest.raises(ValueError, match="n_iters"):
        fused_spm_chunk(*args, n_iters=-1)


# ---------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def spm_setup():
    """tests/test_fused_spm.py's problem: one JAX model, the port's copy of
    it, and B = 6 noisy data vectors."""
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    gs = g[None, :] + 1e-4 * np.random.RandomState(0).randn(6, g.size)
    jm = jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    return jm, interop.from_jax_model(jm, device="cpu"), gs, prj_sum


def _assert_same_result(rt: FusedSpMResult, rj, atol, state_only=False):
    for k in range(3):
        assert rt.x[k].dtype == torch.float32
        np.testing.assert_allclose(rt.x[k].numpy(), np.asarray(rj.x[k]), rtol=0, atol=atol)
    if state_only:
        return
    for k in range(2):
        np.testing.assert_allclose(rt.h[k].numpy(), np.asarray(rj.h[k]), rtol=0, atol=atol)
    np.testing.assert_allclose(rt.mu.numpy(), np.asarray(rj.mu), rtol=1e-6)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    assert tuple(rt.primal_residual.shape) == np.asarray(rj.primal_residual).shape
    np.testing.assert_allclose(rt.primal_residual.numpy(), np.asarray(rj.primal_residual),
                               rtol=2e-2, atol=ATOL)


@pytest.mark.parametrize("niter,interval", [(1, 100), (21, 100), (21, 5)])
def test_fused_spm_matches_jax_short(spm_setup, niter, interval):
    """Short horizon through the iteration-0 penalty update, with and
    without full chunks and a remainder chunk."""
    jm, tm, gs, _ = spm_setup
    kw = dict(niter=niter, mu0=0.1, interval_update_mu=interval)
    rj = JaxFusedSpM(jm, tile_b=2).solve({(0, "y"): gs}, **kw)
    rt = FusedSpMSolver(tm, device="cpu").solve({(0, "y"): gs}, **kw)
    _assert_same_result(rt, rj, ATOL)
    assert int(rt.iterations.max()) == niter


@pytest.mark.parametrize("key", [(1, "alpha"), (0, "alpha")])
def test_fused_spm_alpha_overrides_match_jax(spm_setup, key):
    """Per-lane alpha overrides reach the threshold and the factor."""
    jm, tm, gs, _ = spm_setup
    alphas = np.linspace(5e-4, 5e-3, 6) if key[0] == 1 else np.linspace(0.5, 2.0, 6)
    ov = {(0, "y"): gs, key: alphas}
    rj = JaxFusedSpM(jm, tile_b=2).solve(ov, niter=80, mu0=0.1)
    rt = FusedSpMSolver(tm, device="cpu").solve(ov, niter=80, mu0=0.1)
    _assert_same_result(rt, rj, 1e-3, state_only=True)
    base = FusedSpMSolver(tm, device="cpu").solve({(0, "y"): gs}, niter=80, mu0=0.1)
    assert not torch.allclose(base.x[0], rt.x[0], atol=1e-5)


def _plain_ls_model(P):
    rng = np.random.RandomState(1)
    nl, nw = 10, 17
    A = rng.randn(14, nl)
    prj = rng.randn(nw, nl) * 0.3
    ys = rng.randn(4, 14)
    model = P.Model([P.LeastSquares(1.0, A, ys[0]), P.L1Regularizer(0.05, nl),
                     P.NonNegativePenalty(nw)],
                    [(0, 1, P.identity(nl), P.identity(nl)), (0, 2, prj, P.identity(nw))])
    return model, ys


def test_fused_spm_plain_ls_block_matches_jax():
    """The unconstrained special case: M = B, b2 = alpha B A†y."""
    jm, ys = _plain_ls_model(J)
    tm, _ = _plain_ls_model(T)
    rj = JaxFusedSpM(jm, tile_b=2).solve({(0, "y"): ys}, niter=120)
    rt = FusedSpMSolver(tm, device="cpu").solve({(0, "y"): ys}, niter=120)
    _assert_same_result(rt, rj, 1e-3, state_only=True)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))


def test_fused_spm_without_overrides_solves_the_template(spm_setup):
    jm, tm, gs, _ = spm_setup
    rj = JaxFusedSpM(jm, tile_b=2).solve(batch_size=2, niter=21, mu0=0.1)
    rt = FusedSpMSolver(tm, device="cpu").solve(batch_size=2, niter=21, mu0=0.1)
    _assert_same_result(rt, rj, ATOL)
    assert torch.equal(rt.x[0][0], rt.x[0][1])
    with pytest.raises(ValueError, match="overrides or batch_size"):
        FusedSpMSolver(tm, device="cpu").solve(niter=5)


def test_fused_spm_ragged_batch_and_done_lanes(spm_setup):
    """Nothing is padded: B = 5 gives the first 5 lanes of B = 6, and a
    lane that starts done never iterates."""
    _, tm, gs, _ = spm_setup
    fs = FusedSpMSolver(tm, device="cpu")
    r6 = fs.solve({(0, "y"): gs}, niter=40, mu0=0.1)
    r5 = fs.solve({(0, "y"): gs[:5]}, niter=40, mu0=0.1)
    for k in range(3):
        assert tuple(r5.x[k].shape) == (5, r6.x[k].shape[1])
        np.testing.assert_allclose(r5.x[k].numpy(), r6.x[k][:5].numpy(), rtol=0, atol=1e-6)
    assert torch.equal(r5.iterations, r6.iterations[:5])
    done0 = np.array([False, True, False, False, True, False])
    rd = fs.solve({(0, "y"): gs}, niter=40, mu0=0.1, done0=done0)
    assert rd.iterations.tolist() == [40, 0, 40, 40, 0, 40]
    assert rd.converged.numpy()[done0].all()
    for k in range(3):
        assert not rd.x[k][done0].any()
        np.testing.assert_allclose(rd.x[k][~done0].numpy(), r6.x[k][~done0].numpy(),
                                   rtol=0, atol=1e-6)
    assert np.all(rd.mu.numpy()[done0] == np.float32(0.1))
    with pytest.raises(ValueError, match="done0"):
        fs.solve({(0, "y"): gs}, niter=5, done0=done0[:3])


def test_fused_spm_converges_and_exits_early(spm_setup):
    """With an absolute tolerance every lane converges, the schedule stops
    at the chunk where the last one does, and the solution has the model's
    properties: sum rule, nonnegative spectrum."""
    _, tm, gs, prj_sum = spm_setup
    r = FusedSpMSolver(tm, device="cpu").solve({(0, "y"): gs}, niter=1001, mu0=0.1,
                                               atol=1e-3)
    assert bool(r.converged.all())
    assert int(r.iterations.max()) < 1001
    assert tuple(r.primal_residual.shape) == (6, 11)
    assert torch.isnan(r.primal_residual[:, -1]).all()  # chunks never run stay NaN
    assert float(r.x[2].min()) >= 0.0
    np.testing.assert_allclose(r.x[0].numpy() @ prj_sum, 1.0, atol=1e-4)


def test_fused_spm_rejects_wrong_structure(spm_setup):
    _, tm, gs, _ = spm_setup
    rng = np.random.RandomState(2)
    A = rng.randn(6, 8)
    I = T.identity(8)
    ls, l1, nn = T.LeastSquares(1.0, A, rng.randn(6)), T.L1Regularizer(0.1, 8), \
        T.NonNegativePenalty(8)
    with pytest.raises(ValueError, match="3-block"):
        FusedSpMSolver(T.Model([ls, l1], [(1, 0, I, I)]), device="cpu")
    with pytest.raises(ValueError, match="coupled to block 0"):
        FusedSpMSolver(T.Model([ls, l1, nn], [(1, 0, I, I), (2, 1, I, I)]), device="cpu")
    with pytest.raises(ValueError, match="block 1 must be L1"):
        FusedSpMSolver(T.Model([ls, nn, nn], [(1, 0, I, I), (2, 0, I, I)]), device="cpu")
    with pytest.raises(ValueError, match="block 2 must be NonNeg"):
        FusedSpMSolver(T.Model([ls, l1, l1], [(1, 0, I, I), (2, 0, I, I)]), device="cpu")
    with pytest.raises(ValueError, match="block 0 must be"):
        FusedSpMSolver(T.Model([l1, l1, nn], [(1, 0, I, I), (2, 0, I, I)]), device="cpu")
    with pytest.raises(ValueError, match="offsets"):
        FusedSpMSolver(T.Model([ls, T.L1Regularizer(0.1, 8, np.ones(8)), nn],
                               [(1, 0, I, I), (2, 0, I, I)]), device="cpu")
    with pytest.raises(ValueError, match="couplings must be"):
        FusedSpMSolver(T.Model([ls, l1, nn], [(1, 0, I, T.DiagonalMatrix(np.full(8, 2.0))),
                                              (2, 0, I, I)]), device="cpu")
    assert callable(FusedSpMSolver.solve_mixed)  # tests/test_torch_mixed.py


def test_fused_spm_rejects_unsupported_overrides(spm_setup):
    _, tm, gs, _ = spm_setup
    fs = FusedSpMSolver(tm, device="cpu")
    B, nl = gs.shape[0], fs.nl
    bad = {(0, "y"): gs, (0, "A"): np.zeros((B, gs.shape[1], nl))}
    with pytest.raises(ValueError, match="supports per-instance"):
        fs.solve(bad, niter=5)
    with pytest.raises(ValueError, match="leading batch axis"):
        fs.solve({(1, "alpha"): 0.1}, batch_size=B, niter=5)
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        fs.solve({(0, "y"): gs, (1, "alpha"): np.ones(B - 1)}, niter=5)


@pytest.mark.parametrize("lane", range(3))
def test_fused_spm_matches_the_ports_engine(spm_setup, lane):
    """The affine fold against the engine's block elimination, inside the
    port: FusedSpMSolver (f32) and SimpleOptimizer (f64) on one lane."""
    _, tm, gs, _ = spm_setup
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    rt = FusedSpMSolver(tm, device="cpu").solve({(0, "y"): gs}, niter=21, mu0=0.1)
    opt = T.SimpleOptimizer(spm_model(s, gs[lane], prj_sum, prj_w, alpha_l1=1e-3), mu=0.1,
                            device="cpu")
    opt.solve(21, interval_update_mu=100)
    assert opt.x[0].dtype == torch.float64
    for k in range(3):
        np.testing.assert_allclose(rt.x[k][lane].numpy(), opt.x[k].numpy(), rtol=0, atol=ATOL)
    for k in range(2):
        np.testing.assert_allclose(rt.h[k][lane].numpy(), opt.h[k].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rt.mu[lane].numpy(), opt.mu.numpy(), rtol=1e-6)
