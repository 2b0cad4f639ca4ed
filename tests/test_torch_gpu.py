"""Tests of the port that need a CUDA card: the hand-written chunk kernels
and the Jacobi eigh kernel against their plain versions, the spectral prox
routes the card takes, and the solvers on the card against the same
solvers on the CPU.  They import torch only (no jax), so on a machine with
a card they run with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q

and everywhere else they skip (the last test is the reverse: it checks
that without a card the default device raises).  Kernel tolerance 5e-4 absolute (f32 sums in
another order over 21 iterations, as in tests/test_kernels.py)."""
import numpy as np
import pytest
import torch

import admmsolver_tpu_torch as T
from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu_torch.ops.kernels import (fused_spm_chunk, fused_spm_chunk_reference,
                                              fused_two_block_chunk,
                                              fused_two_block_chunk_reference)
from admmsolver_tpu_torch.parallel import BatchedSolver, FusedSpMSolver, FusedTwoBlockSolver

pytestmark = pytest.mark.gpu

ATOL = 5e-4
PROX = ("l1", "l1_even", "nonneg", "nonneg_even")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(thin, prox, B, N, device, seed=3, R=None):
    """Chunk inputs from the thin basis of a wide A (rank ``R``, N // 2 by
    default) or the full eigenbasis of a tall one, with unit-scale random
    data and state."""
    rng = np.random.RandomState(seed)
    A = rng.randn((R or N // 2) if thin else N + 40, N)
    if thin:
        lam, W = np.linalg.eigh(A @ A.T)
        U = A.T @ W / np.sqrt(lam)
    else:
        lam, U = np.linalg.eigh(A.T @ A)
    mu = rng.uniform(0.5, 2.0, (B, 1))
    dinv = 1.0 / (lam[None, :] + mu) - (1.0 / mu if thin else 0.0)
    thr = 0.05 / mu if prox.startswith("l1") else np.zeros_like(mu)
    acy, x0, x1, h = (s * rng.randn(B, N) for s in (1.0, 0.3, 0.3, 1.0))
    return [torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)
            for a in (U, U.T, dinv, acy, mu, thr, x0, x1, h)]


def _check_chunk(args, n_iters, prox, thin):
    launches = fused_two_block_chunk.launches
    got = fused_two_block_chunk(*args, n_iters=n_iters, prox=prox, thin=thin)
    want = fused_two_block_chunk_reference(*args, n_iters=n_iters, prox=prox, thin=thin)
    torch.cuda.synchronize()
    assert fused_two_block_chunk.launches == launches + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("thin", [True, False], ids=["thin", "full"])
@pytest.mark.parametrize("prox", PROX)
@pytest.mark.parametrize("B,N", [(37, 100), (64, 512)])
def test_cuda_kernel_matches_plain_version(cuda, prox, thin, B, N):
    """Ragged B, N and R (no multiple of the lane tile or of 128), and the
    bench width N=512."""
    _check_chunk(_inputs(thin, prox, B, N, cuda), 21, prox, thin)


@pytest.mark.parametrize("n_iters", [1, 2, 21])
@pytest.mark.parametrize("B,N,R", [
    (37, 512, None),    # B below two lane tiles: the cluster's second block is empty
    (129, 512, None),   # B one past a multiple of the lane tile and of the cluster
    (129, 132, 77),     # R > N/2, N and R ragged against the k-tile; R odd: no bulk copies
    (70, 600, None),    # 32 lanes do not fit: the FMA kernel at 16 lanes
])
def test_cuda_kernel_short_chunks_and_ragged_shapes(cuda, n_iters, B, N, R):
    """x0_prev leaves the loop one iteration before the last, or is the
    input x0 when there is one iteration only."""
    _check_chunk(_inputs(True, "l1", B, N, cuda, R=R), n_iters, "l1", True)


TILINGS_TC = [(32, 32, 2, 1, 1), (32, 32, 2, 2, 1), (32, 16, 4, 2, 1), (32, 16, 2, 4, 1)]
TILINGS_FMA = [(32, 32, 2, 2, 0), (32, 32, 2, 1, 0), (16, 16, 4, 2, 0), (16, 16, 2, 1, 0),
               (8, 16, 4, 1, 0), (4, 16, 2, 4, 0), (2, 16, 4, 1, 0), (1, 16, 4, 1, 0)]


@pytest.mark.parametrize("tilings", [TILINGS_TC, TILINGS_FMA], ids=["tensor-cores", "fma"])
def test_cuda_kernel_tilings_agree(cuda, tilings):
    """Lanes per block, k-tile depth, stages and cluster size do not change
    a bit: every sum runs over k in the same order.  The
    two routes (split TF32 on the tensor cores, f32 FMA) differ by rounding
    only."""
    from admmsolver_tpu_torch.ops.kernels import TwoBlockTiling, _two_block_launch

    args = _inputs(True, "l1_even", 129, 512, cuda, seed=5)
    outs = [_two_block_launch(args, 5, "l1_even", True, TwoBlockTiling(*t)) for t in tilings]
    torch.cuda.synchronize()
    for out in outs[1:]:
        for g, w in zip(out, outs[0]):
            assert torch.equal(g, w)
    other = TILINGS_FMA[0] if tilings is TILINGS_TC else TILINGS_TC[0]
    ref = _two_block_launch(args, 5, "l1_even", True, TwoBlockTiling(*other))
    for g, w in zip(outs[0], ref):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


def test_cuda_kernel_shared_memory_matches_the_wrapper(cuda):
    """The wrapper sizes a block's shared memory with the kernel's own
    formula, and a tiling the kernel is not built for fails at the launch."""
    from admmsolver_tpu_torch.ops import _build
    from admmsolver_tpu_torch.ops.kernels import (TwoBlockTiling, _two_block_launch,
                                                  _two_block_smem_bytes)

    lib = _build.load_libraries()["fused_two_block"]
    for tb, N, R, kt, stages, tc in [(32, 512, 256, 32, 2, 1), (32, 512, 256, 32, 2, 0),
                                     (16, 600, 300, 16, 3, 0), (1, 33, 7, 16, 2, 0)]:
        assert lib.fused_two_block_smem_bytes(tb, N, R, kt, stages, tc) == \
            _two_block_smem_bytes(tb, N, R, kt, stages, tc)
    args = _inputs(True, "l1", 8, 64, cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        _two_block_launch(args, 1, "l1", True, TwoBlockTiling(24, 16, 2, 1, 0))


@pytest.mark.parametrize("thin", [True, False], ids=["thin", "full"])
def test_cuda_kernel_large_magnitudes_and_non_finite_lanes(cuda, thin):
    """The tensor-core kernel splits operands by their bit patterns and
    divides by mu through 1/mu: state scaled by 2^100 (an exact scaling of
    the nonneg iteration) gives the scaled result, and a lane that holds an
    inf or a NaN comes out non-finite where the plain version's does, with
    every other lane as if it were not there."""
    B, N, scale = 70, 128, 2.0 ** 100
    args = _inputs(thin, "nonneg", B, N, cuda, seed=9)
    want = fused_two_block_chunk_reference(*args, n_iters=21, prox="nonneg", thin=thin)
    big = args[:3] + [args[3] * scale] + args[4:6] + [a * scale for a in args[6:]]
    got = fused_two_block_chunk(*big, n_iters=21, prox="nonneg", thin=thin)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose((g / scale).cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)

    bad = [a.clone() for a in args]
    bad[3][5, 7] = float("inf")     # acy of lane 5
    bad[8][40, 0] = float("nan")    # h of lane 40
    bad[6][66, 3] = float("-inf")   # x0 of lane 66: read by no iteration
    got = fused_two_block_chunk(*bad, n_iters=3, prox="nonneg", thin=thin)
    ref = fused_two_block_chunk_reference(*bad, n_iters=3, prox="nonneg", thin=thin)
    clean = fused_two_block_chunk_reference(*args, n_iters=3, prox="nonneg", thin=thin)
    torch.cuda.synchronize()
    for g, r, c in zip(got, ref, clean):
        lanes = torch.isfinite(g).all(dim=1)
        assert torch.equal(lanes, torch.isfinite(r).all(dim=1))
        assert lanes.sum().item() == B - 2
        np.testing.assert_allclose(g[lanes].cpu().numpy(), c[lanes].cpu().numpy(),
                                   rtol=0, atol=ATOL)


def test_cuda_kernel_zero_iterations_and_checks(cuda):
    args = _inputs(True, "l1", 5, 64, cuda)
    x0, x1, h, prev = fused_two_block_chunk(*args, n_iters=0)
    torch.cuda.synchronize()
    for a, b in ((x0, args[6]), (x1, args[7]), (h, args[8]), (prev, args[6])):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="contiguous"):
        fused_two_block_chunk(args[0], args[1], *args[2:6], args[6].T.contiguous().T,
                              *args[7:], n_iters=1)
    with pytest.raises(ValueError, match="tensors on"):
        fused_two_block_chunk(*args[:8], args[8].cpu(), n_iters=1)


def _bp(A, y, block1="l1"):
    N = A.shape[1]
    b1 = T.L1Regularizer(0.1, N) if block1 == "l1" else T.NonNegativePenalty(N)
    return T.Model([T.LeastSquares(1.0, A, y), b1], [(1, 0, T.identity(N), T.identity(N))])


@pytest.mark.parametrize("block1", ["l1", "nonneg"])
def test_fused_solver_on_cuda_matches_cpu(cuda, block1):
    rng = np.random.RandomState(0)
    A = rng.randn(64, 128)
    xt = np.zeros((8, 128))
    for b in range(8):
        xt[b, rng.choice(128, 8, replace=False)] = rng.randn(8)
    ys = xt @ A.T if block1 == "l1" else np.abs(xt @ A.T)
    launches = fused_two_block_chunk.launches
    rc = FusedTwoBlockSolver(_bp(A, ys[0], block1), tile_b=4, device=cuda).solve(
        {(0, "y"): ys}, niter=21)
    assert fused_two_block_chunk.launches == launches + 2
    rh = FusedTwoBlockSolver(_bp(A, ys[0], block1), tile_b=4, device="cpu").solve(
        {(0, "y"): ys}, niter=21)
    for f in ("x0", "x1", "h"):
        np.testing.assert_allclose(getattr(rc, f).cpu().numpy(), getattr(rh, f).numpy(),
                                   rtol=0, atol=ATOL)
    np.testing.assert_array_equal(rc.iterations.cpu().numpy(), rh.iterations.numpy())


def test_simple_optimizer_on_cuda_matches_cpu(cuda):
    rng = np.random.RandomState(1234)
    A = rng.randn(20, 60)
    y = A @ np.where(rng.rand(60) < 0.1, rng.randn(60), 0.0)
    oc = T.SimpleOptimizer(_bp(A, y), device=cuda)
    oh = T.SimpleOptimizer(_bp(A, y), device="cpu")
    oc.solve(200, interval_update_mu=20)
    oh.solve(200, interval_update_mu=20)
    assert oc.x[0].is_cuda and oc.iterations == oh.iterations
    np.testing.assert_allclose(oc.x[0].cpu().numpy(), oh.x[0].numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(oc.mu.cpu().numpy(), oh.mu.numpy())


# ---------------------------------------------------------------------
# SpM slice
# ---------------------------------------------------------------------

def _spm_solver(device, nl=12, nw=25, B=6):
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=nl, nw=nw)
    gs = g[None, :] + 1e-4 * np.random.RandomState(0).randn(B, g.size)
    kw = {} if device is None else {"device": device}   # None: the solver's default
    return FusedSpMSolver(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), **kw), gs


def _spm_inputs(nl, nw, B, device, seed=3):
    """Chunk inputs: the projector of the synthetic SpM basis, the solver's
    own factors for per-lane penalties in [0.5, 2], unit-scale state."""
    solver, gs = _spm_solver(device, nl, nw, B)
    rng = np.random.RandomState(seed)
    f32 = dict(dtype=torch.float32, device=device)
    mu = torch.as_tensor(rng.uniform(0.5, 2.0, (B, 2)), **f32)
    acy = torch.as_tensor(gs, **f32) @ solver.Ac.T
    M, b2 = solver._factors(mu[:, 0], mu[:, 1], torch.ones(B, **f32), acy)
    thr = (0.05 / mu[:, :1]).contiguous()
    x0, x1, h10 = (torch.as_tensor(s * rng.randn(B, nl), **f32) for s in (0.3, 0.3, 1.0))
    x2, h20 = (torch.as_tensor(s * rng.randn(B, nw), **f32) for s in (0.3, 1.0))
    return [solver.P, M, b2, mu, thr, x0, x1, x2, h10, h20]


@pytest.mark.parametrize("nl,nw,B", [(12, 25, 37), (30, 201, 64), (33, 70, 5), (2, 3, 3),
                                     (40, 130, 300), (32, 256, 33), (17, 57, 70)])
def test_cuda_spm_kernel_matches_plain_version(cuda, nl, nw, B):
    """Ragged nl, nw and B (no multiple of 4, of the warp or of the lanes
    per block), nl above one warp, and the full width nl=30, nw=201."""
    args = _spm_inputs(nl, nw, B, cuda)
    launches = fused_spm_chunk.launches
    got = fused_spm_chunk(*args, n_iters=21)
    want = fused_spm_chunk_reference(*args, n_iters=21)
    torch.cuda.synchronize()
    assert fused_spm_chunk.launches == launches + 1
    for g, w in zip(got, want):
        assert g.is_cuda and g.shape == w.shape
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


@pytest.mark.parametrize("tiling", [(1, 1), (1, 5), (2, 3), (4, 2), (4, 16), (0, 8)])
def test_cuda_spm_kernel_tilings_agree(cuda, tiling):
    """Every instantiation of the FMA kernel (lanes per warp) and block size
    gives the same bits: a lane's sums do not depend on its neighbours.  The
    tensor-core kernel, (0, 8), sums in another order and in split TF32, and
    agrees within the kernel tolerance."""
    from admmsolver_tpu_torch.ops.kernels import _spm_launch

    args = _spm_inputs(12, 25, 37, cuda)
    want = _spm_launch(args, 7, (2, 16))
    got = _spm_launch(args, 7, tiling)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if tiling[0]:
            assert torch.equal(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), rtol=0, atol=ATOL)


def test_cuda_spm_kernel_zero_iterations_and_checks(cuda):
    args = _spm_inputs(12, 25, 5, cuda)
    out = fused_spm_chunk(*args, n_iters=0)
    torch.cuda.synchronize()
    for got, want in zip(out, (*args[5:], args[5])):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="contiguous"):
        fused_spm_chunk(*args[:5], args[5].T.contiguous().T, *args[6:], n_iters=1)
    with pytest.raises(ValueError, match="tensors on"):
        fused_spm_chunk(*args[:9], args[9].cpu(), n_iters=1)
    with pytest.raises(ValueError, match="shared memory"):
        big = _spm_inputs(250, 300, 2, cuda)
        fused_spm_chunk(*big, n_iters=1)


def test_fused_spm_solver_on_cuda_matches_cpu(cuda):
    sc, gs = _spm_solver(cuda)
    sh, _ = _spm_solver("cpu")
    launches = fused_spm_chunk.launches
    rc = sc.solve({(0, "y"): gs}, niter=21, mu0=0.1, interval_update_mu=10)
    assert fused_spm_chunk.launches == launches + 3   # 1 + 10 + 10 iterations
    rh = sh.solve({(0, "y"): gs}, niter=21, mu0=0.1, interval_update_mu=10)
    for k in range(3):
        assert rc.x[k].is_cuda
        np.testing.assert_allclose(rc.x[k].cpu().numpy(), rh.x[k].numpy(), rtol=0, atol=ATOL)
    for k in range(2):
        np.testing.assert_allclose(rc.h[k].cpu().numpy(), rh.h[k].numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(rc.mu.cpu().numpy(), rh.mu.numpy(), rtol=1e-6)
    np.testing.assert_array_equal(rc.iterations.cpu().numpy(), rh.iterations.numpy())


def test_simple_optimizer_spm_on_cuda_matches_cpu(cuda):
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    model = spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    oc = T.SimpleOptimizer(model, mu=0.1)   # the default device is the card
    oh = T.SimpleOptimizer(model, mu=0.1, device="cpu")
    oc.solve(200)
    oh.solve(200)
    assert oc.x[0].is_cuda and oc.iterations == oh.iterations
    for a, b in zip(oc.x, oh.x):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(oc.mu.cpu().numpy(), oh.mu.numpy())


@pytest.mark.parametrize("model", ["two_block", "spm"])
def test_batched_solver_on_cuda_matches_cpu(cuda, model):
    """The float64 batched engine on the card (its default device) against
    itself on the host: shared eigenbasis with per-lane shifts, and per-lane
    dense factors of the constrained SpM block."""
    rng = np.random.RandomState(3)
    if model == "two_block":
        A = rng.randn(12, 30)
        tm = _bp(A, rng.randn(12))
        ov = {(0, "y"): rng.randn(4, 12), (1, "alpha"): np.linspace(0.05, 0.5, 4)}
        kw = dict(niter=150, interval_update_mu=20)
    else:
        solver, gs = _spm_solver("cpu")
        tm, ov, kw = solver.model, {(0, "y"): gs}, dict(niter=150, mu0=0.1)
    rc = BatchedSolver(tm).solve(ov, **kw)
    rh = BatchedSolver(tm, device="cpu").solve(ov, **kw)
    for a, b in zip(rc.x + rc.h, rh.x + rh.h):
        assert a.is_cuda and a.dtype == torch.float64
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-9)
    np.testing.assert_allclose(rc.mu.cpu().numpy(), rh.mu.numpy(), rtol=1e-12)
    np.testing.assert_array_equal(rc.iterations.cpu().numpy(), rh.iterations.numpy())
    np.testing.assert_allclose(rc.primal_residual.cpu().numpy(), rh.primal_residual.numpy(),
                               rtol=1e-6, atol=1e-12)


def test_fused_spm_solve_mixed_on_cuda_launches_the_kernel(cuda):
    """The float32 phase goes through the chunk kernel (1 + 100 + 19
    iterations: three launches), the polish runs in float64 on the card and
    ends where the host's mixed solve ends."""
    sc, gs = _spm_solver(cuda)
    sh, _ = _spm_solver("cpu")
    kw = dict(niter_low=120, niter=150, mu0=0.1, rtol=0.0, low_atol=0.0,
              record_residuals=False)
    launches = fused_spm_chunk.launches
    rc = sc.solve_mixed({(0, "y"): gs}, **kw)
    assert fused_spm_chunk.launches == launches + 3
    rh = sh.solve_mixed({(0, "y"): gs}, **kw)
    for k in range(3):
        assert rc.x[k].is_cuda and rc.x[k].dtype == torch.float64
        np.testing.assert_allclose(rc.x[k].cpu().numpy(), rh.x[k].numpy(), rtol=0, atol=2e-5)
    assert rc.iterations.tolist() == [270] * 6


# ---------------------------------------------------------------------
# stream drivers and complex problems through the real embedding
# ---------------------------------------------------------------------

def test_scheduler_run_compiled_on_cuda_matches_run(cuda):
    """The device-side drain against the host wave loop on the card, and
    both against the host loop on the CPU: equal iteration counts and
    flags, x within 1e-9 of its scale."""
    from admmsolver_tpu_torch.parallel import ScenarioScheduler

    rng = np.random.RandomState(5)
    A = rng.randn(12, 24)
    K = rng.randint(2, 10, 13)
    xt = np.zeros((13, 24))
    for i in range(13):
        xt[i, rng.choice(24, K[i], replace=False)] = rng.randn(K[i])
    ys = xt @ A.T
    alphas = 10.0 ** rng.uniform(-2.5, -0.5, 13)
    stream = lambda: ({(0, "y"): ys[i], (1, "alpha"): np.float64(alphas[i])} for i in range(13))
    kw = dict(batch_size=4, chunk_iters=50, niter_max=1500, rtol=0.0, atol=1e-9)
    on_card = ScenarioScheduler(BatchedSolver(_bp(A, ys[0])), **kw)
    on_host = ScenarioScheduler(BatchedSolver(_bp(A, ys[0]), device="cpu"), **kw)
    runs = [on_card.run(stream()), on_card.run_compiled(stream()), on_host.run(stream())]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            assert (a.scenario_id, a.iterations, a.converged) == \
                (b.scenario_id, b.iterations, b.converged)
            scale = np.abs(b.x[0]).max()
            np.testing.assert_allclose(a.x[0], b.x[0], rtol=0, atol=1e-9 * scale)


def test_solve_resumable_on_cuda(cuda, tmp_path):
    """Stopped after one segment and resumed from the file on the card:
    equal to the uninterrupted run, exactly."""
    from admmsolver_tpu_torch.models.applications import basis_pursuit_model

    rng = np.random.RandomState(0)
    A = rng.randn(16, 32)
    ys = rng.randn(6, 16)
    bs = BatchedSolver(basis_pursuit_model(A, ys[0], alpha_l1=0.05))
    kw = dict(checkpoint_every=100, niter=300, rtol=0.0, record_residuals=False)
    first = bs.solve_resumable(str(tmp_path / "a.npz"), {(0, "y"): ys}, **{**kw, "niter": 100})
    assert first.x[0].is_cuda and int(first.iterations.max()) == 100
    resumed = bs.solve_resumable(str(tmp_path / "a.npz"), {(0, "y"): ys}, **kw)
    straight = bs.solve_resumable(str(tmp_path / "b.npz"), {(0, "y"): ys}, **kw)
    for a, b in zip(resumed.x + resumed.h, straight.x + straight.h):
        assert a.is_cuda
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert resumed.iterations.tolist() == [300] * 6


@pytest.mark.parametrize("model", ["basis_pursuit", "spm"])
def test_realified_complex_on_cuda_matches_complex128(cuda, model):
    """A complex128 model solved on the card equals its real embedding
    solved on the card (the isomorphism on the device), and the batched
    realified solve on the card equals the one on the host."""
    from admmsolver_tpu_torch.models.realify import decode, encode

    rng = np.random.RandomState(7)
    if model == "basis_pursuit":
        A = rng.randn(8, 16) + 1j * rng.randn(8, 16)
        ys = rng.randn(3, 8) + 1j * rng.randn(3, 8)
        cm, mu, niter = _bp(A, ys[0]), None, 130
    else:
        s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
        ys = g[None, :] + 1e-4 * (rng.randn(3, g.size) + 1j * rng.randn(3, g.size))
        cm, mu, niter = spm_model(s, ys[0], prj_sum, prj_w, alpha_l1=1e-3), 0.1, 150
    re = T.realify_model(cm)
    oc = T.SimpleOptimizer(cm, mu=mu)
    orr = T.SimpleOptimizer(re.model, mu=mu)
    oc.solve(niter, rtol=0)
    orr.solve(niter, rtol=0)
    assert oc.x[0].is_cuda and oc.x[0].dtype == torch.complex128
    for xc, xr in zip(oc.x, orr.x):
        np.testing.assert_allclose(decode(xr).cpu().numpy(), xc.cpu().numpy(), rtol=0,
                                   atol=1e-10)
    ov = {(0, "y"): encode(ys).numpy()}
    kw = dict(niter=niter, rtol=0, mu0=mu or 1.0)
    rc = BatchedSolver(re.model).solve(ov, **kw)
    rh = BatchedSolver(re.model, device="cpu").solve(ov, **kw)
    for a, b in zip(rc.x + rc.h, rh.x + rh.h):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-9)


def test_fused_realified_on_cuda_launches_the_kernel(cuda):
    """Complex basis pursuit realified through FusedTwoBlockSolver on the
    card: the `_even` kernel mode launches and agrees with the plain
    version on the host to 5e-4 over 21 iterations; the Im lanes of x1 are
    exactly 0."""
    from admmsolver_tpu_torch.models.realify import encode

    rng = np.random.RandomState(11)
    A = rng.randn(24, 64) + 1j * rng.randn(24, 64)
    xt = np.zeros((8, 64))
    for b in range(8):
        xt[b, rng.choice(64, 4, replace=False)] = rng.randn(4)
    yc = xt @ A.T
    ys = encode(yc).numpy()
    re = T.realify_model(_bp(A, yc[0]))
    launches = fused_two_block_chunk.launches
    fc = FusedTwoBlockSolver(re.model, tile_b=4)
    assert fc.prox == "l1_even"
    rc = fc.solve({(0, "y"): ys}, niter=21)
    assert fused_two_block_chunk.launches == launches + 2
    rh = FusedTwoBlockSolver(re.model, tile_b=4, device="cpu").solve({(0, "y"): ys}, niter=21)
    for f in ("x0", "x1", "h"):
        np.testing.assert_allclose(getattr(rc, f).cpu().numpy(), getattr(rh, f).numpy(),
                                   rtol=0, atol=ATOL)
    assert bool((rc.x1[:, 1::2] == 0).all())


def _family_prox(name):
    """(objective, h, mu_diag) of each added family's prox, float64."""
    rng = np.random.RandomState(4)
    if name == "psd":
        f, n = T.SemiPositiveDefinitePenalty((6, 6, 5), 2), 180
    elif name == "nuclear":
        f, n = T.NuclearNormPenalty(1.3, (8, 5)), 40
    elif name == "group":
        f, n = T.GroupL1Regularizer(0.8, 4, 5), 20
    elif name == "huber":
        f, n = T.HuberLoss(0.8, rng.randn(15), 0.3), 15
    else:
        f, n = T.BoxProjectionPenalty(15, -0.3, 0.7), 15      # Python-scalar bounds
    h = 2.0 * rng.randn(3, n)
    mu = rng.uniform(0.5, 2.0, (3, 1)) * np.ones((1, n))
    return f, h, mu


@pytest.mark.parametrize("name", ["psd", "nuclear", "group", "huber", "box"])
def test_family_prox_on_cuda_matches_cpu(cuda, name):
    """Each added prox on the card, batched and single, against the same call
    on the host; Box and Huber take Python-scalar parameters (0-d host
    tensors meet card tensors)."""
    f, h, mu = _family_prox(name)
    fc = f.to(cuda)
    hc, muc = torch.as_tensor(h, device=cuda), torch.as_tensor(mu, device=cuda)
    got = fc.prox_diag(hc, muc, batched=True)
    want = f.prox_diag(torch.as_tensor(h), torch.as_tensor(mu), batched=True)
    assert got.is_cuda and got.dtype == torch.float64
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))
    single = f.prox_diag(hc[0], muc[0])           # the host object on card tensors
    np.testing.assert_allclose(single.cpu().numpy(), want[0].numpy(), rtol=0,
                               atol=1e-12 * float(want.abs().max()))


def test_box_with_python_bounds_solves_on_cuda(cuda):
    from admmsolver_tpu_torch.models.applications import bounded_lsq_model

    rng = np.random.RandomState(5)
    A, y = rng.randn(20, 12), rng.randn(20)
    o = T.SimpleOptimizer(bounded_lsq_model(A, y, 0.0, 0.5))
    o.solve(300)
    assert o.x[1].is_cuda and float(o.x[1].min()) >= 0.0 and float(o.x[1].max()) <= 0.5
    r = BatchedSolver(bounded_lsq_model(A, y, 0.0, 0.5)).solve(
        {(0, "y"): np.stack([y, -y]), (1, "hi"): np.array([0.3, 0.5])}, niter=300)
    assert float(r.x[1][0].max()) <= 0.3 and float(r.x[1][1].max()) <= 0.5


def test_batched_tv_on_cuda_matches_simple_optimizer(cuda):
    """The per-lane banded penalty and its cyclic-reduction factor on the
    card: lanes against SimpleOptimizer solves there, and the batch against
    itself on the host."""
    from admmsolver_tpu_torch.models.applications import tv_denoise_model
    from admmsolver_tpu_torch.ops.linop import TridiagFactor

    rng = np.random.RandomState(6)
    n, B = 300, 3
    truth = np.r_[np.zeros(n // 2), np.ones(n - n // 2)]
    ys = truth[None, :] + 0.2 * rng.randn(B, n)
    bs = BatchedSolver(tv_denoise_model(ys[0], 0.4))
    factors = bs.plan.compute_factors(torch.ones(B, 1, dtype=torch.float64, device=cuda),
                                      batched=True)
    assert isinstance(factors[0], TridiagFactor) and factors[0].d_final.is_cuda
    rc = bs.solve({(0, "y"): ys}, niter=150)
    rh = BatchedSolver(tv_denoise_model(ys[0], 0.4), device="cpu").solve({(0, "y"): ys},
                                                                         niter=150)
    for a, b in zip(rc.x + rc.h, rh.x + rh.h):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-9)
    for b in range(B):
        o = T.SimpleOptimizer(tv_denoise_model(ys[b], 0.4))
        o.solve(150)
        np.testing.assert_allclose(rc.x[0][b].cpu().numpy(), o.x[0].cpu().numpy(),
                                   rtol=0, atol=1e-9)
        assert int(rc.iterations[b]) == o.iterations


def _sym_batch(B, n, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(B, n, n)
    return torch.as_tensor(a + a.transpose(0, 2, 1), dtype=dtype, device=device)


@pytest.mark.parametrize("B,n,dtype,mode", [
    (300, 8, torch.float64, 0),         # the block kernel, A and V in shared memory
    (16, 64, torch.float32, 0),
    (4, 128, torch.float64, 1),         # the block kernel, float64 above 120: device memory
    (2, 256, torch.float32, None),      # float32 above 168: device memory
    (6, 32, torch.float64, 1),          # device memory forced at a small n
    (301, 8, torch.float64, None),      # warp path: 4 slices a warp, the last warp partly filled
    (97, 6, torch.float32, None),       # n does not divide 32: 5 slices a warp, 2 idle lanes
    (33, 16, torch.float64, None),
    (64, 30, torch.float32, None),      # one slice a warp, 2 idle lanes
    (256, 32, torch.float64, None),     # 8c's slices
    (256, 32, torch.float32, None),
    (5, 2, torch.float64, None),        # 16 slices a warp
    (6, 32, torch.float64, 0),          # the block kernel forced below the boundary
    (4, 34, torch.float64, None),       # the first n of the tile path
    (7, 48, torch.float32, None),       # tile path
    (16, 64, torch.float64, None),
    (5, 96, torch.float32, None),
    (4, 118, torch.float64, None),
    (4, 128, torch.float64, None),      # the last n of the tile path, float64 in shared memory
    (4, 128, torch.float32, None),
    (16, 64, torch.float64, 0),         # the block kernel forced inside the tile path's range
], ids=["shared-f64", "shared-f32", "global-f64", "global-f32", "forced-global",
        "warp-f64-partial", "warp-f32-n6", "warp-f64-n16", "warp-f32-n30", "warp-f64-n32",
        "warp-f32-n32", "warp-f64-n2", "forced-shared-n32", "block-f64-n34", "tile-f32-n48",
        "tile-f64-n64", "tile-f32-n96", "tile-f64-n118", "tile-f64-n128", "tile-f32-n128",
        "forced-shared-n64"])
def test_cuda_jacobi_kernel_matches_plain_version(cuda, B, n, dtype, mode):
    """The Jacobi kernel against its plain version on the same slices at
    the default sweep count: sorted eigenvalues within 10·n·eps·max|w|, its
    own V reconstructing A to the same limit and orthogonal within
    10·n·eps; one launch counted.  (The limits follow chip_smoke.py 10d's
    readings, which it prints against them.)  Without ``mode`` the
    dispatch picks the warp path for n <= 32, the tile path for 34 <= n <=
    128 and the block kernel above."""
    from admmsolver_tpu_torch.ops import kernels
    from admmsolver_tpu_torch.ops.linop import _jacobi_sweeps

    a = _sym_batch(B, n, dtype, cuda)
    sweeps = _jacobi_sweeps(n, n <= 16, dtype)
    launches = kernels.jacobi_eigh.launches
    if mode is None:
        w, v = kernels.jacobi_eigh(a, sweeps)
    else:
        w, v = kernels._jacobi_launch(a, sweeps, mode=mode)
    wr, _ = kernels.jacobi_eigh_reference(a, sweeps)
    torch.cuda.synchronize()
    assert kernels.jacobi_eigh.launches == launches + 1
    assert w.is_cuda and w.dtype == dtype and tuple(v.shape) == (B, n, n)
    eps = torch.finfo(dtype).eps
    tol = 10 * n * eps * float(wr.abs().max())
    # sorted: where an angle sits within rounding of the fold at pi/4 the
    # two may end with the same eigenvalues on other diagonal positions
    assert float((torch.sort(w).values - torch.sort(wr).values).abs().max()) <= tol
    recon = (v * w[:, None, :]) @ v.mT
    assert float((recon - a).abs().max()) <= tol
    eye = torch.eye(n, dtype=dtype, device=cuda)
    assert float((v.mT @ v - eye).abs().max()) <= 10 * n * eps


@pytest.mark.parametrize("n,f64,mode,block", [
    (34, True, "tile", "shared"), (34, False, "tile", "shared"),
    (64, True, "tile", "shared"), (96, False, "tile", "shared"),
    (118, True, "tile", "shared"), (128, True, "tile", "global"),
    (128, False, "tile", "shared"), (130, True, "global", "global"),
    (130, False, "shared", "shared")])
def test_cuda_jacobi_dispatch_on_the_card(cuda, n, f64, mode, block):
    """The real library's shared-memory sizes on the card: the mode the
    dispatch takes at n and the block kernel's own mode there (A and V of
    float64 fit a block's shared memory to n = 120 only); the tile path at
    float64 n = 128 needs 201,216 bytes, inside the opt-in limit."""
    from admmsolver_tpu_torch.ops import _build, kernels

    lib = _build.load_libraries()["jacobi_eigh"]
    index = torch.cuda.current_device()
    assert kernels._JACOBI_MODES[kernels._jacobi_mode(lib, index, n, f64)] == mode
    assert kernels._JACOBI_MODES[kernels._jacobi_block_mode(lib, index, n, f64)] == block
    if (n, f64) == (128, True):
        tile = kernels._JACOBI_MODES.index("tile")
        limit = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
        assert lib.jacobi_eigh_smem_bytes(128, 1, tile) == 201216 <= limit


def test_cuda_jacobi_tile_path_refuses_n_outside_34_to_128(cuda):
    """Forcing the tile path at n = 32 or n = 130 raises at the launch;
    nothing falls back to another path."""
    from admmsolver_tpu_torch.ops import kernels

    tile = kernels._JACOBI_MODES.index("tile")
    for n in (32, 130):
        with pytest.raises(RuntimeError, match="launch failed"):
            kernels._jacobi_launch(_sym_batch(2, n, torch.float64, cuda), 2, mode=tile)


def test_cuda_jacobi_warp_path_refuses_n_above_32(cuda):
    """Forcing the warp path at n = 34 raises at the launch; nothing falls
    back to the block kernel."""
    from admmsolver_tpu_torch.ops import kernels

    with pytest.raises(RuntimeError, match="launch failed"):
        kernels._jacobi_launch(_sym_batch(2, 34, torch.float64, cuda), 2,
                               mode=kernels._JACOBI_MODES.index("warp"))


def test_cuda_spectral_dispatch_takes_the_card_routes(cuda, monkeypatch):
    """On the card the PSD prox takes the Jacobi kernel up to the boundary
    and the matrix sign above it, and the nuclear prox the Gram route (the
    kernel) below the boundary and the polar route above it; each agrees
    with the host's exact route."""
    from admmsolver_tpu_torch.ops import kernels, prox

    calls = {"sign": 0}
    sign = prox.psd_project_sign

    def counted(*a, **k):
        calls["sign"] += 1
        return sign(*a, **k)
    monkeypatch.setattr(prox, "psd_project_sign", counted)
    rng = np.random.RandomState(8)
    for n, kernel, route in ((20, 1, 0), (80, 0, 1)):
        x = rng.randn(n * n * 2)
        before = kernels.jacobi_eigh.launches, calls["sign"]
        got = prox.psd_project(torch.as_tensor(x, device=cuda), (n, n, 2), 2)
        want = prox.psd_project(torch.as_tensor(x), (n, n, 2), 2)
        assert kernels.jacobi_eigh.launches - before[0] == kernel
        assert calls["sign"] - before[1] == route
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-9)
    for shape, kernel in (((20, 16), 1), ((96, 80), 0)):
        m, n = shape
        h = 2.0 * rng.randn(3, m * n)
        mu = np.full((3, m * n), 1.3)
        f = T.NuclearNormPenalty(1.3, shape)
        before = kernels.jacobi_eigh.launches
        got = f.prox_diag(torch.as_tensor(h, device=cuda), torch.as_tensor(mu, device=cuda),
                          batched=True)
        assert kernels.jacobi_eigh.launches - before == kernel
        want = f.prox_diag(torch.as_tensor(h), torch.as_tensor(mu), batched=True)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0, atol=1e-9)


@pytest.fixture
def nccl_world(cuda):
    """A process group of one rank through NCCL in this process (a TCP store
    on localhost), destroyed after the test; its mesh on cuda:0."""
    import torch.distributed as dist

    from _torch_dist import free_port
    from admmsolver_tpu_torch.parallel import make_mesh

    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


def test_sharded_batched_solver_over_nccl_equals_unsharded(nccl_world):
    """World size 1 through NCCL: the exit predicate's all_reduce runs every
    chunk, and the solve is bitwise the unsharded one (the same shapes)."""
    from admmsolver_tpu_torch.parallel import batch_sharding

    rng = np.random.RandomState(21)
    A, ys = rng.randn(10, 24), rng.randn(37, 10)
    ov = {(0, "y"): ys}
    plain = BatchedSolver(_bp(A, ys[0])).solve(ov, niter=1000, rtol=1e-8)
    res = BatchedSolver(_bp(A, ys[0]), sharding=batch_sharding(nccl_world)).solve(
        ov, niter=1000, rtol=1e-8)
    assert res.x[0].is_cuda and torch.equal(res.lane_index.cpu(), torch.arange(37))
    assert int(res.iterations.min()) < int(res.iterations.max())
    for a, b in zip(res.x + res.h + (res.mu, res.iterations, res.converged),
                    plain.x + plain.h + (plain.mu, plain.iterations, plain.converged)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("prox", ["l1", "nonneg"])
def test_large_n_over_nccl_equals_simple_optimizer(nccl_world, prox):
    """LargeNTwoBlockSolver on the card (basis from the sharded Gram and the
    card's eigh) against SimpleOptimizer on the card: x within 1e-9, equal
    iteration counts (l1: 300 iterations; nonneg: its early exit, 1e-8)."""
    from admmsolver_tpu_torch.parallel import LargeNTwoBlockSolver

    rng = np.random.RandomState(1 if prox == "l1" else 2)
    M, N = (24, 128) if prox == "l1" else (20, 64)
    A = rng.randn(M, N)
    xt = np.abs(rng.randn(N)) * (rng.rand(N) < 0.2)
    y = A @ xt
    res = LargeNTwoBlockSolver(A, nccl_world, prox=prox).solve(
        y, niter=300 if prox == "l1" else 8000, rtol=0.0 if prox == "l1" else 1e-12,
        atol=0.0 if prox == "l1" else 1e-9)
    assert res.x0.is_cuda and (prox == "l1" or res.converged)
    block1 = T.L1Regularizer(0.1, N) if prox == "l1" else T.NonNegativePenalty(N)
    o = T.SimpleOptimizer(T.Model([T.LeastSquares(1.0, A, y), block1],
                                  [(1, 0, T.identity(N), T.identity(N))]))
    o.solve(res.iterations, rtol=0.0)
    tol = 1e-9 if prox == "l1" else 1e-8   # tests/test_rowshard.py's
    np.testing.assert_allclose(res.x0.cpu().numpy(), o.x[0].cpu().numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(res.x1.cpu().numpy(), o.x[1].cpu().numpy(), rtol=0, atol=tol)


def test_checkpoint_loads_default_to_cuda(tmp_path):
    """Loads place tensors on the card unless the caller asks for the CPU:
    without a CUDA device the default raises."""
    from admmsolver_tpu_torch.utils import load_batch_result, save_batch_result

    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rng = np.random.RandomState(0)
    A = rng.randn(6, 8)
    res = BatchedSolver(_bp(A, rng.randn(6)), device="cpu").solve(
        {(0, "y"): rng.randn(2, 6)}, niter=5)
    path = str(tmp_path / "r.npz")
    save_batch_result(path, res)
    assert load_batch_result(path, device="cpu").x[0].device.type == "cpu"
    with pytest.raises((RuntimeError, AssertionError)):
        load_batch_result(path)


def _captured_model(name):
    """(model, per-lane overrides, mu0) of the engine's captured-chunk tests,
    from a seed: the five models of tests/test_torch_batch_program.py, 8a's
    sign route (covariance denoising, k above the Jacobi boundary) and RPCA's
    Gram route on the Jacobi kernel's tile path."""
    from admmsolver_tpu_torch.models import applications as TA
    from admmsolver_tpu_torch.models.realify import encode

    rng = np.random.RandomState(41)
    B = 3
    if name == "basis_pursuit":
        A = rng.randn(12, 30)
        return _bp(A, rng.randn(12)), {(0, "y"): rng.randn(B, 12)}, 1.0
    if name == "sdp_jacobi":
        A = rng.randn(24, 48)
        return (TA.sdp_model(A, rng.randn(24), (4, 4, 3), axis=2),
                {(0, "y"): rng.randn(B, 24)}, 1.0)
    if name == "huber":
        A, y = rng.randn(20, 8) / np.sqrt(20), rng.randn(20)
        return (TA.robust_regression_model(A, y, delta=0.1),
                {(1, "y"): y[None] + 0.5 * rng.randn(B, 20)}, 1.0)
    if name == "tv":
        ys = np.repeat(rng.randn(4), 50)[None] + 0.2 * rng.randn(B, 200)
        return TA.tv_denoise_model(ys[0], 0.4), {(0, "y"): ys}, 1.0
    if name == "realified_spm":
        s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=8, nw=15)
        gs = g[None] + 1e-4 * (rng.randn(B, g.size) + 1j * rng.randn(B, g.size))
        return (T.realify_model(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)).model,
                {(0, "y"): encode(gs).numpy()}, 0.1)
    if name == "covariance_sign":
        k = 72
        Q = rng.randn(k, k)
        ys = (Q @ Q.T / k).reshape(-1)[None] + 0.1 * rng.randn(B, k * k)
        return TA.covariance_denoise_model(ys[0].reshape(k, k)), {(0, "y"): ys}, 1.0
    if name == "rpca_gram_tile":
        L0 = rng.randn(B, 40, 3) @ rng.randn(3, 40)
        Ys = L0 + (rng.rand(B, 40, 40) < 0.05) * 6.0
        return (TA.rpca_model(Ys[0], svd_method="gram"),
                {(1, "offset"): Ys.reshape(B, -1)}, 1.0)
    raise ValueError(name)


CAPTURED_MODELS = ["basis_pursuit", "sdp_jacobi", "huber", "tv", "realified_spm",
                   "covariance_sign", "rpca_gram_tile"]


def _solve_captured(bs, ov, mu0, capture, **kw):
    from admmsolver_tpu_torch.parallel import batch

    kw = dict(dict(niter=45, interval_update_mu=10, mu0=mu0, rtol=0.0), **kw)
    keep = batch.CAPTURE_CHUNKS
    batch.CAPTURE_CHUNKS = capture
    try:
        res = bs.solve(ov, **kw)
    finally:
        batch.CAPTURE_CHUNKS = keep
    torch.cuda.synchronize()
    return res


@pytest.mark.parametrize("name", CAPTURED_MODELS)
def test_captured_chunks_equal_the_eager_loop(cuda, name):
    """Each chunk a replay of its captured graph, against the same chunks run
    directly (``CAPTURE_CHUNKS`` off) by a solver that never captured, on
    the same card: bitwise in x, h, mu, iterations, flags and histories, on
    the first solve of a program (the key's first chunk eager, then
    captures), on a second one with other data (replays only) and on a
    solve of the capturing solver with ``CAPTURE_CHUNKS`` off (its eager
    work from the graph pool); rtol 0 runs every chunk, so its program holds
    the chunk lengths 10 and 4 (the short last chunk)."""
    model, ov, mu0 = _captured_model(name)
    bs = BatchedSolver(model)
    ov2 = {k: v[::-1].copy() for k, v in ov.items()}
    for o, kw, capture in ((ov, {}, True), (ov2, {}, True),
                           (ov, dict(rtol=1e-9, record_residuals=3), True),
                           (ov2, dict(rtol=1e-9, record_residuals=3), True), (ov, {}, False)):
        got = _solve_captured(bs, o, mu0, capture, **kw)
        want = _solve_captured(BatchedSolver(model), o, mu0, False, **kw)
        for a, b in zip(got.x + got.h + (got.mu, got.iterations, got.converged,
                                         got.primal_residual, got.dual_residual),
                        want.x + want.h + (want.mu, want.iterations, want.converged,
                                           want.primal_residual, want.dual_residual)):
            assert a.is_cuda and a.dtype == b.dtype
            np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    programs = list(bs._programs.values())
    assert len(programs) == 2 and sorted(programs[0].graphs) == [4, 10]
    assert 10 in programs[1].graphs


def test_captured_replays_do_not_sync(cuda, monkeypatch):
    """A chunk's replay and its host bookkeeping read nothing on the host:
    the chunks of a second solve (rtol 0, so no done flag is read) run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from admmsolver_tpu_torch.parallel import batch

    run = batch._ChunkProgram.run
    replays = []

    def strict(self, n, capture, pool):
        torch.cuda.set_sync_debug_mode("error")
        try:
            run(self, n, capture, pool)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        replays.append(n)

    for name in ("huber", "tv", "sdp_jacobi", "covariance_sign"):
        model, ov, mu0 = _captured_model(name)
        bs = BatchedSolver(model)
        ov = {k: torch.as_tensor(v, device=cuda) for k, v in ov.items()}
        _solve_captured(bs, ov, mu0, True)
        monkeypatch.setattr(batch._ChunkProgram, "run", strict)
        _solve_captured(bs, ov, mu0, True)
        monkeypatch.setattr(batch._ChunkProgram, "run", run)
    assert replays == [10, 10, 10, 10, 4] * 4


def test_jacobi_launches_per_solve_unchanged_by_capture(cuda):
    """A replay adds the launches its capture counted: one Jacobi launch an
    iteration either way."""
    from admmsolver_tpu_torch.ops import kernels

    model, ov, mu0 = _captured_model("sdp_jacobi")
    bs = BatchedSolver(model)
    counts = []
    for capture in (True, True, False):
        kernels.jacobi_eigh.launches = 0
        _solve_captured(bs, ov, mu0, capture)
        counts.append(kernels.jacobi_eigh.launches)
    assert counts == [45, 45, 45]


def test_failed_capture_of_a_capturable_model_raises(cuda, monkeypatch):
    """A model declared capturable whose chunk reads a value on the host
    raises at its capture: no fallback to chunks without a graph."""
    model, ov, mu0 = _captured_model("huber")
    prox_diag = T.HuberLoss.prox_diag

    def reading(self, h, mu_diag, batched=False):
        float(h.sum())      # a host read inside the chunk
        return prox_diag(self, h, mu_diag, batched)

    monkeypatch.setattr(T.HuberLoss, "prox_diag", reading)
    assert T.HuberLoss(1.0, np.ones(3)).capturable(torch.float64, cuda)
    with pytest.raises(RuntimeError):
        _solve_captured(BatchedSolver(model), ov, mu0, True)
    torch.cuda.synchronize()


FUSED = ["two_block", "spm"]


def _fused_case(kind, device):
    """(solver, overrides, other overrides, solve keywords) of the fused
    programs' card tests: 37 lanes (the two-block solver pads them to 40),
    A 24 x 64 (thin basis, clusters of two blocks) or SpM nl = 12, nw = 25."""
    rng = np.random.RandomState(43)
    lanes = 37
    if kind == "two_block":
        A = rng.randn(24, 64)
        ys, ys2 = rng.randn(2, lanes, 24)
        return (FusedTwoBlockSolver(_bp(A, ys[0]), tile_b=8, device=device), {(0, "y"): ys},
                {(0, "y"): ys2, (1, "alpha"): np.linspace(0.05, 0.2, lanes)}, {})
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    gs, gs2 = g[None] + 1e-4 * rng.randn(2, lanes, g.size)
    return (FusedSpMSolver(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), device=device),
            {(0, "y"): gs}, {(0, "y"): gs2, (1, "alpha"): np.linspace(5e-4, 5e-3, lanes)},
            {"mu0": 0.1})


def _fused_solve(solver, ov, capture, **kw):
    from admmsolver_tpu_torch.parallel import batch

    kw = dict(dict(niter=45, interval_update_mu=10, rtol=0.0), **kw)
    keep = batch.CAPTURE_CHUNKS
    batch.CAPTURE_CHUNKS = capture
    try:
        res = solver.solve(ov, **kw)
    finally:
        batch.CAPTURE_CHUNKS = keep
    torch.cuda.synchronize()
    return res


def _fused_outputs(r):
    blocks = [r.x0, r.x1, r.h] if hasattr(r, "x0") else list(r.x) + list(r.h)
    return blocks + [r.mu, r.iterations, r.converged, r.primal_residual, r.dual_residual]


def _assert_bitwise(got, want):
    for a, b in zip(_fused_outputs(got), _fused_outputs(want)):
        assert a.is_cuda and a.dtype == b.dtype
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())


@pytest.mark.parametrize("kind", FUSED)
def test_fused_captured_chunks_equal_graph_less(cuda, kind):
    """Each chunk of a fused solve a replay of its captured graph, against
    the same run program with ``CAPTURE_CHUNKS`` off on a solver that never
    captured: bitwise in every output, on the program's first solve (its
    first chunk eager, then captures), on a second one with new data and
    alphas (replays only), where lanes can finish, with done0, and on a
    solve of the capturing solver with capture off.  45 iterations in
    chunks of 10: graphs for iteration 0, the full chunk and a remainder
    of 4."""
    solver, ov, ov2, kw = _fused_case(kind, cuda)
    done0 = np.arange(37) % 5 == 0
    for o, extra, capture in ((ov, {}, True), (ov2, {}, True), (ov, dict(rtol=1e-5), True),
                              (ov2, dict(rtol=1e-5, done0=done0), True), (ov, {}, False)):
        got = _fused_solve(solver, o, capture, **kw, **extra)
        want = _fused_solve(_fused_case(kind, cuda)[0], o, False, **kw, **extra)
        _assert_bitwise(got, want)
    programs = list(solver._programs.values())
    assert len(programs) == 2
    assert sorted(programs[0].graphs) == [(1, True, kind == "spm"), (4, False, False),
                                          (10, True, False)]


@pytest.mark.parametrize("kind", FUSED)
def test_fused_replays_count_their_kernel_launches(cuda, kind):
    """A replay adds the launch its capture counted: one a chunk, captured
    or not (45 iterations: 1 + 4 x 10 + 4, six chunks)."""
    solver, ov, _, kw = _fused_case(kind, cuda)
    kernel = fused_two_block_chunk if kind == "two_block" else fused_spm_chunk
    counts = []
    for capture in (True, True, False):
        kernel.launches = 0
        _fused_solve(solver, ov, capture, **kw)
        counts.append(kernel.launches)
    assert counts == [6, 6, 6]


@pytest.mark.parametrize("kind", FUSED)
def test_fused_cached_program_takes_new_inputs(cuda, kind):
    """A warm program reused with new data, alphas, tolerances and penalty
    knobs equals a fresh solver's solve of those, bitwise."""
    solver, ov, ov2, kw = _fused_case(kind, cuda)
    _fused_solve(solver, ov, True, rtol=1e-6, **kw)
    extra = dict(rtol=1e-4, fact_incr=3.0, max_mu=50.0)
    got = _fused_solve(solver, ov2, True, **kw, **extra)
    assert len(solver._programs) == 1
    _assert_bitwise(got, _fused_solve(_fused_case(kind, cuda)[0], ov2, True, **kw, **extra))


@pytest.mark.parametrize("kind", FUSED)
def test_fused_buffers_keep_their_addresses(cuda, kind, monkeypatch):
    """Every buffer of the program stays where the graphs read and write it,
    across chunks and solves."""
    from admmsolver_tpu_torch.parallel import fused

    solver, ov, ov2, kw = _fused_case(kind, cuda)
    run_chunk = fused._FusedProgram._run_chunk
    seen = []

    def recording(self, key, capture, pool):
        run_chunk(self, key, capture, pool)
        seen.append([t.data_ptr() for t in self.buffers() + (self.knobs, self.row, self.failed)])

    monkeypatch.setattr(fused._FusedProgram, "_run_chunk", recording)
    for o in (ov, ov2, ov):
        _fused_solve(solver, o, True, **kw)
    assert len(seen) == 18 and all(ptrs == seen[0] for ptrs in seen)


@pytest.mark.parametrize("kind", FUSED)
def test_fused_replays_do_not_sync(cuda, kind, monkeypatch):
    """At rtol = atol = 0 a warm solve's chunks read nothing on the host:
    they run under ``torch.cuda.set_sync_debug_mode("error")`` and the
    done flags are never read."""
    from admmsolver_tpu_torch.parallel import batch, fused

    solver, ov, _, kw = _fused_case(kind, cuda)
    ov = {k: torch.as_tensor(v, device=cuda) for k, v in ov.items()}
    _fused_solve(solver, ov, True, **kw)
    run_chunk = fused._FusedProgram._run_chunk
    replays = []

    def strict(self, key, capture, pool):
        torch.cuda.set_sync_debug_mode("error")
        try:
            run_chunk(self, key, capture, pool)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        replays.append(key[0])

    def no_read(*args, **kwargs):
        raise AssertionError("the done flags were read")

    monkeypatch.setattr(fused._FusedProgram, "_run_chunk", strict)
    monkeypatch.setattr(batch, "_flags_read", no_read)
    _fused_solve(solver, ov, True, **kw)
    assert replays == [1, 10, 10, 10, 10, 4]


@pytest.mark.parametrize("kind", FUSED)
def test_fused_failed_capture_raises(cuda, kind, monkeypatch):
    """A chunk that reads a value on the host fails its capture and the
    solve raises: no fallback to chunks without a graph or to the plain
    chunk."""
    solver, ov, _, kw = _fused_case(kind, cuda)
    step = type(solver)._step

    def reading(self, state, *args):
        float(state[0].sum())      # a host read inside the chunk
        return step(self, state, *args)

    monkeypatch.setattr(type(solver), "_step", reading)
    with pytest.raises(RuntimeError):
        _fused_solve(solver, ov, True, **kw)
    torch.cuda.synchronize()


@pytest.mark.parametrize("rtol", [0.0, 1e-4])
def test_fused_spm_not_positive_definite_raises_on_the_card(cuda, rtol):
    """The captured factor refresh keeps its Cholesky infos on the card; a
    lane whose penalty matrix is not positive definite still raises
    LinAlgError, read after the solve or with the done flags."""
    solver, ov, _, kw = _fused_case("spm", cuda)
    alpha = np.ones(37)
    alpha[5] = -1e4
    _fused_solve(solver, ov, True, **kw)
    with pytest.raises(torch.linalg.LinAlgError):
        _fused_solve(solver, {**ov, (0, "alpha"): alpha}, True, rtol=rtol, **kw)


def _single(name):
    """(model, mu0) of the single-instance program's card tests: lane 0 of
    the captured-chunk models, and the 3-block SpM model."""
    if name == "spm":
        s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=10, nw=21)
        return spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), 0.1
    model, _, mu0 = _captured_model(name)
    return model, mu0


def _single_solve(model, mu0, capture, opt=None, **kw):
    """A ``SimpleOptimizer`` solve (45 iterations in chunks of 10 by default)
    with ``CAPTURE_CHUNKS`` set to ``capture``: x, the x before the last
    iteration, h, mu, the count and both histories, on the host."""
    from admmsolver_tpu_torch.parallel import batch

    kw = dict(dict(niter=45, interval_update_mu=10, rtol=0.0), **kw)
    opt = opt or T.SimpleOptimizer(model, mu=mu0)
    keep = batch.CAPTURE_CHUNKS
    batch.CAPTURE_CHUNKS = capture
    try:
        opt.solve(kw.pop("niter"), **kw)
    finally:
        batch.CAPTURE_CHUNKS = keep
    torch.cuda.synchronize()
    assert opt.x[0].is_cuda
    return [t.cpu().numpy() for t in opt.x + list(opt._x_old) + opt.h + [opt.mu]] + [
        np.array(opt.iterations), np.array(opt.primal_residual_history),
        np.array(opt.dual_residual_history)]


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["spm"] + CAPTURED_MODELS)
def test_simple_optimizer_captured_equals_graph_less(cuda, name):
    """Each chunk of a SimpleOptimizer solve a replay of its captured graph,
    against the same run program with ``CAPTURE_CHUNKS`` off on an optimizer
    that never captured: bitwise in x, x_old, h, mu, the count and both
    histories, on the program's first solve (its first chunk eager, then
    captures), a second one (replays only), an exit inside a chunk (the
    done flag read once a chunk), and with capture off on the capturing
    optimizer; the Jacobi kernel's launches equal both ways."""
    from admmsolver_tpu_torch.ops import kernels

    model, mu0 = _single(name)
    opt = T.SimpleOptimizer(model, mu=mu0)
    launches = []
    for kw, capture in (({}, True), ({}, True), (dict(niter=300, rtol=1e-7), True),
                        ({}, False)):
        kernels.jacobi_eigh.launches = 0
        want = _single_solve(model, mu0, False, **kw)
        launches.append(kernels.jacobi_eigh.launches)
        kernels.jacobi_eigh.launches = 0
        # each solve from the start: a fresh state in the same optimizer
        opt._x, opt._h, opt._mu = opt._plan.make_initial_state(mu0=mu0)
        opt._primal_residual, opt._dual_residual = [], []
        _equal(_single_solve(model, mu0, capture, opt, **kw), want)
        launches.append(kernels.jacobi_eigh.launches)
    assert launches[0::2] == launches[1::2]
    programs = list(opt._plan._run_cache.values())
    assert sorted(programs[0].graphs.graphs) == [(1, True), (4, False), (10, True)]


def test_simple_optimizer_cached_program_takes_new_rtol_and_x0(cuda, monkeypatch):
    """A warm program takes another rtol and another starting state without
    a new capture, and equals a graph-less solve of them."""
    from admmsolver_tpu_torch.parallel import batch

    model, mu0 = _single("huber")
    opt = T.SimpleOptimizer(model, mu=mu0)
    _single_solve(model, mu0, True, opt, rtol=1e-6)
    n1 = opt.iterations
    capture = batch._GraphProgram._capture
    captures = []
    monkeypatch.setattr(batch._GraphProgram, "_capture",
                        lambda self, key, pool: captures.append(key) or capture(self, key, pool))
    x0 = [t + 0.5 for t in opt.x]
    ref = T.SimpleOptimizer(model, x0=[t.clone() for t in x0], mu=mu0)
    ref._h, ref._mu = tuple(t.clone() for t in opt.h), opt.mu.clone()
    opt._x = tuple(x0)
    got = _single_solve(model, mu0, True, opt, rtol=1e-9)
    assert captures == [] and len(opt._plan._run_cache) == 1
    want = _single_solve(model, mu0, False, ref, rtol=1e-9)
    _equal(got[:-3] + [got[-3] - n1] + [g[n1:] for g in got[-2:]], want)


def test_simple_optimizer_replays_do_not_sync(cuda, monkeypatch):
    """At rtol = atol = 0 a warm program's chunks read nothing on the host:
    they run under ``torch.cuda.set_sync_debug_mode("error")`` and the done
    flag is never read."""
    from admmsolver_tpu_torch import optimizer
    from admmsolver_tpu_torch.parallel import batch

    for name in ("spm", "tv", "sdp_jacobi", "covariance_sign"):
        model, mu0 = _single(name)
        opt = T.SimpleOptimizer(model, mu=mu0)
        _single_solve(model, mu0, True, opt, record_residuals=False)
        run = optimizer._RunProgram.run
        replays = []

        def strict(self, key, capture, pool):
            torch.cuda.set_sync_debug_mode("error")
            try:
                run(self, key, capture, pool)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            replays.append(key[0])

        def no_read(*args, **kwargs):
            raise AssertionError("the done flag was read")

        monkeypatch.setattr(optimizer._RunProgram, "run", strict)
        monkeypatch.setattr(batch, "_flags_read", no_read)
        opt.solve(45, interval_update_mu=10, rtol=0.0, record_residuals=False)
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert replays == [1, 10, 10, 10, 10, 4]


def test_simple_optimizer_failed_capture_raises(cuda, monkeypatch):
    """A model declared capturable whose chunk reads a value on the host
    raises at its capture (no fallback to chunks without a graph), and the
    allocator stays usable: a later captured solve and the freeing of its
    pool work."""
    import gc

    model, mu0 = _single("huber")
    prox_diag = T.HuberLoss.prox_diag

    def reading(self, h, mu_diag, batched=False):
        float(h.sum())      # a host read inside the chunk
        return prox_diag(self, h, mu_diag, batched)

    monkeypatch.setattr(T.HuberLoss, "prox_diag", reading)
    with pytest.raises(RuntimeError):
        _single_solve(model, mu0, True)
    monkeypatch.undo()
    gc.collect()
    _equal(_single_solve(model, mu0, True), _single_solve(model, mu0, False))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()


def test_simple_optimizer_not_positive_definite_raises_on_the_card(cuda):
    rng = np.random.RandomState(6)
    A = rng.randn(12, 20)
    model = T.Model([T.LeastSquares(-10.0, A, rng.randn(12)), T.L1Regularizer(0.1, 20)],
                    [(1, 0, T.identity(20), T.DiagonalMatrix(rng.uniform(0.5, 2.0, 20)))])
    for rtol in (0.0, 1e-6):
        with pytest.raises(torch.linalg.LinAlgError):
            _single_solve(model, 1.0, True, rtol=rtol)


def _large_n_case(mesh, seed=13):
    from admmsolver_tpu_torch.parallel import LargeNTwoBlockSolver

    rng = np.random.RandomState(seed)
    A = rng.randn(16, 64)
    xt = np.zeros(64)
    xt[rng.choice(64, 4, replace=False)] = rng.randn(4)
    return LargeNTwoBlockSolver(A, mesh, prox="l1", alpha1=0.1), A @ xt


def _large_n_solve(solver, y, capture, **kw):
    from admmsolver_tpu_torch.parallel import batch

    kw = dict(dict(niter=250, interval_update_mu=30, rtol=0.0), **kw)
    keep = batch.CAPTURE_CHUNKS
    batch.CAPTURE_CHUNKS = capture
    try:
        r = solver.solve(y, **kw)
    finally:
        batch.CAPTURE_CHUNKS = keep
    torch.cuda.synchronize()
    return [t.cpu().numpy() for t in (r.x0, r.x1, r.h, r.mu, r.primal_residual,
                                      r.dual_residual)] + [np.array([r.iterations,
                                                                     r.converged])]


def _large_n_captured_equals_graph_less(mesh):
    solver, y = _large_n_case(mesh)
    assert solver.captures
    for kw in ({}, {}, dict(rtol=1e-8, niter=5000)):
        _equal(_large_n_solve(solver, y, True, **kw),
               _large_n_solve(_large_n_case(mesh)[0], y, False, **kw))
    graphs = list(solver._programs.values())[0].graphs
    assert sorted(graphs) == [1, 9, 30]


def test_large_n_without_a_group_captured_equals_graph_less(cuda):
    """A mesh of one process without a process group (its all_reduce a
    no-op): each chunk a replay, bitwise the graph-less solve, on the first
    solve, a second and an exit inside a chunk."""
    from admmsolver_tpu_torch.parallel import make_mesh

    _large_n_captured_equals_graph_less(make_mesh(1))


def test_large_n_over_nccl_captured_equals_graph_less(nccl_world):
    """World size 1 through NCCL: both all_reduces inside the captured
    chunk; bitwise the graph-less solve."""
    _large_n_captured_equals_graph_less(nccl_world)


@pytest.mark.parametrize("entry", ["FusedTwoBlockSolver", "FusedSpMSolver", "SimpleOptimizer",
                                   "BatchedSolver", "make_mesh"])
def test_default_device_raises_without_cuda(entry):
    """Entry points run on the card unless the caller asks for the CPU:
    with no CUDA device the default raises, nothing carries on on the host."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    rng = np.random.RandomState(0)
    A = rng.randn(6, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        if entry == "FusedTwoBlockSolver":
            FusedTwoBlockSolver(_bp(A, rng.randn(6)))
        elif entry == "FusedSpMSolver":
            _spm_solver(None)
        elif entry == "BatchedSolver":
            BatchedSolver(_bp(A, rng.randn(6)))
        elif entry == "make_mesh":
            from admmsolver_tpu_torch.parallel import make_mesh
            make_mesh()
        else:
            T.SimpleOptimizer(_bp(A, rng.randn(6)))
