"""Tests of the port that need a CUDA card: the hand-written chunk kernels
against their plain versions, and the solvers on the card against the same
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
