"""Mixed-precision solves of the port against the JAX package, on the CPU.

``BatchedSolver.solve_mixed`` (a float32 phase, then the same state at full
precision) and ``FusedSpMSolver.solve_mixed`` (the fused float32 chunk phase,
then a float64 ``BatchedSolver`` polish) with the cases and tolerances of
tests/test_mixed_precision.py and the two ``mixed`` tests of
tests/test_fused_spm.py: a polished solution within 1e-8 of the pure float64
one when both converge to atol 1e-10, within 2e-5 at a fixed budget.  The two
packages round a float32 phase differently, so their phase-1 exits may differ
by a few iterations; what is compared across packages is the polished state.
On the CPU the fused phase runs the plain version of the chunk kernel.
"""
import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import spm_model as jax_spm_model
from admmsolver_tpu.parallel import BatchedSolver as JaxBatched
from admmsolver_tpu.parallel import FusedSpMSolver as JaxFusedSpM
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.models.applications import synthetic_spm_data
from admmsolver_tpu_torch.ops.kernels import fused_spm_chunk
from admmsolver_tpu_torch.parallel import BatchedSolver, BatchResult, FusedSpMSolver

torch.set_num_threads(1)


def _setup(B=6, M=30, N=80, seed=0):
    """tests/test_mixed_precision.py's problem: one JAX model, the port's
    copy of it, and B planted 6-sparse signals."""
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 6, replace=False)] = rng.randn(6)
    ys = xt @ A.T
    I = J.identity(N)
    jm = J.Model([J.LeastSquares(1.0, A, ys[0]), J.L1Regularizer(0.1, N)], [(1, 0, I, I)])
    return jm, interop.from_jax_model(jm, device="cpu"), ys, xt


def test_f32_phase_stays_f32():
    """A float32 call on a float64 solver keeps x, h and mu in float32 and
    follows the JAX package's float32 solve (tests/test_mixed_precision.py:26)."""
    jm, tm, ys, _ = _setup()
    bt = BatchedSolver(tm, dtype=torch.float64, device="cpu")
    r = bt.solve({(0, "y"): ys}, niter=50, dtype=torch.float32)
    assert r.x[0].dtype == r.x[1].dtype == r.h[0].dtype == r.mu.dtype == torch.float32
    assert r.primal_residual.dtype == torch.float64
    assert bool(torch.isfinite(r.x[0]).all())
    rj = JaxBatched(jm).solve({(0, "y"): ys}, niter=50, dtype=np.float32)
    np.testing.assert_allclose(r.x[0].numpy(), np.asarray(rj.x[0]), rtol=0, atol=5e-4)
    for name in ("float32", np.float32):
        assert bt.solve({(0, "y"): ys}, niter=3, dtype=name).x[0].dtype == torch.float32


def test_atol_stop():
    """atol stops on the absolute primal+dual residual
    (tests/test_mixed_precision.py:35), at the JAX package's iteration."""
    jm, tm, ys, _ = _setup()
    r = BatchedSolver(tm, device="cpu").solve({(0, "y"): ys}, niter=5000, atol=1e-8)
    rj = JaxBatched(jm).solve({(0, "y"): ys}, niter=5000, atol=1e-8)
    assert bool(r.converged.all())
    np.testing.assert_array_equal(r.iterations.numpy(), np.asarray(rj.iterations))
    for b in range(ys.shape[0]):
        hist = r.primal_residual[b].numpy()
        assert hist[np.isfinite(hist)][-1] < 1e-8


def test_f32_single_phase_accuracy():
    """tests/test_mixed_precision.py:68."""
    _, tm, ys, xt = _setup()
    r = BatchedSolver(tm, device="cpu").solve({(0, "y"): ys}, niter=2000,
                                              dtype=torch.float32, rtol=1e-6)
    assert float(np.abs(r.x[0].double().numpy() - xt).max()) < 5e-2


def test_mixed_matches_pure_f64():
    """tests/test_mixed_precision.py:47, and the JAX package's mixed solve."""
    jm, tm, ys, _ = _setup()
    bt = BatchedSolver(tm, dtype=torch.float64, device="cpu")
    rm = bt.solve_mixed({(0, "y"): ys}, niter_low=500, niter=4000, atol=1e-10)
    rf = bt.solve({(0, "y"): ys}, niter=5000, atol=1e-10)
    assert isinstance(rm, BatchResult) and bool(rm.converged.all())
    assert rm.x[0].dtype == torch.float64
    np.testing.assert_allclose(rm.x[0].numpy(), rf.x[0].numpy(), atol=1e-8)
    # history concatenation bookkeeping
    assert tuple(rm.primal_residual.shape) == (6, 500 + 4000)
    assert tuple(rm.dual_residual.shape) == (6, 500 + 4000)
    rj = JaxBatched(jm).solve_mixed({(0, "y"): ys}, niter_low=500, niter=4000, atol=1e-10)
    np.testing.assert_allclose(rm.x[0].numpy(), np.asarray(rj.x[0]), atol=1e-8)


def test_fused_mixed_matches_two_phase():
    """fused=True gives the two-phase result (tests/test_mixed_precision.py:
    113), and polishes at the solver's dtype only."""
    _, tm, ys, _ = _setup(seed=5)
    bt = BatchedSolver(tm, dtype=torch.float64, device="cpu")
    kw = dict(niter_low=200, niter=300, rtol=1e-10, low_rtol=1e-5, mu0=0.5)
    two = bt.solve_mixed({(0, "y"): ys}, fused=False, **kw)
    one = bt.solve_mixed({(0, "y"): ys}, fused=True, **kw)
    assert torch.equal(one.x[0], two.x[0]) and torch.equal(one.mu, two.mu)
    assert torch.equal(one.iterations, two.iterations)
    a, b = one.primal_residual.numpy(), two.primal_residual.numpy()
    assert a.shape == b.shape == (6, 500)
    np.testing.assert_array_equal(a, b)
    # counts are summed over the phases
    p1 = bt.solve({(0, "y"): ys}, niter=200, dtype=torch.float32, rtol=1e-5, mu0=0.5)
    assert bool((one.iterations >= p1.iterations).all())
    assert int(one.iterations.max()) <= 500
    with pytest.raises(ValueError, match="always polishes at the solver dtype"):
        bt.solve_mixed({(0, "y"): ys}, fused=True, dtype=torch.float32, **kw)
    with pytest.raises(ValueError, match="budgets must be positive"):
        bt.solve_mixed({(0, "y"): ys}, niter_low=0, niter=5)
    assert bt.solve_mixed({(0, "y"): ys}, niter_low=5, niter=5, dtype=torch.float32,
                          ).x[0].dtype == torch.float32


# ---------------------------------------------------------------------
# FusedSpMSolver.solve_mixed
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def spm_setup():
    """tests/test_fused_spm.py's problem."""
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    gs = g[None, :] + 1e-4 * np.random.RandomState(0).randn(6, g.size)
    jm = jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    return jm, interop.from_jax_model(jm, device="cpu"), gs, prj_sum


def test_fused_spm_mixed_precision_handoff(spm_setup):
    """Fused-f32 phase + f64 engine polish reaches the solution of a pure
    f64 solve of the same total budget (tests/test_fused_spm.py:119), and
    the JAX package's mixed solve."""
    jm, tm, gs, prj_sum = spm_setup
    fs = FusedSpMSolver(tm, device="cpu")
    launches = fused_spm_chunk.launches
    kw = dict(niter_low=600, niter=300, mu0=0.1, rtol=0.0, record_residuals=False)
    mixed = fs.solve_mixed({(0, "y"): gs}, **kw)
    assert fused_spm_chunk.launches == launches   # CPU: the plain version
    pure = BatchedSolver(tm, dtype=torch.float64, device="cpu").solve(
        {(0, "y"): gs}, niter=900, mu0=0.1, rtol=0.0, record_residuals=False)
    rj = JaxFusedSpM(jm, tile_b=2).solve_mixed({(0, "y"): gs}, **kw)
    assert isinstance(mixed, BatchResult)
    for k in range(3):
        assert mixed.x[k].dtype == torch.float64
        np.testing.assert_allclose(mixed.x[k].numpy(), pure.x[k].numpy(), atol=2e-5)
        np.testing.assert_allclose(mixed.x[k].numpy(), np.asarray(rj.x[k]), atol=2e-5)
    for k in range(2):
        assert mixed.h[k].dtype == torch.float64
    # the f32 phase may exit early at low_atol; total = phase 1 + phase 2
    total = mixed.iterations.numpy()
    assert ((300 < total) & (total <= 900)).all(), total
    # the polish tightens the sum rule beyond what float32 holds
    np.testing.assert_allclose(mixed.x[0].numpy() @ prj_sum, 1.0, atol=1e-9)
    assert float(mixed.x[2].min()) >= 0.0
    assert fs._polish_solver is not None and fs._polish_solver.dtype == torch.float64


def test_fused_spm_mixed_fused_flag_and_phases(spm_setup):
    """fused=True and fused=False are the same two phases
    (tests/test_fused_spm.py:140); the result is phase 2 started from phase
    1's state, and iterations = min(kernel count, niter_low) + polish count."""
    _, tm, gs, _ = spm_setup
    fs = FusedSpMSolver(tm, device="cpu")
    ov = {(0, "y"): gs}
    kw = dict(niter_low=200, niter=100, mu0=0.1, rtol=0.0, record_residuals=False)
    two = fs.solve_mixed(ov, fused=False, **kw)
    one = fs.solve_mixed(ov, fused=True, **kw)
    for k in range(3):
        assert torch.equal(one.x[k], two.x[k])
    assert torch.equal(one.iterations, two.iterations) and torch.equal(one.mu, two.mu)
    p1 = fs.solve(ov, niter=200, mu0=0.1, rtol=0.0, atol=1e-5)
    p2 = fs._polish_solver.solve(ov, x0=[a.double() for a in p1.x],
                                 h0=[a.double() for a in p1.h], mu0=p1.mu.double(),
                                 niter=100, rtol=0.0, record_residuals=False)
    assert torch.equal(one.x[0], p2.x[0])
    assert torch.equal(one.iterations, p1.iterations + 100)
    assert int(p1.iterations.max()) <= 200


def test_fused_spm_mixed_done0_and_knobs(spm_setup):
    """Lanes the caller marks done skip both phases; lanes that the kernel
    phase finished are polished all the same; the penalty knobs reach both
    phases."""
    _, tm, gs, _ = spm_setup
    fs = FusedSpMSolver(tm, device="cpu")
    done0 = np.array([False, True, False, False, True, False])
    r = fs.solve_mixed({(0, "y"): gs}, niter_low=120, niter=40, mu0=0.1, rtol=0.0,
                       low_atol=1e-2, done0=done0, record_residuals=5)
    assert (r.iterations.numpy()[done0] == 0).all()
    assert not r.x[0][done0].any() and r.converged.numpy()[done0].all()
    # low_atol=1e-2 ends the kernel phase early; the polish still runs 40
    p1 = fs.solve({(0, "y"): gs}, niter=120, mu0=0.1, rtol=0.0, atol=1e-2, done0=done0)
    assert bool(p1.converged.all()) and int(p1.iterations.max()) < 120
    assert torch.equal(r.iterations, p1.iterations + 40 * torch.as_tensor(~done0))
    assert tuple(r.primal_residual.shape) == (6, 8)
    fixed = fs.solve_mixed({(0, "y"): gs}, niter_low=120, niter=40, mu0=0.1, rtol=0.0,
                           th_change=float("inf"), record_residuals=False)
    assert torch.all(fixed.mu == float(np.float32(0.1)))   # neither phase rebalances


def test_fused_spm_mixed_rejects_unsupported_overrides(spm_setup):
    """tests/test_fused_spm.py:161: an engine-legal override that the kernel
    phase cannot take raises instead of polishing the wrong trajectory."""
    _, tm, gs, _ = spm_setup
    fs = FusedSpMSolver(tm, device="cpu")
    bad = {(0, "y"): gs, (0, "A"): np.zeros((6, gs.shape[1], fs.nl))}
    for fused in (True, False):
        with pytest.raises(ValueError, match="supports per-instance"):
            fs.solve_mixed(bad, niter_low=5, niter=5, fused=fused)
    with pytest.raises(ValueError, match="leading batch axis"):
        fs.solve_mixed({}, niter_low=5, niter=5)
    assert T.FusedSpMSolver is FusedSpMSolver
