"""The port's checkpoints and telemetry against admmsolver_tpu.utils, on the
CPU.  The cases mirror tests/test_checkpoint.py (its sharded 8-device case
becomes the single-process scattered round trip).  A resumed solve equals
the uninterrupted one exactly (atol 0) and the JAX package's to 1e-10; npz
files cross-load in both directions and continue the other package's
trajectory to 1e-10 with equal iteration counts."""
import json
import os

import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu.utils as JU
import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import basis_pursuit_model as jax_bp_model
from admmsolver_tpu.parallel import BatchedSolver as JaxBatched
from admmsolver_tpu_torch import utils as TU
from admmsolver_tpu_torch.models.applications import basis_pursuit_model as bp_model
from admmsolver_tpu_torch.parallel import BatchedSolver
from admmsolver_tpu_torch.utils.checkpoint import (load_batch_result_scattered,
                                                   save_batch_result_local)

torch.set_num_threads(1)

TOL = 1e-10


def _model(P, A, y, alpha=0.1):
    N = A.shape[1]
    return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(alpha, N)],
                   [(1, 0, P.identity(N), P.identity(N))])


def _bp_batch(seed=0, M=16, N=32, B=4):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 3, replace=False)] = rng.randn(3)
    return A, xt @ A.T


def test_checkpoint_roundtrip_resume(tmp_path):
    """Interrupt at 50 iterations, checkpoint, restore, continue: equal to
    the same split run without the round trip (each solve() restarts the
    penalty-update counter, as the reference's repeated solve() does), and
    to the JAX package's split run."""
    rng = np.random.RandomState(0)
    A, y = rng.randn(10, 25), rng.randn(10)

    witness = T.SimpleOptimizer(_model(T, A, y), device="cpu")
    witness.solve(50)
    witness.solve(50)

    part = T.SimpleOptimizer(_model(T, A, y), device="cpu")
    part.solve(50)
    path = str(tmp_path / "ckpt.npz")
    TU.save_state(path, part)

    resumed = TU.restore_optimizer(path, _model(T, A, y), device="cpu")
    assert len(resumed._primal_residual) == len(part._primal_residual)
    resumed.solve(50)

    np.testing.assert_allclose(resumed.x[0].numpy(), witness.x[0].numpy(), atol=1e-14)
    np.testing.assert_allclose(resumed._primal_residual, witness._primal_residual, rtol=1e-12)
    np.testing.assert_allclose(resumed.mu.numpy(), witness.mu.numpy(), rtol=0)

    jw = J.SimpleOptimizer(_model(J, A, y))
    jw.solve(50)
    jw.solve(50)
    np.testing.assert_allclose(resumed.x[0].numpy(), np.asarray(jw.x[0]), rtol=0, atol=TOL)
    np.testing.assert_allclose(resumed._primal_residual, jw._primal_residual, rtol=TOL, atol=TOL)


def test_checkpoint_structure_mismatch(tmp_path):
    rng = np.random.RandomState(1)
    A, y = rng.randn(5, 8), rng.randn(5)
    opt = T.SimpleOptimizer(_model(T, A, y), device="cpu")
    opt.solve(5)
    path = str(tmp_path / "ckpt.npz")
    TU.save_state(path, opt)
    A2 = rng.randn(5, 9)
    with pytest.raises(Exception):
        TU.restore_optimizer(path, _model(T, A2, rng.randn(5)), device="cpu")
    # a file of another format version is refused
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["__meta__"] = json.dumps({"version": 2, "nblocks": 2, "npairs": 1})
    np.savez(path, **arrays)
    with pytest.raises(ValueError, match="version"):
        TU.load_state(path)


def test_batch_result_roundtrip(tmp_path):
    rng = np.random.RandomState(2)
    A, ys = rng.randn(6, 12), rng.randn(3, 6)
    bs = BatchedSolver(_model(T, A, ys[0]), device="cpu")
    res = bs.solve({(0, "y"): ys}, niter=30)
    path = str(tmp_path / "batch.npz")
    TU.save_batch_result(path, res)
    res2 = TU.load_batch_result(path, device="cpu")
    for name in ("mu", "iterations", "converged", "primal_residual", "dual_residual"):
        a, b = getattr(res, name), getattr(res2, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    for a, b in zip(res.x + res.h, res2.x + res2.h):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # warm-restart a batched solve from the loaded state
    res3 = bs.solve({(0, "y"): ys}, x0=res2.x, h0=res2.h, mu0=res2.mu, niter=30)
    assert int(res3.iterations.max()) <= 30
    # the file's keys are the JAX package's
    with np.load(path) as z:
        assert sorted(z.files) == sorted(["__meta__", "x_0", "x_1", "h_0", "mu", "iterations",
                                          "converged", "primal_residual", "dual_residual"])


def test_convergence_report():
    primal = list(np.logspace(0, -8, 100))
    dual = list(np.logspace(0, -7, 100))
    rep = TU.convergence_report(primal, dual)
    assert rep["iterations"] == 100
    assert rep["finite"] and not rep["stalled"]
    assert rep["reduction_rate"] < 0
    assert rep == JU.convergence_report(primal, dual)
    stalled = TU.convergence_report([1.0] * 60, [1.0] * 60)
    assert stalled["stalled"]
    # one lane of a batched history (NaN past its exit), as a tensor
    lane = torch.as_tensor(np.concatenate([np.logspace(0, -3, 30), np.full(10, np.nan)]))
    rep = TU.convergence_report(lane, lane)
    assert rep == JU.convergence_report(lane.numpy(), lane.numpy())
    assert rep["iterations"] == 30


def test_check_finite_state():
    rng = np.random.RandomState(3)
    A = rng.randn(4, 6)
    opt = T.SimpleOptimizer(_model(T, A, rng.randn(4)), device="cpu")
    opt.solve(5)
    TU.check_finite_state(opt)  # healthy
    opt._x = (np.full(6, np.nan),) + tuple(opt._x[1:])
    with pytest.raises(FloatingPointError):
        TU.check_finite_state(opt)
    opt._x = (torch.zeros(6),) + tuple(opt._x[1:])
    opt._h = (torch.full((6,), float("inf")),)
    with pytest.raises(FloatingPointError, match="dual"):
        TU.check_finite_state(opt)


def _resumable_kw():
    return dict(checkpoint_every=100, niter=300, rtol=0.0, record_residuals=False)


def test_solve_resumable(tmp_path, monkeypatch):
    """Segmented checkpointed solve == one uninterrupted segmented solve:
    killing between segments and restarting from the file reproduces the
    same state (atol 0); iteration counts accumulate across segments; a
    covered budget returns the file without a solve; the result equals the
    JAX package's solve_resumable."""
    A, ys = _bp_batch()
    ov = {(0, "y"): ys}
    kw = _resumable_kw()
    ckpt = str(tmp_path / "run.npz")
    bs = BatchedSolver(bp_model(A, ys[0], alpha_l1=0.05), device="cpu")

    r1 = bs.solve_resumable(ckpt, ov, **{**kw, "niter": 100})
    assert int(r1.iterations.max()) == 100
    r2 = bs.solve_resumable(ckpt, ov, **kw)
    assert int(r2.iterations.max()) == 300

    bs2 = BatchedSolver(bp_model(A, ys[0], alpha_l1=0.05), device="cpu")
    r3 = bs2.solve_resumable(str(tmp_path / "run2.npz"), ov, **kw)
    for a, b in zip(r2.x + r2.h, r3.x + r3.h):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=0)
    np.testing.assert_array_equal(r2.mu.numpy(), r3.mu.numpy())

    # a fully covered checkpoint short-circuits: no solve runs
    monkeypatch.setattr(bs, "solve", lambda *a, **k: pytest.fail("solve() ran"))
    r4 = bs.solve_resumable(ckpt, ov, **kw)
    for a, b in zip(r4.x, r2.x):
        np.testing.assert_array_equal(a.numpy(), b.numpy())

    jbs = JaxBatched(jax_bp_model(A, ys[0], alpha_l1=0.05))
    rj = jbs.solve_resumable(str(tmp_path / "jax.npz"), ov, **kw)
    for a, b in zip(r3.x + r3.h, tuple(rj.x) + tuple(rj.h)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    np.testing.assert_array_equal(r3.iterations.numpy(), np.asarray(rj.iterations))


def test_solve_resumable_stops_when_converged(tmp_path):
    """Every lane converged: no further segment runs and the checkpoint
    holds the converged state."""
    A, ys = _bp_batch(seed=4)
    bs = BatchedSolver(bp_model(A, ys[0], alpha_l1=0.05), device="cpu")
    ckpt = str(tmp_path / "conv.npz")
    r = bs.solve_resumable(ckpt, {(0, "y"): ys}, checkpoint_every=100, niter=100000,
                           rtol=1e-6, record_residuals=False)
    assert bool(r.converged.all()) and int(r.iterations.max()) < 100000
    back = TU.load_batch_result(ckpt, device="cpu")
    np.testing.assert_array_equal(back.iterations.numpy(), r.iterations.numpy())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_solve_resumable_cross_loads(tmp_path, writer):
    """A checkpoint written after one segment by one package resumes in the
    other and reproduces the writer's own continued trajectory."""
    A, ys = _bp_batch(seed=6)
    ov = {(0, "y"): ys}
    kw = _resumable_kw()
    tbs = BatchedSolver(bp_model(A, ys[0], alpha_l1=0.05), device="cpu")
    jbs = JaxBatched(jax_bp_model(A, ys[0], alpha_l1=0.05))
    first, second = (jbs, tbs) if writer == "jax" else (tbs, jbs)
    ckpt = str(tmp_path / "cross.npz")
    first.solve_resumable(ckpt, ov, **{**kw, "niter": 100})
    resumed = second.solve_resumable(ckpt, ov, **kw)
    own = first.solve_resumable(str(tmp_path / "own.npz"), ov, **kw)
    to_np = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    for a, b in zip(tuple(resumed.x) + tuple(resumed.h), tuple(own.x) + tuple(own.h)):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=TOL)
    np.testing.assert_array_equal(to_np(resumed.iterations), to_np(own.iterations))
    np.testing.assert_allclose(to_np(resumed.mu), to_np(own.mu), rtol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_single_instance_checkpoint_cross_loads(tmp_path, writer):
    """save_state of one package, restore_optimizer of the other."""
    rng = np.random.RandomState(8)
    A, y = rng.randn(8, 20), rng.randn(8)
    path = str(tmp_path / "one.npz")
    if writer == "jax":
        o = J.SimpleOptimizer(_model(J, A, y))
        o.solve(40)
        JU.save_state(path, o)
        back = TU.restore_optimizer(path, _model(T, A, y), device="cpu")
    else:
        o = T.SimpleOptimizer(_model(T, A, y), device="cpu")
        o.solve(40)
        TU.save_state(path, o)
        back = JU.restore_optimizer(path, _model(J, A, y))
    o.solve(40)
    back.solve(40)
    to_np = lambda a: a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    for a, b in zip(back.x, o.x):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=TOL)
    np.testing.assert_allclose(back._primal_residual, o._primal_residual, rtol=TOL, atol=TOL)


def test_scattered_checkpoint_roundtrip(tmp_path):
    """Shard checkpoints reassemble to the full result: one process writes
    all lanes with lane_index = arange(B); two shard files (lanes split and
    re-indexed, read in any order) give the same lanes; the JAX package
    reads the port's shards and the port the JAX package's."""
    rng = np.random.RandomState(17)
    A, ys = rng.randn(8, 16), rng.randn(8, 8)
    bs = BatchedSolver(_model(T, A, ys[0]), device="cpu")
    res = bs.solve({(0, "y"): ys}, niter=40, rtol=0, record_residuals=False)

    p = tmp_path / "ckpt_p0.npz"
    save_batch_result_local(str(p), res)
    with np.load(p) as z:
        np.testing.assert_array_equal(z["lane_index"], np.arange(8))
    back = load_batch_result_scattered([str(p)], device="cpu")
    for a, b in zip(res.x, back.x):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(res.mu.numpy(), back.mu.numpy())
    np.testing.assert_array_equal(res.iterations.numpy(), back.iterations.numpy())
    from admmsolver_tpu.utils.checkpoint import load_batch_result_scattered as jload
    jback = jload([str(p)])
    np.testing.assert_array_equal(np.asarray(jback.x[0]), res.x[0].numpy())

    half = 4
    take = lambda sl: T.parallel.BatchResult(
        x=tuple(a[sl] for a in res.x), h=tuple(a[sl] for a in res.h),
        **{k: getattr(res, k)[sl] for k in ("mu", "iterations", "converged",
                                            "primal_residual", "dual_residual")})
    pa, pb = tmp_path / "p0.npz", tmp_path / "p1.npz"
    save_batch_result_local(str(pa), take(slice(0, half)))
    save_batch_result_local(str(pb), take(slice(half, 8)))
    # the second file's lanes are globally [half, B): patch its indices
    with np.load(pb, allow_pickle=False) as z:
        arrs = {k: z[k] for k in z.files}
    arrs["lane_index"] = np.arange(half, 8)
    np.savez(pb, **arrs)
    both = load_batch_result_scattered([str(pb), str(pa)], device="cpu")
    np.testing.assert_array_equal(both.x[0].numpy(), res.x[0].numpy())
    np.testing.assert_array_equal(both.iterations.numpy(), res.iterations.numpy())
    with pytest.raises(ValueError, match="scattered"):
        load_batch_result_scattered([str(tmp_path / "ckpt_p0.npz"), _plain(tmp_path, res)],
                                    device="cpu")


def _plain(tmp_path, res):
    path = str(tmp_path / "plain.npz")
    TU.save_batch_result(path, res)
    return path


def test_debug_nans_trace_and_timed_solve(tmp_path):
    """Inside debug_nans the engines raise at the first non-finite chunk,
    outside they run on; trace writes a Chrome trace."""
    from admmsolver_tpu_torch.utils.telemetry import trace

    rng = np.random.RandomState(5)
    A, ys = rng.randn(6, 12), rng.randn(3, 6)
    ys[1, 2] = np.nan
    bs = BatchedSolver(_model(T, A, ys[0]), device="cpu")
    solve = lambda: bs.solve({(0, "y"): ys}, niter=30, rtol=0, record_residuals=False)
    assert not bool(torch.isfinite(solve().x[0]).all())
    with TU.debug_nans():
        with pytest.raises(FloatingPointError, match="BatchedSolver"):
            solve()
        opt = T.SimpleOptimizer(_model(T, A, ys[1]), device="cpu")
        with pytest.raises(FloatingPointError, match="SimpleOptimizer"):
            opt.solve(10)
    solve()   # the scope has ended

    logdir = str(tmp_path / "trace")
    with trace(logdir):
        bs.solve({(0, "y"): ys[[0, 2]]}, niter=5)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as f:
        assert "traceEvents" in json.load(f)
