"""The composite drivers as one program each, on the CPU in float64.

``BatchedSolver.solve_path(fused=True)`` and ``solve_scan`` (one group
program: every group's entry, chunks and exit fed from buffers on the card),
``BatchedSolver.solve_mixed(fused=True)`` (two phases, the hand-off on the
card) and ``FusedSpMSolver.solve_mixed(fused=True)`` (the kernel phase's run
program, then the polish's fed program).  Each is held against the JAX
package's one-program form as tests/test_torch_batch.py compares solves (x
and h to 1e-9, mu to rtol 1e-12, counts and flags equal, histories to rtol
1e-6) and against the port's loop or two-dispatch form bitwise where the
shapes are equal.  Where a phase runs in float32 the two packages round it
differently: those cases hold mu and counts exactly, x to 2e-5 after
BatchedSolver's float32 phase (the polished x, as tests/test_torch_mixed.py
holds a fixed budget), x and h to 1e-6 after the SpM kernel phase and its
polish's histories to 1%.  Also:
once warm at rtol 0 no group or phase reads the host (nor does a plain
``solve`` or a wave of ``ScenarioScheduler.run_compiled``, the two one-group
programs beside them), and the programs are cached as the JAX package
caches its compiled forms.
"""
import dataclasses

import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import spm_model as jax_spm_model
from admmsolver_tpu.parallel import BatchedSolver as JaxBatched
from admmsolver_tpu.parallel import FusedSpMSolver as JaxFusedSpM
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu_torch.parallel import (BatchedSolver, FusedSpMSolver, ScenarioScheduler,
                                           batch, fused)
from test_torch_batch import _assert_same, _bp, _cls
from test_torch_optimizer_program import _family, _nothing_from_the_host

torch.set_num_threads(1)


def _solvers(jm, **kw):
    return JaxBatched(jm, **kw), BatchedSolver(interop.from_jax_model(jm, device="cpu"),
                                               device="cpu", **kw)


def _fields(r):
    return r.x + r.h + (r.mu, r.iterations, r.converged, r.primal_residual, r.dual_residual)


def _assert_bitwise(got, want):
    for a, b in zip(_fields(got), _fields(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _path_case(nlam, seed=33):
    rng = np.random.RandomState(seed)
    A = rng.randn(10, 24)
    y = A @ np.concatenate([rng.randn(3), np.zeros(21)])
    ys = y[None] + 0.01 * rng.randn(nlam, 10)
    return A, y, np.logspace(0.5, -2, nlam), {(0, "y"): ys}


# ---------------------------------------------------------------------
# solve_path
# ---------------------------------------------------------------------

@pytest.mark.parametrize("rtol", [0.0, 1e-9], ids=["rtol0", "rtol"])
@pytest.mark.parametrize("nlam", [12, 11], ids=["divisible", "ragged"])
def test_path_program_matches_jax(nlam, rtol):
    """Against the JAX package's ``_compiled_path``: warm starts from the
    last lane, the ragged last group padded and trimmed, strided histories.
    At rtol 0 the solve stops before the lanes' residuals reach rounding
    noise, where the penalty update's test of their ratio is a coin toss
    that a batch of another size (the ragged loop's) tosses otherwise."""
    A, y, lams, ov = _path_case(nlam)
    niter = 90 if rtol == 0 else 400
    kw = dict(overrides=ov, group_size=4, niter=niter, interval_update_mu=20, rtol=rtol,
              record_residuals=3)
    bj, bt = _solvers(_bp(J, A, y))
    res = bt.solve_path((1, "alpha"), lams, fused=True, **kw)
    assert tuple(res.x[0].shape) == (nlam, 24)
    assert tuple(res.primal_residual.shape) == (nlam, -(-niter // 3))
    _assert_same(res, bj.solve_path((1, "alpha"), lams, fused=True, **kw))
    (key,) = bt._programs
    assert key[0] == "path"


@pytest.mark.parametrize("rtol", [0.0, 1e-9], ids=["rtol0", "rtol"])
def test_path_program_equals_the_loop_bitwise(rtol):
    """Where every group is whole, the program and the host loop of one
    ``solve`` a group give the same bits, warm start and x0, h0, mu0 of
    the first group included."""
    A, y, lams, ov = _path_case(12, seed=35)
    bt = BatchedSolver(_bp(T, A, y), device="cpu")
    rng = np.random.RandomState(1)
    kw = dict(overrides=ov, group_size=4, niter=150, interval_update_mu=30, rtol=rtol,
              x0=(0.1 * rng.randn(4, 24), 0.1 * rng.randn(4, 24)), mu0=np.linspace(0.5, 2, 4))
    _assert_bitwise(bt.solve_path((1, "alpha"), lams, fused=True, **kw),
                    bt.solve_path((1, "alpha"), lams, fused=False, **kw))


def test_path_program_checks_its_inputs():
    """Validation runs once, on the whole input; a keyword the program does
    not take raises as the JAX package's ``_solve_path_fused`` does."""
    A, y, lams, ov = _path_case(8)
    bt = BatchedSolver(_bp(T, A, y), device="cpu")
    with pytest.raises(ValueError, match="no batchable field"):
        bt.solve_path((1, "beta"), lams, overrides=ov, group_size=4, niter=5)
    with pytest.raises(TypeError, match="unexpected keyword"):
        bt.solve_path((1, "alpha"), lams, overrides=ov, group_size=4, niter=5,
                      done0=np.zeros(4, bool))
    assert not bt._programs


# ---------------------------------------------------------------------
# solve_scan
# ---------------------------------------------------------------------

@pytest.mark.parametrize("model", ["least_squares", "constrained"])
def test_scan_program_matches_jax(model):
    """Against the JAX package's ``run_scan``: per-lane A, an uneven last
    group (padded by the last instance, trimmed), warm starts, histories."""
    rng = np.random.RandomState(32)
    B = 5
    As, ys = rng.randn(B, 6, 10), rng.randn(B, 6)
    mk = (lambda P, A, y: _bp(P, A, y)) if model == "least_squares" else _cls
    bj, bt = _solvers(mk(J, As[0], ys[0]))
    ov = {(0, "A"): As, (0, "y"): ys}
    kw = dict(group_size=2, niter=70, interval_update_mu=25, mu0=np.linspace(0.5, 2.0, B),
              record_residuals=True,
              x0=tuple(0.1 * rng.randn(B, 10) for _ in bt.plan.block_sizes))
    res = bt.solve_scan(ov, **kw)
    _assert_same(res, bj.solve_scan(ov, **kw))
    ((key, program),) = bt._programs.items()
    assert key[0] == "scan" and key[2][0][1][:1] == (2,) and program.rows == 3


def test_scan_program_equals_the_loop_bitwise():
    """Each whole group of the program gives the bits of the same group
    solved alone (the form a sharded solver keeps)."""
    rng = np.random.RandomState(30)
    B, g = 8, 4
    As, ys = rng.randn(B, 8, 12), rng.randn(B, 8)
    bt = BatchedSolver(_bp(T, As[0], ys[0]), device="cpu")
    ov = {(0, "A"): As, (0, "y"): ys}
    kw = dict(niter=150, interval_update_mu=40, rtol=1e-10, record_residuals=True)
    res = bt.solve_scan(ov, group_size=g, **kw)
    cfg = bt._config(150, 40, True, 1e3, 2.0, 10.0, 1.0)
    for s in range(0, B, g):
        one = bt._solve_lanes(g, cfg, {k: v[s:s + g] for k, v in ov.items()}, bt.dtype,
                              None, None, 1.0, None, (1e-10, 0.0), True, 1, False)
        _assert_bitwise(batch._lanewise(lambda a, s=s: a[s:s + g], res), one)


# ---------------------------------------------------------------------
# BatchedSolver.solve_mixed
# ---------------------------------------------------------------------

def _mixed_case(seed=5, B=6, M=30, N=80):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 6, replace=False)] = rng.randn(6)
    return A, xt @ A.T


@pytest.mark.parametrize("low", ["float64", "float32"])
def test_mixed_program_matches_jax(low):
    """Against the JAX package's ``_compiled_mixed``: the phases' counts
    summed, their histories joined.  A float64 first phase is the same
    arithmetic in both packages; a float32 one rounds differently."""
    A, ys = _mixed_case()
    bj, bt = _solvers(J.Model([J.LeastSquares(1.0, A, ys[0]), J.L1Regularizer(0.1, 80)],
                              [(1, 0, J.identity(80), J.identity(80))]))
    kw = dict(niter_low=150, niter=120, low_dtype=low, low_rtol=0.0, rtol=0.0, mu0=0.5,
              interval_update_mu=40, record_residuals=7)
    res = bt.solve_mixed({(0, "y"): ys}, fused=True, **kw)
    rj = bj.solve_mixed({(0, "y"): ys}, fused=True, **kw)
    assert tuple(res.primal_residual.shape) == (6, 22 + 18)
    if low == "float64":
        _assert_same(res, rj)
    else:
        # the polished x, as tests/test_torch_mixed.py compares across packages
        for a, b in zip(res.x, rj.x, strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=2e-5)
        np.testing.assert_allclose(res.mu.numpy(), np.asarray(rj.mu), rtol=1e-12)
        np.testing.assert_array_equal(res.iterations.numpy(), np.asarray(rj.iterations))
        np.testing.assert_array_equal(np.isnan(res.primal_residual.numpy()),
                                      np.isnan(np.asarray(rj.primal_residual)))
    assert [key[0] for key in bt._programs] == ["mixed"]


@pytest.mark.parametrize("tols", [dict(rtol=0.0, low_rtol=0.0),
                                  dict(rtol=1e-10, low_rtol=1e-5, atol=1e-12)],
                         ids=["fixed", "tolerances"])
def test_mixed_program_equals_two_dispatch_bitwise(tols):
    A, ys = _mixed_case(seed=7)
    bt = BatchedSolver(_bp(T, A, ys[0]), device="cpu")
    kw = dict(niter_low=200, niter=300, mu0=0.5, interval_update_mu=50,
              x0=(0.01 * np.ones((6, 80)), np.zeros((6, 80))), **tols)
    _assert_bitwise(bt.solve_mixed({(0, "y"): ys}, fused=True, **kw),
                    bt.solve_mixed({(0, "y"): ys}, fused=False, **kw))
    with pytest.raises(TypeError, match="unexpected keyword"):
        bt.solve_mixed({(0, "y"): ys}, fused=True, done0=np.zeros(6, bool), **kw)


# ---------------------------------------------------------------------
# FusedSpMSolver.solve_mixed
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def spm_setup():
    """tests/test_fused_spm.py's problem."""
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    gs = g[None, :] + 1e-4 * np.random.RandomState(0).randn(6, g.size)
    jm = jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    return jm, interop.from_jax_model(jm, device="cpu"), gs


def _assert_spm_close(r, rj):
    for a, b in zip(r.x + r.h, tuple(rj.x) + tuple(rj.h), strict=True):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(r.mu.numpy(), np.asarray(rj.mu))
    np.testing.assert_array_equal(r.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(r.converged.numpy(), np.asarray(rj.converged))


@pytest.mark.parametrize("fused_flag", [True, False], ids=["fused", "two_dispatch"])
@pytest.mark.parametrize("knob", [dict(interval_update_mu=50), dict(th_change=float("inf"))],
                         ids=["interval_50", "th_change_inf"])
def test_spm_mixed_knobs_reach_the_phases_as_in_jax(spm_setup, knob, fused_flag):
    """The two-dispatch form gives the kernel phase ``done0`` alone and the
    polish every knob, the composite gives the penalty knobs to both phases
    (JAX ``fused_spm.py:483-485``, ``:556-557``, ``:584-586``)."""
    jm, tm, gs = spm_setup
    kw = dict(niter_low=120, niter=40, mu0=0.1, rtol=0.0, fused=fused_flag, **knob)
    r = FusedSpMSolver(tm, device="cpu").solve_mixed({(0, "y"): gs}, **kw)
    _assert_spm_close(r, JaxFusedSpM(jm, tile_b=2).solve_mixed({(0, "y"): gs}, **kw))


@pytest.mark.parametrize("case", ["default", "done0_strided"])
def test_spm_mixed_program_matches_jax_and_two_dispatch(spm_setup, case):
    """The composite against the JAX package's (histories: the polish's)
    and, at the default knobs, bitwise against the two-dispatch form."""
    jm, tm, gs = spm_setup
    kw = dict(niter_low=150, niter=60, mu0=0.1, rtol=0.0)
    if case == "done0_strided":
        kw.update(done0=np.array([False, True, False, False, True, False]),
                  record_residuals=4, low_atol=1e-3, interval_update_mu=30)
    fs = FusedSpMSolver(tm, device="cpu")
    one = fs.solve_mixed({(0, "y"): gs}, fused=True, **kw)
    rj = JaxFusedSpM(jm, tile_b=2).solve_mixed({(0, "y"): gs}, fused=True, **kw)
    _assert_spm_close(one, rj)
    for a, b in ((one.primal_residual, rj.primal_residual),
                 (one.dual_residual, rj.dual_residual)):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2, atol=1e-12)
    assert [key[0] for key in fs._programs] == ["mixed"]
    if case == "default":
        _assert_bitwise(one, fs.solve_mixed({(0, "y"): gs}, fused=False, **kw))
    else:
        assert (one.iterations.numpy()[kw["done0"]] == 0).all()


# ---------------------------------------------------------------------
# no host read once warm; the cache
# ---------------------------------------------------------------------

def _composites(name):
    """(solver, the composite calls) of a family of
    tests/test_torch_optimizer_program.py at rtol 0 (atol 0, low_atol 0)."""
    B = 4
    if name == "spm_fused":
        s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=10, nw=21)
        fs = FusedSpMSolver(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), device="cpu")
        ys = g[None] + 1e-4 * np.random.RandomState(2).randn(B, g.size)
        return fs, [lambda: fs.solve_mixed({(0, "y"): ys}, niter_low=35, niter=25, mu0=0.1,
                                           low_atol=0.0, rtol=0.0, interval_update_mu=10,
                                           done0=np.array([False, True, False, False]))]
    bs = BatchedSolver(_family(name), device="cpu")
    f = bs.model.functions
    k = next(k for k, fn in enumerate(f) if "alpha" in fn.batch_fields)
    lams = np.linspace(0.2, 0.05, 2 * B)
    knobs = dict(niter=12, interval_update_mu=5, rtol=0.0)
    calls = [lambda: bs.solve_path((k, "alpha"), lams, group_size=B, **knobs),
             lambda: bs.solve_scan({(k, "alpha"): lams[:B + 1]}, group_size=2, **knobs),
             lambda: bs.solve_mixed({(k, "alpha"): lams[:B]}, niter_low=12, low_rtol=0.0,
                                    fused=True, **knobs)]
    return bs, calls


@pytest.mark.parametrize("name", ["bp", "spm", "complex", "diag", "cov", "sdp", "rpca",
                                  "group", "huber", "tv", "box", "realified",
                                  "realified_spm", "spm_fused"])
def test_warm_composites_take_nothing_from_the_host(name, monkeypatch):
    """Once its program is warm, a composite at rtol 0 reads nothing on the
    host from its first group's entry to its last group's exit (each
    group's or phase's entry, chunks and exit, and the host loop between),
    nor copies a tensor made there: what a captured step cannot hold."""
    guarded = []

    def strict(fn):
        def run(self, *args, **kwargs):
            if not self.warm:
                return fn(self, *args, **kwargs)
            guarded.append(type(self).__name__)
            with _nothing_from_the_host():
                return fn(self, *args, **kwargs)
        return run

    solver, calls = _composites(name)
    firsts = [call() for call in calls]
    # patched once the programs are built: their stages look their runs up
    monkeypatch.setattr(batch._FedProgram, "run_group", strict(batch._FedProgram.run_group))
    monkeypatch.setattr(fused._FusedProgram, "run_schedule",
                        strict(fused._FusedProgram.run_schedule))
    for call, first in zip(calls, firsts):
        guarded.clear()
        again = call()
        assert guarded, "no warm group ran"
        _assert_bitwise(again, first)


@pytest.mark.parametrize("name", ["bp", "spm", "complex", "diag", "cov", "sdp", "rpca",
                                  "group", "huber", "tv", "box", "realified",
                                  "realified_spm"])
def test_warm_solve_and_wave_take_nothing_from_the_host(name, monkeypatch):
    """Once its program is warm, a plain ``solve`` at rtol 0 reads nothing
    on the host from its entry to its last chunk, and neither does a wave
    of ``ScenarioScheduler.run_compiled`` from its entry to its exit (the
    wave's one read of the harvested count comes after): what a captured
    step cannot hold."""
    guarded = []
    run_group = batch._FedProgram.run_group

    def strict(self, *args, **kwargs):
        if not self.warm:
            return run_group(self, *args, **kwargs)
        guarded.append(type(self).__name__)
        with _nothing_from_the_host():
            return run_group(self, *args, **kwargs)

    bs = BatchedSolver(_family(name), device="cpu")
    k = next(k for k, fn in enumerate(bs.model.functions) if "alpha" in fn.batch_fields)
    lams = np.linspace(0.2, 0.05, 3)
    solve = lambda: bs.solve({(k, "alpha"): lams}, niter=12, interval_update_mu=5, rtol=0.0)
    sched = ScenarioScheduler(bs, batch_size=2, chunk_iters=5, niter_max=10, rtol=0.0,
                              interval_update_mu=5)
    drain = lambda: sched.run_compiled({(k, "alpha"): lam} for lam in lams)
    first = solve(), drain()
    monkeypatch.setattr(batch._FedProgram, "run_group", strict)
    again = solve()
    assert guarded == ["_FedProgram"]
    _assert_bitwise(again, first[0])
    guarded.clear()
    waves = drain()
    # three scenarios of two waves each in two lanes: four waves
    assert guarded == ["_WaveProgram"] * 4
    for a, b in zip(waves, first[1], strict=True):
        assert (a.scenario_id, a.iterations, a.converged) == (b.scenario_id, b.iterations,
                                                               b.converged)
        assert all(np.array_equal(u, v) for u, v in zip(a.x + (a.final_mu,),
                                                         b.x + (b.final_mu,)))


def test_program_cache_reuses_and_drops_the_oldest():
    """A second call with the same key reuses the program (no new program,
    its buffers at the same addresses); the 33rd key drops the first."""
    A, y, lams, ov = _path_case(8)
    bt = BatchedSolver(_bp(T, A, y), device="cpu")
    kw = dict(overrides=ov, group_size=4, rtol=0.0, interval_update_mu=10)
    first = bt.solve_path((1, "alpha"), lams, niter=20, **kw)
    (program,) = bt._programs.values()
    addresses = [t.data_ptr() for t in program.buffers()]
    ov2 = {(0, "y"): ov[(0, "y")][::-1].copy()}
    again = bt.solve_path((1, "alpha"), lams, niter=20, **dict(kw, overrides=ov2))
    assert list(bt._programs.values()) == [program]
    assert [t.data_ptr() for t in program.buffers()] == addresses
    fresh = BatchedSolver(_bp(T, A, y), device="cpu").solve_path(
        (1, "alpha"), lams, niter=20, **dict(kw, overrides=ov2))
    _assert_bitwise(again, fresh)
    assert not torch.equal(again.x[0], first.x[0])
    for niter in range(21, 53):
        bt.solve_path((1, "alpha"), lams, niter=niter, **kw)
    assert len(bt._programs) == batch.PROGRAM_CACHE_SIZE == 32
    assert program not in bt._programs.values()
    assert [key[1].niter for key in bt._programs] == list(range(21, 53))


def test_group_program_serves_every_number_of_groups():
    """One program a key whatever the number of groups: a scan of fewer
    groups runs on the first rows of the program's stacks (its buffers at
    the same addresses), one of more grows them; each gives the bits of a
    fresh solver's scan."""
    rng = np.random.RandomState(31)
    As, ys = rng.randn(10, 6, 10), rng.randn(10, 6)
    bt = BatchedSolver(_bp(T, As[0], ys[0]), device="cpu")
    kw = dict(group_size=2, niter=30, interval_update_mu=10, rtol=0.0)
    ov = lambda B: {(0, "A"): As[:B], (0, "y"): ys[:B]}
    bt.solve_scan(ov(8), **kw)
    (program,) = bt._programs.values()
    addresses = [t.data_ptr() for t in program.buffers()]
    for B, rows in ((4, 4), (3, 4), (10, 5)):   # fewer groups, a ragged one, more
        res = bt.solve_scan(ov(B), **kw)
        assert list(bt._programs.values()) == [program] and program.rows == rows
        assert ([t.data_ptr() for t in program.buffers()] == addresses) == (rows == 4)
        fresh = BatchedSolver(_bp(T, As[0], ys[0]), device="cpu").solve_scan(ov(B), **kw)
        _assert_bitwise(res, fresh)


def test_failed_factorization_raises(monkeypatch):
    """A group whose Cholesky factorization fails raises LinAlgError, read
    once after the last group at rtol 0."""
    rng = np.random.RandomState(3)
    As = rng.randn(4, 8, 12)
    bt = BatchedSolver(_bp(T, As[0], rng.randn(8)), device="cpu")
    ov = {(0, "A"): As, (0, "y"): rng.randn(4, 8)}
    bt.solve_scan(ov, group_size=2, niter=12, interval_update_mu=5, rtol=0.0)
    real = batch.any_not_pd
    monkeypatch.setattr(batch, "any_not_pd", lambda infos: ~real(infos))
    with pytest.raises(torch.linalg.LinAlgError):
        bt.solve_scan(ov, group_size=2, niter=12, interval_update_mu=5, rtol=0.0)


def test_results_are_copies():
    """The result does not alias the program's buffers: the next call
    leaves it as it was."""
    A, y, lams, ov = _path_case(8)
    bt = BatchedSolver(_bp(T, A, y), device="cpu")
    kw = dict(overrides=ov, group_size=4, niter=20, rtol=0.0)
    r1 = bt.solve_path((1, "alpha"), lams, **kw)
    keep = dataclasses.replace(r1, x=tuple(t.clone() for t in r1.x))
    bt.solve_path((1, "alpha"), lams[::-1].copy(), **kw)
    assert all(torch.equal(a, b) for a, b in zip(r1.x, keep.x))
