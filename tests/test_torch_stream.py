"""The port's stacked stream (``ScenarioScheduler.run_stacked``) on the CPU in
float64, without the JAX package: a ragged stream of basis-pursuit
scenarios (sparsity and L1 weight per scenario, an absolute stop) whose
lanes finish in different waves, some converged and some at the budget.

``run_stacked`` equals ``run_compiled`` and the host loop ``run`` bit for
bit, and the plain reference of the benchmark's stream cell
(``portbench/references/bp_stream.py``) in iterations and flags and in x
to 1e-9; the reference's one continuous run equals its run in waves with
the state carried, the claim it rests on; the wave program's counters
equal what its outputs imply, and are recorded only with the switch on.
"""
import numpy as np
import pytest
import torch

from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, identity
from admmsolver_tpu_torch.parallel import BatchedSolver, ScenarioScheduler, StreamResult
from admmsolver_tpu_torch.utils import telemetry
from portbench.references import admm, bp_stream

N, M, S, B, CHUNK, NITER_MAX, ATOL = 64, 16, 24, 8, 10, 600, 1e-9


def _stream(seed=0):
    """A, and the stacked ys and L1 weights of S scenarios: K from 1 to 12 of
    64, alpha 10^U(-2.5, -0.5)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((S, N))
    for i, k in enumerate(rng.randint(1, 13, S)):
        xt[i, rng.choice(N, k, replace=False)] = rng.randn(k)
    return A, xt @ A.T, 10.0 ** rng.uniform(-2.5, -0.5, S)


def _scheduler(A, **kw):
    model = Model([LeastSquares(1.0, A, np.zeros(M)), L1Regularizer(0.1, N)],
                  [(1, 0, identity(N), identity(N))])
    kw = dict(dict(batch_size=B, chunk_iters=CHUNK, niter_max=NITER_MAX, rtol=0.0, atol=ATOL,
                   interval_update_mu=CHUNK), **kw)
    return ScenarioScheduler(BatchedSolver(model, device="cpu"), **kw)


def _stacks(ys, alphas):
    return {(0, "y"): torch.as_tensor(ys), (1, "alpha"): torch.as_tensor(alphas)}


def _rows(ys, alphas):
    return [{(0, "y"): ys[i], (1, "alpha"): np.float64(alphas[i])} for i in range(len(ys))]


def _same_bits(r, results):
    """A StreamResult and a list of ScenarioResults hold the same bits."""
    assert [s.scenario_id for s in results] == list(range(len(results)))
    for b, x in enumerate(r.x):
        assert torch.equal(x, torch.as_tensor(np.stack([s.x[b] for s in results])))
    assert r.iterations.tolist() == [s.iterations for s in results]
    assert r.converged.tolist() == [s.converged for s in results]
    assert torch.equal(r.final_mu, torch.as_tensor(np.stack([s.final_mu for s in results])))


def test_run_stacked_equals_run_compiled_and_run_bit_for_bit():
    A, ys, alphas = _stream()
    sched = _scheduler(A)
    r = sched.run_stacked(_stacks(ys, alphas))
    assert tuple(r.x[0].shape) == (S, N) and r.x[0].dtype == torch.float64
    assert r.iterations.dtype == torch.int32 and r.converged.dtype == torch.bool
    assert tuple(r.final_mu.shape) == (S, 1)
    # ragged: some scenarios converge in different waves, some reach the budget
    assert 0 < int(r.converged.sum()) < S
    assert len(set(r.iterations.tolist())) > 4 and NITER_MAX in r.iterations.tolist()
    _same_bits(r, sched.run_compiled(_rows(ys, alphas)))
    _same_bits(r, sched.run(_rows(ys, alphas)))


def test_run_stacked_matches_the_plain_reference():
    A, ys, alphas = _stream()
    r = _scheduler(A).run_stacked(_stacks(ys, alphas))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    st = bp_stream.solve({"A": t(A)}, {"y": t(ys), "alpha1": t(alphas),
                                       "alpha_ls": torch.ones(S, dtype=torch.float64)},
                         1.0, admm.Knobs(niter=NITER_MAX, interval=CHUNK, rtol=0.0, atol=ATOL,
                                         checks="iteration"))
    assert st.count.tolist() == r.iterations.tolist()
    assert st.done.tolist() == r.converged.tolist()
    for xp, xr in zip(r.x, st.x):
        assert float((xp - xr).abs().max()) <= 1e-9 * float(xr.abs().max())


def test_reference_in_waves_equals_its_single_run():
    """Waves of ``interval`` iterations, each a fresh run from the carried
    state (x, h, mu, flags, counts) that restarts the penalty schedule, as a
    lane of the stream does: the same bits as one continuous run."""
    A, ys, alphas = _stream(1)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    fix, batch = {"A": t(A)}, {"y": t(ys), "alpha1": t(alphas),
                               "alpha_ls": torch.ones(S, dtype=torch.float64)}
    knobs = dict(interval=CHUNK, rtol=0.0, atol=ATOL, checks="iteration")
    whole = bp_stream.solve(fix, batch, 1.0, admm.Knobs(niter=NITER_MAX, **knobs))
    p = bp_stream.BasisPursuit(fix["A"], batch["y"], batch["alpha_ls"], batch["alpha1"])
    st = admm.fresh_state(p.sizes, p.pair_sizes, S, 1.0, torch.float64, "cpu")
    for _ in range(NITER_MAX // CHUNK):
        st = admm.run(p, st, admm.Knobs(niter=CHUNK, **knobs))
    assert 0 < int(whole.done.sum()) < S
    assert torch.equal(st.count, whole.count) and torch.equal(st.done, whole.done)
    assert torch.equal(st.mu, whole.mu)
    for a, b in zip(st.x + st.h, whole.x + whole.h):
        assert torch.equal(a, b)


def test_stream_counters_match_the_outputs():
    A, ys, alphas = _stream()
    sched = _scheduler(A)
    telemetry.reset()
    try:
        r = sched.run_stacked(_stacks(ys, alphas))
        assert not any(k in telemetry.snapshot()["counters"]
                       for k in ("waves", "scenarios_out", "stream.slot_iters",
                                 "stream.lane_iters", "flag_reads"))
        with telemetry.tracing():
            r2 = sched.run_stacked(_stacks(ys, alphas))
        log = telemetry.snapshot()
    finally:
        telemetry.reset()
    assert torch.equal(r2.x[0], r.x[0])
    (call,) = [rec for rec in log["records"] if rec["name"] == telemetry.SOLVE]
    got = call["attrs"]["counters"]
    waves = sum(1 for rec in log["records"] if rec["name"] == "admm.wave")
    # waves of CHUNK iterations: a wave a read, B lane slots a wave iteration
    assert got["waves"] == got["flag_reads"] == waves > NITER_MAX // CHUNK
    assert got["scenarios_out"] == S
    assert got["stream.slot_iters"] == B * CHUNK * waves
    assert got["stream.lane_iters"] == int(r.iterations.sum())
    assert got["stream.lane_iters"] < got["stream.slot_iters"]
    # each read inside its wave
    ids = {rec["id"] for rec in log["records"] if rec["name"] == "admm.wave"}
    reads = [rec for rec in log["records"] if rec["name"] == "admm.flags_read"]
    assert len(reads) == waves and all(rec["parent"] in ids for rec in reads)


def test_run_compiled_stacks_inside_its_span():
    A, ys, alphas = _stream()
    with telemetry.tracing():
        telemetry.reset()
        _scheduler(A).run_compiled(_rows(ys, alphas))
        log = telemetry.snapshot()
    telemetry.reset()
    calls = [rec for rec in log["records"] if rec["name"] == telemetry.SOLVE]
    (outer,) = [rec for rec in calls if rec["parent"] is None]
    (stack,) = [rec for rec in log["records"] if rec["name"] == "admm.stream_in"]
    assert stack["parent"] == outer["id"] and len(calls) == 2
    assert outer["attrs"]["counters"]["scenarios_out"] == S


def test_run_stacked_casts_and_keeps_the_callers_tensors():
    """float32 stacks into a float64 solver are cast; the program keeps its
    own copy of the stacks, so a second stream on the same program writes
    nothing into the first one's tensors."""
    A, ys, alphas = _stream()
    sched = _scheduler(A)
    first = _stacks(ys, alphas)
    kept = {k: v.clone() for k, v in first.items()}
    r1 = sched.run_stacked(first)
    _, ys2, alphas2 = _stream(2)
    r2 = sched.run_stacked(_stacks(ys2, alphas2))
    for k, v in first.items():
        assert torch.equal(v, kept[k])
    assert not torch.equal(r1.x[0], r2.x[0])
    r32 = sched.run_stacked({k: v.float() for k, v in first.items()})
    assert r32.x[0].dtype == torch.float64
    ref = sched.run_stacked({k: v.float().double() for k, v in first.items()})
    assert torch.equal(r32.x[0], ref.x[0])


def test_run_stacked_falls_back_to_run_in_the_stacked_form():
    """solve_kw the wave program does not carry (here chunked_checks) take
    the host loop over the rows; the result is stacked all the same, and
    an empty stream gives empty rows."""
    A, ys, alphas = _stream()
    sched = _scheduler(A, chunked_checks=True)
    calls = []
    run = sched.run
    sched.run = lambda scen: calls.append(1) or run(scen)
    r = sched.run_stacked(_stacks(ys, alphas))
    assert calls == [1]
    _same_bits(r, run(_rows(ys, alphas)))
    empty = sched.run_stacked({(0, "y"): torch.zeros(0, M), (1, "alpha"): torch.zeros(0)})
    assert tuple(empty.x[1].shape) == (0, N) and tuple(empty.final_mu.shape) == (0, 1)
    with pytest.raises(ValueError, match="inconsistent batch"):
        sched.run_stacked({(0, "y"): torch.zeros(3, M), (1, "alpha"): torch.zeros(2)})
    assert type(r) is StreamResult
