"""The batched engine's one-group program (``BatchedSolver.solve``: its
entry and chunks) on the CPU (no graph: each step runs directly), against
the eager loop, against the JAX package's one compiled program
(``BatchedSolver.solve``, ``_compiled``) and against a one-group
``solve_scan`` of the same lanes.

The eager loop (:func:`_eager_run`) is the schedule as plain per-iteration
steps, with a refactor after iteration 0 and after every chunk and the
history slot a Python int: the engine's form before its chunk program,
kept here as the reference.  For basis pursuit, the SDP through the Jacobi
route, Huber regression (a dense per-lane factor), TV denoising (the
cyclic-reduction factor) and realified SpM (the Kronecker factor), under
per-iteration, strided and no histories, chunked checks, a short last
chunk and ``done0``: the program equals the eager loop bitwise (x, h, mu,
iterations, flags and both histories) and the JAX package at
tests/test_torch_batch.py's tolerances (x and h to 1e-9 of max(1,
max|x|), mu to rtol 1e-12, equal iterations and flags, histories to rtol
1e-6 with atol 1e-12 and NaN in the same places).  Then the program's
buffers, its cache and the declared capturability table, the deferred
Cholesky check of the dense factor, and the host's reads of the done flags
in the one schedule of every program family, against the JAX package's
iteration counts.
"""
import types

import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models import applications as JA
from admmsolver_tpu.parallel import BatchedSolver as JaxBatched
from admmsolver_tpu_torch.models import applications as TA
from admmsolver_tpu_torch.models.objectivefunc import (any_not_pd, deferred_cholesky_checks,
                                                      inv_hpd, raise_if_not_pd)
from admmsolver_tpu_torch.models.realify import encode
from admmsolver_tpu_torch.ops import prox
from admmsolver_tpu_torch.parallel import BatchedSolver, batch
from admmsolver_tpu_torch.utils import telemetry

torch.set_num_threads(1)

B = 3
NITER, INTERVAL = 31, 10          # chunks 1-10, 11-20, 21-30: all full
SHORT_NITER = 26                  # the last chunk 21-25: 5 iterations


def _model(name, P):
    """(model of package P, per-lane overrides, mu0) of one of the five
    models, from a seed."""
    rng = np.random.RandomState(31)
    apps = TA if P is T else JA
    if name == "basis_pursuit":
        A = rng.randn(8, 20)
        ys = rng.randn(B, 8)
        return (P.Model([P.LeastSquares(1.0, A, ys[0]), P.L1Regularizer(0.1, 20)],
                        [(1, 0, P.identity(20), P.identity(20))]), {(0, "y"): ys}, 1.0)
    if name == "sdp_jacobi":
        shape = (4, 4, 2)
        A = rng.randn(16, 32)
        xt = np.zeros(shape)
        for r in range(2):
            Q = rng.randn(4, 4)
            xt[:, :, r] = Q @ Q.T / 4
        y = A @ xt.reshape(-1)
        return (apps.sdp_model(A, y, shape, axis=2),
                {(0, "y"): y[None] + 1e-2 * rng.randn(B, 16)}, 1.0)
    if name == "huber":
        A, y = rng.randn(20, 8) / np.sqrt(20), rng.randn(20)
        return (apps.robust_regression_model(A, y, delta=0.1),
                {(1, "y"): y[None] + 0.5 * rng.randn(B, 20)}, 1.0)
    if name == "tv":
        N = 48
        truth = np.repeat(rng.randn(4), N // 4)
        ys = truth[None] + 0.2 * rng.randn(B, N)
        return apps.tv_denoise_model(ys[0], 0.4), {(0, "y"): ys}, 1.0
    if name == "realified_spm":
        s, g, prj_sum, prj_w, _, _ = JA.synthetic_spm_data(nl=8, nw=15)
        g = g + 1e-3j * rng.randn(g.size)
        gs = g[None] + 1e-4 * (rng.randn(B, g.size) + 1j * rng.randn(B, g.size))
        return (P.realify_model(apps.spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)).model,
                {(0, "y"): encode(gs).numpy()}, 0.1)
    raise ValueError(name)


MODELS = ["basis_pursuit", "sdp_jacobi", "huber", "tv", "realified_spm"]
CONDITIONS = {
    "histories": dict(record_residuals=True, rtol=1e-7),
    "strided": dict(record_residuals=3, rtol=1e-7),
    "no_histories": dict(record_residuals=False, rtol=0.0),
    "chunked_checks": dict(chunked_checks=True, rtol=1e-7),
    "short_last_chunk": dict(niter=SHORT_NITER, rtol=1e-7),
    "done0": dict(done0=np.array([False, True, False]), rtol=0.0),
}


def _eager_run(self, cfg, ov, x, h, mu, tols, done0, record, stride, chunked_checks):
    """``BatchedSolver._run`` as the eager loop: iteration 0, then chunks of
    ``interval_update_mu`` plain iterations, each followed by a refactor
    (``inv_hpd`` raising at once), the host reading the done flags where
    the program does."""
    plan = self.plan
    interval, niter = cfg.interval_update_mu, cfg.niter
    rtol, atol = tols
    B = mu.shape[0]
    functions = self._bind(self._prologue_overrides(ov))
    refactored = lambda c: c[:3] + (
        plan.compute_factors(c[2], functions, batched=True),) + c[4:]
    unfactored = lambda c: c[:3] + (None,) + c[4:]
    hist = (niter + stride - 1) // stride if record else 1
    slot = (lambda git: min(git // stride, hist - 1)) if record else (lambda git: 0)
    nan = lambda: torch.full((B, hist), float("nan"), dtype=torch.float64, device=self.device)
    can_finish = rtol > 0 or atol > 0
    all_done = done0 is not None and self._all_done(done0)
    freeze = can_finish or done0 is not None
    if done0 is None:
        done0 = torch.zeros(B, dtype=torch.bool, device=self.device)
    carry = refactored((x, h, mu, None, done0, torch.zeros(B, dtype=torch.int32,
                                                           device=self.device), nan(), nan()))

    def step(carry, git, residuals=True):
        return plan.iteration(carry, slot(git), git, cfg, tols, functions,
                              compute_residuals=residuals, freeze=freeze)

    carry = refactored(unfactored(step(carry, 0)))
    it = 1
    while it < niter and not all_done:
        boundary = it + interval - 1
        for git in range(it, min(it + interval, niter)):
            carry = step(carry, git, not chunked_checks or git == boundary)
        carry = refactored(unfactored(carry))
        it += interval
        if can_finish and it < niter:
            all_done = self._all_done(carry[4])
    x, h, mu, _, done, count, pbuf, dbuf = carry
    return batch.BatchResult(x=x, h=h, mu=mu, iterations=count, converged=done,
                             primal_residual=pbuf, dual_residual=dbuf)


def _solve(bs, ov, mu0, capture, **kw):
    """``bs.solve`` through its chunk program (``capture``: True as a solve
    on the card would, False as with ``CAPTURE_CHUNKS`` off; on the CPU both
    run the chunk directly)."""
    kw = dict(dict(niter=NITER, interval_update_mu=INTERVAL, mu0=mu0), **kw)
    keep = batch.CAPTURE_CHUNKS
    batch.CAPTURE_CHUNKS = capture
    try:
        return bs.solve(ov, **kw)
    finally:
        batch.CAPTURE_CHUNKS = keep


def _eager(model, ov, mu0, **kw):
    """A fresh solver's solve through :func:`_eager_run`."""
    bs = BatchedSolver(model, device="cpu")
    bs._run = types.MethodType(_eager_run, bs)
    kw = dict(dict(niter=NITER, interval_update_mu=INTERVAL, mu0=mu0), **kw)
    return bs.solve(ov, **kw)


def _assert_bitwise(got, want):
    for a, b in zip(got.x + got.h + (got.mu, got.iterations, got.converged, got.primal_residual,
                                     got.dual_residual),
                    want.x + want.h + (want.mu, want.iterations, want.converged,
                                       want.primal_residual, want.dual_residual)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _assert_matches_jax(rt, rj):
    scale = max(1.0, max(float(np.abs(np.asarray(x)).max()) for x in rj.x))
    for a, b in zip(rt.x + rt.h, tuple(rj.x) + tuple(rj.h)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(rt.mu.numpy(), np.asarray(rj.mu), rtol=1e-12)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    np.testing.assert_array_equal(rt.converged.numpy(), np.asarray(rj.converged))
    for a, b in ((rt.primal_residual, rj.primal_residual),
                 (rt.dual_residual, rj.dual_residual)):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("condition", list(CONDITIONS))
@pytest.mark.parametrize("name", MODELS)
def test_program_equals_eager_loop_and_jax(name, condition):
    mt, ov, mu0 = _model(name, T)
    mj, _, _ = _model(name, J)
    kw = CONDITIONS[condition]
    bs = BatchedSolver(mt, device="cpu")
    program = _solve(bs, ov, mu0, True, **kw)
    assert len(bs._programs) == 1
    _assert_bitwise(program, _eager(mt, ov, mu0, **kw))
    _assert_bitwise(_solve(bs, ov, mu0, False, **kw), program)
    jkw = dict(dict(niter=NITER, interval_update_mu=INTERVAL, mu0=mu0), **kw)
    _assert_matches_jax(program, JaxBatched(mj).solve(ov, **jkw))
    if condition == "done0":
        assert program.iterations.tolist() == [NITER, 0, NITER]


@pytest.mark.parametrize("condition", list(CONDITIONS))
@pytest.mark.parametrize("name", MODELS)
def test_solve_equals_one_group_scan(name, condition):
    """``solve``'s one-group program against ``solve_scan`` of the same
    lanes as one group (the same entry, chunks and exit through the group
    program): bitwise.  The scan has no ``done0``: there the lanes that
    start done keep their initial state, count no iteration and stay done,
    and the others equal the scan's."""
    mt, ov, mu0 = _model(name, T)
    kw = dict(dict(niter=NITER, interval_update_mu=INTERVAL, mu0=mu0), **CONDITIONS[condition])
    done0 = kw.pop("done0", None)
    bs = BatchedSolver(mt, device="cpu")
    got = bs.solve(ov, done0=done0, **kw)
    scan = BatchedSolver(mt, device="cpu").solve_scan(
        ov, group_size=B, **dict(dict(record_residuals=True), **kw))
    if done0 is None:
        _assert_bitwise(got, scan)
        return
    live = torch.as_tensor(~done0)
    assert got.iterations[~live].tolist() == [0] and got.converged[~live].all()
    for a in got.x + got.h:
        assert not a[~live].any()
    for a, b in zip(got.x + got.h + (got.mu, got.iterations, got.converged, got.primal_residual,
                                     got.dual_residual),
                    scan.x + scan.h + (scan.mu, scan.iterations, scan.converged,
                                       scan.primal_residual, scan.dual_residual)):
        np.testing.assert_array_equal(a[live].numpy(), b[live].numpy())


def test_realified_spm_refactor_stays_kronecker():
    """The penalty's block structure is decided at the first refactor from
    the couplings (LaneOperators.block), not read from mu's values: the
    realified SpM factor of block 0 stays Kronecker."""
    mt, ov, mu0 = _model("realified_spm", T)
    bs = BatchedSolver(mt, device="cpu")
    factors = bs.plan.compute_factors(torch.full((B, 2), 0.3, dtype=torch.float64),
                                      batched=True)
    assert factors[0][0].kind == "kron" and factors[0][0].rest == 2
    for terms in bs.plan._mu_lanes[torch.device("cpu")]:
        assert all(op.kind != "diag" or op.block is not None for _, op in terms)


def test_buffers_keep_their_addresses_across_chunks_and_solves(monkeypatch):
    mt, ov, mu0 = _model("huber", T)
    bs = BatchedSolver(mt, device="cpu")
    seen = []
    chunk = batch._FedProgram._iterate

    def recording(self, n):
        chunk(self, n)
        fields = [t for k, name in self._fields for t in batch._leaves(
            getattr(self.functions[k], name))]
        seen.append([t.data_ptr() for t in self.x + self.h + self.tols + (
            self.mu, self.done, self.count, self.pbuf, self.dbuf, self.it, self.steps,
            self.failed, *fields)])

    monkeypatch.setattr(batch._FedProgram, "_iterate", recording)
    _solve(bs, ov, mu0, True, rtol=1e-7)
    ov2 = {k: v[::-1].copy() for k, v in ov.items()}
    _solve(bs, ov2, mu0, True, rtol=1e-9)
    assert len(bs._programs) == 1 and len(seen) == 2 * ((NITER - 1) // INTERVAL)
    assert all(ptrs == seen[0] for ptrs in seen)


@pytest.mark.parametrize("name", ["basis_pursuit", "huber", "tv"])
def test_cached_program_takes_new_inputs(name):
    """The stale-capture trap: a program made by one solve, reused with a
    new y, x0, mu0 and tolerance, equals a fresh eager solve of those."""
    mt, ov, mu0 = _model(name, T)
    bs = BatchedSolver(mt, device="cpu")
    first = _solve(bs, ov, mu0, True, rtol=1e-7)
    rng = np.random.RandomState(5)
    ov2 = {k: v + 0.3 * rng.randn(*v.shape) for k, v in ov.items()}
    mu2 = np.array([0.5, 2.0, 1.0]) * mu0
    warm = dict(x0=tuple(a * 0.5 for a in first.x), h0=first.h, rtol=1e-9)
    again = _solve(bs, ov2, mu2, True, **warm)
    assert len(bs._programs) == 1
    _assert_bitwise(again, _eager(mt, ov2, mu2, **warm))
    # the first result is a copy: the second solve left it alone
    _assert_bitwise(first, _eager(mt, ov, mu0, rtol=1e-7))


def test_program_cache_is_fifo_of_32():
    mt, ov, mu0 = _model("basis_pursuit", T)
    bs = BatchedSolver(mt, device="cpu")
    strides = range(1, 1 + batch.PROGRAM_CACHE_SIZE + 1)
    for n in strides:
        _solve(bs, ov, mu0, True, record_residuals=n, rtol=0.0)
    stride_of = lambda key: key[4]
    assert len(bs._programs) == batch.PROGRAM_CACHE_SIZE
    assert [stride_of(key) for key in bs._programs] == list(strides)[1:]
    # a hit does not reorder: the oldest is still dropped next
    _solve(bs, ov, mu0, True, record_residuals=2, rtol=0.0)
    _solve(bs, ov, mu0, True, record_residuals=40, rtol=0.0)
    assert [stride_of(key) for key in bs._programs] == list(strides)[2:] + [40]
    # tolerances are values of a program, not keys
    _solve(bs, ov, mu0, True, record_residuals=40, rtol=1e-3)
    _solve(bs, ov, mu0, True, record_residuals=40, rtol=1e-5)
    assert len([k for k in bs._programs if stride_of(k) == 40]) == 2   # can_finish: True/False


@pytest.mark.parametrize("record", [True, 3, False], ids=["histories", "strided", "none"])
def test_one_program_serves_every_niter(record):
    """niter is not part of the key: solves of other lengths reuse the
    program (a longer history takes new buffers) and equal the eager loop."""
    mt, ov, mu0 = _model("huber", T)
    bs = BatchedSolver(mt, device="cpu")
    for niter in (NITER, SHORT_NITER, 47, 12, NITER):
        kw = dict(niter=niter, record_residuals=record, rtol=1e-9)
        _assert_bitwise(_solve(bs, ov, mu0, True, **kw), _eager(mt, ov, mu0, **kw))
    assert len(bs._programs) == 1
    program = next(iter(bs._programs.values()))
    assert program.pbuf.shape[1] == {True: 47, 3: 16, False: 1}[record]


def test_failed_factorization_is_read_with_the_done_flags(monkeypatch):
    """Where lanes can finish, the failure flag of the chunk's
    factorizations comes in the same host read as the done flags."""
    mt, ov, mu0 = _model("huber", T)
    ov = dict(ov)
    ov[(0, "alpha")] = np.array([1e-6, -50.0, 1e-6])
    bs = BatchedSolver(mt, device="cpu")
    reads = []
    all_done = BatchedSolver._all_done

    def counting(self, done, failed=None):
        reads.append(failed is not None)
        return all_done(self, done, failed)

    monkeypatch.setattr(BatchedSolver, "_all_done", counting)
    with pytest.raises(torch.linalg.LinAlgError):
        _solve(bs, ov, mu0, True, rtol=1e-9)
    assert reads == [True]


def test_route_switches_are_part_of_the_key(monkeypatch):
    mt, ov, mu0 = _model("sdp_jacobi", T)
    bs = BatchedSolver(mt, device="cpu")
    _solve(bs, ov, mu0, True, rtol=0.0)
    monkeypatch.setattr(prox, "JACOBI_MAX_N", 2)
    _solve(bs, ov, mu0, True, rtol=0.0)
    assert len(bs._programs) == 2


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def test_route_capturability_table():
    """The declared table: the Jacobi kernel and the matrix sign are
    capturable, the library eigh and SVD are not."""
    assert prox.ROUTE_CAPTURABLE == {"jacobi": True, "sign": True, "eigh": False,
                                     "complex_eigh": False, "svd": False}
    f64, f32 = torch.float64, torch.float32
    assert prox.psd_route(8, f64, CUDA) == "jacobi"
    assert prox.psd_route(64, f64, CUDA) == "jacobi"
    assert prox.psd_route(128, f64, CUDA) == "sign"
    assert prox.psd_route(128, f64, CPU) == "eigh"
    assert prox.psd_route(48, f32, CUDA) == "sign"
    assert prox.psd_route(16, torch.complex128, CPU) == "jacobi"    # 32 x 32 embedding
    assert prox.psd_route(48, torch.complex128, CPU) == "complex_eigh"
    assert prox.psd_route(48, torch.complex128, CUDA) == "sign"


@pytest.mark.parametrize("objective,device,switches,want", [
    (T.L1Regularizer(0.1, 8), CUDA, {}, True),
    (T.LeastSquares(1.0, np.eye(4), np.ones(4)), CUDA, {}, True),
    (T.HuberLoss(1.0, np.ones(4)), CUDA, {}, True),
    (T.SemiPositiveDefinitePenalty((8, 8, 3), 2), CUDA, {}, True),               # Jacobi
    (T.SemiPositiveDefinitePenalty((128, 128, 1), 2), CUDA, {}, True),           # sign
    (T.SemiPositiveDefinitePenalty((128, 128, 1), 2), CUDA,
     {"USE_SIGN_ABOVE_JACOBI": False}, False),                                   # eigh
    (T.SemiPositiveDefinitePenalty((2, 8, 8), 0), CUDA, {"JACOBI_MAX_N": 4,
                                                         "USE_SIGN_ABOVE_JACOBI": False}, False),
    (T.NuclearNormPenalty(1.0, (32, 32)), CUDA, {}, True),                       # auto: Gram
    (T.NuclearNormPenalty(1.0, (96, 96)), CUDA, {}, True),                       # auto: sign
    (T.NuclearNormPenalty(1.0, (32, 32), svd_method="xla"), CUDA, {}, False),
    (T.NuclearNormPenalty(1.0, (300, 300), svd_method="gram"), CUDA, {}, False),  # Gram + eigh
    (T.NuclearNormPenalty(1.0, (300, 300), svd_method="sign"), CUDA, {}, True),
    (T.NuclearNormPenalty(1.0, (32, 32)), CPU, {}, False),                       # auto: SVD
], ids=["l1", "ls", "huber", "psd_jacobi", "psd_sign", "psd_eigh", "psd_axis0_eigh",
        "nuclear_gram", "nuclear_sign", "nuclear_xla", "nuclear_gram_eigh",
        "nuclear_sign_300", "nuclear_cpu"])
def test_objective_capturability(monkeypatch, objective, device, switches, want):
    for name, value in switches.items():
        monkeypatch.setattr(prox, name, value)
    assert objective.capturable(torch.float64, device) is want


def test_uncapturable_model_runs_the_eager_loop_on_the_card(monkeypatch):
    """On a CUDA device a model with a route a graph cannot hold runs its
    program's chunks directly; every other model replays captured graphs
    (and on the CPU no model does)."""
    rng = np.random.RandomState(2)
    Y = rng.randn(6, 5)
    bs = BatchedSolver(TA.rpca_model(Y, svd_method="xla"), device="cpu")
    functions = bs.model.functions
    assert not bs._programs.captures(functions, torch.float64)
    monkeypatch.setattr(bs._programs, "device", CUDA)
    assert not bs._programs.captures(functions, torch.float64)
    gram = BatchedSolver(TA.rpca_model(Y, svd_method="gram"), device="cpu")
    assert not gram._programs.captures(gram.model.functions, torch.float64)
    monkeypatch.setattr(gram._programs, "device", CUDA)
    assert gram._programs.captures(gram.model.functions, torch.float64)
    monkeypatch.setattr(batch, "CAPTURE_CHUNKS", False)
    assert not gram._programs.captures(gram.model.functions, torch.float64)


def test_deferred_cholesky_check():
    """A positive-definite batch gives bitwise the same inverse either way;
    one that is not raises either way: at once, or where the infos are
    read."""
    rng = np.random.RandomState(4)
    G = torch.as_tensor(rng.randn(3, 6, 6))
    pd = G @ G.mT + 0.5 * torch.eye(6, dtype=torch.float64)
    with deferred_cholesky_checks() as infos:
        deferred = inv_hpd(pd)
    assert len(infos) == 1
    raise_if_not_pd(any_not_pd(infos))
    assert torch.equal(deferred, inv_hpd(pd))
    bad = pd.clone()
    bad[1] = -bad[1]
    with pytest.raises(torch.linalg.LinAlgError):
        inv_hpd(bad)
    with deferred_cholesky_checks() as infos:
        inv_hpd(bad)
    with pytest.raises(torch.linalg.LinAlgError):
        raise_if_not_pd(any_not_pd(infos))


@pytest.mark.parametrize("capture", [True, False], ids=["program", "eager"])
def test_non_pd_dense_factor_raises_in_the_engine(capture):
    """Huber's per-lane ridge inverse, made not positive definite by a
    negative ridge in one lane, raises from the solve: through the program
    (its infos read after the last chunk) and through the eager loop (at
    once)."""
    mt, ov, mu0 = _model("huber", T)
    ov = dict(ov)
    ov[(0, "alpha")] = np.array([1e-6, -50.0, 1e-6])
    with pytest.raises(torch.linalg.LinAlgError):
        if capture:
            _solve(BatchedSolver(mt, device="cpu"), ov, mu0, True, rtol=0.0)
        else:
            _eager(mt, ov, mu0, rtol=0.0)


# ---------------------------------------------------------------------
# The host's reads of the done flags: the one schedule of every program
# ---------------------------------------------------------------------

# case -> (niter, interval_update_mu, tolerances for float64, for float32, done0)
READ_CASES = {
    "no_lane_can_finish": (41, 10, dict(rtol=0.0), dict(rtol=0.0), False),
    "done0": (41, 10, dict(rtol=0.0), dict(rtol=0.0), True),
    "lanes_can_finish": (41, 10, dict(rtol=1e-12), dict(rtol=1e-12), False),
    "one_chunk": (1, 10, dict(rtol=1e-12), dict(rtol=1e-12), True),
    "remainder": (45, 10, dict(rtol=1e-12), dict(rtol=1e-12), False),
    "early_finish": (400, 20, dict(rtol=1e-4), dict(rtol=1e-3), False),
}
# solver -> (state in float32, takes done0, reads after its first step,
#            factorizes: a read between steps takes the failure flag too)
READ_SOLVERS = {
    "SimpleOptimizer": (False, False, True, False),
    "BatchedSolver": (False, True, False, False),
    "FusedTwoBlockSolver": (True, True, True, False),
    "FusedSpMSolver": (True, True, True, True),
    "LargeNTwoBlockSolver": (False, False, True, False),
}


def _read_solves(name):
    """(port solve, JAX solve) of ``name``, each ``fn(niter, interval,
    **knobs)`` returning the most iterations any lane ran."""
    rng = np.random.RandomState(3)
    if name == "LargeNTwoBlockSolver":
        from admmsolver_tpu.parallel import make_mesh as jax_mesh
        from admmsolver_tpu.parallel.rowshard import LargeNTwoBlockSolver as JaxLargeN
        from admmsolver_tpu_torch.interop import large_n_from_jax
        from admmsolver_tpu_torch.parallel import make_mesh

        A = rng.randn(16, 64)
        y = A[:, :4] @ rng.randn(4)
        js = JaxLargeN(A, jax_mesh(axis_name="n"), prox="l1", alpha1=0.1)
        ts = large_n_from_jax(js, make_mesh(devices="cpu"))
        solve = lambda s: lambda niter, interval, **kw: int(
            s.solve(y, niter=niter, interval_update_mu=interval, **kw).iterations)
        return solve(ts), solve(js)
    if name == "FusedSpMSolver":
        from admmsolver_tpu.parallel import FusedSpMSolver as JaxFusedSpM
        from admmsolver_tpu_torch.parallel import FusedSpMSolver

        s, g, prj_sum, prj_w, _, _ = TA.synthetic_spm_data(nl=12, nw=25)
        ov = {(0, "y"): g[None] + 1e-4 * rng.randn(4, g.size)}
        models = {P: apps.spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
                  for P, apps in ((J, JA), (T, TA))}
        ts, js = FusedSpMSolver(models[T], device="cpu"), JaxFusedSpM(models[J], tile_b=4)
        kw0 = dict(mu0=0.1)
    else:
        N = 40
        A = rng.randn(12, N)
        xt = np.zeros((4, N))
        for b in range(4):
            xt[b, rng.choice(N, 3, replace=False)] = rng.randn(3)
        ov = {(0, "y"): xt @ A.T}
        models = {P: P.Model([P.LeastSquares(1.0, A, ov[(0, "y")][0]), P.L1Regularizer(0.1, N)],
                             [(1, 0, P.identity(N), P.identity(N))]) for P in (J, T)}
        kw0 = {}
        if name == "SimpleOptimizer":
            def solve(P):
                def run(niter, interval, **kw):
                    o = P.SimpleOptimizer(models[P], **({"device": "cpu"} if P is T else {}))
                    o.solve(niter, interval_update_mu=interval, **kw)
                    return o.iterations
                return run
            return solve(T), solve(J)
        if name == "BatchedSolver":
            ts, js = BatchedSolver(models[T], device="cpu"), JaxBatched(models[J])
        else:
            from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver as JaxFused
            from admmsolver_tpu_torch.parallel import FusedTwoBlockSolver

            ts = FusedTwoBlockSolver(models[T], tile_b=4, device="cpu")
            js = JaxFused(models[J], tile_b=4)
    solve = lambda s: lambda niter, interval, **kw: int(np.max(np.asarray(s.solve(
        ov, niter=niter, interval_update_mu=interval, **kw0, **kw).iterations)))
    return solve(ts), solve(js)


def _lengths(niter, interval):
    """The iterations of each step of a solve that runs to ``niter``:
    iteration 0, the full chunks, the remainder."""
    nfull, nrem = divmod(niter - 1, interval)
    return [1] + [interval] * nfull + ([nrem] if nrem else [])


def _chunk_keys(name, lengths, interval):
    """The keys of the steps of ``lengths`` (no penalty update after the
    remainder)."""
    update = lambda k, n: k == 0 or n == interval
    if name == "SimpleOptimizer":
        return [(n, update(k, n)) for k, n in enumerate(lengths)]
    if name == "BatchedSolver":
        return ["entry"] + lengths[1:]
    if name.startswith("Fused"):
        # the SpM program makes A†y of the lanes' data in its first step
        return [(n, update(k, n), k == 0 and name == "FusedSpMSolver")
                for k, n in enumerate(lengths)]
    return lengths


@pytest.mark.parametrize("name,case", [
    (name, case) for name, (_, done0, _, _) in READ_SOLVERS.items() for case in READ_CASES
    if done0 or not READ_CASES[case][4]])
def test_host_reads_of_the_done_flags(name, case, monkeypatch):
    """Every program's one schedule: the host reads the done flags only
    where a lane can finish, after a step that is not the last (not after a
    fed program's entry), and once for a caller's done0 (the fused solvers
    only where no such read follows); a solve stops at the first read that
    finds every lane done.  The steps run and the reads are pinned against
    the JAX package's iteration counts: the steps are the shortest prefix of
    the schedule that holds the slowest lane's iterations.  Where the
    program factorizes, each read between steps takes the failure flag."""
    f32, _, after_entry, factorizes = READ_SOLVERS[name]
    niter, interval, tols64, tols32, done0 = READ_CASES[case]
    kw = dict(tols32 if f32 else tols64)
    if done0:
        kw["done0"] = np.zeros(4, bool)
    port, jax = _read_solves(name)
    want_iters = jax(niter, interval, **kw)
    taken, flags_read = [], batch._flags_read

    def reading(done, failed=None, mesh=None):
        taken.append(failed is not None)
        return flags_read(done, failed, mesh)

    monkeypatch.setattr(batch, "_flags_read", reading)
    with telemetry.tracing():
        telemetry.reset()
        assert port(niter, interval, **kw) == want_iters
        snap = telemetry.snapshot()
    lengths = _lengths(niter, interval)
    keys = _chunk_keys(name, lengths, interval)
    ran = next(r for r in range(1, len(keys) + 1) if sum(lengths[:r]) >= want_iters)
    if not after_entry:
        ran = max(ran, min(2, len(keys)))   # a chunk follows the entry unread
    can_finish = kw["rtol"] > 0
    reads = sum(1 for k in range(ran) if can_finish and k + 1 < len(keys)
                and (k or after_entry))
    first = done0 and (name == "BatchedSolver" or not can_finish and len(keys) > 1)
    assert [r["attrs"]["key"] for r in snap["records"] if r["name"] == "admm.chunk"] \
        == keys[:ran]
    assert snap["counters"].get("flag_reads", 0) == len(taken) == reads + first
    assert taken == [False] * first + [factorizes] * reads
    if case == "early_finish":
        assert ran < len(keys)
    elif not can_finish:
        assert want_iters == niter
