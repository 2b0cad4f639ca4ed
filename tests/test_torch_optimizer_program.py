"""``SimpleOptimizer``'s run program on the CPU (no graph: each chunk runs
directly), against the JAX package's one jitted solve
(``SimpleOptimizer._compiled_run``) and against a plain per-iteration loop.

The plain loop (:func:`_plain_solve`) is the engine's solve before its run
program: the schedule as Python steps, a refactor whenever the penalty
changes and a host read of the convergence flag every iteration; kept here
as the reference the program must equal bitwise (x, the x before the last
iteration, h, mu, the count and both histories).  Against the JAX package,
in float64, on basis pursuit (A 10x20 and 20x60) and the 3-block SpM model
(nl = 10, nw = 21): x, h, mu, ``x_old`` and the histories to 1e-12, equal
iteration counts, under a full chunk of 100 and an interval of 7, a solve
that converges inside a chunk, rtol = atol = 0, no histories, two solves in
a row, a callback, a complex model (complex128) and a float32 state (x to 1e-5
of max|x|, histories of float32 values to 1e-4 of the first residual).  Then a factorization that
fails raises ``LinAlgError``, the program cache (one program a key, at most
32, the oldest dropped first), and a warm program's chunks neither read a
value on the host nor copy a tensor made there (what a captured chunk
cannot hold: the card's capture would raise), for every family.
"""
import contextlib

import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models import applications as JA
from admmsolver_tpu_torch import optimizer
from admmsolver_tpu_torch.models import applications as TA
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

torch.set_num_threads(1)

TOL = 1e-12


def _bp(P, M=20, N=60, seed=1234):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros(N)
    xt[rng.choice(N, 5, replace=False)] = rng.randn(5)
    return P.Model([P.LeastSquares(1.0, A, A @ xt), P.L1Regularizer(0.1, N)],
                   [(1, 0, P.identity(N), P.identity(N))])


def _spm(P):
    s, g, prj_sum, prj_w, _, _ = TA.synthetic_spm_data(nl=10, nw=21)
    return (JA if P is J else TA).spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)


def _complex_bp(P):
    rng = np.random.RandomState(3)
    A = rng.randn(10, 20) + 1j * rng.randn(10, 20)
    xt = np.zeros(20, complex)
    xt[[2, 7]] = [1 + 1j, -2]
    return P.Model([P.LeastSquares(1.0, A, A @ xt), P.L1Regularizer(0.05, 20)],
                   [(1, 0, P.identity(20), P.identity(20))])


def _diag(P):
    rng = np.random.RandomState(5)
    A = rng.randn(12, 20)
    d = rng.uniform(0.5, 2.0, 20)
    return P.Model([P.LeastSquares(1.0, A, rng.randn(12)), P.L1Regularizer(0.1, 20)],
                   [(1, 0, P.identity(20), P.DiagonalMatrix(d))])


MODELS = {"bp": (_bp, 1.0), "spm": (_spm, 0.1), "complex": (_complex_bp, 1.0),
          "diag": (_diag, 1.0)}

# (niter, solve keywords): a full chunk of 100 and a remainder, an interval
# of 7, a solve that stops inside a chunk (bp at 277, SpM at 147), no
# tolerance, no histories
CASES = {
    "chunk_100": (250, dict(interval_update_mu=100)),
    "interval_7": (250, dict(interval_update_mu=7, rtol=0.0)),
    "converges_mid_chunk": (600, dict(interval_update_mu=20, rtol=1e-6)),
    "rtol_atol_zero": (120, dict(interval_update_mu=50, rtol=0.0, atol=0.0)),
    "no_record": (150, dict(interval_update_mu=30, record_residuals=False)),
}


def _pair(kind, **kw):
    make, mu = MODELS[kind]
    return (J.SimpleOptimizer(make(J), mu=mu, **kw),
            T.SimpleOptimizer(make(T), mu=mu, device="cpu", **kw))


def _assert_matches_jax(ot, oj, tol=TOL):
    for a, b in zip(ot.x + ot.h + list(ot._x_old), oj.x + oj.h + list(oj._x_old)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=tol)
    np.testing.assert_array_equal(ot.mu.numpy(), np.asarray(oj.mu))
    assert ot.iterations == oj.iterations
    for mine, theirs in ((ot.primal_residual_history, oj.primal_residual_history),
                         (ot.dual_residual_history, oj.dual_residual_history)):
        assert len(mine) == len(theirs)
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=tol)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["bp", "spm"])
def test_program_matches_jax(kind, case):
    niter, kw = CASES[case]
    oj, ot = _pair(kind)
    oj.solve(niter, **kw)
    ot.solve(niter, **kw)
    _assert_matches_jax(ot, oj)
    if case == "converges_mid_chunk":
        assert ot.iterations < niter and (ot.iterations - 1) % 20
    if case == "no_record":
        assert ot.iterations == 0


def _plain_solve(opt, niter, interval_update_mu=100, rtol=1e-12, atol=0.0):
    """The solve as plain per-iteration steps from ``opt``'s state: x, the x
    before the last iteration, h, mu, the count and both histories."""
    plan = opt._plan
    x, h, mu = opt._x, opt._h, opt._mu
    pbuf, dbuf = [], []
    factors = plan.compute_factors(mu)
    x_old = x
    for it in range(niter):
        x_new, h_new, prods = plan.sweep(x, h, mu, factors, True)
        pn, dn, convs = plan.pair_residuals(x_new, x, mu, prods)
        primal, dual = sum(pn[1:], pn[0]), sum(dn[1:], dn[0])
        conv = torch.stack([(rp < rtol) & (rd < rtol) for rp, rd in convs]).all()
        conv = conv | ((primal < atol) & (dual < atol))
        pbuf.append(primal)
        dbuf.append(dual)
        x_old, x, h = x, x_new, h_new
        if bool(conv):
            break
        if it % interval_update_mu == 0:
            mu_new = plan.updated_mu(mu, pn, dn, 2.0, 10.0, opt._max_mu)
            if not torch.equal(mu_new, mu):
                factors = plan.compute_factors(mu_new)
            mu = mu_new
    return x + x_old + h + (mu, torch.tensor(len(pbuf)), torch.stack(pbuf), torch.stack(dbuf))


@pytest.mark.parametrize("case", ["chunk_100", "converges_mid_chunk"])
@pytest.mark.parametrize("kind", sorted(MODELS))
def test_program_equals_the_plain_loop_bitwise(kind, case):
    niter, kw = CASES[case]
    make, mu = MODELS[kind]
    ot = T.SimpleOptimizer(make(T), mu=mu, device="cpu")
    want = _plain_solve(ot, niter, **kw)
    ot.solve(niter, **kw)
    got = tuple(ot.x) + ot._x_old + tuple(ot.h) + (
        ot.mu, torch.tensor(ot.iterations),
        torch.tensor(ot.primal_residual_history, dtype=torch.float64),
        torch.tensor(ot.dual_residual_history, dtype=torch.float64))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("record", [False, True])
def test_callback_records_every_iteration_as_jax(record):
    """A solve with a callback records one history row an iteration, also
    with ``record_residuals=False`` (JAX ``optimizer.py:609-617``)."""
    oj = J.SimpleOptimizer(_bp(J, M=10, N=20))
    ot = T.SimpleOptimizer(_bp(T, M=10, N=20), device="cpu")
    seen = []
    oj.solve(5, callback=lambda: None, record_residuals=record)
    ot.solve(5, callback=lambda: seen.append(ot.x[0].clone()), record_residuals=record)
    assert len(ot.primal_residual_history) == len(oj.primal_residual_history) == 5
    assert len(seen) == 5 and not torch.equal(seen[0], seen[-1])
    _assert_matches_jax(ot, oj)


def test_callback_stops_at_the_converging_iteration_as_jax():
    oj, ot = _pair("spm")
    calls = []
    oj.solve(600, callback=lambda: None, interval_update_mu=20, rtol=1e-6)
    ot.solve(600, callback=lambda: calls.append(1), interval_update_mu=20, rtol=1e-6)
    assert len(calls) == ot.iterations < 600
    _assert_matches_jax(ot, oj)


@pytest.mark.parametrize("kind", ["bp", "spm"])
def test_two_solves_in_a_row_match_jax(kind):
    """The second solve starts its penalty schedule at 0 again and reuses
    the first's program where the key is the same."""
    oj, ot = _pair(kind)
    for niter, kw in ((130, dict(interval_update_mu=20)), (130, dict(interval_update_mu=20)),
                      (40, {})):
        oj.solve(niter, **kw)
        ot.solve(niter, **kw)
        _assert_matches_jax(ot, oj)
    assert len(ot._plan._run_cache) == 2


def test_float32_state_matches_jax_with_float32_histories():
    oj = J.SimpleOptimizer(_bp(J), dtype=np.float32)
    oj.solve(200, interval_update_mu=20)
    ot = T.SimpleOptimizer(_bp(T), dtype=torch.float32, device="cpu")
    ot.solve(200, interval_update_mu=20)
    assert ot.x[0].dtype == torch.float32 and ot.mu.dtype == torch.float32
    scale = float(np.abs(np.asarray(oj.x[0])).max())
    for a, b in zip(ot.x, oj.x):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5 * scale)
    np.testing.assert_array_equal(ot.mu.numpy(), np.asarray(oj.mu))
    assert ot.iterations == oj.iterations == 200
    hist = np.array(ot.primal_residual_history)
    np.testing.assert_array_equal(hist.astype(np.float32).astype(np.float64), hist)
    # late residuals are differences of O(1) values summed in another order
    np.testing.assert_allclose(hist, oj.primal_residual_history, rtol=0, atol=1e-4 * hist[0])


def test_complex_model_matches_jax():
    oj, ot = _pair("complex")
    oj.solve(600, interval_update_mu=20, rtol=1e-6)
    ot.solve(600, interval_update_mu=20, rtol=1e-6)
    assert ot.x[0].dtype == torch.complex128 and ot.mu.dtype == torch.float64
    assert ot.iterations < 600
    _assert_matches_jax(ot, oj)


def test_model_without_pairs_stops_after_one_iteration_as_jax():
    rng = np.random.RandomState(4)
    A, y = rng.randn(30, 10), rng.randn(30)
    oj = J.SimpleOptimizer(J.Model([J.LeastSquares(1.0, A, y)]))
    ot = T.SimpleOptimizer(T.Model([T.LeastSquares(1.0, A, y)]), device="cpu")
    oj.solve(50, rtol=0.0)
    ot.solve(50, rtol=0.0)
    assert ot.iterations == oj.iterations == 1
    _assert_matches_jax(ot, oj)


def _not_pd():
    rng = np.random.RandomState(6)
    A = rng.randn(12, 20)
    return T.Model([T.LeastSquares(-10.0, A, rng.randn(12)), T.L1Regularizer(0.1, 20)],
                   [(1, 0, T.identity(20), T.DiagonalMatrix(rng.uniform(0.5, 2.0, 20)))])


@pytest.mark.parametrize("how", ["rtol_zero", "rtol", "callback"])
def test_factorization_that_fails_raises(how):
    """The program's Cholesky infos stay on the device; a penalty matrix
    that is not positive definite still raises LinAlgError, and the state
    stays as it was."""
    opt = T.SimpleOptimizer(_not_pd(), device="cpu")
    kw = {"rtol_zero": dict(rtol=0.0), "rtol": dict(rtol=1e-6),
          "callback": dict(callback=lambda: None)}[how]
    x0 = opt.x[0].clone()
    with pytest.raises(torch.linalg.LinAlgError):
        opt.solve(30, interval_update_mu=10, **kw)
    assert torch.equal(opt.x[0], x0) and opt.iterations == 0


def test_program_cache_reuses_and_drops_the_oldest():
    """One program a key (cfg, record): another tolerance and another
    starting state take the same program and equal a fresh optimizer's
    solve from that state; the 33rd key drops the oldest."""
    opt = T.SimpleOptimizer(_bp(T, M=10, N=20), device="cpu")
    opt.solve(30, interval_update_mu=10, rtol=1e-3)
    cache = opt._plan._run_cache
    (program,) = cache.values()
    x0, h0, mu0 = [t.clone() for t in opt.x], tuple(t.clone() for t in opt.h), opt.mu.clone()
    opt.solve(30, interval_update_mu=10, rtol=1e-9)
    assert list(cache.values()) == [program]
    fresh = T.SimpleOptimizer(_bp(T, M=10, N=20), x0=x0, device="cpu")
    fresh._h, fresh._mu = h0, mu0
    fresh.solve(30, interval_update_mu=10, rtol=1e-9)
    for a, b in zip(opt.x + opt.h + [opt.mu], fresh.x + fresh.h + [fresh.mu]):
        assert torch.equal(a, b)
    for niter in range(31, 63):
        opt.solve(niter, rtol=0.0)
    assert len(cache) == 32 and program not in cache.values()
    assert [key[0].niter for key in cache] == list(range(31, 63))


NO_READS = ("__bool__", "item", "tolist", "__float__", "__int__", "__index__", "numpy")
# the functions that make a tensor on the host unless given a device
FACTORIES = {"tensor", "as_tensor", "asarray", "from_numpy", "arange", "zeros", "ones",
             "full", "empty", "eye", "linspace"}
# what returns a Python value without reading a tensor's values
METADATA = {"__get__", "size", "dim", "numel", "stride", "element_size", "is_contiguous",
            "is_complex", "is_floating_point", "data_ptr", "storage_offset", "__len__",
            "ndimension", "nelement", "get_device", "__hash__", "__eq__", "__repr__",
            "__format__"}
# functions whose output shape or checks depend on values: a read on the card
SYNCING = {"nonzero", "argwhere", "unique", "unique_consecutive", "masked_select",
           "linalg_cholesky", "linalg_inv", "linalg_solve", "linalg_eigh", "linalg_eigvalsh",
           "linalg_svd", "linalg_svdvals", "linalg_lstsq"}


class _HostGuard(TorchFunctionMode):
    """Refuses what a captured chunk cannot hold: a function that returns a
    tensor's value as a Python value, one whose shape or checks depend on
    values, an index by a mask, a Python number set into one element (the
    card copies it from the host), and a tensor a factory made without a
    device that is moved, copied, or (of more than one entry) reaches any
    other function (a 0-d one may stand beside device tensors as a
    scalar)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", repr(func))
        leaves = tree_flatten((args, kwargs))[0]
        for t in leaves:
            if isinstance(t, torch.Tensor) and getattr(t, "_host_made", False) and (
                    t.ndim or name in ("to", "cuda", "copy_")):
                raise AssertionError(f"a tensor made on the host reaches {name} inside a chunk")
            if name in ("__getitem__", "__setitem__") and isinstance(t, torch.Tensor) \
                    and t is not args[0] and t.dtype == torch.bool:
                raise AssertionError(f"{name} by a mask inside a chunk")
        if name in SYNCING:
            raise AssertionError(f"{name} reads values on the host inside a chunk")
        if name == "__setitem__" and isinstance(args[2], (bool, int, float, complex)):
            with torch.overrides._disable_current_modes():
                if args[0][args[1]].ndim == 0:
                    raise AssertionError("a Python number set into one element inside a chunk")
        out = func(*args, **kwargs)
        if isinstance(out, (bool, int, float, complex)) and name not in METADATA:
            raise AssertionError(f"{name} returned a value to the host inside a chunk")
        if name in FACTORIES and kwargs.get("device") is None and isinstance(out, torch.Tensor):
            out._host_made = True
        return out


@contextlib.contextmanager
def _nothing_from_the_host():
    """Inside, a read of a tensor's value on the host raises, and so does
    anything else :class:`_HostGuard` refuses."""
    saved = {name: getattr(torch.Tensor, name) for name in NO_READS}

    def refuse(name):
        def read(self, *args, **kwargs):
            raise AssertionError(f"Tensor.{name} read a value on the host inside a chunk")
        return read

    try:
        for name in NO_READS:
            setattr(torch.Tensor, name, refuse(name))
        with _HostGuard():
            yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _family(name):
    rng = np.random.RandomState(9)
    if name == "cov":
        Q = rng.randn(12, 12)
        return TA.covariance_denoise_model(Q @ Q.T / 12)
    if name == "sdp":
        return TA.sdp_model(rng.randn(24, 48), rng.randn(24), (4, 4, 3), axis=2)
    if name == "rpca":
        return TA.rpca_model(rng.randn(16, 2) @ rng.randn(2, 16), svd_method="sign")
    if name == "group":
        return TA.group_lasso_model(rng.randn(16, 32), rng.randn(16), 0.1, 4)
    if name == "huber":
        return TA.robust_regression_model(rng.randn(20, 8), rng.randn(20), delta=0.1)
    if name == "tv":
        return TA.tv_denoise_model(np.repeat(rng.randn(4), 50) + 0.2 * rng.randn(200), 0.4)
    if name == "box":
        return TA.bounded_lsq_model(rng.randn(16, 8), rng.randn(16))
    if name == "realified":
        return T.realify_model(_complex_bp(T)).model
    if name == "realified_spm":
        s, g, prj_sum, prj_w, _, _ = TA.synthetic_spm_data(nl=8, nw=15)
        g = g + 1e-3j * rng.randn(g.size)
        return T.realify_model(TA.spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)).model
    return MODELS[name][0](T)


@pytest.mark.parametrize("name", ["bp", "spm", "complex", "diag", "cov", "sdp", "rpca",
                                  "group", "huber", "tv", "box", "realified",
                                  "realified_spm"])
def test_warm_chunks_take_nothing_from_the_host(name, monkeypatch):
    """Once the program is warm (its first chunk ran), no chunk reads a
    tensor's value on the host or copies one made there: what a captured
    chunk cannot hold."""
    chunk = optimizer._RunProgram._chunk
    strict = []

    def checked(self, key):
        if not self.graphs.warm:
            return chunk(self, key)
        strict.append(key)
        with _nothing_from_the_host():
            return chunk(self, key)

    monkeypatch.setattr(optimizer._RunProgram, "_chunk", checked)
    opt = T.SimpleOptimizer(_family(name), device="cpu")
    opt.solve(25, interval_update_mu=10, rtol=0.0)
    assert strict == [(10, True), (10, True), (4, False)]
    assert all(np.isfinite(x.numpy()).all() for x in opt.x)
