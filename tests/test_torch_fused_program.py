"""The fused solvers' run programs (``parallel/fused._FusedProgram``) against
the JAX package's one-program solves (``FusedTwoBlockSolver._compiled_run``,
``FusedSpMSolver._compiled_solve``), on the CPU in float32.

On the CPU the program's chunk function runs directly (no graph): the same
buffers, the same device-side history row and penalty knobs, the same host
loop as a captured solve on a card.  The JAX chunk kernels run in interpret
mode.  Both sides get the same seeded numpy inputs; A is 20 x 60 (thin
basis, R = 20) with B = 8, SpM has nl = 12, nw = 25.

Tolerances are those of tests/test_torch_fused.py and
tests/test_torch_fused_spm.py: x and h within SHORT = 5e-4 absolute over 21
iterations or fewer and LONG = 1e-3 over longer horizons (f32 sums in
another order); penalties equal (two-block, up to 21 iterations) or within
1e-6 relative (SpM), else at most one residual-balancing step apart;
iteration counts, flags and the NaN rows of the histories equal; history
values within 1e-3 relative (two-block) or 2e-2 relative and SHORT absolute
(SpM).  A program reused by a solver is held bitwise to a fresh solver's
solve of the same inputs."""
import numpy as np
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import spm_model as jax_spm_model
from admmsolver_tpu.parallel import FusedSpMSolver as JaxFusedSpM
from admmsolver_tpu.parallel.fused import FusedTwoBlockSolver as JaxFused
from admmsolver_tpu_torch import interop
from admmsolver_tpu_torch.models.applications import synthetic_spm_data
from admmsolver_tpu_torch.models.realify import encode
from admmsolver_tpu_torch.parallel import FusedSpMSolver, FusedTwoBlockSolver, batch, fused

torch.set_num_threads(1)

SHORT, LONG = 5e-4, 1e-3
B = 8
KINDS = ["two_block", "spm"]


def _bp_data(seed=0, M=20, N=60, nb=B):
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    xt = np.zeros((nb, N))
    for b in range(nb):
        xt[b, rng.choice(N, 4, replace=False)] = rng.randn(4)
    return A, xt @ A.T + 0.01 * rng.randn(nb, M)


def _bp(P, A, y, alpha=0.1):
    N = A.shape[1]
    return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(alpha, N)],
                   [(1, 0, P.identity(N), P.identity(N))])


@pytest.fixture(scope="module")
def problems():
    """Per kind: the JAX model, the port's copy of it, B lanes of data and a
    second set of data (for a reused program), and the solve's defaults."""
    A, ys = _bp_data()
    _, ys2 = _bp_data(seed=1)
    jm = _bp(J, A, ys[0])
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    rng = np.random.RandomState(0)
    gs, gs2 = (g[None, :] + 1e-4 * rng.randn(B, g.size) for _ in range(2))
    sm = jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3)
    return {"two_block": (jm, interop.from_jax_model(jm, device="cpu"), ys, ys2, {}),
            "spm": (sm, interop.from_jax_model(sm, device="cpu"), gs, gs2, {"mu0": 0.1})}


def _solvers(problems, kind, tile_b=4):
    jm, tm, _, _, _ = problems[kind]
    if kind == "two_block":
        return JaxFused(jm, tile_b=tile_b), FusedTwoBlockSolver(tm, tile_b=tile_b, device="cpu")
    return JaxFusedSpM(jm, tile_b=tile_b), FusedSpMSolver(tm, device="cpu")


def _fields(r):
    """(x and h blocks, mu, iterations, converged, primal, dual) of either result."""
    if hasattr(r, "x0"):
        return [r.x0, r.x1, r.h], r.mu, r.iterations, r.converged, r.primal_residual, \
            r.dual_residual
    return list(r.x) + list(r.h), r.mu, r.iterations, r.converged, r.primal_residual, \
        r.dual_residual


def _same_as_jax(kind, rt, rj, atol, exact_mu=True):
    bt, mut, itt, ct, pt, dt = _fields(rt)
    bj, muj, itj, cj, pj, dj = (_fields(rj)[0], *map(np.asarray, _fields(rj)[1:]))
    for k, (a, b) in enumerate(zip(bt, bj)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol,
                                   err_msg=f"block {k}")
    if kind == "spm":
        np.testing.assert_allclose(mut.numpy(), muj, rtol=1e-6)
    elif exact_mu:
        np.testing.assert_array_equal(mut.numpy(), muj)
    else:
        ratio = mut.numpy() / muj
        assert np.all((ratio >= 0.49) & (ratio <= 2.01)), ratio
    np.testing.assert_array_equal(itt.numpy(), itj)
    np.testing.assert_array_equal(ct.numpy(), cj)
    for a, b in ((pt, pj), (dt, dj)):
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(b))
        if kind == "spm":
            np.testing.assert_allclose(a.numpy(), b, rtol=2e-2, atol=SHORT)
        else:
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-3, atol=1e-6)


def _bitwise(r1, r2):
    flat = lambda r: _fields(r)[0] + list(_fields(r)[1:])
    for a, b in zip(flat(r1), flat(r2)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("niter,interval", [(19, 5), (8, 3), (2, 5)])
def test_remainder_chunk_matches_jax(problems, kind, niter, interval):
    """niter - 1 not a multiple of the interval: the last chunk is a
    remainder without a penalty update (19 = 1 + 3x5 + 3; 8 = 1 + 2x3 + 1;
    2 = 1 + a remainder of 1)."""
    fj, ft = _solvers(problems, kind)
    _, _, ys, _, kw = problems[kind]
    kw = dict(kw, niter=niter, interval_update_mu=interval)
    rj = fj.solve({(0, "y"): ys}, **kw)
    rt = ft.solve({(0, "y"): ys}, **kw)
    _same_as_jax(kind, rt, rj, SHORT)
    assert int(rt.iterations.min()) == niter
    assert not torch.isnan(rt.primal_residual).any()


@pytest.mark.parametrize("kind", KINDS)
def test_early_exit_lanes_finish_in_different_chunks(problems, kind):
    """rtol > 0: lanes finish in different chunks, the schedule stops after
    the chunk in which the last one does, and the rows after it stay NaN."""
    fj, ft = _solvers(problems, kind)
    _, _, ys, _, kw = problems[kind]
    kw = dict(kw, niter=1001, interval_update_mu=20, rtol=1e-4)
    rj = fj.solve({(0, "y"): ys}, **kw)
    rt = ft.solve({(0, "y"): ys}, **kw)
    _same_as_jax(kind, rt, rj, LONG, exact_mu=False)
    assert bool(rt.converged.all())
    its = rt.iterations.numpy()
    assert len(set(its.tolist())) > 1 and its.max() < 1001
    last = (its.max() - 1) // 20   # the last chunk that ran
    assert not torch.isnan(rt.primal_residual[:, :last + 1]).any()
    assert torch.isnan(rt.primal_residual[:, last + 1:]).all()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rtol", [0.0, 1e-4])
def test_done0_lanes_never_iterate(problems, kind, rtol):
    """Lanes a caller marks done keep their state and count no iteration,
    with and without lanes that can finish."""
    fj, ft = _solvers(problems, kind)
    _, _, ys, _, kw = problems[kind]
    done0 = np.array([False, True, False, False, True, False, False, True])
    kw = dict(kw, niter=41, interval_update_mu=10, rtol=rtol, done0=done0)
    rj = fj.solve({(0, "y"): ys}, **kw)
    rt = ft.solve({(0, "y"): ys}, **kw)
    _same_as_jax(kind, rt, rj, LONG, exact_mu=False)
    assert not rt.iterations.numpy()[done0].any() and rt.converged.numpy()[done0].all()
    for blk in _fields(rt)[0]:
        assert not blk[torch.as_tensor(done0)].any()


def test_all_lanes_done0_runs_only_the_first_chunk(problems):
    """Every lane done at the start: the first chunk runs (its residual row
    is written, as in JAX), no other."""
    fj, ft = _solvers(problems, "two_block")
    _, _, ys, _, _ = problems["two_block"]
    kw = dict(niter=41, interval_update_mu=10, rtol=0.0, done0=np.ones(B, bool))
    rj = fj.solve({(0, "y"): ys}, **kw)
    rt = ft.solve({(0, "y"): ys}, **kw)
    _same_as_jax("two_block", rt, rj, SHORT)
    assert not torch.isnan(rt.primal_residual[:, 0]).any()
    assert torch.isnan(rt.primal_residual[:, 1:]).all()


def test_two_block_batch_not_a_tile_multiple(problems):
    """B = 6 with tile_b = 4: the program holds Bp = 8 lanes, the padding
    lanes start done and never iterate, and the result has 6."""
    fj, ft = _solvers(problems, "two_block")
    _, _, ys, _, _ = problems["two_block"]
    ov = {(0, "y"): ys[:6], (1, "alpha"): np.logspace(-2, 0, 6)}
    kw = dict(niter=33, interval_update_mu=10)
    rj = fj.solve(ov, **kw)
    rt = ft.solve(ov, **kw)
    assert tuple(rt.x0.shape) == (6, 60) and tuple(rt.primal_residual.shape) == (6, 5)
    _same_as_jax("two_block", rt, rj, LONG, exact_mu=False)
    (key, program), = ft._programs.items()
    assert key[1] == 8 and program.state[0].shape[0] == 8
    assert program.done[6:].all() and not program.state[-1][6:].any()


@pytest.mark.parametrize("kind", KINDS)
def test_cached_program_takes_new_inputs(problems, kind):
    """The stale-capture trap: a program made by one solve, reused with new
    data, per-lane alphas, tolerances and penalty knobs, equals a fresh
    solver's solve of those (bitwise) and the JAX package's."""
    fj, ft = _solvers(problems, kind)
    jm, tm, ys, ys2, kw = problems[kind]
    ft.solve({(0, "y"): ys, (1, "alpha"): np.full(B, 2e-3 if kind == "spm" else 0.1)},
             niter=81, interval_update_mu=20, rtol=1e-5, **kw)
    a1 = np.linspace(5e-4, 5e-3, B) if kind == "spm" else np.linspace(0.05, 0.2, B)
    ov = {(0, "y"): ys2, (1, "alpha"): a1}
    kw2 = dict(kw, niter=81, interval_update_mu=20, rtol=1e-4, fact_incr=3.0, max_mu=50.0)
    rt = ft.solve(ov, **kw2)
    assert len(ft._programs) == 1
    _bitwise(rt, _solvers(problems, kind)[1].solve(ov, **kw2))
    _same_as_jax(kind, rt, fj.solve(ov, **kw2), LONG, exact_mu=False)


@pytest.mark.parametrize("kind", KINDS)
def test_longer_niter_after_shorter_on_one_solver(problems, kind):
    """A longer history than the program holds takes new buffers: the
    longer solve equals a fresh solver's and the JAX package's; the program
    (keyed without niter) is the same one."""
    fj, ft = _solvers(problems, kind)
    _, _, ys, _, kw = problems[kind]
    kw = dict(kw, interval_update_mu=10)
    short = ft.solve({(0, "y"): ys}, niter=21, **kw)
    program = next(iter(ft._programs.values()))
    assert program.pbuf.shape[0] == 3
    rt = ft.solve({(0, "y"): ys}, niter=61, **kw)
    assert list(ft._programs.values()) == [program] and program.pbuf.shape[0] == 7
    assert tuple(rt.primal_residual.shape) == (B, 7)
    assert tuple(short.primal_residual.shape) == (B, 3)
    _bitwise(rt, _solvers(problems, kind)[1].solve({(0, "y"): ys}, niter=61, **kw))
    _same_as_jax(kind, rt, fj.solve({(0, "y"): ys}, niter=61, **kw), LONG, exact_mu=False)
    # and a shorter one again keeps the longer buffers
    again = ft.solve({(0, "y"): ys}, niter=21, **kw)
    _bitwise(again, short)


@pytest.mark.parametrize("block1", ["l1", "nonneg"])
def test_realified_even_modes_match_jax(block1):
    """A complex basis-pursuit model realified: the kernel's ``_even`` prox
    modes through the program, with a remainder chunk and lanes that can
    finish."""
    rng = np.random.RandomState(3)
    M, N = 10, 30
    A = rng.randn(M, N) + 1j * rng.randn(M, N)
    xt = np.zeros((B, N), complex)
    for b in range(B):
        xt[b, rng.choice(N, 3, replace=False)] = rng.randn(3) + 1j * rng.randn(3)
    ys = xt @ A.T

    def mk(P):
        return P.Model([P.LeastSquares(1.0, A, ys[0]),
                        P.L1Regularizer(0.05, N) if block1 == "l1" else P.NonNegativePenalty(N)],
                       [(1, 0, P.identity(N), P.identity(N))])

    ft = FusedTwoBlockSolver(T.realify_model(mk(T)).model, tile_b=4, device="cpu")
    fj = JaxFused(J.realify_model(mk(J)).model, tile_b=4)
    assert ft.prox == fj.prox == block1 + "_even"
    ov = {(0, "y"): encode(ys).numpy()}
    for kw, atol in ((dict(niter=17, interval_update_mu=5), SHORT),
                     (dict(niter=303, interval_update_mu=20, rtol=1e-4), LONG)):
        rt = ft.solve(ov, **kw)
        _same_as_jax("two_block", rt, fj.solve(ov, **kw), atol, exact_mu=atol == SHORT)
        assert np.all(rt.x1.numpy()[:, 1::2] == 0)


@pytest.mark.parametrize("rtol", [0.0, 1e-4])
def test_spm_factor_not_positive_definite_raises(problems, rtol):
    """A lane whose penalty matrix is not positive definite still raises
    torch's LinAlgError: read after the solve where no lane can finish, in
    the done flags' read where one can."""
    _, tm, gs, _, _ = problems["spm"]
    ft = FusedSpMSolver(tm, device="cpu")
    alpha = np.ones(B)
    alpha[3] = -1e4
    with pytest.raises(torch.linalg.LinAlgError):
        ft.solve({(0, "y"): gs, (0, "alpha"): alpha}, niter=41, interval_update_mu=10,
                 mu0=0.1, rtol=rtol)
    # the program's next solve starts clean
    ok = ft.solve({(0, "y"): gs}, niter=41, interval_update_mu=10, mu0=0.1, rtol=rtol)
    _bitwise(ok, FusedSpMSolver(tm, device="cpu").solve(
        {(0, "y"): gs}, niter=41, interval_update_mu=10, mu0=0.1, rtol=rtol))


@pytest.mark.parametrize("kind", KINDS)
def test_buffers_keep_their_addresses_across_chunks_and_solves(problems, kind, monkeypatch):
    _, ft = _solvers(problems, kind)
    _, _, ys, ys2, kw = problems[kind]
    seen = []
    chunk = fused._FusedProgram._chunk

    def recording(self, key):
        chunk(self, key)
        seen.append([t.data_ptr() for t in self.buffers() + (self.knobs, self.row, self.failed)])

    monkeypatch.setattr(fused._FusedProgram, "_chunk", recording)
    ft.solve({(0, "y"): ys}, niter=31, interval_update_mu=10, rtol=1e-9, **kw)
    ft.solve({(0, "y"): ys2}, niter=31, interval_update_mu=10, rtol=1e-7, **kw)
    assert len(ft._programs) == 1 and len(seen) == 8
    assert all(ptrs == seen[0] for ptrs in seen)


@pytest.mark.parametrize("kind", KINDS)
def test_program_cache_is_keyed_and_bounded(problems, kind, monkeypatch):
    """Keyed like the JAX ``_run_cache`` without niter (interval, batch,
    data or not, device, whether a lane can finish); at most
    PROGRAM_CACHE_SIZE programs, the oldest dropped first."""
    monkeypatch.setattr(batch, "PROGRAM_CACHE_SIZE", 3)
    _, ft = _solvers(problems, kind)
    _, _, ys, _, kw = problems[kind]
    for interval in (2, 3, 4, 5):
        ft.solve({(0, "y"): ys}, niter=7, interval_update_mu=interval, **kw)
    assert [key[0] for key in ft._programs] == [3, 4, 5]
    ft.solve({(0, "y"): ys}, niter=9, interval_update_mu=5, **kw)
    ft.solve({(0, "y"): ys}, niter=9, interval_update_mu=5, rtol=0.0, **kw)
    assert [key[0] for key in ft._programs] == [4, 5, 5]
    assert [key[-2] for key in ft._programs][1:] == [True, False]
    if kind == "spm":
        ft.solve(batch_size=B, niter=9, interval_update_mu=5, rtol=0.0, **kw)
        assert list(ft._programs)[-1][2] is False


@pytest.mark.parametrize("kind", KINDS)
def test_niter_must_be_positive(problems, kind):
    _, ft = _solvers(problems, kind)
    _, _, ys, _, kw = problems[kind]
    with pytest.raises(ValueError, match="niter"):
        ft.solve({(0, "y"): ys}, niter=0, **kw)
