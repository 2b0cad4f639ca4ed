"""The SpM factor refresh (``ops.kernels.spm_factor_refresh``) on the CPU.

* its plain version equals the solver's former ``_factors`` bit for bit, with
  and without a sum rule;
* the route rule: the plain version on the CPU; on a card float32 only, the
  warp kernel at nl <= 32, nc <= 4 and the block kernel at any other shape;
* a CPU solve launches no kernel and still matches the JAX package;
* a numpy model of the kernel's arithmetic (``csrc/spm_factor_refresh.cu``:
  the symmetric sweep, one thread a column, then the sum-rule fold), op for
  op in float32 with fused multiply-adds (1/sqrt and 1/p correctly rounded:
  the kernel's MUFU.RSQ and its Newton step are within an ulp of them),
  against the plain version, and its not-positive-definite infos against
  ``cholesky_ex``'s.  Change it with the kernel.  The kernel itself is held to the plain version on a card in
  tests/test_torch_gpu.py."""
import numpy as np
import pytest
import torch

import admmsolver_tpu_torch as T
from admmsolver_tpu.models.applications import spm_model as jax_spm_model
from admmsolver_tpu.parallel import FusedSpMSolver as JaxFusedSpM
from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu_torch.models.objectivefunc import inv_hpd
from admmsolver_tpu_torch.ops import kernels
from admmsolver_tpu_torch.ops.kernels import spm_factor_refresh, spm_factor_refresh_reference
from admmsolver_tpu_torch.parallel import FusedSpMSolver

torch.set_num_threads(1)

F32 = np.float32


def _solver(kind, nl=12, nw=25):
    """A CPU FusedSpMSolver whose block 0 is a plain LeastSquares ("ls") or
    a ConstrainedLeastSquares with the sum rule ("cls1") or the sum rule and
    a second row ("cls2")."""
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=nl, nw=nw)
    A = T.DiagonalMatrix(-s)
    if kind == "ls":
        f0 = T.LeastSquares(1.0, A, g)
    else:
        C = np.asarray(prj_sum).reshape(1, nl)
        D = np.array([1.0])
        if kind == "cls2":
            C = np.vstack([C, np.linspace(-1.0, 1.0, nl)])
            D = np.array([1.0, 0.3])
        f0 = T.ConstrainedLeastSquares(1.0, A, g, C, D)
    model = T.Model([f0, T.L1Regularizer(1e-3, nl), T.NonNegativePenalty(nw)],
                    [(0, 1, T.identity(nl), T.identity(nl)), (0, 2, prj_w, T.identity(nw))])
    return FusedSpMSolver(model, device="cpu"), g


def _lanes(solver, g, B=9, seed=3):
    """(mu1, mu2, alpha, acy) of B lanes: penalties log-uniform in
    [1e-3, 1e3], alphas in [0.5, 2], A†y of noisy data."""
    rng = np.random.RandomState(seed)
    f32 = dict(dtype=torch.float32)
    mu = torch.as_tensor(10.0 ** rng.uniform(-3, 3, (B, 2)), **f32)
    alpha = torch.as_tensor(rng.uniform(0.5, 2.0, B), **f32)
    ys = torch.as_tensor(g[None] + 1e-4 * rng.randn(B, g.size), **f32)
    return mu[:, 0], mu[:, 1], alpha, ys @ solver.Ac.T


def _old_factors(solver, mu1, mu2, alpha_ls, acy):
    """``FusedSpMSolver._factors`` as it was before the refresh kernel."""
    eye = torch.eye(solver.nl, dtype=torch.float32)
    Mpen = (alpha_ls[:, None, None] * solver.AcA
            + mu1[:, None, None] * eye
            + mu2[:, None, None] * solver.W)
    M = inv_hpd(Mpen)
    b2 = None
    if solver.is_cls:
        Bf = M
        xi2 = -(Bf @ solver.C.T)
        Sinv = -inv_hpd(-(solver.C @ xi2))
        M = Bf - xi2 @ (Sinv @ (solver.C @ Bf))
        b2 = (xi2 @ (Sinv @ solver.D)[:, :, None])[:, :, 0]
    aMy = alpha_ls[:, None] * (M @ acy[:, :, None])[:, :, 0]
    return M.contiguous(), (aMy if b2 is None else aMy + b2).contiguous()


def _shared(solver):
    return (solver.AcA, solver.W) + ((solver.C, solver.D) if solver.is_cls else (None, None))


@pytest.mark.parametrize("kind", ["ls", "cls1", "cls2"])
def test_plain_version_equals_the_old_factors(kind):
    """The plain version, and the solver's ``_factors`` through the wrapper
    on the CPU, give the former refresh's bits."""
    solver, g = _solver(kind)
    lanes = _lanes(solver, g)
    want = _old_factors(solver, *lanes)
    mu1, mu2, alpha, acy = lanes
    for got in (spm_factor_refresh_reference(*_shared(solver), alpha, mu1, mu2, acy),
                solver._factors(*lanes)):
        for a, b in zip(got, want):
            assert a.dtype == torch.float32 and a.is_contiguous()
            assert torch.equal(a, b)


@pytest.mark.parametrize("device,dtype,nl,nc,route", [
    ("cuda", torch.float32, 30, 1, "warp"),
    ("cuda", torch.float32, 32, 4, "warp"),
    ("cuda", torch.float32, 1, 0, "warp"),
    ("cuda", torch.float32, 33, 1, "block"),
    ("cuda", torch.float32, 30, 5, "block"),
    ("cuda", torch.float32, 200, 0, "block"),
    ("cpu", torch.float32, 30, 1, "plain"),
    ("cpu", torch.float32, 64, 8, "plain"),
    ("cpu", torch.float64, 12, 0, "plain"),
])
def test_route_rule(device, dtype, nl, nc, route):
    """The plain version on the CPU only; on the card a kernel at every
    shape."""
    assert kernels._refresh_route(torch.device(device), dtype, nl, nc) == route


@pytest.mark.parametrize("device,dtype,error", [
    ("cuda", torch.float64, TypeError),
    ("cuda", torch.float16, TypeError),
    ("meta", torch.float32, ValueError),
])
def test_route_rule_refuses(device, dtype, error):
    """Another dtype on the card, or another device, raises: no library
    fallback."""
    with pytest.raises(error):
        kernels._refresh_route(torch.device(device), dtype, 30, 1)


def test_cpu_solve_launches_no_refresh_kernel_and_matches_jax():
    """A CPU solve counts no launch on either route and matches the JAX
    package's FusedSpMSolver as before (tests/test_torch_fused_spm.py's
    problem, three full chunks and a remainder)."""
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=12, nw=25)
    gs = g[None, :] + 1e-4 * np.random.RandomState(0).randn(6, g.size)
    counters = (spm_factor_refresh, *spm_factor_refresh.routes.values())
    before = [c.launches for c in counters]
    kw = dict(niter=21, mu0=0.1, interval_update_mu=5)
    rt = FusedSpMSolver(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), device="cpu").solve(
        {(0, "y"): gs}, **kw)
    assert [c.launches for c in counters] == before
    rj = JaxFusedSpM(jax_spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), tile_b=2).solve(
        {(0, "y"): gs}, **kw)
    for k in range(3):
        np.testing.assert_allclose(rt.x[k].numpy(), np.asarray(rj.x[k]), rtol=0, atol=5e-4)
    np.testing.assert_allclose(rt.mu.numpy(), np.asarray(rj.mu), rtol=1e-6)


# ---------------------------------------------------------------------
# numpy model of the kernel's arithmetic
# ---------------------------------------------------------------------

def _fma(a, b, c):
    """float32 a * b + c with one rounding (the product is exact in float64)."""
    f64 = lambda x: np.asarray(x, np.float64)
    return (f64(a) * f64(b) + f64(c)).astype(F32)


def _sweep(a, base, bad):
    """The kernel's symmetric sweep of each lane's n x n matrix ``a`` (B, n,
    n), row i of the last axis being thread i's registers: -a^{-1}.  Sets
    ``bad`` (B,) to base + k + 1 at the first pivot k that is not positive
    and finite."""
    a = a.copy()
    n = a.shape[-1]
    for k in range(n):
        w = a[:, k, :].copy()                     # row k, as the warp's buffer holds it
        p = w[:, k]
        with np.errstate(invalid="ignore", divide="ignore"):
            fails = ~((p > 0) & (p < np.inf))
            bad[:] = np.where((bad == 0) & fails, base + k + 1, bad)
            rs = (1.0 / np.sqrt(p.astype(np.float64))).astype(F32)
            v = (w * rs[:, None]).astype(F32)
            new = _fma(-v[:, :, None], v[:, None, :], a)
            vr = (v * rs[:, None]).astype(F32)
            new[:, k, :] = vr
            new[:, :, k] = vr
            new[:, k, k] = (F32(-1) / p).astype(F32)
        a = new
    return a


def _butterfly(t):
    """The warp's xor-butterfly sum of t (B, 32) over the last axis."""
    for off in (16, 8, 4, 2, 1):
        t = (t + t[:, np.arange(32) ^ off]).astype(F32)
    return t[:, 0]


def _kernel_model(AcA, W, C, D, alpha, mu1, mu2, acy):
    """(M, b2, info) as the kernel computes them, in numpy float32; M[b, i,
    j] is entry i of thread j's column."""
    B, nl = acy.shape
    sym = lambda x: np.tril(x) + np.tril(x, -1).T       # the lower triangle, mirrored
    eye = np.eye(nl, dtype=F32)
    a = _fma(mu2[:, None, None], sym(W)[None],
             _fma(alpha[:, None, None], sym(AcA)[None], (mu1[:, None, None] * eye).astype(F32)))
    bad = np.zeros(B, np.int32)
    bf = -_sweep(a, 0, bad)
    nc = 0 if C is None else C.shape[0]
    macy = lambda m: sum_fma([(m[:, i, :], acy[:, i:i + 1]) for i in range(nl)])
    if nc == 0:
        return bf, (alpha[:, None] * macy(bf)).astype(F32), bad
    cb = np.stack([sum_fma([(bf[:, i, :], C[c, i]) for i in range(nl)]) for c in range(nc)],
                  axis=-1)                                           # (B, j, c) = (C Bf)[c, j]
    x = np.zeros((B, nc, nc), F32)
    for c in range(nc):
        for d in range(c + 1):
            t = np.zeros((B, 32), F32)
            t[:, :nl] = (C[c][None, :] * cb[:, :, d]).astype(F32)
            x[:, c, d] = x[:, d, c] = _butterfly(t)
    sinv = _sweep(x, nl, bad)
    q = np.stack([sum_fma([(sinv[:, c, d][:, None], cb[:, :, d]) for d in range(nc)])
                  for c in range(nc)], axis=-1)                      # (B, j, c)
    m = bf.copy()
    for c in range(nc):
        m = _fma(cb[:, :, c][:, :, None], q[:, :, c][:, None, :], m)  # - xi2[i, c] q_j[c]
    sd = np.stack([sum_fma([(sinv[:, c, d], D[d]) for d in range(nc)]) for c in range(nc)],
                  axis=-1)
    fold = sum_fma([(-cb[:, :, c], sd[:, c:c + 1]) for c in range(nc)])
    return m, _fma(alpha[:, None], macy(m), fold), bad


def sum_fma(terms):
    """The fused chain acc = fma(a, b, acc) over ``terms`` in order, from 0."""
    acc = F32(0)
    for a, b in terms:
        acc = _fma(a, b, acc)
    return acc


def _model_inputs(nl, nc, B=7, seed=0):
    """Shared AcA (a scaled Gram), W = PᵀP and a random C, D, at float32;
    per-lane penalties log-uniform in [1e-2, 1e2]."""
    rng = np.random.RandomState(seed)
    A = rng.randn(nl + 3, nl) / np.sqrt(nl)
    P = rng.randn(2 * nl + 1, nl) / np.sqrt(2 * nl)
    shared = [A.T @ A, P.T @ P, rng.randn(nc, nl) if nc else None,
              rng.randn(nc) if nc else None]
    lanes = [10.0 ** rng.uniform(-2, 2, B), 10.0 ** rng.uniform(-2, 2, B),
             rng.uniform(0.5, 2.0, B), rng.randn(B, nl)]
    return [None if t is None else np.asarray(t, F32) for t in shared + lanes]


@pytest.mark.parametrize("nl,nc", [(1, 0), (2, 1), (7, 0), (12, 2), (17, 4), (30, 1), (32, 3)])
def test_kernel_model_matches_plain_version(nl, nc):
    """The kernel's arithmetic against the plain version, lane by lane,
    within 4e-6 of the lane's largest entry (the two take other roundings;
    they differ by at most 6e-7 of it here)."""
    AcA, W, C, D, mu1, mu2, alpha, acy = _model_inputs(nl, nc)
    M, b2, info = _kernel_model(AcA, W, C, D, alpha, mu1, mu2, acy)
    t = lambda x: None if x is None else torch.as_tensor(x)
    Mr, b2r = spm_factor_refresh_reference(t(AcA), t(W), t(C), t(D), t(alpha), t(mu1), t(mu2),
                                           t(acy))
    assert not info.any()
    for got, want in ((M, Mr.numpy()), (b2, b2r.numpy())):
        scale = np.abs(want).reshape(len(want), -1).max(axis=1)
        err = np.abs(got - want).reshape(len(want), -1).max(axis=1)
        assert (err <= 4e-6 * scale).all(), (err / scale).max()


def test_kernel_model_infos_match_cholesky_ex():
    """A lane whose penalty matrix is not positive definite reports the
    column cholesky_ex reports; a sum rule whose -S is not (a zero row of C)
    reports nl + its column + 1; the other lanes report 0."""
    nl, nc = 12, 2
    AcA, W, C, D, mu1, mu2, alpha, acy = _model_inputs(nl, nc)
    alpha[2] = -1e3
    mu1[4] = -mu1[4] - 5.0
    with np.errstate(invalid="ignore", over="ignore"):
        _, _, info = _kernel_model(AcA, W, C, D, alpha, mu1, mu2, acy)
    Mpen = (torch.as_tensor(alpha)[:, None, None] * torch.as_tensor(AcA)
            + torch.as_tensor(mu1)[:, None, None] * torch.eye(nl)
            + torch.as_tensor(mu2)[:, None, None] * torch.as_tensor(W))
    want = torch.linalg.cholesky_ex(Mpen).info.numpy()
    assert want[2] > 0 and want[4] > 0
    np.testing.assert_array_equal(info, want)
    C[1] = 0.0
    with np.errstate(invalid="ignore", over="ignore"):
        _, _, info = _kernel_model(AcA, W, C, D, alpha, mu1, mu2, acy)
    assert info[2] == want[2] and info[4] == want[4]
    ok = np.setdiff1d(np.arange(len(info)), [2, 4])
    np.testing.assert_array_equal(info[ok], nl + 2)
