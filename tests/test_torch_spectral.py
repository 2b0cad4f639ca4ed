"""Parity of the port's spectral routes with admmsolver_tpu on the CPU: the
Jacobi eigendecomposition (the plain version of the CUDA kernel), the Gram
SVD, the matrix-sign PSD projection and singular-value threshold, and the PSD
dispatch among them, each route forced in both packages through the module
constants they share.  Inputs are numpy arrays from a seed; float64 unless
a test says float32.

Tolerances: Jacobi eigenvalues to 1e-12·max|w| of JAX's and of LAPACK's in
float64 (the same rounds and angles in both packages; measured ~1e-14) and
to 20·n·eps·‖A‖_F in float32 (XLA's float32 atan2/sin/cos round otherwise);
its vectors to 1e-9 of JAX's in float64 (an eigenvector moves by rounding
over the gap); reconstruction and orthogonality to n·eps·‖A‖_F.  The sign
routes to 1e-12·‖X‖_F of JAX's (the same products in another order) and to
the JAX tests' bounds against LAPACK; the dispatch to the JAX tests' bounds
(tests/test_linop.py:468-692, 860-974; tests/test_batch.py:501-545)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu as J
import admmsolver_tpu.ops.linop as JL
import admmsolver_tpu.ops.prox as JP
import admmsolver_tpu_torch as T
import admmsolver_tpu_torch.ops.linop as TL
import admmsolver_tpu_torch.ops.prox as TP
from admmsolver_tpu.parallel import BatchedSolver as JBatched
from admmsolver_tpu_torch.ops import kernels
from admmsolver_tpu_torch.parallel import BatchedSolver

torch.set_num_threads(1)

DTYPES = {"f64": (np.float64, torch.float64), "f32": (np.float32, torch.float32)}


def _sym(rng, shape, n):
    A = rng.randn(*shape, n, n)
    return A + A.swapaxes(-1, -2)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---------------------------------------------------------------------
# jacobi_eigh
# ---------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("n", [1, 2, 5, 8, 16, 17, 33, 64])
def test_jacobi_eigh_matches_jax(n, dt):
    npd, _ = DTYPES[dt]
    rng = np.random.RandomState(n)
    A = _sym(rng, (6,), n).astype(npd)
    w, v = (_np(t) for t in TL.jacobi_eigh(torch.as_tensor(A)))
    wj, vj = (np.asarray(t) for t in JL.jacobi_eigh(jnp.asarray(A)))
    assert w.dtype == npd and v.dtype == npd and w.shape == (6, n) and v.shape == (6, n, n)
    eps = np.finfo(npd).eps
    fro = float(np.linalg.norm(A.astype(np.float64), axis=(-2, -1)).max())
    scale = float(np.abs(wj).max())
    V, W = v.astype(np.float64), w.astype(np.float64)
    if dt == "f64":
        np.testing.assert_allclose(w, wj, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(v, vj, rtol=0, atol=1e-9)
        np.testing.assert_allclose(w, np.linalg.eigvalsh(A), rtol=0, atol=1e-12 * scale)
    else:
        np.testing.assert_allclose(w, wj, rtol=0, atol=20 * n * eps * fro)
    assert np.all(np.diff(W, axis=-1) >= 0)
    recon = np.einsum("bij,bj,blj->bil", V, W, V)
    np.testing.assert_allclose(recon, A, rtol=0, atol=max(n, 4) * eps * fro)
    orth = np.einsum("bji,bjk->bik", V, V)
    np.testing.assert_allclose(orth, np.broadcast_to(np.eye(n), orth.shape), rtol=0,
                               atol=max(n, 4) * eps * 10)


@pytest.mark.parametrize("n", [6, 7, 20])
def test_jacobi_eigh_unsorted_and_explicit_sweeps_match_jax(n):
    """``sort=False`` leaves the eigenvalues in the input's coordinate order
    (the PSD prox's form), and an explicit sweep count runs that many sweeps
    in both packages, odd n padded alike."""
    rng = np.random.RandomState(40 + n)
    A = _sym(rng, (2, 3), n)
    for kw in ({"sort": False}, {"sweeps": 3}, {"sweeps": 3, "sort": False}):
        w, v = TL.jacobi_eigh(torch.as_tensor(A), **kw)
        wj, vj = JL.jacobi_eigh(jnp.asarray(A), **kw)
        np.testing.assert_allclose(w.numpy(), np.asarray(wj), rtol=0, atol=1e-12 * np.abs(A).max())
        np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=0, atol=1e-10)


@pytest.mark.parametrize("n,dt,want", [
    (8, torch.float64, 8), (7, torch.float64, 8), (16, torch.float32, 10), (17, torch.float64, 9),
    (33, torch.float64, 10), (129, torch.float64, 11), (64, torch.float32, 8),
    (65, torch.float32, 9)])
def test_jacobi_default_sweeps_follow_jax(n, dt, want):
    """JAX linop.py:260-264 (unrolled, n <= 16) and 340-352 (scan form), on
    the padded even n."""
    assert TL._jacobi_sweeps(n + n % 2, n <= 16, dt) == want


def test_jacobi_eigh_multidim_batch_and_checks():
    rng = np.random.RandomState(1)
    A = _sym(rng, (4, 6), 8)
    w, v = TL.jacobi_eigh(torch.as_tensor(A))
    assert tuple(w.shape) == (4, 6, 8) and tuple(v.shape) == (4, 6, 8, 8)
    np.testing.assert_allclose(w.numpy(), np.linalg.eigvalsh(A), rtol=0, atol=1e-12 * np.abs(A).max())
    H = rng.randn(2, 4, 4) + 1j * rng.randn(2, 4, 4)
    with pytest.raises(TypeError, match="real symmetric"):
        TL.jacobi_eigh(torch.as_tensor(H + H.conj().swapaxes(-1, -2)))
    with pytest.raises(ValueError, match="n <= 256"):
        TL.jacobi_eigh(torch.zeros(1, 257, 257, dtype=torch.float64))
    # the kernel's wrapper takes (batch, n, n) with n even, f32 or f64
    with pytest.raises(ValueError, match="even"):
        kernels.jacobi_eigh(torch.zeros(2, 5, 5, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="batch, n, n"):
        kernels.jacobi_eigh(torch.zeros(4, 4, dtype=torch.float64), 3)
    with pytest.raises(TypeError, match="float32 or float64"):
        kernels.jacobi_eigh(torch.zeros(2, 4, 4, dtype=torch.float16), 3)


def _kernel_schedule(a, sweeps):
    """The CUDA kernel's loop written out in numpy: pairs indexed by label
    (arr_k = [0, 1..n-1 rotated right by k]), every 2x2 block of A rotated
    columns first, then rows, and V's column pairs."""
    a = a.copy()
    n = a.shape[-1]
    m = n // 2
    v = np.broadcast_to(np.eye(n), a.shape).copy()

    def label(t, k):
        return 0 if t == 0 else 1 + (t - 1 - k) % (n - 1)

    for r in range(sweeps * (n - 1)):
        k = r % (n - 1)
        p = np.array([label(t, k) for t in range(m)])
        q = np.array([label(n - 1 - t, k) for t in range(m)])
        b = np.arange(a.shape[0])[:, None]
        th = 0.5 * np.arctan2(2.0 * a[b, p, q], a[b, q, q] - a[b, p, p])
        th = th - np.where(np.abs(th) > np.pi / 4, np.sign(th) * (np.pi / 2), 0.0)
        c, s = np.cos(th), np.sin(th)
        ci, si = c[:, :, None], s[:, :, None]
        cj, sj = c[:, None, :], s[:, None, :]
        bb = b[:, :, None]
        a00, a01 = a[bb, p[:, None], p[None, :]], a[bb, p[:, None], q[None, :]]
        a10, a11 = a[bb, q[:, None], p[None, :]], a[bb, q[:, None], q[None, :]]
        b00, b01 = a00 * cj - a01 * sj, a00 * sj + a01 * cj
        b10, b11 = a10 * cj - a11 * sj, a10 * sj + a11 * cj
        a[bb, p[:, None], p[None, :]] = b00 * ci - b10 * si
        a[bb, q[:, None], p[None, :]] = b00 * si + b10 * ci
        a[bb, p[:, None], q[None, :]] = b01 * ci - b11 * si
        a[bb, q[:, None], q[None, :]] = b01 * si + b11 * ci
        x0, x1 = v[:, :, p], v[:, :, q]
        v[:, :, p] = x0 * c[:, None, :] - x1 * s[:, None, :]
        v[:, :, q] = x0 * s[:, None, :] + x1 * c[:, None, :]
    return np.diagonal(a, axis1=-2, axis2=-1), v


@pytest.mark.parametrize("n", [2, 4, 10])
def test_kernel_label_schedule_equals_plain_version(n):
    """The kernel indexes pairs by label where the plain version permutes
    the matrix every round: the two orders of the same rotations agree to
    rounding (atan2/sin/cos of numpy against torch's)."""
    rng = np.random.RandomState(n)
    A = _sym(rng, (3,), n)
    w, v = kernels.jacobi_eigh_reference(torch.as_tensor(A), 4)
    wk, vk = _kernel_schedule(A, 4)
    np.testing.assert_allclose(w.numpy(), wk, rtol=0, atol=1e-13 * np.abs(A).max())
    np.testing.assert_allclose(v.numpy(), vk, rtol=0, atol=1e-12)


def _warp_layout(n):
    """The warp path's constants as csrc/jacobi_eigh.cu writes them:
    ``layout0`` (the label at row position j in round 0), ``position0`` (its
    inverse) and ``perm`` (new row j = old row perm[j] after each round)."""
    def arrangement1(t):
        return 0 if t == 0 else n - 1 if t == 1 else t - 1

    layout0 = [j // 2 if j % 2 == 0 else n - 1 - j // 2 for j in range(n)]
    position0 = [2 * lab if lab < n // 2 else 2 * (n - 1 - lab) + 1 for lab in range(n)]
    perm = [position0[arrangement1(j // 2 if j % 2 == 0 else n - 1 - j // 2)]
            for j in range(n)]
    return layout0, position0, perm


def _warp_schedule(a, sweeps):
    """The warp path of the CUDA kernel in numpy, lane by lane: 32 // n
    slices a warp of 32 lanes (idle lanes and the last warp's missing slices
    on zeros), lane L of a slice holding column L of A (rows in the round's
    paired layout) and of V (rows by label); a shuffle from lane ``src`` is
    ``value[src % 32]``, the warp's (c, s) table 32 entries."""
    B, n, _ = a.shape
    m, S = n // 2, 32 // n
    layout0, position0, perm = _warp_layout(n)
    warps = -(-B // S)
    lane = np.arange(32)
    group, L = lane // n, lane % n
    base = group * n
    slice_ = np.arange(warps)[:, None] * S + group[None, :]
    active = (group[None, :] < S) & (slice_ < B)
    src = np.where(active, slice_, 0)
    x = np.where(active[..., None], a[src][:, :, layout0, :][
        np.arange(warps)[:, None, None], lane[None, :, None], np.arange(n)[None, None, :],
        L[None, :, None]], 0.0)
    y = np.broadcast_to((np.arange(n)[None, :] == L[:, None]).astype(float),
                        (warps, 32, n)).copy()
    t, k = L.copy(), 0
    w_ = np.arange(warps)[:, None]
    for _ in range(sweeps * (n - 1)):
        first = t < m
        i = np.where(first, t, n - 1 - t)
        partner = (base + np.where(t == n - 1, 0, 1 + (3 * n - 4 - t - k) % (n - 1))) % 32
        u0, z0 = x[:, lane, 2 * i], x[:, lane, 2 * i + 1]
        uo, zo = u0[:, partner], z0[:, partner]
        app, apq, aqq = (np.where(first, u0, uo), np.where(first, uo, u0),
                         np.where(first, zo, z0))
        th = 0.5 * np.arctan2(2.0 * apq, aqq - app)
        th = th - np.where(np.abs(th) > np.pi / 4, np.sign(th) * (np.pi / 2), 0.0)
        c, s = np.cos(th), np.sin(th)
        table = np.zeros((warps, 32, 2))
        slot = group * m + i
        table[:, slot[first]] = np.stack([c, s], axis=-1)[:, first]
        sg = np.where(first, -s, s)
        x = x * c[..., None] + x[:, partner] * sg[..., None]
        y = y * c[..., None] + y[:, partner] * sg[..., None]
        for j in range(m):
            g = table[:, group * m + j]
            r0, r1 = x[..., 2 * j].copy(), x[..., 2 * j + 1].copy()
            x[..., 2 * j] = r0 * g[..., 0] - r1 * g[..., 1]
            x[..., 2 * j + 1] = r0 * g[..., 1] + r1 * g[..., 0]
        x = x[..., perm]
        t = np.where(t == 0, 0, np.where(t == n - 1, 1, t + 1))
        k = 0 if k == n - 2 else k + 1
    pos = np.array(position0)[L]
    diag = x[w_, lane[None, :], pos[None, :]]
    w = np.zeros((B, n))
    v = np.zeros((B, n, n))
    act = np.nonzero(active)
    w[slice_[act], L[act[1]]] = diag[act]
    v[slice_[act], :, L[act[1]]] = y[act]
    return w, v


@pytest.mark.parametrize("n", [2, 6, 8, 16, 32])
def test_kernel_warp_schedule_equals_plain_version(n):
    """The warp path (one lane a column, floor(32/n) slices a warp, columns
    kept by label, rows in the paired layout permuted in registers, pairs'
    partners and (c, s) exchanged as the kernel does) run in numpy at the
    default sweep count against the plain version, on a batch whose last
    warp is partly filled; the kernel's closed-form layout equals the plain
    version's."""
    d0, pi = kernels._jacobi_layout(n)
    layout0, position0, perm = _warp_layout(n)
    assert layout0 == d0 and perm == pi
    assert [position0[lab] for lab in d0] == list(range(n))
    rng = np.random.RandomState(60 + n)
    A = _sym(rng, (2 * (32 // n) + 1,), n)
    sweeps = TL._jacobi_sweeps(n, n <= 16, torch.float64)
    w, v = kernels.jacobi_eigh_reference(torch.as_tensor(A), sweeps)
    wk, vk = _warp_schedule(A, sweeps)
    np.testing.assert_allclose(w.numpy(), wk, rtol=0, atol=1e-13 * np.abs(A).max())
    np.testing.assert_allclose(v.numpy(), vk, rtol=0, atol=1e-12)


def test_kernel_jacobi_dispatch_takes_the_warp_path_to_32():
    """n <= _JACOBI_WARP_MAX_N goes to the warp path without asking the
    device; its blocks are one warp; the block kernel's size is unchanged."""
    warp = kernels._JACOBI_MODES.index("warp")
    assert kernels._JACOBI_WARP_MAX_N == 32
    for n in range(2, 33, 2):
        assert kernels._jacobi_mode(None, 0, n, True) == warp
        assert kernels._jacobi_mode(None, 0, n, False) == warp
    assert kernels._jacobi_threads(8, warp) == kernels._jacobi_threads(32, warp) == 32
    assert kernels._jacobi_threads(8, 0) == 32
    assert kernels._jacobi_threads(34, 0) == 608        # 34 * 17 in whole warps


class _FitLib:
    """The two functions of the Jacobi library that _jacobi_mode asks, for
    a device on which the modes ``fits`` fit one block's shared memory and
    no other does.  (The card test
    ``test_cuda_jacobi_dispatch_on_the_card`` holds the real library's
    sizes on the H100.)"""

    def __init__(self, *fits):
        self.fits = fits

    @staticmethod
    def jacobi_eigh_max_smem(device, limit):
        limit._obj.value = 1
        return 0

    def jacobi_eigh_smem_bytes(self, n, f64, mode):
        return 0 if kernels._JACOBI_MODES[mode] in self.fits else 2


@pytest.mark.parametrize("n,f64,fits,mode,threads", [
    (34, True, ("tile",), "tile", 256), (34, False, ("tile",), "tile", 256),
    (64, True, ("tile",), "tile", 512), (96, False, ("tile",), "tile", 512),
    (128, True, ("tile",), "tile", 768), (128, False, ("tile",), "tile", 768),
    (130, True, ("global",), "global", 1024), (130, False, ("shared", "global"), "shared", 1024)])
def test_kernel_jacobi_dispatch_takes_the_tile_path_from_34_to_128(n, f64, fits, mode, threads):
    """34 <= n <= 128 asks for the tile path alone, above it the block
    kernel, in shared memory where that fits, else in device memory; the
    thread count the wrapper gives each.  A tile path that does not fit
    raises rather than falling back to the block kernel."""
    assert kernels._JACOBI_TILE_N == (34, 128)
    got = kernels._jacobi_mode(_FitLib(*fits), 0, n, f64)
    assert kernels._JACOBI_MODES[got] == mode
    assert kernels._jacobi_threads(n, got) == threads
    if mode == "tile":
        with pytest.raises(ValueError, match="does not fit"):
            kernels._jacobi_mode(_FitLib("shared", "global"), 0, n, f64)


def _folded_angle(app, apq, aqq):
    """(c, s) of the folded angle as the plain version and the kernel's
    tile path take it: atan2, the fold to |θ| ≤ π/4, cos, sin."""
    th = 0.5 * np.arctan2(2.0 * apq, aqq - app)
    th = th - np.where(np.abs(th) > np.pi / 4, np.sign(th) * (np.pi / 2), 0.0)
    return np.cos(th), np.sin(th)


def _tile_label(t, k, n):
    r = t - 1 - k
    return np.where(t == 0, 0, 1 + np.where(r < 0, r + n - 1, r))


def _tri(a, b, n):
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    return (lo * (2 * n - lo - 1)) // 2 + hi - lo - 1


def _tile_blocks(m):
    """The tile path's 2x2 blocks of two pairs as csrc/jacobi_eigh.cu
    enumerates them (u = (dl − 1)·m + i: pairs i and i + dl mod m), as
    (lo, hi), and the pair tn of the next round whose pivot each holds
    (−1: none)."""
    u = np.arange(m * (m - 1) // 2)
    i, dl = u % m, 1 + u // m
    j = (i + dl) % m
    lo, hi = np.minimum(i, j), np.maximum(i, j)
    tn = np.where(hi == lo + 2, lo + 1, np.where((lo == 0) & (hi == 1), 0,
                                                  np.where((lo == m - 2) & (hi == m - 1), m - 1, -1)))
    return lo, hi, tn


def _tile_partition(m):
    """The blocks as the tile kernel deals them out: its first warps the
    pivot block of each pair tn of the next round; the other threads the
    other blocks, u' = 0 .. m(m-1)/2 - m - 1: u' < m the non-pivot blocks
    of bands 1 and 2, u' >= m block u = u' + m of the circulant order."""
    pivot = [(0 if t == 0 else m - 2 if t == m - 1 else t - 1,
              1 if t == 0 else m - 1 if t == m - 1 else t + 1) for t in range(m)]
    rest = []
    for up in range(m * (m - 1) // 2 - m):
        if up < m:
            i = up + 1 if up < m - 3 else m - 1 if up == m - 3 else up
            j = (i + (1 if up < m - 2 else 2)) % m
        else:
            u = up + m
            i, j = u % m, (u % m + 1 + u // m) % m
        rest.append((min(i, j), max(i, j)))
    return pivot, rest


def _rot_pp(app, apq, aqq, c, s):
    return (app * c - apq * s) * c - (apq * c - aqq * s) * s


def _rot_qq(app, apq, aqq, c, s):
    return (app * s + apq * c) * s + (apq * s + aqq * c) * c


def _rot_pq(app, apq, aqq, c, s):
    return (app * s + apq * c) * c - (apq * s + aqq * c) * s


def _tile_schedule(a, sweeps):
    """The tile path of the CUDA kernel in numpy: A's strict upper triangle
    (row-major, ``_tri``) rotated in place, one 2x2 block of two pairs at a
    time in the kernel's order; the diagonal a_ll and each round's pivots
    a_pq in tables of two parities; the block holding a pivot of the next
    round computes that pair's diagonal entries from this round's tables,
    its angle, and the pivot's value after the next round; V kept
    transposed."""
    B, n, _ = a.shape
    m = n // 2
    iu = np.triu_indices(n, 1)
    A = a[:, iu[0], iu[1]].copy()
    d = np.diagonal(a, axis1=1, axis2=2).copy()
    Vt = np.broadcast_to(np.eye(n), (B, n, n)).copy()
    t = np.arange(m)
    p, q = _tile_label(t, 0, n), _tile_label(n - 1 - t, 0, n)
    at = _tri(p, q, n)
    app, apq, aqq = d[:, p], A[:, at], d[:, q]
    c, s = _folded_angle(app, apq, aqq)
    e = apq.copy()
    A[:, at] = _rot_pq(app, apq, aqq, c, s)
    lo, hi, tn = _tile_blocks(m)
    piv = tn >= 0
    L, H, TN = lo[piv], hi[piv], tn[piv]
    q_lo, p_hi = TN == 1, TN == m - 1
    for r in range(sweeps * (n - 1)):
        k = r % (n - 1)
        pi, qi = _tile_label(lo, k, n), _tile_label(n - 1 - lo, k, n)
        pj, qj = _tile_label(hi, k, n), _tile_label(n - 1 - hi, k, n)
        ci, si, cj, sj = c[:, lo], s[:, lo], c[:, hi], s[:, hi]
        idx = (_tri(pi, pj, n), _tri(pi, qj, n), _tri(qi, pj, n), _tri(qi, qj, n))
        x00, x01, x10, x11 = (A[:, ix] for ix in idx)
        y00, y01 = x00 * cj - x01 * sj, x00 * sj + x01 * cj
        y10, y11 = x10 * cj - x11 * sj, x10 * sj + x11 * cj
        z00, z01 = y00 * ci - y10 * si, y01 * ci - y11 * si
        z10, z11 = y00 * si + y10 * ci, y01 * si + y11 * ci
        # next round's angles from its pivot blocks
        apq_n = np.where(q_lo, z11[:, piv], np.where(p_hi, z00[:, piv], z01[:, piv]))
        pl, ql, ph, qh = pi[piv], qi[piv], pj[piv], qj[piv]
        args_lo = (d[:, pl], e[:, L], d[:, ql], c[:, L], s[:, L])
        args_hi = (d[:, ph], e[:, H], d[:, qh], c[:, H], s[:, H])
        app_n = np.where(q_lo, _rot_qq(*args_lo), _rot_pp(*args_lo))
        aqq_n = np.where(p_hi, _rot_pp(*args_hi), _rot_qq(*args_hi))
        cn, sn = _folded_angle(app_n, apq_n, aqq_n)
        c2, s2, e2, d2 = (np.full_like(c, np.nan), np.full_like(s, np.nan),
                          np.full_like(e, np.nan), np.full_like(d, np.nan))
        c2[:, TN], s2[:, TN], e2[:, TN] = cn, sn, apq_n
        d2[:, np.where(q_lo, ql, pl)] = app_n
        d2[:, np.where(p_hi, ph, qh)] = aqq_n
        pv = _rot_pq(app_n, apq_n, aqq_n, cn, sn)
        z11[:, piv] = np.where(q_lo, pv, z11[:, piv])
        z00[:, piv] = np.where(p_hi, pv, z00[:, piv])
        z01[:, piv] = np.where(~q_lo & ~p_hi, pv, z01[:, piv])
        for ix, z in zip(idx, (z00, z01, z10, z11)):
            A[:, ix] = z
        # V <- V G on the rows of V^T
        j = np.arange(m)
        pv_, qv_ = _tile_label(j, k, n), _tile_label(n - 1 - j, k, n)
        x0, x1 = Vt[:, pv_, :], Vt[:, qv_, :]
        cc, ss = c[:, :, None], s[:, :, None]
        Vt[:, pv_, :], Vt[:, qv_, :] = x0 * cc - x1 * ss, x0 * ss + x1 * cc
        c, s, e, d = c2, s2, e2, d2
    return d, Vt.transpose(0, 2, 1)


@pytest.mark.parametrize("n", [34, 48, 64, 96])
def test_kernel_tile_schedule_equals_plain_version(n):
    """The tile path (one stored triangle of A rotated in place, every pair
    of pairs once, diagonal and pivots in tables of two parities, next
    round's angles from this round's pivot blocks) run
    in numpy at the default sweep count against the plain version: w to
    1e-12·max|A| and V to 1e-11, both in label order.  Its block order
    covers every pair of pairs once, its pivot blocks hold each pair of the
    next round once, at the entry the schedule puts it, and the kernel's
    split of the blocks between its first warps (the pivot blocks) and the
    others covers each block once."""
    m = n // 2
    lo, hi, tn = _tile_blocks(m)
    assert sorted(zip(lo, hi)) == [(i, j) for i in range(m) for j in range(i + 1, m)]
    assert sorted(tn[tn >= 0]) == list(range(m))
    pivot, rest = _tile_partition(m)
    assert pivot == [(lo[b], hi[b]) for b in np.argsort(np.where(tn >= 0, tn, m))[:m]]
    assert sorted(pivot + rest) == sorted(zip(lo, hi))
    for k in range(n - 1):
        k1 = (k + 1) % (n - 1)
        for b in np.nonzero(tn >= 0)[0]:
            t = tn[b]
            nxt = (int(_tile_label(t, k1, n)), int(_tile_label(n - 1 - t, k1, n)))
            first = _tile_label(n - 1 - lo[b] if t == 1 else lo[b], k, n)
            second = _tile_label(hi[b] if t == m - 1 else n - 1 - hi[b], k, n)
            assert nxt == (int(first), int(second))
    rng = np.random.RandomState(80 + n)
    A = _sym(rng, (3,), n)
    sweeps = TL._jacobi_sweeps(n, False, torch.float64)
    w, v = kernels.jacobi_eigh_reference(torch.as_tensor(A), sweeps)
    wk, vk = _tile_schedule(A, sweeps)
    np.testing.assert_allclose(w.numpy(), wk, rtol=0, atol=1e-12 * np.abs(A).max())
    np.testing.assert_allclose(v.numpy(), vk, rtol=0, atol=1e-11)


# ---------------------------------------------------------------------
# svd_via_gram
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mn", [(40, 30), (30, 40), (20, 20), (64, 48)])
def test_svd_via_gram_matches_jax_and_numpy(mn):
    m, n = mn
    rng = np.random.RandomState(9)
    x = rng.randn(5, m, n)
    x[0] = np.outer(rng.randn(m), rng.randn(n))       # a rank-1 lane
    U, s, Vh = TL.svd_via_gram(torch.as_tensor(x))
    Uj, sj, Vhj = (np.asarray(t) for t in JL.svd_via_gram(jnp.asarray(x)))
    assert tuple(U.shape) == Uj.shape and tuple(Vh.shape) == Vhj.shape
    smax = float(sj.max())
    # the rank-1 lane's zero singular values are the Gram's rounding floor
    # (~sqrt(eps)·s_max), in either package its own: only the full-rank
    # lanes are held to JAX's
    np.testing.assert_allclose(s.numpy()[1:], sj[1:], rtol=0, atol=1e-12 * smax)
    np.testing.assert_allclose(((U * s[..., None, :]) @ Vh).numpy(), x, rtol=0, atol=1e-12 * smax)
    np.testing.assert_allclose(s.numpy(), np.linalg.svd(x, compute_uv=False), rtol=0,
                               atol=2e-6 * smax)
    with pytest.raises(TypeError, match="real input"):
        TL.svd_via_gram(torch.as_tensor(x + 1j * x))


def test_svd_via_gram_soft_threshold_and_other_eigh():
    """The nuclear prox's use: U (s - tau)_+ Vh equals the exact-SVD
    construction; a given eigh_fn (and the library eigh above 256) too."""
    rng = np.random.RandomState(10)
    x = rng.randn(4, 12, 9)
    tau = 0.3
    U0, s0, Vh0 = np.linalg.svd(x, full_matrices=False)
    want = (U0 * np.maximum(s0 - tau, 0.0)[..., None, :]) @ Vh0
    for eigh_fn in (None, torch.linalg.eigh):
        U, s, Vh = TL.svd_via_gram(torch.as_tensor(x), eigh_fn=eigh_fn)
        got = (U * torch.clamp_min(s - tau, 0.0)[..., None, :]) @ Vh
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
    big = rng.randn(2, 270, 258)
    U, s, Vh = TL.svd_via_gram(torch.as_tensor(big))
    sj = np.asarray(JL.svd_via_gram(jnp.asarray(big))[1])
    np.testing.assert_allclose(s.numpy(), sj, rtol=0, atol=1e-11 * sj.max())


# ---------------------------------------------------------------------
# psd_project_sign, svt_sign
# ---------------------------------------------------------------------

def _lapack_psd(X):
    w, v = np.linalg.eigh(X)
    return np.einsum("kij,kj,klj->kil", v, np.maximum(w, 0.0), v.conj())


@pytest.mark.parametrize("n", [70, 128])
def test_psd_project_sign_with_tiny_eigenvalues(n):
    rng = np.random.RandomState(n)
    X = rng.randn(3, n, n)
    X = (X + X.transpose(0, 2, 1)) / 2
    # near-zero eigenvalues, the sign iteration's hard region
    w, v = np.linalg.eigh(X[0])
    w[:5] = np.array([-1e-14, -1e-9, 1e-12, 1e-7, -1e-5]) * np.abs(w).max()
    X[0] = (v * w) @ v.T
    scale = float(np.linalg.norm(X, axis=(1, 2)).max())
    got = TP.psd_project_sign(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP.psd_project_sign(jnp.asarray(X))), rtol=0,
                               atol=1e-12 * scale)
    np.testing.assert_allclose(got, _lapack_psd(X), rtol=0, atol=1e-11 * scale)
    got32 = TP.psd_project_sign(torch.as_tensor(X, dtype=torch.float32))
    assert got32.dtype == torch.float32
    np.testing.assert_allclose(got32.numpy().astype(np.float64), _lapack_psd(X), rtol=0,
                               atol=5e-5 * scale)


def test_psd_project_sign_zero_and_definite_slices():
    rng = np.random.RandomState(1)
    n = 80
    Q = rng.randn(n, n)
    pos = Q @ Q.T / n
    got = TP.psd_project_sign(torch.as_tensor(np.stack([np.zeros((n, n)), pos, -pos]))).numpy()
    assert np.all(got[0] == 0.0)
    np.testing.assert_allclose(got[1], pos, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got[2], 0.0, rtol=0, atol=1e-12)


def test_svt_sign_edge_cases():
    """tests/test_linop.py:948-974 in both packages: zero input, tau = 0,
    tau above s_max, per-lane tau; a wide matrix, and complex refused."""
    rng = np.random.RandomState(3)
    m, n = 96, 80
    X = rng.randn(m, n)
    smax = np.linalg.svd(X, compute_uv=False)[0]
    assert np.all(TP.svt_sign(torch.zeros(2, m, n, dtype=torch.float64), 0.3).numpy() == 0.0)
    got = TP.svt_sign(torch.as_tensor(X), 0.0).numpy()
    np.testing.assert_allclose(got, X, rtol=0, atol=1e-10 * smax)
    np.testing.assert_allclose(got, np.asarray(JP.svt_sign(jnp.asarray(X), 0.0)), rtol=0,
                               atol=1e-12 * smax)
    np.testing.assert_allclose(TP.svt_sign(torch.as_tensor(X), 2.0 * smax).numpy(), 0.0,
                               rtol=0, atol=1e-10 * smax)
    Xs = np.stack([X, X])
    taus = np.array([0.1 * smax, 0.5 * smax])
    got = TP.svt_sign(torch.as_tensor(Xs), torch.as_tensor(taus)).numpy()
    np.testing.assert_allclose(got, np.asarray(JP.svt_sign(jnp.asarray(Xs), jnp.asarray(taus))),
                               rtol=0, atol=1e-12 * smax)
    U, S, Vh = np.linalg.svd(X, full_matrices=False)
    for i, t in enumerate(taus):
        np.testing.assert_allclose(got[i], (U * np.maximum(S - t, 0.0)) @ Vh, rtol=0,
                                   atol=1e-11 * smax)
    wide = TP.svt_sign(torch.as_tensor(X.T), 0.5 * smax).numpy()
    np.testing.assert_allclose(wide, got[1].T, rtol=0, atol=1e-12 * smax)
    with pytest.raises(TypeError, match="real input"):
        TP.svt_sign(torch.as_tensor(X + 0j), 0.1)


# ---------------------------------------------------------------------
# The PSD dispatch
# ---------------------------------------------------------------------

def _psd_oracle(x, shape, axis):
    x3 = np.moveaxis(x.reshape(shape), axis, 0)
    out = np.empty_like(x3)
    for i, sl in enumerate(x3):
        w, v = np.linalg.eigh(sl, UPLO="L")
        out[i] = (v * np.maximum(w, 0.0)) @ v.conj().T
    return np.moveaxis(out, 0, axis).ravel()


@pytest.fixture
def routes(monkeypatch):
    """Set the dispatch constants of both packages alike."""
    def force(**values):
        for mod in (TP, JP):
            for name, value in values.items():
                monkeypatch.setattr(mod, name, value)
    return force


def test_dispatch_constants_are_the_jax_packages():
    for name in ("JACOBI_MAX_N", "JACOBI_MAX_N_F32", "USE_SIGN_ABOVE_JACOBI", "SIGN_SCHEDULES",
                 "_SIGN_QUINTIC"):
        assert getattr(TP, name) == getattr(JP, name), name
    assert TP._jacobi_boundary(torch.float64) == 64 and TP._jacobi_boundary(torch.float32) == 32


def test_sign_route_is_on_for_cuda_operands_only(routes):
    """The JAX package's "on the TPU" reads "the operand is on a CUDA
    device"; "always" and False force it either way."""
    cpu = torch.zeros(2)
    assert not TP._sign_active(cpu)
    routes(USE_SIGN_ABOVE_JACOBI="always")
    assert TP._sign_active(cpu)
    routes(USE_SIGN_ABOVE_JACOBI=False)
    assert not TP._sign_active(cpu)


def _route_calls(monkeypatch):
    """Count the calls of each route of the port's dispatch."""
    calls = {"jacobi": 0, "sign": 0, "eigh": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    wrap(TL, "jacobi_eigh", "jacobi")
    wrap(TP, "psd_project_sign", "sign")
    wrap(TP.torch.linalg, "eigh", "eigh")
    return calls


@pytest.mark.parametrize("case", [
    # (n, complex, constants, the route the port takes)
    (6, False, {}, "jacobi"),
    (64, False, {}, "jacobi"),
    (100, False, {}, "eigh"),                                  # CPU default: exact
    (100, False, {"USE_SIGN_ABOVE_JACOBI": "always"}, "sign"),
    (70, False, {"USE_SIGN_ABOVE_JACOBI": "always", "JACOBI_MAX_N": 16}, "sign"),
    (20, False, {"JACOBI_MAX_N": 16, "USE_SIGN_ABOVE_JACOBI": False}, "eigh"),
    (12, True, {}, "jacobi"),                                  # realified 24 <= 64
    (40, True, {}, "eigh"),                                    # complex eigh
    (40, True, {"USE_SIGN_ABOVE_JACOBI": "always"}, "sign"),   # realified 80 > 64
], ids=lambda c: f"n{c[0]}{'c' if c[1] else ''}-{c[3]}-{'-'.join(map(str, c[2].values()))}")
def test_psd_project_routes_match_jax_and_lapack(case, routes, monkeypatch):
    """Each branch of JAX prox.py:193-250, forced alike in both packages:
    the port takes the named route and agrees with the JAX package and with
    the per-slice LAPACK construction (1e-9 on the sign route, whose floor is
    delta·||X||_F; 1e-11 elsewhere)."""
    n, cplx, consts, route = case
    routes(**consts)
    calls = _route_calls(monkeypatch)
    rng = np.random.RandomState(n)
    shape, axis = (n, n, 2), 2
    x = rng.randn(int(np.prod(shape)))
    if cplx:
        x = x + 1j * rng.randn(x.size)
    got = TP.psd_project(torch.as_tensor(x), shape, axis).numpy()
    assert calls[route] >= 1 and sum(calls.values()) == calls[route], calls
    want = np.asarray(JP.psd_project(jnp.asarray(x), shape, axis))
    tol = 1e-9 if route == "sign" else 1e-11
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    np.testing.assert_allclose(got, _psd_oracle(x, shape, axis), rtol=0, atol=tol)


def test_psd_project_float32_boundary(routes, monkeypatch):
    """float32 slices use JACOBI_MAX_N_F32 (32): n = 40 leaves Jacobi."""
    calls = _route_calls(monkeypatch)
    rng = np.random.RandomState(4)
    for n, route in ((32, "jacobi"), (40, "eigh")):
        x = rng.randn(n * n * 2)
        got = TP.psd_project(torch.as_tensor(x, dtype=torch.float32), (n, n, 2), 2)
        assert got.dtype == torch.float32 and calls[route] >= 1
        np.testing.assert_allclose(got.numpy(), _psd_oracle(x, (n, n, 2), 2), rtol=0,
                                   atol=2e-5 * np.abs(x).max() * n)
        calls.update(jacobi=0, sign=0, eigh=0)


@pytest.mark.parametrize("route", ["sign", "jacobi", "eigh"])
def test_batched_sdp_with_each_route_matches_jax(route, routes):
    """tests/test_batch.py:501-545 at a smaller slice: a least-squares fit
    with a PSD cone on one k x k slice through BatchedSolver, each route
    forced alike in both packages (k = 20 is above a lowered Jacobi
    boundary of 16 for the sign and eigh routes); x of every block to 1e-8
    of JAX's, and the result PSD."""
    routes(**{"sign": {"USE_SIGN_ABOVE_JACOBI": "always", "JACOBI_MAX_N": 16},
              "jacobi": {},
              "eigh": {"USE_SIGN_ABOVE_JACOBI": False, "JACOBI_MAX_N": 16}}[route])
    rng = np.random.RandomState(16)
    k, B = 20, 2
    N = k * k
    A = rng.randn(N // 4, N)
    Q = rng.randn(k, k)
    ys = (A @ (Q @ Q.T / k).reshape(-1))[None, :] + 1e-4 * rng.randn(B, N // 4)

    def model(P, wrap):
        return P.Model([P.LeastSquares(1.0, wrap(A), wrap(ys[0])),
                        P.SemiPositiveDefinitePenalty((k, k, 1), axis=2)],
                       [(1, 0, P.identity(N), P.identity(N))])

    got = BatchedSolver(model(T, lambda a: a), device="cpu").solve(
        {(0, "y"): ys}, niter=40, record_residuals=False)
    want = JBatched(model(J, jnp.asarray)).solve({(0, "y"): jnp.asarray(ys)}, niter=40,
                                                 record_residuals=False)
    for a, b in zip(got.x, want.x):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-8 * np.abs(b).max())
    X = got.x[1].numpy().reshape(B, k, k)
    assert np.linalg.eigvalsh(0.5 * (X + X.swapaxes(-1, -2))).min() > -1e-8
