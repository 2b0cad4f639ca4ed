"""Parity of the port's structured operators with admmsolver_tpu.ops.linop:
the same numpy data goes through both packages' matmul/add dispatch,
matvecs (with rectangular truncate/zero-pad) and adjoints, in float64;
results agree to 1e-12 and keep the same structure."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

import admmsolver_tpu.ops.linop as J
import admmsolver_tpu_torch.ops.linop as T

torch.set_num_threads(1)

TOL = 1e-12


def _ops(P, kind, shape, seed, complex_=False):
    """The operator ``kind`` of ``shape`` in package ``P`` (J or T), from
    numpy data made from ``seed``."""
    rng = np.random.RandomState(seed)
    val = (lambda *s: rng.randn(*s) + 1j * rng.randn(*s)) if complex_ else rng.randn
    wrap = jnp.asarray if P is J else (lambda a: a)
    if kind == "dense":
        return P.DenseMatrix(wrap(val(*shape)))
    if kind == "diag":
        return P.DiagonalMatrix(wrap(val(min(shape))), shape)
    if kind == "si":
        return P.ScaledIdentityMatrix(shape, complex(val(1)[0]) if complex_ else float(val(1)[0]))
    raise ValueError(kind)


def _dense(m):
    a = m.asmatrix()
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


KINDS = ("dense", "diag", "si")
# (left shape, right shape) for square, tall and wide products
SHAPES = [((5, 5), (5, 5)), ((6, 4), (4, 3)), ((3, 4), (4, 6)), ((4, 6), (6, 6)),
          ((6, 6), (6, 4))]


@pytest.mark.parametrize("shapes", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kl", KINDS)
@pytest.mark.parametrize("kr", KINDS)
def test_matmul_dispatch_matches_jax(kl, kr, shapes):
    sl, sr = shapes
    out = {}
    for P in (J, T):
        a, b = _ops(P, kl, sl, 1), _ops(P, kr, sr, 2)
        out[P] = P.matmul(a, b)
    assert type(out[T]).__name__ == type(out[J]).__name__
    assert tuple(out[T].shape) == tuple(out[J].shape)
    np.testing.assert_allclose(_dense(out[T]), _dense(out[J]), rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(5, 5), (4, 6), (6, 4)])
@pytest.mark.parametrize("kl", KINDS)
@pytest.mark.parametrize("kr", KINDS)
def test_add_dispatch_matches_jax(kl, kr, shape):
    out = {P: P.add(_ops(P, kl, shape, 3), _ops(P, kr, shape, 4)) for P in (J, T)}
    assert type(out[T]).__name__ == type(out[J]).__name__
    np.testing.assert_allclose(_dense(out[T]), _dense(out[J]), rtol=0, atol=TOL)


@pytest.mark.parametrize("shape", [(5, 5), (3, 5), (5, 3)])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("rhs_cols", [None, 2])
def test_matvec_truncate_pad_matches_jax(kind, shape, rhs_cols):
    rng = np.random.RandomState(7)
    v = rng.randn(shape[1]) if rhs_cols is None else rng.randn(shape[1], rhs_cols)
    got = _ops(T, kind, shape, 5) @ torch.as_tensor(v)
    want = np.asarray(_ops(J, kind, shape, 5) @ jnp.asarray(v))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), _dense(_ops(T, kind, shape, 5)) @ v,
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_adjoint_scale_inverse_diagonal_match_jax(kind):
    shape = (4, 4)
    t, j = _ops(T, kind, shape, 9, complex_=True), _ops(J, kind, shape, 9, complex_=True)
    np.testing.assert_allclose(_dense(t.H), _dense(j.H), atol=TOL)
    np.testing.assert_allclose(_dense(t * 2.5), _dense(j * 2.5), atol=TOL)
    np.testing.assert_allclose(_dense(-t), _dense(-j), atol=TOL)
    np.testing.assert_allclose(_dense(t - t), 0.0, atol=TOL)
    if kind != "dense":
        np.testing.assert_allclose(_dense(t.inv()), _dense(j.inv()), atol=TOL)
        np.testing.assert_allclose(t.effective_diagonal().numpy(),
                                   np.asarray(j.effective_diagonal()), atol=TOL)
    else:
        assert t.effective_diagonal() is None
        np.testing.assert_allclose(_dense(t.inv()), np.linalg.inv(_dense(t)), atol=1e-10)
    rect = _ops(T, kind, (3, 4), 9)
    assert kind == "dense" or rect.effective_diagonal() is None


def test_identity_hash_and_asmatrixtype():
    I = T.identity(4)
    assert isinstance(I, T.ScaledIdentityMatrix) and I.is_square()
    np.testing.assert_array_equal(_dense(I), np.eye(4))
    assert _dense(I).dtype == np.float64
    a = np.arange(6.0).reshape(2, 3)
    m = T.asmatrixtype(a)
    assert isinstance(m, T.DenseMatrix) and T.asmatrixtype(m) is m
    assert T.matrix_hash(m) == T.matrix_hash(T.DenseMatrix(a.copy()))
    assert T.matrix_hash(m) != T.matrix_hash(T.DenseMatrix(a + 1))
    assert T.matrix_hash(T.ScaledIdentityMatrix(3, 2.0)) == \
        T.matrix_hash(T.ScaledIdentityMatrix(3, torch.tensor(2.0, dtype=torch.float64)))
    with pytest.raises(ValueError):
        T.matmul(T.DenseMatrix(a), T.DenseMatrix(a))
    with pytest.raises(ValueError):
        T.add(T.DenseMatrix(a), T.identity(2))


def test_matvec_follows_state_precision_and_device():
    """Operators stored in f64 apply at the vector's precision (f32 stays
    f32), as admmsolver_tpu's _match_precision does."""
    rng = np.random.RandomState(0)
    for kind in KINDS:
        op = _ops(T, kind, (4, 4), 1)
        v = torch.as_tensor(rng.randn(4), dtype=torch.float32)
        out = op @ v
        assert out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), _dense(op) @ v.double().numpy(), atol=1e-5)
        moved = op.to("cpu")
        np.testing.assert_array_equal(_dense(moved), _dense(op))


# ---------------------------------------------------------------------
# PartialDiagonalMatrix (A ⊗ I) and InterleavedComplexDiagonalMatrix, the
# cases of tests/test_linop.py, each built in both packages
# ---------------------------------------------------------------------

def _cplx(rng, *shape):
    return rng.randn(*shape) + 1j * rng.randn(*shape)


def _struct(P, kind, seed):
    """Operators of tests/test_linop.py that involve the Kronecker and
    interleaved forms, in package ``P`` (J or T), from numpy data."""
    rng = np.random.RandomState(seed)
    wrap = jnp.asarray if P is J else (lambda a: a)
    table = {
        "pd3x3_r4": lambda: P.PartialDiagonalMatrix(P.DenseMatrix(wrap(_cplx(rng, 3, 3))), (4,)),
        "pd3x1_r4": lambda: P.PartialDiagonalMatrix(P.DenseMatrix(wrap(_cplx(rng, 3, 1))), (4,)),
        "pd1x3_r4": lambda: P.PartialDiagonalMatrix(P.DenseMatrix(wrap(_cplx(rng, 1, 3))), (4,)),
        "pd3x3_r22": lambda: P.PartialDiagonalMatrix(P.DenseMatrix(wrap(_cplx(rng, 3, 3))), (2, 2)),
        "pd_si": lambda: P.PartialDiagonalMatrix(P.ScaledIdentityMatrix(2, 3.0), (2,)),
        "pd_diag_rect": lambda: P.PartialDiagonalMatrix(
            P.DiagonalMatrix(wrap(_cplx(rng, 1)), (1, 2)), (2,)),
        "icd": lambda: P.InterleavedComplexDiagonalMatrix(wrap(rng.randn(6)), wrap(rng.randn(6))),
    }
    return table[kind]()


def _both(kind, seed):
    return _struct(J, kind, seed), _struct(T, kind, seed)


def _same(t, j, atol=TOL):
    assert type(t).__name__ == type(j).__name__, (type(t).__name__, type(j).__name__)
    assert tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(_dense(t), _dense(j), rtol=0, atol=atol)


@pytest.mark.parametrize("left,right", [
    ("pd3x3_r4", "dense12x4"), ("pd3x3_r4", "si12x4"), ("pd3x3_r4", "pd3x1_r4"),
    ("dense12x12", "pd3x1_r4"), ("diag12", "pd3x1_r4"), ("si12", "pd3x1_r4"),
    ("pd1x3_r4", "pd3x3_r4"), ("pd1x3_r4", "diag12"), ("pd1x3_r4", "si12"),
    ("dense4x12", "pd3x3_r4"), ("blockdiag12", "pd3x3_r22"), ("pd3x3_r22", "pd3x3_r22"),
    ("icd", "icd"), ("icd", "si12"), ("icd", "dense12x4"), ("icdH", "icd"),
])
def test_partial_and_interleaved_matmul_match_jax(left, right):
    """Products keep the JAX package's structure: Kronecker times
    Kronecker, a blockwise-constant diagonal times a Kronecker, complex
    diagonals times each other (a real product collapses to a diagonal)."""
    def make(P, name, seed):
        rng = np.random.RandomState(seed)
        wrap = jnp.asarray if P is J else (lambda a: a)
        extra = {
            "dense12x4": lambda: P.DenseMatrix(wrap(_cplx(rng, 12, 4))),
            "dense12x12": lambda: P.DenseMatrix(wrap(_cplx(rng, 12, 12))),
            "dense4x12": lambda: P.DenseMatrix(wrap(_cplx(rng, 4, 12))),
            "si12x4": lambda: P.ScaledIdentityMatrix((12, 4), 1 + 1j),
            "si12": lambda: P.ScaledIdentityMatrix(12, 1 + 1j),
            "diag12": lambda: P.DiagonalMatrix(wrap(np.ones(12))),
            "blockdiag12": lambda: P.DiagonalMatrix(wrap(np.repeat(rng.randn(3), 4))),
            "icdH": lambda: _struct(P, "icd", seed).conjugate().T,
        }
        return extra[name]() if name in extra else _struct(P, name, seed)

    out = {P: P.matmul(make(P, left, 1), make(P, right, 2)) for P in (J, T)}
    _same(out[T], out[J])
    np.testing.assert_allclose(_dense(out[T]), _dense(make(T, left, 1)) @ _dense(make(T, right, 2)),
                               atol=TOL)


@pytest.mark.parametrize("left", ["diag", "si", "pd", "dense", "blockdiag", "icd", "icdsi"])
@pytest.mark.parametrize("right", ["diag", "si", "pd", "dense", "icd"])
def test_partial_and_interleaved_add_match_jax(left, right):
    """Sums: scaled identity or a blockwise-constant diagonal plus a
    Kronecker stays Kronecker, complex diagonals stay interleaved."""
    def make(P, name, seed):
        rng = np.random.RandomState(seed)
        wrap = jnp.asarray if P is J else (lambda a: a)
        return {
            "diag": lambda: P.DiagonalMatrix(wrap(rng.randn(4))),
            "blockdiag": lambda: P.DiagonalMatrix(wrap(np.repeat(rng.randn(2), 2))),
            "si": lambda: P.ScaledIdentityMatrix(4, 1.5),
            "pd": lambda: P.PartialDiagonalMatrix(P.DenseMatrix(wrap(rng.randn(2, 2))), (2,)),
            "dense": lambda: P.DenseMatrix(wrap(rng.randn(4, 4))),
            "icd": lambda: P.InterleavedComplexDiagonalMatrix(wrap(rng.randn(2)), wrap(rng.randn(2))),
            "icdsi": lambda: P.ScaledIdentityMatrix(4, 0.7),
        }[name]()

    out = {P: P.add(make(P, left, 3), make(P, right, 4)) for P in (J, T)}
    _same(out[T], out[J])
    diff = make(T, left, 3) - make(T, right, 4)
    np.testing.assert_allclose(_dense(diff), _dense(make(T, left, 3)) - _dense(make(T, right, 4)),
                               atol=TOL)


@pytest.mark.parametrize("kind", ["pd3x3_r4", "pd3x3_r22", "pd_si", "icd"])
def test_partial_and_interleaved_unary_match_jax(kind):
    """Scale, transpose, conjugate, adjoint, inverse, Gram and effective
    diagonal of both forms against the JAX package and the dense oracle."""
    j, t = _both(kind, 5)
    D = _dense(t)
    for tt, jj, want in ((t * 2.5, j * 2.5, 2.5 * D), (t.T, j.T, D.T), (t.conj(), j.conj(), D.conj()),
                         (t.H, j.H, D.conj().T), (-t, -j, -D)):
        _same(tt, jj)
        np.testing.assert_allclose(_dense(tt), want, atol=TOL)
    _same(t.inv(), j.inv(), atol=1e-10)
    np.testing.assert_allclose(_dense(t.inv()) @ D, np.eye(D.shape[0]), atol=1e-10)
    np.testing.assert_allclose(_dense(t.gram()), D.conj().T @ D, atol=TOL)
    ed, edj = t.effective_diagonal(), j.effective_diagonal()
    assert (ed is None) == (edj is None)
    if ed is not None:
        np.testing.assert_allclose(ed.numpy(), np.asarray(edj), atol=TOL)
    assert t.hash() == _struct(T, kind, 5).hash()


@pytest.mark.parametrize("kind", ["pd3x3_r4", "pd3x1_r4", "pd1x3_r4", "pd_si", "pd_diag_rect", "icd"])
@pytest.mark.parametrize("rhs_cols", [None, 3])
def test_partial_and_interleaved_matvec_match_jax(kind, rhs_cols):
    """Matvecs with and without trailing batch columns (truncate/pad of a
    rectangular inner factor included), and the batched rows form."""
    j, t = _both(kind, 6)
    rng = np.random.RandomState(8)
    n = t.shape[1]
    v = _cplx(rng, n) if rhs_cols is None else _cplx(rng, n, rhs_cols)
    got = (t @ torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(j @ jnp.asarray(v)), rtol=0, atol=TOL)
    np.testing.assert_allclose(got, _dense(t) @ v, rtol=0, atol=TOL)
    rows = _cplx(rng, 5, n)
    np.testing.assert_allclose(t.matvec_rows(torch.as_tensor(rows)).numpy(), rows @ _dense(t).T,
                               rtol=0, atol=TOL)


def test_interleaved_hermitian_gram_collapses_to_diagonal():
    j, t = _both("icd", 2)
    d = t.re.numpy() + 1j * t.im.numpy()
    g = T.matmul(t.conjugate().T, t)
    assert isinstance(g, T.DiagonalMatrix)
    np.testing.assert_allclose(g.diagonals.numpy(), np.repeat(np.abs(d) ** 2, 2), atol=1e-13)
    assert g.effective_diagonal() is not None
    np.testing.assert_allclose(t.gram().diagonals.numpy(), np.repeat(np.abs(d) ** 2, 2), atol=1e-13)
    assert t.effective_diagonal() is None
    re_only = T.InterleavedComplexDiagonalMatrix(t.re, torch.zeros_like(t.re))
    np.testing.assert_allclose(re_only.effective_diagonal().numpy(), np.repeat(t.re.numpy(), 2))


def test_vecprod_pad():
    """Rectangular-diagonal helpers (reference test_matrix.py:247-257)."""
    from admmsolver_tpu.ops.linop import _pad_by_zero as jpad, _vecprod as jvec
    from admmsolver_tpu_torch.ops.linop import _pad_by_zero, _vecprod

    np.testing.assert_allclose(_vecprod(np.ones(1), np.ones(2), 3).numpy(), [1, 0, 0])
    np.testing.assert_allclose(_pad_by_zero(np.ones(1), 3).numpy(), [1, 0, 0])
    rng = np.random.RandomState(0)
    a, b = rng.randn(4), rng.randn(2)
    np.testing.assert_array_equal(_vecprod(a, b, 5).numpy(), np.asarray(jvec(a, b, 5)))
    np.testing.assert_array_equal(_pad_by_zero(b, 4).numpy(), np.asarray(jpad(b, 4)))
    with pytest.raises(ValueError):
        _pad_by_zero(a, 3)


@pytest.mark.parametrize("other", ["scalar", "blockdiag", "diag", "kron", "kron_rest4", "dense"])
def test_lane_operators_compose_kronecker(other):
    """Per-lane penalties with a Kronecker term: scalars and blockwise
    constant diagonals keep the ``kron`` form (B small factors), anything
    else densifies; every lane's operator equals the dense sum, applied to
    rows and to shared columns, and its inverse is the dense inverse."""
    rng = np.random.RandomState(3)
    B, m, r = 3, 4, 2
    n = m * r
    G = rng.randn(m, m)
    G = G @ G.T + m * np.eye(m)
    kron = T.LaneOperators.shared(T.PartialDiagonalMatrix(G, (r,))).scale(
        torch.as_tensor(rng.uniform(0.5, 2.0, B)))
    assert kron.kind == "kron" and kron.rest == r
    data = {
        "scalar": lambda: T.LaneOperators("scalar", torch.as_tensor(rng.uniform(1, 2, B)), n),
        "blockdiag": lambda: T.LaneOperators(
            "diag", torch.as_tensor(np.repeat(rng.uniform(1, 2, (B, m)), r, axis=1)), n),
        "diag": lambda: T.LaneOperators("diag", torch.as_tensor(rng.uniform(1, 2, (1, n))), n),
        "kron": lambda: T.LaneOperators.shared(T.PartialDiagonalMatrix(np.eye(m), (r,))),
        # another rest: G' ⊗ I_4 with a 2×2 factor
        "kron_rest4": lambda: T.LaneOperators.shared(
            T.PartialDiagonalMatrix(np.eye(2) + 0.1, (n // 2,))),
        "dense": lambda: T.LaneOperators("dense", torch.as_tensor(np.eye(n)[None] * 2.0), n),
    }[other]()
    total = kron + data
    want_kind = "kron" if other in ("scalar", "blockdiag", "kron") else "dense"
    assert total.kind == want_kind
    full = kron._as("dense") + data._as("dense") if data.kind != "scalar" \
        else kron._as("dense") + data.data[:, None, None] * torch.eye(n, dtype=torch.float64)
    v = torch.as_tensor(rng.randn(B, n))
    np.testing.assert_allclose(total.matvec_rows(v).numpy(),
                               (full @ v[..., None])[..., 0].numpy(), atol=1e-12)
    cols = torch.as_tensor(rng.randn(n, 2))
    np.testing.assert_allclose(total.matmat(cols).numpy(), (full @ cols).numpy(), atol=1e-12)
    from admmsolver_tpu_torch.models.objectivefunc import _inv_hpd

    inv = _inv_hpd(total)
    assert inv.kind == total.kind
    np.testing.assert_allclose(inv.matvec_rows(total.matvec_rows(v)).numpy(), v.numpy(),
                               atol=1e-10)


def _jax_operator(name):
    """One operator of each of the JAX package's six classes, from a seed."""
    rng = np.random.RandomState(12)
    return {
        "DenseMatrix": lambda: J.DenseMatrix(jnp.asarray(rng.randn(4, 6))),
        "ScaledIdentityMatrix": lambda: J.ScaledIdentityMatrix((5, 5), 2.5),
        "DiagonalMatrix": lambda: J.DiagonalMatrix(jnp.asarray(rng.randn(4)), (4, 6)),
        "PartialDiagonalMatrix": lambda: J.PartialDiagonalMatrix(
            J.DenseMatrix(jnp.asarray(rng.randn(3, 3))), (2,)),
        "InterleavedComplexDiagonalMatrix": lambda: J.InterleavedComplexDiagonalMatrix(
            jnp.asarray(rng.randn(6)), jnp.asarray(rng.randn(6))),
        "BandedMatrix": lambda: J.BandedMatrix((0, 1), jnp.asarray(rng.randn(2, 7)), (7, 8)),
    }[name]()


@pytest.mark.parametrize("name", ["DenseMatrix", "ScaledIdentityMatrix", "DiagonalMatrix",
                                  "PartialDiagonalMatrix", "InterleavedComplexDiagonalMatrix",
                                  "BandedMatrix"])
def test_to_dense_is_asmatrix_and_matches_jax(name):
    """Every operator class's ``to_dense`` is its own ``asmatrix`` (not the
    base class's) and equals the JAX package's ``to_dense`` of the same
    operator carried over by ``interop``."""
    from admmsolver_tpu_torch import interop

    j = _jax_operator(name)
    t = interop._operator(j, "cpu", None)
    assert type(t).__name__ == name and type(t).to_dense is T.MatrixBase.to_dense
    dense = t.to_dense()
    assert isinstance(dense, torch.Tensor) and torch.equal(dense, t.asmatrix())
    np.testing.assert_allclose(dense.numpy(), np.asarray(j.to_dense()), rtol=0, atol=TOL)


def test_to_dense_of_the_base_class_is_not_implemented():
    """The abstract base has no dense form, in either package."""
    for P in (J, T):
        with pytest.raises(NotImplementedError):
            P.MatrixBase().to_dense()
