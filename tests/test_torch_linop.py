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
