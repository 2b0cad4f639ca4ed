"""The fused two-block chunk: the port's plain version against the JAX
Pallas kernel, run in interpret mode as tests/test_kernels.py runs it on
the CPU.  The CUDA kernel is held against the plain version on a card in
tests/test_torch_gpu.py.

Tolerance 5e-4 absolute, the short-horizon bound of tests/test_kernels.py:
the two sides take the same f32 sums in another order, and that noise
random-walks through the prox's switching over 21 iterations."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from admmsolver_tpu.ops.kernels import fused_two_block_chunk as jax_chunk
from admmsolver_tpu_torch.ops.kernels import (fused_two_block_chunk,
                                              fused_two_block_chunk_reference)

torch.set_num_threads(1)

ATOL = 5e-4
PROX = ("l1", "l1_even", "nonneg", "nonneg_even")


def _inputs(thin, prox, B=8, N=128, seed=0):
    """Numpy chunk inputs (U, Ut, dinv, acy, mu, thr, x0, x1, h) from a
    basis-pursuit-like problem: the thin basis of a wide A (R=64) or the
    full eigenbasis of a tall one (R=N)."""
    rng = np.random.RandomState(seed)
    A = rng.randn(64 if thin else 192, N)
    if thin:
        lam, W = np.linalg.eigh(A @ A.T)
        U = A.T @ W / np.sqrt(lam)
    else:
        lam, U = np.linalg.eigh(A.T @ A)
    mu = rng.uniform(0.5, 2.0, (B, 1))
    dinv = 1.0 / (lam[None, :] + mu)
    if thin:
        dinv = dinv - 1.0 / mu
    thr = 0.05 / mu if prox.startswith("l1") else np.zeros_like(mu)
    acy, x0, x1, h = (s * rng.randn(B, N) for s in (1.0, 0.3, 0.3, 1.0))
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return [f32(a) for a in (U, U.T, dinv, acy, mu, thr, x0, x1, h)]


@pytest.mark.parametrize("thin", [True, False], ids=["thin", "full"])
@pytest.mark.parametrize("prox", PROX)
def test_plain_version_matches_jax_kernel(prox, thin):
    args = _inputs(thin, prox)
    want = jax_chunk(*map(jnp.asarray, args), n_iters=21, prox=prox,
                     tile_b=8, interpret=True, thin=thin)
    launches = fused_two_block_chunk.launches
    got = fused_two_block_chunk(*map(torch.as_tensor, args), n_iters=21,
                                prox=prox, thin=thin)
    assert fused_two_block_chunk.launches == launches  # CPU: no kernel launch
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)
    if prox.endswith("_even"):
        assert np.all(got[1].numpy()[:, 1::2] == 0)


def test_chunk_returns_previous_iterate():
    """x0_prev is the x0 the last iteration started from; zero
    iterations return the input state."""
    args = [torch.as_tensor(a) for a in _inputs(True, "l1")]
    x0a, _, _, _ = fused_two_block_chunk(*args, n_iters=3, prox="l1", thin=True)
    state = args[6:]
    x0b, x1b, hb, prevb = fused_two_block_chunk(*args[:6], x0a, *state[1:], n_iters=0,
                                                prox="l1", thin=True)
    assert torch.equal(x0b, x0a) and torch.equal(prevb, x0a)
    two = fused_two_block_chunk(*args, n_iters=2, prox="l1", thin=True)
    three = fused_two_block_chunk(*args, n_iters=3, prox="l1", thin=True)
    assert torch.equal(three[3], two[0])


def test_chunk_rejects_bad_arguments():
    args = [torch.as_tensor(a) for a in _inputs(True, "l1")]
    with pytest.raises(ValueError, match="prox"):
        fused_two_block_chunk(*args, n_iters=1, prox="l2")
    with pytest.raises(TypeError, match="float32"):
        fused_two_block_chunk(*args[:8], args[8].double(), n_iters=1)
    with pytest.raises(ValueError, match="dinv"):
        fused_two_block_chunk(*args[:2], args[2][:, :-1], *args[3:], n_iters=1)
    with pytest.raises(ValueError, match="n_iters"):
        fused_two_block_chunk(*args, n_iters=-1)
