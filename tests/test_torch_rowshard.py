"""Large-N operator sharding of the port, mirroring tests/test_rowshard.py.

Two gloo host ranks (this file run as ``__main__``, see tests/_torch_dist.py)
run ``sharded_gram`` and ``LargeNTwoBlockSolver`` with the long axis split
over them.  Against the dense products and the JAX package's ``sharded_gram``
on its 8-device mesh to 1e-12; the large-N solve at world sizes 1 and 2
against the JAX package's ``LargeNTwoBlockSolver`` and the port's
``SimpleOptimizer`` with the tolerances of tests/test_rowshard.py: x within
1e-9, mu to 1e-12 relative, the primal history to 1e-8, equal iteration
counts.  The ranks build their basis on their own (a sharded Gram, rank 0's
eigh broadcast) or take the JAX solver's through ``large_n_from_jax``.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

from _torch_dist import run_ranks, worker_main

torch.set_num_threads(1)


def _gram_data():
    rng = np.random.RandomState(0)
    A, y = rng.randn(32, 24), rng.randn(32)
    return A, y, A + 1j * rng.randn(32, 24), y + 1j * rng.randn(32)


def _l1_data():
    rng = np.random.RandomState(1)
    M, N = 24, 128
    A = rng.randn(M, N)
    xt = np.zeros(N)
    xt[rng.choice(N, 6, replace=False)] = rng.randn(6)
    return A, A @ xt


def _nonneg_data():
    rng = np.random.RandomState(2)
    A = rng.randn(20, 64)
    xt = np.abs(rng.randn(64)) * (rng.rand(64) < 0.2)
    return A, A @ xt


def _fields(res, allgather):
    return {"x0": allgather(res.x0), "x1": allgather(res.x1), "mu": float(res.mu),
            "it": res.iterations, "conv": res.converged,
            "pb": np.asarray(res.primal_residual)[:res.iterations]}


def _large_n(mesh, basis=None):
    """The l1 solve (on the given JAX basis) and the nonneg solve; x gathered."""
    from admmsolver_tpu_torch.interop import large_n_from_jax
    from admmsolver_tpu_torch.parallel import LargeNTwoBlockSolver, process_allgather

    gather = lambda t: process_allgather(t, mesh).numpy()
    A, y = _l1_data()
    sol = (LargeNTwoBlockSolver(A, mesh, prox="l1", alpha1=0.1) if basis is None
           else large_n_from_jax(basis, mesh))
    out = {"l1": _fields(sol.solve(y, niter=300, rtol=0.0), gather),
           "rows": (tuple(sol.Ac.shape), tuple(sol.U.shape))}
    if basis is None:
        A, y = _nonneg_data()
        sol = LargeNTwoBlockSolver(A, mesh, prox="nonneg")
        out["nonneg"] = _fields(sol.solve(y, niter=8000, atol=1e-9), gather)
    return out


def _flat(prefix, fields):
    return {f"{prefix}.{k}": np.asarray(v) for k, v in fields.items()}


def work(mesh, outdir):
    """One rank: the Grams, both solves, and the l1 solve on the JAX basis."""
    from admmsolver_tpu_torch.parallel import sharded_gram

    A, y, Ac, yc = _gram_data()
    out = {}
    for name, (a, b) in (("gram", (A, y)), ("gram_c", (Ac, yc))):
        G, r = sharded_gram(a, b, mesh)
        out[f"{name}.G"], out[f"{name}.r"] = G.numpy(), r.numpy()
    own = _large_n(mesh)
    with np.load(os.path.join(outdir, "jax_basis.npz")) as z:
        basis = types.SimpleNamespace(**{k: z[k] for k in ("lam", "U", "Ac")},
                                      prox="l1", alpha_ls=1.0, alpha1=0.1)
    out.update(_flat("l1", own["l1"]), **_flat("nonneg", own["nonneg"]),
               **_flat("from_jax", _large_n(mesh, basis)["l1"]),
               rows=np.array(own["rows"]))
    return out


@pytest.fixture(scope="module")
def jax_solvers():
    """The JAX package's solvers on its 8-device mesh, their l1 and nonneg
    results."""
    from admmsolver_tpu.parallel import make_mesh
    from admmsolver_tpu.parallel.rowshard import LargeNTwoBlockSolver

    mesh = make_mesh(axis_name="n")
    A, y = _l1_data()
    l1 = LargeNTwoBlockSolver(A, mesh, prox="l1", alpha1=0.1)
    A, y2 = _nonneg_data()
    nonneg = LargeNTwoBlockSolver(A, mesh, prox="nonneg")
    return {"solver": l1, "l1": _fields(l1.solve(y, niter=300, rtol=0.0), np.asarray),
            "nonneg": _fields(nonneg.solve(y2, niter=8000, atol=1e-9), np.asarray)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_solvers):
    outdir = str(tmp_path_factory.mktemp("ranks"))
    s = jax_solvers["solver"]
    np.savez(os.path.join(outdir, "jax_basis.npz"), lam=np.asarray(s.lam), U=np.asarray(s.U),
             Ac=np.asarray(s.Ac))
    return run_ranks(__file__, outdir)


@pytest.fixture(scope="module")
def one_rank(jax_solvers):
    """World size 1 in this process (a mesh with no group)."""
    from admmsolver_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices="cpu")
    own = _large_n(mesh)
    own["from_jax"] = _large_n(mesh, jax_solvers["solver"])["l1"]
    return own


def _by_world(world, ranks, one_rank, name):
    if world == 1:
        return one_rank[name]
    return {k[len(name) + 1:]: v for k, v in ranks[0].items() if k.startswith(name + ".")}


def _same(got, want, xtol=1e-9):
    np.testing.assert_allclose(got["x0"], want["x0"], rtol=0, atol=xtol)
    np.testing.assert_allclose(got["x1"], want["x1"], rtol=0, atol=xtol)
    np.testing.assert_allclose(float(got["mu"]), float(want["mu"]), rtol=1e-12)
    assert int(got["it"]) == int(want["it"])
    np.testing.assert_allclose(got["pb"], want["pb"], rtol=1e-8, atol=1e-13)


@pytest.mark.parametrize("kind", ["real", "complex"])
def test_sharded_gram_matches_dense(ranks, kind):
    A, y, Ac, yc = _gram_data()
    if kind == "complex":
        A, y, name = Ac, yc, "gram_c"
    else:
        name = "gram"
    for out in ranks:   # the sums are on every rank
        np.testing.assert_allclose(out[f"{name}.G"], A.conj().T @ A, rtol=0, atol=1e-12)
        np.testing.assert_allclose(out[f"{name}.r"], A.conj().T @ y, rtol=0, atol=1e-12)


def test_sharded_gram_matches_jax(ranks):
    from admmsolver_tpu.parallel import make_mesh
    from admmsolver_tpu.parallel.rowshard import sharded_gram

    A, y, _, _ = _gram_data()
    G, r = sharded_gram(A, y, make_mesh(axis_name="n"))
    np.testing.assert_allclose(ranks[1]["gram.G"], np.asarray(G), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ranks[1]["gram.r"], np.asarray(r), rtol=0, atol=1e-12)


def test_sharded_gram_rows_must_divide_the_mesh():
    from admmsolver_tpu_torch.parallel import sharded_gram
    from admmsolver_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(0, 3, torch.device("cpu"), ("n",))
    A, y, _, _ = _gram_data()
    with pytest.raises(AssertionError, match="rows 32 must divide the mesh size 3"):
        sharded_gram(A, y, mesh)
    with pytest.raises(ValueError, match="is not an axis"):
        sharded_gram(A[:30], y[:30], mesh, axis_name="batch")


@pytest.mark.parametrize("world", [1, 2])
def test_large_n_l1_matches_jax(ranks, one_rank, jax_solvers, world):
    """Feature-sharded basis pursuit == the JAX package's, trajectory for
    trajectory (the same count through adaptive-mu boundaries)."""
    _same(_by_world(world, ranks, one_rank, "l1"), jax_solvers["l1"])


def test_large_n_l1_matches_simple_optimizer(ranks):
    import admmsolver_tpu_torch as T

    A, y = _l1_data()
    N = A.shape[1]
    o = T.SimpleOptimizer(T.Model([T.LeastSquares(1.0, A, y), T.L1Regularizer(0.1, N)],
                                  [(1, 0, T.identity(N), T.identity(N))]), device="cpu")
    o.solve(300, rtol=0.0)
    _same(_by_world(2, ranks, None, "l1"),
          {"x0": o.x[0].numpy(), "x1": o.x[1].numpy(), "mu": float(o.mu[0]), "it": 300,
           "pb": np.array(o.primal_residual_history)})


@pytest.mark.parametrize("name", ["l1", "nonneg"])
def test_large_n_two_ranks_equal_one_rank(ranks, one_rank, name):
    _same(_by_world(2, ranks, one_rank, name), one_rank[name])


@pytest.mark.parametrize("world", [1, 2])
def test_large_n_nonneg_and_early_exit(ranks, one_rank, jax_solvers, world):
    import admmsolver_tpu_torch as T

    got = _by_world(world, ranks, one_rank, "nonneg")
    assert bool(got["conv"]) and int(got["it"]) < 8000 and got["x1"].min() >= 0.0
    _same(got, jax_solvers["nonneg"])
    A, y = _nonneg_data()
    N = A.shape[1]
    o = T.SimpleOptimizer(T.Model([T.LeastSquares(1.0, A, y), T.NonNegativePenalty(N)],
                                  [(1, 0, T.identity(N), T.identity(N))]), device="cpu")
    o.solve(int(got["it"]), rtol=0.0)
    np.testing.assert_allclose(got["x0"], o.x[0].numpy(), rtol=0, atol=1e-8)


@pytest.mark.parametrize("world", [1, 2])
def test_large_n_from_jax_solves_on_the_jax_basis(ranks, one_rank, jax_solvers, world):
    _same(_by_world(world, ranks, one_rank, "from_jax"), jax_solvers["l1"], xtol=1e-10)


def test_each_rank_holds_its_rows(ranks, one_rank):
    """Ac and U: N/W rows a rank (R = M = 24 for this full-rank A)."""
    np.testing.assert_array_equal(ranks[0]["rows"], [[64, 24], [64, 24]])
    assert one_rank["rows"] == ((128, 24), (128, 24))


def test_large_n_checks_and_result_to_numpy():
    from admmsolver_tpu_torch.interop import large_n_result_to_numpy
    from admmsolver_tpu_torch.parallel import LargeNTwoBlockSolver, make_mesh
    from admmsolver_tpu_torch.parallel.mesh import Mesh

    mesh = make_mesh(devices="cpu")
    A, y = _l1_data()
    with pytest.raises(AssertionError, match="wide A"):
        LargeNTwoBlockSolver(A.T, mesh)
    with pytest.raises(AssertionError, match="N=128 must divide the mesh size 3"):
        LargeNTwoBlockSolver(A, Mesh(0, 3, torch.device("cpu"), ("n",)))
    with pytest.raises(AssertionError, match="prox"):
        LargeNTwoBlockSolver(A, mesh, prox="l2")
    out = large_n_result_to_numpy(LargeNTwoBlockSolver(A, mesh).solve(y, niter=7, rtol=0.0))
    assert out["x0"].shape == (128,) and out["iterations"] == 7 and not out["converged"]
    assert out["primal_residual"].dtype == np.float64 and out["primal_residual"].shape == (7,)


if __name__ == "__main__":
    worker_main(work)
    sys.exit(0)
