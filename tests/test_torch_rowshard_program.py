"""``LargeNTwoBlockSolver``'s solve program on the CPU (no graph: each chunk
runs directly), at world sizes 1 and 2, against the JAX package's one
``shard_map``-ped ``while_loop`` (``LargeNTwoBlockSolver._compiled``).

Both packages solve on the JAX solver's thin basis (``large_n_from_jax``;
the two ranks read it from a file), so that they differ only in the order
of their sums.  Cases: float32 A (16 x 64) through four halvings of the
penalty to an exit inside a chunk, where the histories and mu stay float32
as in the JAX package, x within 1e-4 of max|x| (float32 sums in another
order) and equal iteration counts; float64 A (16 x 64) with a remainder
chunk (250 iterations in chunks of 100) and with an exit inside a chunk at
rtol 1e-8 (chunks of 30): x, h and the histories to 1e-12; the nonneg prox
(A 20 x 64, 300 iterations): x and h to 1e-10 (3.5e-12 measured), the
histories to 1e-12; mu equal, equal counts and flags in every case.  Two
ranks run this file as ``__main__`` (tests/_torch_dist.py).  Then the cache (another rtol takes the same program), the host's reads of
the done flag (none at rtol = atol = 0, one a chunk at most otherwise) and
the declared rule of which meshes capture their chunks.
"""
import os
import sys
import types

import numpy as np
import pytest
import torch

from _torch_dist import run_ranks, worker_main

torch.set_num_threads(1)

# name -> (dtype, prox, alpha1, seed, (M, N), solve keywords, x tolerance).
# The float32 case's exit is decisive: a slow one can move by a few
# iterations with the order of float32 sums (seen at other seeds and knobs).
CASES = {
    "f32_exit": ("float32", "l1", 0.5, 21, (16, 64),
                 dict(niter=3000, rtol=1e-3, interval_update_mu=10, mu0=8.0), 1e-4),
    "remainder": ("float64", "l1", 0.1, 13, (16, 64),
                  dict(niter=250, rtol=0.0, interval_update_mu=100), 1e-12),
    "exit_mid_chunk": ("float64", "l1", 0.1, 13, (16, 64),
                       dict(niter=5000, rtol=1e-8, interval_update_mu=30), 1e-12),
    "nonneg": ("float64", "nonneg", 0.1, 14, (20, 64),
               dict(niter=300, rtol=0.0, interval_update_mu=100), 1e-10),
}


def _data(name):
    dtype, prox, _, seed, (M, N), _, _ = CASES[name]
    rng = np.random.RandomState(seed)
    A = rng.randn(M, N)
    if prox == "l1":
        xt = np.zeros(N)
        xt[rng.choice(N, 4, replace=False)] = rng.randn(4)
    else:
        xt = np.abs(rng.randn(N)) * (rng.rand(N) < 0.2)
    return A.astype(dtype), (A @ xt).astype(dtype)


def _fields(res, gather):
    return {"x0": gather(res.x0), "x1": gather(res.x1), "h": gather(res.h),
            "mu": np.asarray(res.mu), "it": res.iterations, "conv": res.converged,
            "pb": np.asarray(res.primal_residual), "db": np.asarray(res.dual_residual)}


def _port_solves(mesh, bases):
    """Every case on ``mesh``, each on its JAX basis; x and h gathered."""
    from admmsolver_tpu_torch.interop import large_n_from_jax
    from admmsolver_tpu_torch.parallel import process_allgather

    gather = lambda t: process_allgather(t, mesh).numpy()
    out = {}
    for name in CASES:
        _, y = _data(name)
        res = large_n_from_jax(bases[name], mesh).solve(y, **CASES[name][5])
        out[name] = _fields(res, gather)
    return out


def _basis(z, name):
    return types.SimpleNamespace(**{k: z[k] for k in ("lam", "U", "Ac")}, prox=CASES[name][1],
                                 alpha_ls=1.0, alpha1=CASES[name][2])


def work(mesh, outdir):
    """One rank: every case on the JAX bases written by the test process."""
    bases = {}
    for name in CASES:
        with np.load(os.path.join(outdir, f"{name}.npz")) as z:
            bases[name] = _basis(z, name)
    return {f"{name}.{k}": np.asarray(v) for name, fields in _port_solves(mesh, bases).items()
            for k, v in fields.items()}


@pytest.fixture(scope="module")
def jax_solves():
    """The JAX package's solvers of the cases on its 8-device mesh, and
    their results."""
    from admmsolver_tpu.parallel import make_mesh
    from admmsolver_tpu.parallel.rowshard import LargeNTwoBlockSolver

    mesh = make_mesh(axis_name="n")
    out = {}
    for name, (_, prox, alpha1, _, _, kw, _) in CASES.items():
        A, y = _data(name)
        solver = LargeNTwoBlockSolver(A, mesh, prox=prox, alpha1=alpha1)
        out[name] = (solver, _fields(solver.solve(y, **kw), np.asarray))
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_solves):
    outdir = str(tmp_path_factory.mktemp("ranks"))
    for name, (s, _) in jax_solves.items():
        np.savez(os.path.join(outdir, f"{name}.npz"), lam=np.asarray(s.lam), U=np.asarray(s.U),
                 Ac=np.asarray(s.Ac))
    out = run_ranks(__file__, outdir)[0]
    return {name: {k[len(name) + 1:]: v for k, v in out.items() if k.startswith(name + ".")}
            for name in CASES}


@pytest.fixture(scope="module")
def one_rank(jax_solves):
    """World size 1 in this process (a mesh with no group)."""
    from admmsolver_tpu_torch.parallel import make_mesh

    return _port_solves(make_mesh(devices="cpu"), {n: s for n, (s, _) in jax_solves.items()})


@pytest.mark.parametrize("world", [1, 2])
@pytest.mark.parametrize("name", sorted(CASES))
def test_large_n_program_matches_jax(ranks, one_rank, jax_solves, name, world):
    got = (one_rank if world == 1 else ranks)[name]
    want = jax_solves[name][1]
    dtype = CASES[name][0]
    for k in ("pb", "db", "mu"):
        assert got[k].dtype == want[k].dtype == np.dtype(dtype), k
    assert int(got["it"]) == int(want["it"]) and bool(got["conv"]) == bool(want["conv"])
    np.testing.assert_array_equal(got["mu"], want["mu"])
    n = int(want["it"])
    tol = CASES[name][6]
    if dtype == "float32":
        # four halvings of mu, then the exit inside a chunk
        assert float(want["mu"]) == 8.0 / 16 and want["conv"] and (n - 1) % 10
        for k in ("x0", "x1"):
            np.testing.assert_allclose(got[k], want[k], rtol=0,
                                       atol=tol * float(np.abs(want[k]).max()))
        return
    for k in ("x0", "x1", "h"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=tol)
    for k in ("pb", "db"):
        np.testing.assert_allclose(got[k][:n], want[k][:n], rtol=0, atol=1e-12)
        assert np.isnan(got[k][n:]).all() and np.isnan(want[k][n:]).all()
    if name == "exit_mid_chunk":
        assert want["conv"] and n < 5000 and (n - 1) % 30


def _own_solver(name):
    from admmsolver_tpu_torch.parallel import LargeNTwoBlockSolver, make_mesh

    A, y = _data(name)
    return LargeNTwoBlockSolver(A, make_mesh(devices="cpu"), prox=CASES[name][1],
                                alpha1=CASES[name][2]), y


def test_cached_program_takes_another_rtol():
    """A second solve of the same (niter, interval) with another rtol and mu0
    takes the same program and equals a fresh solver's solve bitwise."""
    sol, y = _own_solver("exit_mid_chunk")
    sol.solve(y, niter=2000, rtol=1e-6, interval_update_mu=30)
    (program,) = sol._programs.values()
    got = sol.solve(y, niter=2000, rtol=1e-9, mu0=2.0, interval_update_mu=30)
    assert list(sol._programs.values()) == [program]
    want = _own_solver("exit_mid_chunk")[0].solve(y, niter=2000, rtol=1e-9, mu0=2.0,
                                                  interval_update_mu=30)
    assert got.iterations == want.iterations and got.converged == want.converged
    for a, b in ((got.x0, want.x0), (got.x1, want.x1), (got.h, want.h), (got.mu, want.mu),
                 (got.primal_residual, want.primal_residual)):
        assert torch.equal(a.nan_to_num(), b.nan_to_num())
    sol.solve(y, niter=2001, rtol=1e-9, interval_update_mu=30)
    assert len(sol._programs) == 2


def test_which_meshes_capture(monkeypatch):
    """A CUDA device captures its chunks with no group or a NCCL one; a gloo
    group (collectives on the host), the CPU and CAPTURE_CHUNKS off run
    them without graphs."""
    import torch.distributed as dist

    from admmsolver_tpu_torch.parallel import LargeNTwoBlockSolver, batch
    from admmsolver_tpu_torch.parallel.mesh import Mesh

    def on(mesh):
        sol = LargeNTwoBlockSolver.__new__(LargeNTwoBlockSolver)
        sol.mesh, sol._programs = mesh, batch._ProgramCache(mesh.device)
        return sol

    cuda = torch.device("cuda", 0)
    assert on(Mesh(0, 1, cuda, ("n",))).captures
    assert not on(Mesh(0, 1, torch.device("cpu"), ("n",))).captures
    for backend, captures in (("nccl", True), ("gloo", False)):
        monkeypatch.setattr(dist, "get_backend", lambda group, b=backend: b)
        assert on(Mesh(0, 1, cuda, ("n",), group=object())).captures == captures
    monkeypatch.setattr(batch, "CAPTURE_CHUNKS", False)
    assert not on(Mesh(0, 1, cuda, ("n",))).captures


if __name__ == "__main__":
    worker_main(work)
    sys.exit(0)
