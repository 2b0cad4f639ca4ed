"""Sharded batch solves of the port, mirroring tests/test_sharding.py.

Two gloo host ranks (this file run as ``__main__``, see tests/_torch_dist.py)
solve the cases of tests/test_sharding.py with ``BatchedSolver(...,
sharding=batch_sharding(mesh))``; the test process reassembles the lanes of
both ranks by their global indices and holds them against the JAX package's
solves on its 8-device mesh: x, h and mu within 1e-10, equal iteration counts
and flags.  Where a rank's solve can be repeated in one process with the same
local shapes (the mixed recipe, the resumable solve) the two are bitwise
equal.  Also: the scheduler over a sharded solver, and per-rank checkpoint
shards that the JAX package's loader reassembles.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from _torch_dist import free_port, run_ranks, worker_main

TOL = 1e-10
FIELDS = ("x0", "x1", "h0", "mu", "it", "conv")


def _bp(P, A, y, alpha=0.1):
    N = A.shape[1]
    return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(alpha, N)],
                   [(1, 0, P.identity(N), P.identity(N))])


def _cases():
    """name -> (seed data, solve arguments) of the batch cases."""
    rng = np.random.RandomState(21)
    A, ys = rng.randn(10, 24), rng.randn(16, 10)
    cases = {"sharded": (A, {(0, "y"): ys}, dict(niter=150))}
    # one hard lane on the last rank, easy lanes elsewhere
    rng = np.random.RandomState(22)
    A = rng.randn(8, 12)
    ys = np.tile(0.1 * (A @ np.ones(12)), (8, 1))
    ys[-1] = 50 * rng.randn(8)
    alphas = np.full(8, 1e-3)
    alphas[-1] = 10.0
    cases["convergence"] = (A, {(0, "y"): ys, (1, "alpha"): alphas},
                            dict(niter=3000, rtol=1e-8))
    rng = np.random.RandomState(23)
    A, ys = rng.randn(6, 10), rng.randn(5, 6)
    cases["uneven"] = (A, {(0, "y"): ys}, dict(niter=50))
    rng = np.random.RandomState(3)
    As, ys = rng.randn(16, 6, 10), rng.randn(16, 6)
    cases["operators"] = (As[0], {(0, "A"): As, (0, "y"): ys}, dict(niter=60))
    rng = np.random.RandomState(17)
    A, ys = rng.randn(8, 16), rng.randn(16, 8)
    cases["checkpoint"] = (A, {(0, "y"): ys}, dict(niter=40, rtol=0))
    return cases


def _path_case():
    rng = np.random.RandomState(22)
    A, y = rng.randn(8, 16), rng.randn(8)
    lams = np.logspace(0, -2, 16)
    return A, lams, dict(overrides={(0, "y"): np.broadcast_to(y, (16, 8))}, group_size=8,
                         niter=100, rtol=1e-8)


def _scan_case():
    rng = np.random.RandomState(32)
    As, ys = rng.randn(5, 6, 10), rng.randn(5, 6)
    return As, {(0, "A"): As, (0, "y"): ys}, dict(
        group_size=2, niter=60, mu0=np.linspace(0.5, 2.0, 5),
        x0=tuple(0.1 * rng.randn(5, 10) for _ in range(2)))


def _streams():
    """(name, A, ys, scheduler arguments): tests/test_scheduler.py's budget
    stream and a converging stream."""
    rng = np.random.RandomState(6)
    A, ys = rng.randn(8, 16), rng.randn(5, 8)
    rng = np.random.RandomState(0)
    A2, ys2 = rng.randn(10, 24), rng.randn(11, 10)
    return [("budget", A, ys, dict(batch_size=2, chunk_iters=50, niter_max=100, rtol=0.0)),
            ("stream", A2, ys2, dict(batch_size=4, chunk_iters=100, niter_max=3000,
                                     rtol=1e-8))]


def _put(out, name, res):
    out.update({f"{name}.x0": res.x[0].numpy(), f"{name}.x1": res.x[1].numpy(),
                f"{name}.h0": res.h[0].numpy(), f"{name}.mu": res.mu.numpy(),
                f"{name}.it": res.iterations.numpy(), f"{name}.conv": res.converged.numpy(),
                f"{name}.lanes": res.lane_index.numpy()})


def work(mesh, outdir):
    """One rank: every case through the sharded solver."""
    import admmsolver_tpu_torch as T
    from admmsolver_tpu_torch.parallel import BatchedSolver, ScenarioScheduler, batch_sharding
    from admmsolver_tpu_torch.utils.checkpoint import save_batch_result_local

    shard = batch_sharding(mesh)
    out = {}
    for name, (A, ov, kw) in _cases().items():
        ov0 = {k: v[0] for k, v in ov.items() if k[1] in ("y", "A")}
        res = BatchedSolver(_bp(T, ov0.get((0, "A"), A), ov[(0, "y")][0]),
                            sharding=shard).solve(ov, **kw)
        _put(out, name, res)
        if name == "checkpoint":
            save_batch_result_local(os.path.join(outdir, f"ckpt_p{mesh.rank}.npz"), res)
    A, lams, kw = _path_case()
    _put(out, "path", BatchedSolver(_bp(T, A, kw["overrides"][(0, "y")][0]),
                                    sharding=shard).solve_path((1, "alpha"), lams, **kw))
    As, ov, kw = _scan_case()
    _put(out, "scan", BatchedSolver(_bp(T, As[0], ov[(0, "y")][0]),
                                    sharding=shard).solve_scan(ov, **kw))
    for name, A, ys, kw in _streams():
        sched = ScenarioScheduler(BatchedSolver(_bp(T, A, ys[0]), sharding=shard), **kw)
        for mode in ("run", "run_compiled"):
            rs = getattr(sched, mode)({(0, "y"): y} for y in ys)
            out[f"{name}.{mode}.sid"] = np.array([r.scenario_id for r in rs])
            out[f"{name}.{mode}.x0"] = np.stack([r.x[0] for r in rs])
            out[f"{name}.{mode}.it"] = np.array([r.iterations for r in rs])
            out[f"{name}.{mode}.conv"] = np.array([r.converged for r in rs])
            out[f"{name}.{mode}.mu"] = np.stack([r.final_mu for r in rs])
    # the mixed recipe and the resumable solve, each beside a one-process
    # solve of this rank's lanes
    A, ov, _ = _cases()["sharded"]
    sharded = BatchedSolver(_bp(T, A, ov[(0, "y")][0]), sharding=shard)
    lanes = shard.lanes(16)
    mine = {k: v[lanes.start:lanes.stop] for k, v in ov.items()}
    one = BatchedSolver(_bp(T, A, ov[(0, "y")][0]), device="cpu")
    _put(out, "mixed", sharded.solve(ov, niter=120, recipe="mixed", rtol=1e-10))
    res = one.solve(mine, niter=120, recipe="mixed", rtol=1e-10)
    _put(out, "mixed_one", dataclasses.replace(
        res, lane_index=torch.arange(lanes.start, lanes.stop)))
    path = os.path.join(outdir, "resume.npz")
    sharded.solve_resumable(path, ov, checkpoint_every=50, niter=50)
    _put(out, "resumed", sharded.solve_resumable(path, ov, checkpoint_every=50, niter=150))
    _put(out, "uninterrupted", sharded.solve_resumable(
        os.path.join(outdir, "straight.npz"), ov, checkpoint_every=50, niter=150))
    return out


def _whole(ranks, name):
    """The lanes of both ranks of one case, in global order."""
    idx = np.concatenate([r[f"{name}.lanes"] for r in ranks])
    np.testing.assert_array_equal(np.sort(idx), np.arange(idx.size))
    order = np.argsort(idx)
    return {f: np.concatenate([r[f"{name}.{f}"] for r in ranks])[order] for f in FIELDS}


def _jax_fields(res):
    return {"x0": np.asarray(res.x[0]), "x1": np.asarray(res.x[1]), "h0": np.asarray(res.h[0]),
            "mu": np.asarray(res.mu), "it": np.asarray(res.iterations),
            "conv": np.asarray(res.converged)}


def _same(got, want, tol=TOL):
    for f in ("x0", "x1", "h0"):
        np.testing.assert_allclose(got[f], want[f], rtol=0, atol=tol, err_msg=f)
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-12)
    np.testing.assert_array_equal(got["it"], want["it"])
    np.testing.assert_array_equal(got["conv"], want["conv"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("ranks"))
    return outdir, run_ranks(__file__, outdir)


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's solves of every case on its 8-device mesh."""
    import admmsolver_tpu as J
    from admmsolver_tpu.parallel import (BatchedSolver, ScenarioScheduler, batch_sharding,
                                         make_mesh)

    shard = batch_sharding(make_mesh())
    out = {}
    for name, (A, ov, kw) in _cases().items():
        ov0 = {k: v[0] for k, v in ov.items() if k[1] in ("y", "A")}
        out[name] = _jax_fields(BatchedSolver(_bp(J, ov0.get((0, "A"), A), ov[(0, "y")][0]),
                                              sharding=shard).solve(ov, **kw))
    A, lams, kw = _path_case()
    out["path"] = _jax_fields(BatchedSolver(_bp(J, A, kw["overrides"][(0, "y")][0])).solve_path(
        (1, "alpha"), lams, **kw))
    As, ov, kw = _scan_case()
    out["scan"] = _jax_fields(BatchedSolver(_bp(J, As[0], ov[(0, "y")][0])).solve_scan(ov, **kw))
    for name, A, ys, kw in _streams():
        rs = ScenarioScheduler(BatchedSolver(_bp(J, A, ys[0])), **kw).run(
            {(0, "y"): y} for y in ys)
        out[name] = {"sid": np.array([r.scenario_id for r in rs]),
                     "x0": np.stack([np.asarray(r.x[0]) for r in rs]),
                     "it": np.array([r.iterations for r in rs]),
                     "conv": np.array([r.converged for r in rs]),
                     "mu": np.stack([np.asarray(r.final_mu) for r in rs])}
    return out


@pytest.mark.parametrize("name", ["sharded", "operators", "checkpoint"])
def test_sharded_matches_jax(ranks, jax_results, name):
    """Even batches (tests/test_sharding.py: sharded against unsharded, per-
    instance operators; tests/test_checkpoint.py's batch): each rank holds its
    contiguous half."""
    _, rs = ranks
    for r, out in enumerate(rs):
        np.testing.assert_array_equal(out[f"{name}.lanes"], np.arange(8 * r, 8 * (r + 1)))
    _same(_whole(rs, name), jax_results[name])


def test_sharded_global_convergence_agreement(ranks, jax_results):
    """The loop exits only when ALL ranks' lanes are done: the hard lane on
    the last rank runs on while the other rank's lanes stay frozen."""
    got = _whole(ranks[1], "convergence")
    assert got["it"][0] != got["it"][-1] and got["conv"].all()
    _same(got, jax_results["convergence"])


def test_uneven_batch_is_padded_and_trimmed(ranks, jax_results):
    """B = 5 on 2 ranks: rank 0 holds lanes 0-2, rank 1 lanes 3-4 and one
    padding lane that the result drops."""
    _, rs = ranks
    assert rs[0]["uneven.x0"].shape == (3, 10) and rs[1]["uneven.x0"].shape == (2, 10)
    np.testing.assert_array_equal(rs[1]["uneven.lanes"], [3, 4])
    _same(_whole(rs, "uneven"), jax_results["uneven"])


def test_sharded_solve_path(ranks, jax_results):
    """Each group of the path is a sharded solve; the warm start of the next
    group is the last lane of the previous one, which rank 1 holds."""
    _, rs = ranks
    np.testing.assert_array_equal(rs[0]["path.lanes"], [0, 1, 2, 3, 8, 9, 10, 11])
    _same(_whole(rs, "path"), jax_results["path"])


def test_sharded_solve_scan(ranks, jax_results):
    _same(_whole(ranks[1], "scan"), jax_results["scan"])


@pytest.mark.parametrize("stream", ["budget", "stream"])
@pytest.mark.parametrize("mode", ["run", "run_compiled"])
def test_scheduler_over_a_sharded_solver(ranks, jax_results, stream, mode):
    """Every rank drives the same stream and returns every scenario
    (``run_compiled`` falls back to ``run`` on a sharded solver)."""
    want = jax_results[stream]
    for out in ranks[1]:
        np.testing.assert_array_equal(out[f"{stream}.{mode}.sid"], want["sid"])
        np.testing.assert_array_equal(out[f"{stream}.{mode}.it"], want["it"])
        np.testing.assert_array_equal(out[f"{stream}.{mode}.conv"], want["conv"])
        np.testing.assert_allclose(out[f"{stream}.{mode}.x0"], want["x0"], rtol=0, atol=TOL)
        np.testing.assert_allclose(out[f"{stream}.{mode}.mu"], want["mu"], rtol=1e-12)


def test_mixed_recipe_bitwise_matches_one_process(ranks):
    """The f64 polish of a sharded solver starts from the gathered f32
    state; each rank's lanes equal a one-process mixed solve of them."""
    for out in ranks[1]:
        for f in FIELDS:
            np.testing.assert_array_equal(out[f"mixed.{f}"], out[f"mixed_one.{f}"])


def test_resumable_solve_resumes_exactly(ranks):
    """Stopped after one segment and resumed equals uninterrupted; rank 0
    wrote the one checkpoint of all lanes."""
    outdir, rs = ranks
    for out in rs:
        for f in FIELDS:
            np.testing.assert_array_equal(out[f"resumed.{f}"], out[f"uninterrupted.{f}"])
    from admmsolver_tpu_torch.utils.checkpoint import load_batch_result

    ck = load_batch_result(os.path.join(outdir, "resume.npz"), device="cpu")
    np.testing.assert_array_equal(ck.x[0].numpy(), _whole(rs, "resumed")["x0"])


@pytest.mark.parametrize("loader", ["jax", "torch"])
def test_scattered_checkpoint_from_real_ranks(ranks, jax_results, loader):
    """Each rank wrote its own shard with its global lane indices; either
    package's loader reassembles the batch (files in any order)."""
    outdir, rs = ranks
    paths = [os.path.join(outdir, f"ckpt_p{r}.npz") for r in (1, 0)]
    if loader == "jax":
        from admmsolver_tpu.utils.checkpoint import load_batch_result_scattered
        back = load_batch_result_scattered(paths)
    else:
        from admmsolver_tpu_torch.utils.checkpoint import load_batch_result_scattered
        back = load_batch_result_scattered(paths, device="cpu")
    got = _jax_fields(back)
    whole = _whole(rs, "checkpoint")
    for f in FIELDS:
        np.testing.assert_array_equal(got[f], whole[f])
    _same(got, jax_results["checkpoint"])


@pytest.fixture
def world_of_one():
    """A real gloo process group of one rank in this process, destroyed after
    the test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["batch", "replicated"])
def test_world_of_one_equals_the_unsharded_solve(world_of_one, kind):
    """At world size 1 the sharded solve is the whole batch: bitwise the
    unsharded solve, the exit predicate's all_reduce included."""
    import admmsolver_tpu_torch as T
    from admmsolver_tpu_torch.parallel import (BatchedSolver, batch_sharding, make_mesh,
                                               replicated_sharding)

    mesh = make_mesh(1, devices="cpu")
    assert mesh.group is not None and mesh.world_size == 1
    shard = (batch_sharding if kind == "batch" else replicated_sharding)(mesh)
    A, ov, _ = _cases()["convergence"]
    plain = BatchedSolver(_bp(T, A, ov[(0, "y")][0]), device="cpu").solve(
        ov, niter=3000, rtol=1e-8)
    res = BatchedSolver(_bp(T, A, ov[(0, "y")][0]), sharding=shard).solve(
        ov, niter=3000, rtol=1e-8)
    assert torch.equal(res.lane_index, torch.arange(8))
    for a, b in zip(res.x + res.h + (res.mu, res.iterations),
                    plain.x + plain.h + (plain.mu, plain.iterations)):
        assert torch.equal(a, b)


def test_batch_sharding_lanes():
    from admmsolver_tpu_torch.parallel.mesh import BatchSharding, Mesh

    shard = BatchSharding(Mesh(1, 2, torch.device("cpu"), ("batch",)))
    assert shard.num_devices == 2 and shard.padded(5) == 6
    assert shard.lanes(5) == range(3, 6) and shard.lanes(8) == range(4, 8)


if __name__ == "__main__":
    worker_main(work)
    sys.exit(0)
