"""Multi-process execution of the port, mirroring tests/test_distributed.py.

Two host processes (this file run as ``__main__``, see tests/_torch_dist.py)
form one world through ``init_distributed`` with the gloo backend and solve
the batch of tests/test_distributed.py sharded over it through the ordinary
``BatchedSolver`` path; the exit predicate's ``all_reduce`` crosses the
process boundary.  Each rank's lanes are BITWISE equal to a one-process solve
of the same lanes (the same local shapes and thread count), and the gathered
batch is within 1e-10 of the JAX package's solve on a 4-device mesh, with
equal iteration counts.
"""
import sys

import numpy as np
import pytest
import torch

from _torch_dist import run_ranks, worker_main

M, N, B, NITER = 24, 48, 8, 120


def _problem():
    """tests/test_distributed.py's batch: planted 5-sparse signals."""
    rng = np.random.RandomState(1234)
    A = rng.randn(M, N)
    xt = np.zeros((B, N))
    for b in range(B):
        xt[b, rng.choice(N, 5, replace=False)] = rng.randn(5)
    return A, xt @ A.T


def _model(P, A, y):
    return P.Model([P.LeastSquares(1.0, A, y), P.L1Regularizer(0.1, N)],
                   [(1, 0, P.identity(N), P.identity(N))])


def work(mesh, outdir):
    """One rank: the sharded solve, a one-process solve of its lanes, and the
    gathered batch."""
    import admmsolver_tpu_torch as T
    from admmsolver_tpu_torch.parallel import BatchedSolver, batch_sharding, process_allgather

    A, ys = _problem()
    bs = BatchedSolver(_model(T, A, ys[0]), dtype=torch.float64,
                       sharding=batch_sharding(mesh))
    res = bs.solve({(0, "y"): ys}, niter=NITER, mu0=1.0, record_residuals=False)
    lanes = res.lane_index.numpy()
    # the sign of zero survives a gather; lane i of a batch of 5 (rank 0
    # holds lanes 0-2, rank 1 lanes 3-4) reaches every rank from its owner
    signed = torch.tensor([-0.0, 0.0, 1.0 + mesh.rank], dtype=torch.float64)
    csigned = torch.complex(signed, -signed)
    five = torch.arange(5.0, dtype=torch.float64)[:, None] * torch.ones(1, 3)
    real = range(3 * mesh.rank, min(3 * mesh.rank + 3, 5))
    shard5 = batch_sharding(mesh)
    one = BatchedSolver(_model(T, A, ys[0]), device="cpu").solve(
        {(0, "y"): ys[lanes]}, niter=NITER, mu0=1.0, record_residuals=False)
    return dict(world=np.array([mesh.rank, mesh.world_size]), lanes=lanes,
                x0=res.x[0].numpy(), x1=res.x[1].numpy(), it=res.iterations.numpy(),
                one_x0=one.x[0].numpy(), one_x1=one.x[1].numpy(), one_it=one.iterations.numpy(),
                all_x0=process_allgather(res.x[0], mesh).numpy(),
                all_x1=process_allgather(res.x[1], mesh).numpy(),
                all_it=process_allgather(res.iterations, mesh).numpy(),
                signed=process_allgather(signed, mesh).numpy(),
                csigned=torch.view_as_real(process_allgather(csigned, mesh)).numpy(),
                lane5=torch.stack([shard5.lane(five[real.start:real.stop], i, 5)
                                   for i in range(5)]).numpy())


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(__file__, str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def jax_solve():
    """The JAX package's solve on a 4-device mesh (test_distributed.py's
    single-process oracle)."""
    import admmsolver_tpu as J
    from admmsolver_tpu.parallel import BatchedSolver, batch_sharding, make_mesh

    A, ys = _problem()
    res = BatchedSolver(_model(J, A, ys[0]), dtype=np.float64,
                        sharding=batch_sharding(make_mesh(4))).solve(
        {(0, "y"): ys}, niter=NITER, mu0=1.0, record_residuals=False)
    return {"x0": np.asarray(res.x[0]), "x1": np.asarray(res.x[1]),
            "it": np.asarray(res.iterations)}


def test_two_ranks_form_one_world_and_split_the_batch(ranks):
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["world"], [r, 2])
        np.testing.assert_array_equal(out["lanes"], np.arange(r * B // 2, (r + 1) * B // 2))


@pytest.mark.parametrize("field", ["x0", "x1", "it"])
def test_two_processes_bitwise_match_one_process_on_the_same_lanes(ranks, field):
    for out in ranks:
        np.testing.assert_array_equal(out[field], out["one_" + field])


def test_process_allgather_gives_every_rank_the_batch(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["all_x0"], np.concatenate([o["x0"] for o in ranks]))
        np.testing.assert_array_equal(out["all_it"], np.concatenate([o["it"] for o in ranks]))


@pytest.mark.parametrize("field", ["signed", "csigned"])
def test_process_allgather_keeps_the_sign_of_zero(ranks, field):
    want = np.array([-0.0, 0.0, 1.0, -0.0, 0.0, 2.0])
    if field == "csigned":
        want = np.stack([want, -want], axis=-1)
    assert np.signbit(want).any() and not np.signbit(want).all()
    for out in ranks:
        np.testing.assert_array_equal(np.signbit(out[field]), np.signbit(want))
        np.testing.assert_array_equal(out[field], want)


def test_batch_sharding_lane_reaches_every_rank(ranks):
    for out in ranks:
        np.testing.assert_array_equal(out["lane5"], np.arange(5.0)[:, None] * np.ones(3))


@pytest.mark.parametrize("field", ["x0", "x1"])
def test_gathered_batch_matches_jax(ranks, jax_solve, field):
    np.testing.assert_allclose(ranks[0]["all_" + field], jax_solve[field], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(ranks[0]["all_it"], jax_solve["it"])


def test_init_distributed_is_a_noop_for_one_process():
    import torch.distributed as dist

    from admmsolver_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed()
    init_distributed("127.0.0.1:1", num_processes=1, process_id=0)
    assert not dist.is_initialized()
    mesh = make_mesh(1, devices="cpu")
    assert (mesh.rank, mesh.world_size, mesh.group) == (0, 1, None)
    t = torch.arange(3.0)
    assert mesh.all_reduce(t) is t and torch.equal(t, torch.arange(3.0))


def test_make_mesh_raises_where_it_cannot_own_the_devices(monkeypatch):
    from admmsolver_tpu_torch.parallel import make_mesh

    with pytest.raises(ValueError, match="a process owns one device"):
        make_mesh(2, devices="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(devices="cuda:0")


def test_init_distributed_asks_for_a_card_for_nccl(monkeypatch):
    from admmsolver_tpu_torch.parallel import init_distributed

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
        init_distributed("127.0.0.1:1", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(num_processes=2)


if __name__ == "__main__":
    worker_main(work)
    sys.exit(0)
