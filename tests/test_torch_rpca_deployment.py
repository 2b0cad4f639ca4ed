"""The robust-PCA background-subtraction deployment (PCP on a camera's video a
lane) in the port, without the JAX package.

The port's ``BatchedSolver`` on ``rpca_model`` in float64 equals the plain
reference of the benchmark's cell (``portbench/references/rpca.py``: QR and
SVD) through each route of the singular-value threshold, in iterations,
flags, penalties and x; the cell's generator makes videos of the
configuration's shapes from the seed; the program counts the thresholds a
solve does by route (``prox.svt.<route>``), once a lane-application, and a
replayed chunk on the card adds what its capture counted.
"""
import numpy as np
import pytest
import torch

from admmsolver_tpu_torch import SimpleOptimizer
from admmsolver_tpu_torch.models.applications import rpca_model
from admmsolver_tpu_torch.parallel import BatchedSolver
from admmsolver_tpu_torch.utils import telemetry
from portbench import harness
from portbench.problems import rpca as problem
from portbench.references import admm, rpca as reference

SEED = 2**31 + 2525
CONFIG = "rpca_hall_25344x200"
# a 12 x 8-pixel video of 24 frames, three cameras
SMALL = dict(height=8, width=12, m=96, n=24, lam=1 / np.sqrt(96))
B, MU0, RTOL, INTERVAL = 3, 0.25, 1e-7, 100


def _video(cfg=SMALL, lanes=B, seed=SEED):
    return problem.video(cfg, lanes, torch.Generator().manual_seed(seed), "cpu")


@pytest.mark.parametrize("method", ["sign", "gram", "xla"])
def test_port_equals_the_plain_reference(method):
    """120 iterations, across the penalty update at iteration 100, with the
    stopping rule read after every iteration."""
    Y = _video()[0]
    niter = 120
    bs = BatchedSolver(rpca_model(np.zeros((SMALL["m"], SMALL["n"])), svd_method=method),
                       device="cpu")
    r = bs.solve({(1, "offset"): Y.reshape(B, -1)}, mu0=MU0, niter=niter, rtol=RTOL,
                 interval_update_mu=INTERVAL, record_residuals=False)
    st = reference.solve({"lam": SMALL["lam"]}, {"Y": Y}, MU0,
                         admm.Knobs(niter=niter, interval=INTERVAL, rtol=RTOL,
                                    checks="iteration"))
    assert torch.equal(r.iterations.long(), st.count)
    assert torch.equal(r.converged, st.done)
    assert torch.allclose(r.mu.reshape(B, -1), st.mu)
    assert float(st.mu.min()) > MU0             # the penalty moved
    for k in (0, 1):
        scale = float(st.x[k].abs().max())
        assert float((r.x[k] - st.x[k]).abs().max()) < 1e-10 * scale


def test_reference_threshold_is_the_svd_threshold():
    X = torch.randn(2, 30, 7, dtype=torch.float64)
    tau = torch.tensor([0.5, 2.0], dtype=torch.float64)
    U, s, Vh = torch.linalg.svd(X, full_matrices=False)
    want = (U * torch.clamp_min(s - tau[:, None], 0.0)[:, None, :]) @ Vh
    assert torch.allclose(reference.svt(X, tau), want, atol=1e-13)
    assert torch.allclose(reference.svt(X.mT, tau), want.mT, atol=1e-13)


def test_generator_at_the_configurations_shapes():
    """The configuration's pixels and weight, on 24 frames of its 200."""
    cfg = harness.load_json("configs", CONFIG)
    assert cfg["m"] == 176 * 144 == cfg["height"] * cfg["width"] and cfg["n"] == 200
    assert cfg["lam"] == pytest.approx(1 / np.sqrt(176 * 144), rel=1e-15)
    assert cfg["reduced"] == []
    cut = dict(cfg, n=24)
    Y, bg, mask = problem.video(cut, 4, torch.Generator().manual_seed(SEED), "cpu")
    assert Y.shape == bg.shape == mask.shape == (4, 176 * 144, 24)
    assert Y.dtype == torch.float64
    share = mask.double().mean(dim=(1, 2))
    assert bool(((share >= 0.05) & (share <= 0.10)).all()), share
    assert float(Y.min()) > -0.01 and float(Y.max()) < 1.01
    s = torch.linalg.svdvals(bg)
    assert bool((s[:, 3] < 1e-9 * s[:, 0]).all()) and bool((s[:, 2] > 1e-6 * s[:, 0]).all())
    # the foreground is what sets Y apart from the background
    off = (Y - bg).abs()
    assert float(off[~mask].max()) < 0.02 and float(off[mask].median()) > 0.1
    # the batches of a run on the CPU: the configuration's cpu_size, from the seed
    small = problem.video(problem.size(cfg, "cpu"), 4, torch.Generator().manual_seed(SEED),
                          "cpu")[0]
    again = problem.batches(cfg, {}, problem.fixed(cfg, SEED), 4, 2,
                            torch.Generator().manual_seed(SEED), "cpu")
    other = problem.batches(cfg, {}, problem.fixed(cfg, SEED + 1), 4, 2,
                            torch.Generator().manual_seed(SEED + 1), "cpu")
    assert torch.equal(again[0]["Y"], small) and not torch.equal(again[1]["Y"], small)
    assert not torch.equal(other[0]["Y"], small)


@pytest.mark.parametrize("method,route", [("sign", "sign"), ("gram", "jacobi"), ("xla", "svd")])
def test_thresholds_counted_once_a_lane_application(method, route):
    """On the CPU every chunk runs directly: a solve of B lanes and n
    iterations counts B n thresholds by its route, in the call's record;
    nothing with the switch off."""
    Y = _video()[0]
    bs = BatchedSolver(rpca_model(np.zeros((SMALL["m"], SMALL["n"])), svd_method=method),
                       device="cpu")
    ov = {(1, "offset"): Y.reshape(B, -1)}
    telemetry.reset()
    bs.solve(ov, mu0=MU0, niter=7, rtol=0.0, record_residuals=False)
    assert telemetry.snapshot()["counters"].get(f"prox.svt.{route}", 0) == 0
    with telemetry.tracing():
        bs.solve(ov, mu0=MU0, niter=7, rtol=0.0, record_residuals=False)
        SimpleOptimizer(rpca_model(Y[0].numpy(), svd_method=method), device="cpu").solve(5)
    snap = telemetry.snapshot()
    assert snap["counters"][f"prox.svt.{route}"] == B * 7 + 5
    calls = [r for r in snap["records"] if r["name"] == telemetry.SOLVE and r["parent"] is None]
    assert [c["attrs"]["counters"][f"prox.svt.{route}"] for c in calls] == [B * 7, 5]
    telemetry.reset()


def test_counts_inside_a_capture_go_to_its_tally():
    """A count made while a graph is captured goes to the capture's tally,
    whatever the switch, and not to the log (nothing ran)."""
    telemetry.reset()
    counts = {}
    with telemetry.capturing(counts):
        telemetry.count("prox.svt.sign", 4)
        telemetry.count("prox.svt.sign", 4)
    assert counts == {"prox.svt.sign": 8}
    assert "prox.svt.sign" not in telemetry.snapshot()["counters"]
    with telemetry.tracing():
        with telemetry.capturing({}):
            telemetry.count("prox.svt.sign")
        assert "prox.svt.sign" not in telemetry.snapshot()["counters"]
        telemetry.count("prox.svt.sign", 3)
    assert telemetry.snapshot()["counters"]["prox.svt.sign"] == 3
    telemetry.reset()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_replayed_chunks_add_their_captures_counts(card):
    """On the card the chunks are graphs: a solve's record counts B n
    thresholds however many of its chunks were replays, and a tracing()
    capture marks the threshold inside the chunk."""
    from admmsolver_tpu_torch.parallel import batch

    assert batch.CAPTURE_CHUNKS
    Y = _video(dict(SMALL, height=12, width=8, m=96, n=72))[0].to(card)
    bs = BatchedSolver(rpca_model(np.zeros((96, 72)), svd_method="sign"), device=card)
    ov = {(1, "offset"): Y.reshape(B, -1)}
    kw = dict(mu0=MU0, niter=25, interval_update_mu=10, rtol=0.0, record_residuals=False)
    bs.solve(ov, **kw)                                   # warm: builds and captures
    telemetry.reset()
    with telemetry.tracing():
        bs.solve(ov, **kw)
        bs.solve(ov, **kw)                               # the marked graphs, replayed
    torch.cuda.synchronize()
    snap = telemetry.snapshot()
    calls = [r["attrs"]["counters"] for r in snap["records"]
             if r["name"] == telemetry.SOLVE and r["parent"] is None]
    assert len(calls) == 2
    for c in calls:
        assert c["prox.svt.sign"] == B * 25 and c["replays"] >= 3 and "eager_chunks" not in c
    marks = [m["marks"] for m in snap["marks"] if "svt.start" in m["marks"]]
    assert marks and all(0 <= m["svt.start"] <= m["svt.end"] <= m["chunk.end"] for m in marks)
    telemetry.reset()
