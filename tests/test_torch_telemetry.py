"""The port's spans, counters and device marks (``utils.telemetry``).

On the CPU: with the switch off a solve records nothing; with it on a
solve's spans nest under its ``admm.solve`` and carry its call id, the
done-flag reads are those the chunk schedule implies, a mixed composite's
stages come in order, and the spans are host events of a
``torch.profiler`` trace (no user annotations, so no copies on the device
timeline) and of the Chrome trace ``trace`` writes.

On a card (``-m gpu``; the file imports no jax, so it runs with
``--noconftest``): the marks captured into the SpM chunk are read, the
switch adds no host synchronisation, and a graph captured with the switch
off, or under a profiler alone, holds no event node.
"""
import ctypes
import functools
import json
import os
import warnings

import numpy as np
import pytest
import torch

from admmsolver_tpu_torch import L1Regularizer, LeastSquares, Model, identity
from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
from admmsolver_tpu_torch.parallel import BatchedSolver, FusedSpMSolver, batch
from admmsolver_tpu_torch.utils import telemetry


@pytest.fixture(autouse=True)
def fresh_log():
    telemetry.reset()
    yield
    telemetry.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lasso(device, B=4, M=12, N=30, seed=0):
    rng = np.random.RandomState(seed)
    A, ys = rng.randn(M, N), rng.randn(B, M)
    model = Model([LeastSquares(1.0, A, ys[0]), L1Regularizer(0.1, N)],
                  [(1, 0, identity(N), identity(N))])
    return BatchedSolver(model, device=device), {(0, "y"): ys}


def _spm(device, B=6, nl=12, nw=25):
    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=nl, nw=nw)
    gs = g + 1e-4 * np.random.RandomState(0).randn(B, nl)
    return (FusedSpMSolver(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-3), device=device),
            {(0, "y"): gs})


def _records(name):
    return [r for r in telemetry.snapshot()["records"] if r["name"] == name]


def test_switch_off_records_nothing():
    bs, ov = _lasso("cpu")
    assert not telemetry.enabled()
    assert telemetry.span("admm.chunk", key=1) is telemetry.span("admm.solve")
    bs.solve(ov, niter=300, rtol=1e-30)
    snap = telemetry.snapshot()
    assert snap["spans"] == {} and snap["records"] == [] and snap["marks"] == []
    assert not any(snap["counters"].values())


def test_batched_solve_spans_and_flag_reads():
    """A solve that reads its flags and never converges: one ``admm.solve``
    holding the entry and every chunk, one flag read after each chunk but
    the last, every record in the call."""
    bs, ov = _lasso("cpu")
    with telemetry.tracing():
        res = bs.solve(ov, niter=1000, interval_update_mu=100, rtol=1e-30)
    assert not bool(res.converged.any())
    snap = telemetry.snapshot()
    records = snap["records"]
    (solve,) = [r for r in records if r["name"] == telemetry.SOLVE]
    assert solve["attrs"]["entry"] == "BatchedSolver.solve" and solve["parent"] is None
    assert {r["call"] for r in records} == {solve["call"]}
    chunks = [r for r in records if r["name"] == "admm.chunk"]
    schedule = batch._GraphProgram.schedule(1000, 100)
    assert [c["attrs"]["key"] for c in chunks] == ["entry"] + [n for n, _ in schedule[1:]]
    by_id = {r["id"]: r for r in records}
    for r in records[1:]:
        while r["parent"] is not None:
            r = by_id[r["parent"]]
        assert r is solve
    # the entry and the chunks after it; no read after the last chunk
    reads = len(schedule) - 2
    assert snap["counters"]["flag_reads"] == snap["spans"]["admm.flags_read"]["count"] == reads
    assert solve["attrs"]["counters"]["flag_reads"] == reads
    assert snap["counters"]["eager_chunks"] == len(schedule)
    assert snap["spans"]["admm.solve"]["self_s"] < snap["spans"]["admm.solve"]["total_s"]
    assert {"admm.inputs", "admm.load", "admm.result"} <= set(snap["spans"])


def test_program_build_and_init_are_spans():
    with telemetry.tracing():
        bs, ov = _lasso("cpu")
        bs.solve(ov, niter=50)
        bs.solve(ov, niter=50)
    snap = telemetry.snapshot()
    assert snap["spans"]["admm.init"]["count"] == 1
    assert snap["counters"]["program_builds"] == 1
    assert [r["call"] for r in _records(telemetry.SOLVE)] == [1, 2]
    assert _records("admm.init")[0]["call"] is None


def test_mixed_composite_stages_in_order():
    fs, ov = _spm("cpu")
    fs.solve_mixed(ov, niter_low=300, niter=200, mu0=0.1)
    with telemetry.tracing():
        fs.solve_mixed(ov, niter_low=300, niter=200, mu0=0.1)
    records = telemetry.snapshot()["records"]
    stages = [r for r in records if r["name"] == "admm.stage"]
    assert [s["attrs"]["label"] for s in stages] == ["kernel phase", "polish"]
    by_id = {r["id"]: r for r in records}
    entries = [r for r in records if r["name"] == "admm.chunk" and r["attrs"]["key"] == "entry"]
    # the polish's entry is the hand-off
    assert len(entries) == 1 and by_id[entries[0]["parent"]] is stages[1]
    assert all(r["call"] == 1 for r in records)


def test_spans_are_host_events_under_the_profiler():
    """A profiler turns the spans on (outside a ``tracing`` scope): they nest
    by ``cpu_parent`` and are not user annotations, so the profiler makes no
    copy of them on the device timeline."""
    from torch.profiler import ProfilerActivity, profile

    bs, ov = _lasso("cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        bs.solve(ov, niter=250, rtol=1e-30)
    events = [e for e in prof.events() if e.name.startswith("admm.")]
    names = [e.name for e in events]
    assert names.count("admm.solve") == 1 and names.count("admm.chunk") == 4
    assert not any(e.is_user_annotation for e in events)
    for e in events:
        if e.name == "admm.chunk":
            parent = e.cpu_parent
            while parent is not None and parent.name != "admm.solve":
                parent = parent.cpu_parent
            assert parent is not None
    assert telemetry.snapshot()["counters"]["flag_reads"] == 2
    telemetry.reset()
    with telemetry.tracing(False), profile(activities=[ProfilerActivity.CPU]) as prof:
        bs.solve(ov, niter=250, rtol=1e-30)
    assert not any(e.name.startswith("admm.") for e in prof.events())
    assert telemetry.snapshot()["records"] == []


def test_trace_writes_the_spans(tmp_path):
    bs, ov = _lasso("cpu")
    with telemetry.trace(str(tmp_path)):
        bs.solve(ov, niter=120)
    (name,) = os.listdir(tmp_path)
    with open(tmp_path / name) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"admm.solve", "admm.chunk", "admm.load"} <= names
    assert not telemetry.enabled()


# -- on a card ---------------------------------------------------------------

def _event_record_nodes(graph) -> int:
    """The event record nodes of a kept graph, counted through libcuda."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds = []
    for i in range(n.value):
        t = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(nodes[i]), ctypes.byref(t)) == 0
        kinds.append(t.value)
    return kinds.count(7)     # CU_GRAPH_NODE_TYPE_EVENT_RECORD


@pytest.mark.gpu
def test_marks_time_the_spm_refresh(cuda):
    fs, ov = _spm(cuda, B=256, nl=30, nw=61)
    fs.solve(ov, niter=400, mu0=0.1, rtol=0.0)
    with telemetry.tracing():
        for _ in range(3):
            fs.solve(ov, niter=400, mu0=0.1, rtol=0.0)
            torch.cuda.synchronize()
    snap = telemetry.snapshot()
    chunks = [m for m in snap["marks"] if "refresh.end" in m["marks"]]
    assert snap["counters"]["chunks_timed"] == len(snap["marks"]) > 0
    full = [m["marks"] for m in chunks if m["key"][0] == 100]
    assert full
    for m in full:
        assert 0 < m["refresh.end"] < m["kernel.end"] < m["chunk.end"]
    share = 100 * sum(m["refresh.end"] for m in full) / sum(m["chunk.end"] for m in full)
    assert 0 < share < 100


@pytest.mark.gpu
def test_switch_adds_no_synchronisation(cuda):
    bs, ov = _lasso(cuda, B=64, M=40, N=120)
    fs, ov_spm = _spm(cuda, B=64)

    def solves():
        bs.solve(ov, niter=400, rtol=1e-30)
        fs.solve_mixed(ov_spm, niter_low=300, niter=300, mu0=0.1)

    def syncs():
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as seen:
                warnings.simplefilter("always")
                solves()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        return sum("synchronizing" in str(w.message) for w in seen)

    solves()
    with telemetry.tracing():
        solves()      # captures the graphs with marks
    off = syncs()
    with telemetry.tracing():
        on = syncs()
    assert off > 0 and on == off


@pytest.mark.gpu
def test_graph_without_the_switch_has_no_event_node(cuda, monkeypatch):
    monkeypatch.setattr(torch.cuda, "CUDAGraph",
                        functools.partial(torch.cuda.CUDAGraph, keep_graph=True))
    from torch.profiler import ProfilerActivity, profile

    fs, ov = _spm(cuda, B=64)
    fs.solve(ov, niter=250, mu0=0.1)
    (program,) = fs._programs.values()
    # a profiler alone turns the spans on, not the graphs with marks
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        fs.solve(ov, niter=250, mu0=0.1)
    assert program.graphs and not program.marked
    # a warm program replays every chunk, iteration 0's too
    assert telemetry.snapshot()["spans"]["admm.replay"]["count"] == len(batch._GraphProgram.schedule(250, 100))
    with telemetry.tracing():
        fs.solve(ov, niter=250, mu0=0.1)
    assert set(program.marked) == set(program.graphs)
    assert all(_event_record_nodes(g) == 0 for g, _, _ in program.graphs.values())
    # chunk.start, refresh.end, kernel.end, chunk.end
    assert all(_event_record_nodes(g) == 4 for g, _, _, _ in program.marked.values())
