"""The yardstick: roofline counts worked by hand, the trace's reduction, the
plain references against the code under test, and the files that a new
configuration, cell or metric takes."""
from __future__ import annotations

import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench import harness, peaks
from portbench.counts import spm as spm_counts
from portbench.counts import two_block
from portbench.references import admm
from portbench.trace import Trace

H100 = peaks.peaks_of("NVIDIA H100 80GB HBM3")


def test_two_block_count_by_hand():
    # B = 2 lanes, N = 4, R = 3, 5 iterations, thin, l1
    w = two_block.work(2, 4, 3, 5)
    assert w["shared_flops"] == 4 * 2 * 4 * 3 * 5                  # 480
    assert w["other_flops"] == ((3 + 2 + 2 + 4 + 3) * 4 + 3) * 2 * 5   # 590
    assert w["bytes"] == 4 * ((2 * 12 + 2 * 3 + 4 * 2 * 4 + 2 * 2) + 4 * 2 * 4)   # 4 * 98
    # the cell's shape: 1000 iterations of 4096 lanes, N 1000, R 100
    w = two_block.work(4096, 1000, 100, 1000)
    shared_s = 4 * 4096 * 1000 * 100 * 1000 / 495e12
    assert 14100 * 4096 * 1000 / 67e12 < shared_s and w["bytes"] / 3.35e12 < shared_s
    assert two_block.bound_s(w, H100) == pytest.approx(shared_s)
    assert two_block.bound_s(w, H100) == pytest.approx(3.3099e-3, rel=1e-4)


def test_spm_count_by_hand():
    # B = 3 lanes, nl = 2, nw = 5, 4 iterations
    w = spm_counts.work(3, 2, 5, 4)
    assert w["shared_flops"] == 4 * 3 * 5 * 2 * 4                 # 480
    assert w["other_flops"] == (2 * 4 + 14 * 2 + 9 * 5) * 3 * 4    # 972
    inputs = 5 * 2 + 3 * (4 + 2 + 3 + 6 + 10)
    assert w["bytes"] == 4 * (inputs + 3 * (8 + 10))
    # the cell's shape: the lanes' own M hk0 and the elementwise steps bound it
    w = spm_counts.work(4096, 30, 61, 100)
    other_s = (1800 + 420 + 549) * 4096 * 100 / 67e12
    assert 4 * 4096 * 61 * 30 * 100 / 495e12 < other_s and w["bytes"] / 3.35e12 < other_s
    assert spm_counts.bound_s(w, H100) == pytest.approx(other_s)
    assert spm_counts.bound_s(w, H100) == pytest.approx(1.6928e-5, rel=1e-4)


def test_no_implementation_reads_above_its_roofline():
    """The bound counts the algorithm's work once and lets the tensor cores,
    the float32 units and the memory overlap: a kernel that keeps the busiest
    of them at its peak reads 100%, no more, and no kernel takes less time."""
    for w, fastest in ((two_block.work(4096, 1000, 100, 100), "shared_flops"),
                       (spm_counts.work(4096, 30, 61, 100), "other_flops")):
        times = {"shared_flops": w["shared_flops"] / 495e12,
                 "other_flops": w["other_flops"] / 67e12, "bytes": w["bytes"] / 3.35e12}
        assert max(times, key=times.get) == fastest
        bound = (two_block if fastest == "shared_flops" else spm_counts).bound_s(w, H100)
        assert bound == pytest.approx(max(times.values()))
    assert peaks.peaks_of("Some other card") is None


def test_trace_union_gaps_and_host_calls():
    host = [("portbench.call", 0.0, 100.0), ("portbench.call", 100.0, 200.0),
            ("portbench.solve", 0.5, 52.0), ("portbench.solve", 100.5, 150.0),
            ("cudaGraphLaunch", 1.0, 2.0), ("cudaLaunchKernel", 50.0, 51.0),
            ("cudaLaunchKernel", 95.0, 96.0),
            ("aten::copy_", 60.0, 90.0), ("python", 0.0, 200.0)]
    device = [("k1", 5.0, 40.0), ("k2", 30.0, 55.0), ("k1", 95.0, 180.0),
              ("outside", 300.0, 400.0)]
    tr = Trace(device, host)
    assert tr.calls == 2 and tr.window_s == pytest.approx(200e-6)
    assert tr.busy_s == pytest.approx((55 - 5 + 180 - 95) * 1e-6)
    assert tr.device_s("k1") == pytest.approx((35 + 85) * 1e-6)
    assert tr.host_launch_calls() == 2
    assert tr.top_ops()[0][0] == "k1"
    gaps = tr.idle_gaps()
    assert gaps[0] == ["host: aten::copy_", pytest.approx(40e-6)]
    assert [g[1] for g in gaps] == sorted((g[1] for g in gaps), reverse=True)
    assert sum(g[1] for g in gaps) == pytest.approx(tr.window_s - tr.busy_s)


def _close(a, b, tol):
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max()) <= tol


def test_basis_pursuit_reference_matches_the_port():
    from admmsolver_tpu_torch.parallel import BatchedSolver
    from portbench.problems import basis_pursuit as bp
    from portbench.references import basis_pursuit as ref

    cfg = dict(harness.load_json("configs", "bp_n1000_m100"), N=60, M=20, K=4)
    fix = bp.fixed(cfg, 3)
    (b,) = bp.batches(cfg, {"alpha1": {"logspace": [-2, 0, 3]}}, fix, 6, 1,
                      torch.Generator().manual_seed(3), "cpu")
    port = BatchedSolver(bp.port_model(cfg, fix), device="cpu").solve(
        {(0, "y"): b["y"], (1, "alpha"): b["alpha1"]}, niter=300, rtol=1e-10)
    st = ref.solve({"A": torch.as_tensor(fix["A"])}, b, 1.0, admm.Knobs(niter=300, rtol=1e-10))
    assert torch.equal(st.count.to(port.iterations.dtype), port.iterations)
    assert _close(port.x[0], st.x[0], 1e-9) and _close(port.mu, st.mu, 0)


def test_spm_reference_matches_the_port():
    from admmsolver_tpu_torch.parallel import BatchedSolver
    from portbench.problems import spm
    from portbench.references import spm as ref

    cfg = dict(harness.load_json("configs", "spm_nl30_nw61"), nl=12, nw=41)
    fix = spm.fixed(cfg, 0)
    (b,) = spm.batches(cfg, {}, fix, 4, 1, torch.Generator().manual_seed(5), "cpu")
    port = BatchedSolver(spm.port_model(cfg, fix), device="cpu").solve(
        {(0, "y"): b["y"]}, niter=400, rtol=1e-10, mu0=0.1)
    f64 = {k: (v if isinstance(v, float) else torch.as_tensor(v)) for k, v in fix.items()}
    st = ref.solve(f64, b, 0.1, admm.Knobs(niter=400, rtol=1e-10))
    assert torch.equal(st.count.to(port.iterations.dtype), port.iterations)
    for k in range(3):
        assert _close(port.x[k], st.x[k], 1e-8)


def test_frozen_spm_basis_is_the_ports_synthetic_basis():
    from admmsolver_tpu_torch.models.applications import synthetic_spm_data
    from portbench.problems import spm

    s, P, c, g = spm.basis(30, 61, 10.0, 5.0)
    s2, g2, c2, P2, _, _ = synthetic_spm_data(nl=30, nw=61, noise=0.0)
    for a, b in ((s, s2), (P, P2), (c, c2), (g, g2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-14)


def test_chunk_checks_read_at_chunk_ends():
    assert admm._check_points(1000, 100) == {0, *range(100, 1000, 100), 999}
    assert admm._check_points(201, 100) == {0, 100, 200}


def test_a_new_configuration_cell_and_metric_are_files_alone(tmp_path):
    """Copies the benchmark, adds a configuration, a cell naming it and a
    metric listing the cell, each a new file, and runs the cell: no file
    that was there changes."""
    import shutil

    dst = tmp_path / "portbench"
    shutil.copytree(REPO / "portbench", dst, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    cfg = dict(harness.load_json("configs", "bp_n1000_m100"), name="bp_n64_m16", N=64, M=16,
               K=3)
    (dst / "configs" / "bp_n64_m16.json").write_text(json.dumps(cfg))
    work = dict(harness.load_json("workloads", "bp.lpath_f64"), name="bp64.small",
                config="bp_n64_m16", traffic="small", lanes=8,
                inputs={"alpha1": {"logspace": [-2, 0, 4]}, "measurements": 2},
                solve={"niter": 50, "rtol": 1e-10}, per_layer=["solver.iters_per_solve"])
    (dst / "workloads" / "bp64.small.json").write_text(json.dumps(work))
    (dst / "metrics" / "lanes_per_call.py").write_text(textwrap.dedent('''
        NAME = "lanes.per_call"
        UNIT = "problems"
        BETTER = "higher"
        SOURCE = "program_counter"
        LAYER = "traffic"
        MOVES = "solves_per_s"
        CELLS = ("bp64.small",)

        def read(r):
            return float(r.lanes)
    '''))
    code = textwrap.dedent(f'''
        import json, sys
        sys.path[:0] = [{str(tmp_path)!r}, {str(REPO)!r}]
        from portbench import harness
        assert harness.ROOT.parent.as_posix() == {tmp_path.as_posix()!r}
        assert "bp64.small" in harness.workloads() and "bp_n64_m16" in harness.configs()
        line = harness.run("bp64.small", 7, 0.2, True, device="cpu")
        print(json.dumps(line))
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["metrics"]["lanes.per_call"]["value"] == 8.0
    assert "solver.iters_per_solve" in line["metrics"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_benchmark_json_agrees_with_the_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = harness.workloads()
    assert [w["name"] for w in bench["workloads"]] == [w for w in
                                                        [w["name"] for w in bench["workloads"]]
                                                        if w in cells]
    for w in bench["workloads"]:
        f = cells[w["name"]]
        for k in ("config", "traffic", "chips", "why"):
            assert w[k] == f[k], (w["name"], k)
    configs = harness.configs()
    for c in bench["configs"]:
        f = configs[c["name"]]
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert c["source"] == f["source"] and c["reduced"] == f["reduced"]
    readers = harness.metrics()
    listed = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        r = readers[m["name"]]
        for k in ("unit", "better", "source", "layer", "moves"):
            assert m[k] == getattr(r, k.upper()), (m["name"], k)
        want = [c for c in listed if m["name"] in harness.per_layer_of(c, cells[c])]
        assert m["workloads"] == want, m["name"]
    reported = {}
    for c in listed:
        for q, name in harness.e2e_names(cells[c]).items():
            reported.setdefault(name, (q, []))[1].append(c)
    assert {m["name"] for m in bench["end_to_end"]} == set(reported)
    for m in bench["end_to_end"]:
        q, where = reported[m["name"]]
        assert m["unit"] == harness.E2E[q]
        assert m.get("workloads", listed) == where, m["name"]
    for m in bench["per_layer"]:   # a layer's metric moves a metric its cells report
        assert all(m["moves"] in harness.e2e_names(cells[c]).values() for c in m["workloads"])
