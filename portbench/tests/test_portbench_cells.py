"""Every cell end to end at a CPU size: the run's result line, its checks,
the per-layer metrics the cell lists, and the command's refusal without a
card or without the code under test."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import CELLS, REPO, small
from portbench import harness

SEED = 2**31 + 12345     # above 32 signed bits, as the driver's seeds are


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_at_a_small_size(cell):
    line = harness.run(cell, SEED, 0.3, False, device="cpu", work=small(cell))
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 8
    names = harness.e2e_names(harness.load_json("workloads", cell))
    assert set(line["metrics"]) == set(names.values())
    for q, name in names.items():
        m = line["metrics"][name]
        assert m["unit"] == harness.E2E[q] and m["value"] > 0
    for name, c in line["checks"].items():
        assert 0 <= c["value"] <= c["limit"], name
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_cells_counters(cell):
    """On the CPU the profiler sees no device: the device metrics find nothing
    and are left out; the solver's counters are read."""
    line = harness.run(cell, SEED, 0.2, True, device="cpu", work=small(cell))
    names = set(harness.per_layer_of(cell, harness.load_json("workloads", cell)))
    assert set(line["metrics"]) <= names
    for name in ("solver.iters_per_solve", "solver.converged_pct"):
        assert (name in line["metrics"]) == (name in names)
    if "solver.iters_per_solve" in names:
        assert 0 < line["metrics"]["solver.iters_per_solve"]["value"] <= 400


@pytest.mark.parametrize("cell", ["bp.fused_f32", "spm.fused_f32"])
def test_traced_iterations_are_the_annotated_calls_alone(cell, monkeypatch):
    """At rtol 0 every lane runs every iteration: the iterations the readers
    get are those of the traced calls and no others (not the unannotated
    call that starts the tracer)."""
    seen = []

    class Probe:
        UNIT = "calls"

        @staticmethod
        def read(r):
            seen.append(r)

    monkeypatch.setattr(harness, "per_layer_of", lambda cell, work: {"probe": Probe})
    work = small(cell, niter=100)
    work["trace_seconds"] = 0.0
    harness.run(cell, SEED, 0.0, True, device="cpu", work=work, calls=1)
    (r,) = seen
    assert r.trace.calls >= 2
    assert r.traced_iterations == r.trace.calls * r.lanes * 100
    assert r.traced_batch_iterations == r.trace.calls * 100


def test_same_seed_same_inputs():
    from portbench.problems import basis_pursuit, spm
    import torch

    for prob, cfg in ((basis_pursuit, harness.load_json("configs", "bp_n1000_m100")),
                      (spm, harness.load_json("configs", "spm_nl30_nw61"))):
        a, b = (prob.batches(cfg, {}, prob.fixed(cfg, SEED), 4, 2,
                             torch.Generator().manual_seed(SEED), "cpu") for _ in range(2))
        for x, y in zip(a, b):
            for k in x:
                assert torch.equal(x[k], y[k])


def _run_cli(cwd, *extra, env=None):
    return subprocess.run([sys.executable, "portbench/run.py", "--workload", "bp.fused_f32",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
                          cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_command_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _run_cli(REPO, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_code_under_test(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run fails and prints no result."""
    shutil.copytree(REPO / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_cli(tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.gpu
def test_one_short_run_on_the_card(card):
    out = _run_cli(REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
