"""The readers of the port's spans, counters and device marks: each on a
synthetic trace or record, the idle time by program span, what a program
without spans gives (nothing), the CPU traced run, and on the card that a
profile of the port's spans holds no copy of them on the device timeline."""
from __future__ import annotations

import pytest

from conftest import small
from portbench import harness, spans
from portbench.metrics import (mixed_polish_share_pct_to_tol, program_allocs_per_call_short,
                               program_flag_reads_per_call_to_tol, program_launch_idle_pct_to_tol)
from portbench.trace import Trace

SEED = 2**31 + 777


class Readings:
    def __init__(self, trace):
        self.trace = trace


def _trace():
    """Two calls of 100 us: the card busy 10-30 and 60-95 in the first,
    110-150 in the second; the host launching a replay over 30-60 (card
    idle 30-60) and 150-190, reading flags 95-100."""
    host = [("portbench.call", 0.0, 100.0), ("portbench.call", 100.0, 200.0),
            ("admm.solve", 1.0, 99.0), ("admm.solve", 101.0, 199.0),
            ("admm.chunk", 20.0, 70.0), ("admm.replay", 30.0, 60.0),
            ("cudaGraphLaunch", 31.0, 59.0), ("admm.flags_read", 95.0, 98.0),
            ("admm.chunk", 140.0, 195.0), ("admm.replay", 150.0, 190.0),
            ("admm.flags_read", 196.0, 198.0), ("admm.flags_read", -50.0, -40.0)]
    device = [("k", 10.0, 30.0), ("k", 60.0, 95.0), ("k", 110.0, 150.0)]
    return Trace(device, host)


def test_idle_by_innermost_span():
    tr = _trace()
    idle = spans.idle_by_span(tr)
    # idle: 0-10 (caller 0-1, solve 1-10), 30-60 (replay), 95-110 (solve 95-99 outside
    # the flag read 95-98: flags 3, solve 1, caller 99-101: 2, solve 101-110: 9),
    # 150-200 (replay 150-190, chunk 190-195, solve 195-196 and 198-199, flags 196-198,
    # caller 199-200)
    want = {"caller": 1 + 2 + 1, "admm.solve": 9 + 1 + 9 + 2, "admm.replay": 30 + 40,
            "admm.flags_read": 3 + 2, "admm.chunk": 5}
    assert idle == pytest.approx({k: 1e-6 * v for k, v in want.items()})
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)


def test_flag_reads_and_launch_idle_read_the_spans():
    r = Readings(_trace())
    # the read before the first call is not in the window
    assert program_flag_reads_per_call_to_tol.read(r) == 1.0
    assert program_launch_idle_pct_to_tol.read(r) == pytest.approx(100 * 70 / 200)
    assert program_launch_idle_pct_to_tol.read(r) <= 100 * (1 - r.trace.busy_s / r.trace.window_s)


def test_a_program_without_spans_gives_nothing(monkeypatch):
    tr = _trace()
    bare = Readings(Trace(tr.device, [(n, a, b) for n, a, b in tr.host
                                      if not n.startswith("admm.")]))
    monkeypatch.setattr(spans, "program_log", lambda: None)
    monkeypatch.setattr(program_allocs_per_call_short, "program_log", lambda: None)
    for m in (program_flag_reads_per_call_to_tol, program_launch_idle_pct_to_tol,
              program_allocs_per_call_short, mixed_polish_share_pct_to_tol):
        assert m.read(bare) is None, m.NAME


def _log():
    """Three calls, the last two annotated: their allocations and each call's
    stages, beside a chunk's marks."""
    calls = [{"name": "admm.solve", "call": c, "attrs": {"counters": {}, "alloc_segments": n}}
             for c, n in ((1, 9), (2, 1), (3, 2))]
    stage = lambda c, polish, end: {"call": c, "program": "_MixedProgram",
                                    "marks": {"kernel phase": 0.0, "polish": polish,
                                              "end": end}}
    chunk = {"call": 3, "key": 100, "marks": {"chunk.start": 0.0, "chunk.end": 5.0}}
    marks = [stage(1, 1.0, 2.0), chunk, stage(2, 1.0, 4.0), stage(3, 2.0, 6.0)]
    return {"records": [{"name": "admm.chunk", "call": 1, "attrs": {}}] + calls,
            "marks": marks}


def test_counters_and_marks_read_the_annotated_calls(monkeypatch):
    monkeypatch.setattr(spans, "program_log", _log)
    monkeypatch.setattr(program_allocs_per_call_short, "program_log", _log)
    r = Readings(_trace())          # two annotated calls: calls 2 and 3 of the log
    assert program_allocs_per_call_short.read(r) == 1.5
    # (4 - 1 + 6 - 2) / (4 + 6)
    assert mixed_polish_share_pct_to_tol.read(r) == pytest.approx(100 * 7 / 10)


def test_cpu_traced_run_reports_the_flag_reads():
    """On the CPU the spans are in the profile but there is no device: the
    flag reads are read (the schedule's: one after each chunk but the last,
    three chunks a phase at 200 iterations), the device's shares are not."""
    for cell, reads in (("bp.lpath_f64", 1.0), ("spm.mixed_f64", 3.0)):
        line = harness.run(cell, SEED, 0.2, True, device="cpu", work=small(cell))
        got = line["metrics"]
        assert got["program.flag_reads_per_call.to_tol"]["value"] == reads
        for name in ("program.launch_idle_pct.to_tol", "mixed.polish_share_pct.to_tol"):
            assert name not in got


@pytest.mark.gpu
def test_profile_of_the_spans_has_no_device_copy(card):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from admmsolver_tpu_torch.models.applications import spm_model, synthetic_spm_data
    from admmsolver_tpu_torch.parallel import FusedSpMSolver

    s, g, prj_sum, prj_w, _, _ = synthetic_spm_data(nl=30, nw=61)
    fs = FusedSpMSolver(spm_model(s, g, prj_sum, prj_w, alpha_l1=1e-5), device=card)
    ov = {(0, "y"): g + 1e-5 * torch.randn(256, 30, dtype=torch.float64).numpy()}
    fs.solve_mixed(ov, niter_low=300, niter=300, mu0=0.1)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            with torch.profiler.record_function("portbench.call"):
                fs.solve_mixed(ov, niter_low=300, niter=300, mu0=0.1)
                torch.cuda.synchronize()
    tr = Trace.from_profiler(prof)
    # the profile replays the graphs the solve replays without it
    assert any(n == "admm.replay" for n, _, _ in tr.host)
    assert not any(n == "admm.capture" for n, _, _ in tr.host)
    assert not any(n.startswith("admm.") for n, _, _ in tr.device)
    assert tr.busy_s > 0
