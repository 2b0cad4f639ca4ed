"""``correct`` fails where it has to: the control (the cell's computation a
precision step below, in the program's place) and the timed path broken
underneath, each through the rest of a run at a CPU size; and the process
holds no JAX."""
from __future__ import annotations

import subprocess
import sys
import textwrap

import pytest
import torch

from conftest import CELLS, REPO, small
from portbench import harness

SEED = 2**31 + 777


def _entry_kind(cell):
    return harness.module("entries", harness.load_json("workloads", cell)["entry"]).Entry.control


# lanes and iterations at which the control shows on the CPU: the SpM
# resamples need the cell's whole budget before TF32's error outgrows float32's
CONTROL_SIZE = {"spm.fused_f32": (32, 2000)}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """At the CPU size the control fails a number that the program passes
    (on the card the same runs at the cell's size: ``portbench/control.py``)."""
    lanes, niter = CONTROL_SIZE.get(cell, (8, 300))
    work = small(cell, lanes=lanes, niter=niter)
    port = harness.run(cell, SEED, 0.0, False, device="cpu", work=work, calls=2)
    ctl = harness.run(cell, SEED, 0.0, False, device="cpu", work=work, calls=2,
                      control=_entry_kind(cell))
    assert port["correct"], port["checks"]
    assert not ctl["correct"], ctl["checks"]


def _broken(kind):
    """A fault in the answers each call returns, made where they are produced."""
    def wrap(call):
        def broken(inputs):
            r = call(inputs)
            xs = (r.x0, r.x1) if hasattr(r, "x0") else r.x
            for x in xs:
                if kind == "unchanged":        # a step that returns its state unchanged
                    x.zero_()
                elif kind == "half":           # half of the batch left out
                    x[x.shape[0] // 2:] = 0
                elif kind == "altered":        # every answer 10% off
                    x.mul_(1.1)
                elif kind == "crossed":        # a sixteenth of the lanes given others' answers
                    n = x.shape[0]
                    x[: n // 16] = x[n // 2: n // 2 + n // 16].clone()
            return r
        return broken
    return wrap


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered", "crossed"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_timed_path_is_not_correct(cell, kind):
    work = small(cell)
    if kind == "crossed":   # two lanes of 32 in one block: a 90th percentile passes them
        work = small(cell, lanes=32)
        work["check"]["block"] = 32
    line = harness.run(cell, SEED, 0.0, False, device="cpu", work=work, calls=3,
                       fault=_broken(kind))
    assert not line["correct"], line["checks"]


def test_process_holds_no_jax():
    code = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {str(REPO)!r})
        sys.path.insert(0, {str(REPO / "portbench" / "tests")!r})
        from conftest import small
        from portbench import harness
        for cell in harness.workloads():
            harness.run(cell, 5, 0.0, True, device="cpu", work=small(cell), calls=1)
        found = sorted({{m.split(".")[0] for m in sys.modules}} & {{"jax", "jaxlib", "flax",
                                                                 "admmsolver_tpu"}})
        assert not found, found
        assert harness.forbidden_modules() == []
        assert "admmsolver_tpu_torch" in sys.modules
        print("clean")
    ''')
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0 and out.stdout.strip() == "clean", out.stderr[-3000:]


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "admmsolver_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "admmsolver_tpu", sys)
    assert harness.forbidden_modules() == ["admmsolver_tpu", "jax"]


@pytest.mark.gpu
def test_control_is_not_correct_on_the_card(card):
    """The control at the cell's own size (a short call on the card)."""
    out = subprocess.run([sys.executable, "portbench/control.py", "--workload", "bp.fused_f32",
                          "--seeds", "11", "--program-seeds", "11", "--calls", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    rows = [json.loads(s) for s in out.stdout.strip().splitlines()]
    assert [r["correct"] for r in rows] == [True, False]
    assert torch.cuda.is_available()
