"""The stream cell (``bp.stream_f64``): its scenarios from the seed, and its
check failing with the timed path broken inside and outside the wave
program, at a CPU size where lanes are refilled (24 scenarios through 8
lanes, waves of 10 iterations, every scenario at its 60-iteration
budget)."""
from __future__ import annotations

import pytest
import torch

from conftest import small
from portbench import harness

SEED = 2**31 + 4242
CELL = "bp.stream_f64"


def _cfg(**kw):
    return dict(harness.load_json("configs", "bp_stream_n1000_m100"), **kw)


def test_same_seed_same_scenarios():
    from portbench.problems import bp_stream

    cfg = _cfg(N=64, M=16)
    inputs = harness.load_json("workloads", CELL)["inputs"]
    a, b, c = (bp_stream.batches(cfg, inputs, bp_stream.fixed(cfg, s), 32, 2,
                                 torch.Generator().manual_seed(s), "cpu")
               for s in (SEED, SEED, SEED + 1))
    for x, y in zip(a, b):
        for k in x:
            assert torch.equal(x[k], y[k])
    assert not torch.equal(a[0]["y"], c[0]["y"])
    assert not torch.equal(a[0]["y"], a[1]["y"])
    lo, hi = inputs["log10_alpha1"]
    w = a[0]["alpha1"].log10()
    assert bool(((w >= lo) & (w <= hi)).all()) and float(w.std()) > 0.3
    assert bool((a[0]["alpha_ls"] == cfg["alpha_ls"]).all())


def _refilling():
    work = small(CELL, lanes=24, niter=60)
    work["solve"].update(batch=8, chunk=10)
    work["inputs"] = {"K": [1, 12], "log10_alpha1": [-2.5, -0.5]}
    return work, _cfg(N=64, M=16)


def test_refilling_stream_is_correct():
    work, cfg = _refilling()
    line = harness.run(CELL, SEED, 0.0, False, device="cpu", work=work, cfg=cfg, calls=2)
    assert line["correct"], line["checks"]


def _rows_moved(call):
    def broken(inputs):
        r = call(inputs)
        for x in r.x:                    # every scenario's answer in another's row
            x.copy_(x.roll(x.shape[0] // 2, 0))
        return r
    return broken


def _altered(call):
    def broken(inputs):
        r = call(inputs)
        for x in r.x:                    # every answer 10% off
            x.mul_(1.1)
        return r
    return broken


def _skip_one_refill(monkeypatch):
    """The first wave of each run that refills a lane leaves the state of
    every lane as it was: the refilled lanes start from their previous
    scenario's x, h and penalty."""
    from admmsolver_tpu_torch.parallel import scheduler

    load, exit_ = scheduler._WaveProgram.load, scheduler._WaveProgram._exit

    def load_(self, *args, **kwargs):
        load(self, *args, **kwargs)
        self.refill_skipped = False

    def exit_keeping_state(self):
        before = int(self.nxt)
        kept = [t.clone() for t in self.x + self.h + (self.mu,)]
        exit_(self)
        if not self.refill_skipped and before < self.S and int(self.nxt) > before:
            for t, k in zip(self.x + self.h + (self.mu,), kept):
                t.copy_(k)
            self.refill_skipped = True

    monkeypatch.setattr(scheduler._WaveProgram, "load", load_)
    monkeypatch.setattr(scheduler._WaveProgram, "_exit", exit_keeping_state)


@pytest.mark.parametrize("kind", ["rows_moved", "refill_skipped", "altered"])
def test_broken_stream_is_not_correct(kind, monkeypatch):
    work, cfg = _refilling()
    fault = {"rows_moved": _rows_moved, "altered": _altered}.get(kind)
    if kind == "refill_skipped":
        _skip_one_refill(monkeypatch)
    line = harness.run(CELL, SEED, 0.0, False, device="cpu", work=work, cfg=cfg, calls=2,
                       fault=fault)
    assert not line["correct"], line["checks"]
