"""The benchmark of ``admmsolver_tpu_torch``: one run of one cell.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<name>.json``), the entry it drives (``entries/<entry>.py``), its
traffic and its correctness limits.  A configuration names its problem, whose
inputs ``problems/<problem>.py`` makes from the seed and whose plain reference
is ``references/<problem>.py``.  A per-layer metric is ``metrics/<file>.py``,
reported in the cells it lists and in those whose workload names it.  Each is
found by globbing its folder: a new one is a new file.

Traffic is a closed loop with one caller: set-up makes a pool of distinct
input batches from the seed, on the device, and warms the cell's own shapes;
then calls run back to back, each ending at ``torch.cuda.synchronize()``,
call ``i`` taking batch ``i % pool``, until the window's time is up.  Once
the window has closed, the reference re-solves the lanes of a few calls
sampled from the seed, and ``correct`` says whether every compared number
lies within its limit.
"""
from __future__ import annotations

import importlib
import json
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from . import check
from .trace import CALL, SOLVE, Trace

ROOT = Path(__file__).resolve().parent
#: per-lane batch keys -> the port's override keys (block 0 the data fit,
#: block 1 the L1 term, in every problem here)
OVERRIDE_KEYS = {"y": (0, "y"), "alpha_ls": (0, "alpha"), "alpha1": (1, "alpha")}
#: top-level module names the benchmark's process may not hold (the JAX
#: package and JAX itself), compared whole
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "admmsolver_tpu")
E2E = {"solves_per_s": "problems/s", "call_ms.p95": "ms", "setup_s": "s"}


def e2e_names(work: dict) -> Dict[str, str]:
    """The names under which a cell reports the end-to-end quantities.  A
    cell whose calls the host's own work shows in reports its rate and tail
    apart (``metric_suffix``: ``.short`` for calls of a few tens of ms,
    ``.to_tol`` for calls that wait on the solver's stopping rule), so that
    their spread sets their bounds alone and not those of calls the card
    keeps busy."""
    suffix = work.get("metric_suffix", "")
    return {q: q + (suffix if q != "setup_s" else "") for q in E2E}


def _names(folder: str, suffix: str):
    return sorted(p.stem for p in (ROOT / folder).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def workloads() -> Dict[str, dict]:
    return {n: load_json("workloads", n) for n in _names("workloads", ".json")}


def configs() -> Dict[str, dict]:
    return {n: load_json("configs", n) for n in _names("configs", ".json")}


def load_json(folder: str, name: str) -> dict:
    path = ROOT / folder / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"no {folder[:-1]} named {name!r} (looked for {path})")
    return json.loads(path.read_text())


def module(folder: str, name: str):
    if name not in _names(folder, ".py"):
        raise SystemExit(f"no {folder[:-1]} named {name!r} under {ROOT / folder}")
    return importlib.import_module(f"{__package__}.{folder}.{name}")


def metrics() -> Dict[str, object]:
    """Every per-layer metric reader by its metric's name."""
    out = {}
    for n in _names("metrics", ".py"):
        m = module("metrics", n)
        out[m.NAME] = m
    return out


def per_layer_of(cell: str, work: dict) -> Dict[str, object]:
    """The per-layer metrics reported in ``cell``."""
    return {name: m for name, m in metrics().items()
            if cell in m.CELLS or name in work.get("per_layer", ())}


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN_MODULES))


def _quantile(values, q: float) -> float:
    """The ``q`` quantile by linear interpolation between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


class Ctx(SimpleNamespace):
    """What an entry is built from: the cell's workload ``work``, its
    configuration ``cfg``, the shared inputs ``fix``, the problem and
    reference modules and the device."""

    def overrides(self, batch: dict, dtype) -> dict:
        """The port's per-lane overrides of a batch: the keys the traffic
        varies (``work["overrides"]``), in ``dtype``."""
        return {OVERRIDE_KEYS[k]: batch[k].to(dtype).contiguous()
                for k in self.work["overrides"]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class _Loop:
    """Calls back to back: call ``n`` takes input ``n % pool``; counts on the
    device the lanes' iterations, converged lanes and non-finite answers;
    keeps a reservoir sample of the calls' answers."""

    def __init__(self, outputs, call, inputs, device, rng: random.Random, keep: int) -> None:
        self.outputs, self.call, self.inputs, self.device = outputs, call, inputs, device
        self.rng, self.keep = rng, keep
        zero = lambda: torch.zeros((), dtype=torch.float64, device=device)
        self.iters, self.itmax, self.conv, self.bad = zero(), zero(), zero(), zero()
        self.n = 0
        self.times: list = []
        self.kept: list = []     # (call index, input index, answers)

    def one(self, annotate: bool = False) -> None:
        n, pool = self.n, len(self.inputs)
        t0 = time.perf_counter()
        if annotate:
            with torch.profiler.record_function(SOLVE):
                r = self.call(self.inputs[n % pool])
        else:
            r = self.call(self.inputs[n % pool])
        out = self.outputs(r)
        del r
        self.iters += out["iterations"].sum()
        self.itmax += out["iterations"].max()
        self.conv += out["converged"].sum()
        finite = torch.stack([torch.isfinite(x).all(dim=1) for x in out["x"]]).all(dim=0)
        self.bad += (~finite).sum()
        _sync(self.device)
        self.times.append(time.perf_counter() - t0)
        if len(self.kept) < self.keep:
            self.kept.append((n, n % pool, out))
        else:
            j = self.rng.randrange(n + 1)
            if j < self.keep:
                self.kept[j] = (n, n % pool, out)
        self.n += 1

    def until(self, stop, annotate: bool = False) -> None:
        """Calls until ``stop(calls made here, seconds since the first)``."""
        t0, k = time.perf_counter(), 0
        while True:
            if annotate:
                with torch.profiler.record_function(CALL):
                    self.one(annotate=True)
            else:
                self.one()
            k += 1
            if stop(k, time.perf_counter() - t0):
                return


def traced_stretch(loop: _Loop, seconds: float, device: torch.device):
    """Profiles one call that is not read (it pays for starting the tracer),
    then annotated calls, two at least, until ``seconds`` have passed.
    Returns the trace of the annotated calls and their iterations: the sum
    over their lanes, and the sum of each call's largest lane count."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        loop.one()
        before = (float(loop.iters.item()), float(loop.itmax.item()))
        loop.until(lambda k, dt: k >= 2 and dt >= seconds, annotate=True)
    tr = Trace.from_profiler(prof)
    del prof
    return tr, (float(loop.iters.item()) - before[0], float(loop.itmax.item()) - before[1])


def run(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
        started: Optional[float] = None, work: Optional[dict] = None,
        cfg: Optional[dict] = None, control: Optional[str] = None,
        calls: Optional[int] = None, fault=None, gaps: Optional[list] = None) -> dict:
    """One run of ``cell``; returns the result line as a dict (its key
    ``checks`` last).  ``work`` and ``cfg`` replace the cell's files (the
    tests' small sizes); ``control`` puts the cell's control in the program's
    place; ``calls`` runs that many calls in place of a timed window;
    ``fault`` wraps the entry's call (the tests' broken timed paths);
    ``gaps``, where given, gets every compared lane's gap to its own reference
    and to the reference of the lane half a block away (``control.py``)."""
    started = time.perf_counter() if started is None else started
    device = torch.device(device)
    work = dict(load_json("workloads", cell) if work is None else work)
    cfg = load_json("configs", work["config"]) if cfg is None else cfg
    problem = module("problems", cfg["problem"])
    ctx = Ctx(work=work, cfg=cfg, device=device, problem=problem,
              reference=module("references", cfg["problem"]), fix=problem.fixed(cfg, seed))
    unknown = sorted(set(work["check"]["limits"]) - set(check.NUMBERS))
    if unknown:
        raise SystemExit(f"{cell}: no comparison named {unknown}")
    entry_mod = module("entries", work["entry"])
    if cfg["problem"] not in entry_mod.Entry.problems:
        raise SystemExit(f"entry {work['entry']} does not serve problem {cfg['problem']}")

    # set-up: the pool of inputs from the seed on the device, the program,
    # then warm calls (two by default) on the pool's first batches: the
    # first builds and captures, the second is a replay
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    lanes, pool = int(work["lanes"]), int(work.get("pool", 4))
    batches = problem.batches(cfg, work.get("inputs", {}), ctx.fix, lanes, pool, gen, device)
    entry = entry_mod.Entry(ctx)
    runner = entry
    if control is not None:
        from .control import control_entry
        runner = control_entry(entry, control)
    inputs = [runner.prepare(b) for b in batches]
    call = runner.call if fault is None else fault(runner.call)
    for i in range(int(work.get("warm_calls", 2))):
        call(inputs[i % pool])
    _sync(device)
    setup_s = time.perf_counter() - started

    # the window: the sample of calls to compare is drawn from the seed
    spec = work["check"]
    loop = _Loop(runner.outputs, call, inputs, device, random.Random(seed),
                 int(spec.get("calls", 2)))
    tr, traced = None, (0.0, 0.0)
    if trace:
        # a short traced stretch first: the profiler's events of a whole
        # window would not fit, and its cost would distort the timed calls
        tr, traced = traced_stretch(loop, float(work.get("trace_seconds", 1.0)), device)
    loop.times.clear()
    t_start = time.perf_counter()
    first = loop.n
    if calls is None:
        loop.until(lambda k, dt: dt >= seconds)
    else:
        loop.until(lambda k, dt: k >= calls)
    window = time.perf_counter() - t_start
    window_calls = loop.n - first
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    total_lanes = loop.n * lanes
    iters_total, conv_total, bad_total = (float(t.item()) for t in (loop.iters, loop.conv,
                                                                      loop.bad))
    kept, times = loop.kept, loop.times

    # the program's state goes before the reference runs
    entry.solver = None
    del runner, call, inputs, loop
    if device.type == "cuda":
        torch.cuda.empty_cache()
    result_metrics: Dict[str, dict] = {}
    if not trace:
        values = {"solves_per_s": window_calls * lanes / window,
                  "call_ms.p95": 1e3 * _quantile(times, 0.95), "setup_s": setup_s}
        for q, name in e2e_names(work).items():
            result_metrics[name] = {"value": values[q], "unit": E2E[q]}
    breakdown = None
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        readings = SimpleNamespace(trace=tr, cell=cell, work=work, cfg=cfg,
                                   device_name=dev_info["kind"], lanes=lanes,
                                   iterations_total=iters_total, converged_total=conv_total,
                                   lanes_total=total_lanes, traced_iterations=traced[0],
                                   traced_batch_iterations=traced[1])
        for name, m in per_layer_of(cell, work).items():
            v = m.read(readings)
            if v is not None:
                result_metrics[name] = {"value": v, "unit": m.UNIT}
        if device.type == "cuda":
            dev_info["busy_s"] = tr.busy_s
            dev_info["window_s"] = tr.window_s
            breakdown = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}

    # correctness: the reference on every lane of the sampled calls
    numbers: Dict[str, float] = {name: 0.0 for name in spec["limits"]}
    block = int(spec.get("block", lanes))
    fix64 = check.on(ctx.fix, torch.float64, device)
    for _, b, out in sorted(kept, key=lambda k: k[0]):
        batch = batches[b]
        for lo in range(0, lanes, block):
            hi = min(lanes, lo + block)
            ref = entry.reference(fix64, check.on(check.lanes(batch, lo, hi),
                                                         torch.float64, device))
            port = {"x": [x[lo:hi] for x in out["x"]]}
            for name, v in check.compare(port, ref, ctx.fix, spec).items():
                numbers[name] = max(numbers[name], v)
            if gaps is not None:
                half = (hi - lo) // 2
                crossed = {"x": [x.roll(half, 0) for x in port["x"]]}
                gaps.append((check.lane_gaps(port["x"], ref["x"], spec["blocks"]).cpu(),
                             check.lane_gaps(crossed["x"], ref["x"], spec["blocks"]).cpu()))
    checks = {name: {"value": numbers[name], "limit": float(lim)}
              for name, lim in spec["limits"].items()}
    correct = all(numbers[k] <= float(v) for k, v in spec["limits"].items()) and bad_total == 0
    line = {"correct": bool(correct), "attempted": int(total_lanes), "failed": int(bad_total),
            "metrics": result_metrics, "device": dev_info}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["card"] = card_line(device)
    line["checks"] = checks
    return line


def card_line(device: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    if device.type != "cuda":
        return "cpu"
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
