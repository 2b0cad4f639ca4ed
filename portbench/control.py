"""The controls that the numbers deciding ``correct`` must fail: the cell's
computation one precision step below the one its configuration states, put in
the program's place.

- ``tf32`` (float32 cells): the plain reference in float32 with its products
  in TF32 (on a card the library's TF32 switch; on the CPU its operands
  rounded to TF32's 10-bit mantissa, as the tensor cores take them).
- ``program_f32`` (float64 cells): the program's own float32 path
  (``Entry.control_entry``).

Run on the card at a cell's own size, each seed a run of ``--calls`` calls
with the cell's comparison, and with ``--program-seeds`` the program itself
on those seeds in the same process (the lower readings).  Each line also
gives quantiles (0.5, 0.9, 0.99, 0.999, 1) of the lanes' gaps, and of the
gaps that each lane's answer would read against the reference of the lane
half a block away (what a lane-mapping fault would read), and the shares of
lanes whose gap exceeds 0.5, 1, 2 and 4 times the cell's ``lane_level``::

    python portbench/control.py --workload bp.fused_f32 --seeds 11 12 13 --program-seeds 21 22
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

import torch


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to nearest on TF32's 10-bit mantissa."""
    if t.dtype != torch.float32:
        return t
    i = t.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Products(torch.overrides.TorchFunctionMode):
    PRODUCTS = {torch.matmul, torch.Tensor.__matmul__, torch.Tensor.__rmatmul__,
                torch.Tensor.matmul, torch.mm, torch.bmm}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = tuple(_tf32(a) if isinstance(a, torch.Tensor) else a for a in args)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def tf32_products(device: torch.device):
    """Products in TF32 inside the scope."""
    if device.type == "cuda":
        old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    else:
        with _TF32Products():
            yield


class _ReferenceTF32:
    """The entry's plain reference, float32 with TF32 products, in the
    program's place."""

    def __init__(self, entry) -> None:
        from .check import on

        self.entry, self.on = entry, on
        self.device = entry.ctx.device
        self.fix = on(entry.ctx.fix, torch.float32, self.device)

    def prepare(self, batch: dict) -> dict:
        return self.on(batch, torch.float32, self.device)

    def call(self, batch: dict) -> dict:
        with tf32_products(self.device):
            return self.entry.reference(self.fix, batch)

    @staticmethod
    def outputs(r: dict) -> dict:
        return r


def control_entry(entry, kind: str):
    if kind != entry.control:
        raise ValueError(f"this cell's control is {entry.control!r}, not {kind!r}")
    if kind == "tf32":
        return _ReferenceTF32(entry)
    return entry.control_entry()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[], help="seeds of the control")
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[],
                    help="seeds of the program")
    ap.add_argument("--calls", type=int, default=None, help="calls a run (default: the "
                    "cell's check.calls)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    from . import harness

    work = harness.load_json("workloads", args.workload)
    kind = harness.module("entries", work["entry"]).Entry.control
    calls = args.calls or int(work["check"].get("calls", 2))
    qs = (0.5, 0.9, 0.99, 0.999, 1.0)
    level = float(work["check"].get("lane_level", 0.0))
    for side, seed in ([("program", s) for s in args.program_seeds]
                       + [("control", s) for s in args.seeds]):
        gaps: list = []
        line = harness.run(args.workload, seed, 0.0, False, calls=calls,
                           control=None if side == "program" else kind, gaps=gaps)
        own = torch.cat([g[0] for g in gaps]).double()
        crossed = torch.cat([g[1] for g in gaps]).double()
        print(json.dumps({"side": side, "seed": seed, "correct": line["correct"],
                          "checks": line["checks"], "card": line["card"],
                          "gap_quantiles": [float(torch.quantile(own, q)) for q in qs],
                          "crossed_quantiles": [float(torch.quantile(crossed, q))
                                                for q in qs],
                          "over_pct": {f"{f:g}": float(100.0 * (own > f * level).double().mean())
                                       for f in (0.5, 1, 2, 4)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from portbench.control import main as _main
    sys.exit(_main())
