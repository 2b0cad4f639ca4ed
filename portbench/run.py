"""The benchmark of ``admmsolver_tpu_torch`` on one CUDA card: one run of one
cell, its result as the last line of standard output.

    python portbench/run.py --workload bp.fused_f32 --seed 7 --seconds 30 --trace 0

With ``--trace 0`` the line holds the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a short profiled stretch
before the window, with the device's busy and window seconds and a
breakdown.  The numbers that decide ``correct`` close standard error and the
line, each beside its limit.  Exits non-zero with no result without a CUDA
device, and when the process holds JAX or the JAX package after the window.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import os  # noqa: E402

# One caller with few threads: the host's work is launching graphs and
# reading flags, which a pool of idle math threads only contends with.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="One run of one benchmark cell.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # the port's kernel builds stay in the checkout (admmsolver_tpu_torch/_build);
    # anything else that caches goes under the checkout too
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT.parent / ".portbench_cache" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(ROOT.parent / ".portbench_cache" / "torch_extensions"))
    sys.path.insert(0, str(ROOT.parent))
    import torch

    from portbench import harness

    cells = harness.workloads()
    if args.workload not in cells:
        print(f"run: no workload {args.workload!r} under {ROOT / 'workloads'}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cells[args.workload]
                                                                        ["chips"]):
        print("run: no CUDA device, or fewer than the cell asks for", file=sys.stderr)
        return 2
    line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                       started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"run: the process holds {found}: the benchmark runs the PyTorch port alone",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
