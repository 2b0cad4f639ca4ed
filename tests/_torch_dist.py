"""Two-rank gloo runs for the port's multi-device tests.

A test file that uses this runs ITSELF as the workers: under ``__main__`` it
calls :func:`worker_main`, which forms a gloo process group of host ranks
and hands the mesh to the file's ``work(mesh)``; whatever that returns (a
dict of arrays) is saved as ``rank<r>.npz``.  The test process starts the
ranks once, from a module-scoped fixture, through :func:`run_ranks`, and
each test then compares one output.  The workers import torch and the port
only, with one thread each.
"""
import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(test_file: str, outdir: str, world: int = 2, timeout: float = 300.0):
    """Run ``test_file`` as ``world`` gloo ranks; the saved outputs of each
    rank, in rank order.  A rank that fails or outlives ``timeout`` fails the
    caller (all ranks are killed)."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, test_file, str(r), str(world), port, outdir],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"gloo ranks of {test_file} outlived {timeout} s:\n"
                             + "\n---\n".join(outs))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    if codes != [0] * world:
        raise AssertionError(f"gloo ranks exited {codes}:\n" + "\n---\n".join(outs))
    return [dict(np.load(os.path.join(outdir, f"rank{r}.npz"))) for r in range(world)]


def worker_main(work) -> None:
    """The body of a rank: ``argv`` = rank, world, port, outdir."""
    import torch
    import torch.distributed as dist

    from admmsolver_tpu_torch.parallel import init_distributed, make_mesh

    torch.set_num_threads(1)
    rank, world, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        out = work(make_mesh(world, devices="cpu"), outdir)
        np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
