"""The robust-PCA cell (``rpca.hall_f64``): the video's size on each device,
and its readers of the threshold's counters and product kernels.  The cell
itself, its control and its broken timed paths run at the CPU size in the
cell-parametrized tests (``test_portbench_cells.py``,
``test_portbench_correct.py``)."""
from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.metrics import rpca_roofline_pct, rpca_svt_product_share_pct
from portbench.problems import rpca
from portbench.trace import Trace

SEED = 2**31 + 2626
CELL = "rpca.hall_f64"


def test_the_video_follows_the_device():
    """On a card the published video; on the CPU, where the cell-parametrized
    tests run it, the configuration's ``cpu_size``; the weight 1/sqrt(max(m, n))
    of each."""
    cfg = harness.load_json("configs", harness.load_json("workloads", CELL)["config"])
    card = rpca.size(cfg, "cuda")
    assert (card["height"], card["width"], card["m"], card["n"]) == (144, 176, 25344, 200)
    assert card["lam"] == cfg["lam"]
    cpu = rpca.size(cfg, "cpu")
    assert (cpu["m"], cpu["n"]) == (96, 24) and cpu["lam"] == pytest.approx(96 ** -0.5)
    (b,) = rpca.batches(cfg, {}, rpca.fixed(cfg, SEED), 3, 1,
                        torch.Generator().manual_seed(SEED), "cpu")
    assert b["Y"].shape == (3, 96, 24)


def _readings(device, calls=2):
    """What a reader gets of ``calls`` traced calls spanning one second with
    the device operations ``device`` (name, start, end in microseconds)."""
    tr = Trace(device, [("portbench.call", 0.0, 1e6)] * calls)
    return SimpleNamespace(trace=tr, device_name="NVIDIA H100 80GB HBM3", lanes=4,
                           cfg={"m": 25344, "n": 200})


def test_roofline_reads_the_thresholds_counted(monkeypatch):
    """The bound of the counted lane-iterations over the union of device
    activity; nothing where the program counts no threshold (a port
    without the counters)."""
    r = _readings([("k", 0.0, 2e6)])
    records = [{"name": "admm.solve", "call": i, "attrs": {"counters": c}}
               for i, c in enumerate([{"prox.svt.sign": 2000}, {"prox.svt.sign": 2000,
                                                                "prox.svt.jacobi": 0}])]
    monkeypatch.setattr(rpca_roofline_pct, "program_log", lambda: {"records": records})
    from portbench.counts import rpca as counts
    from portbench.peaks import peaks_of

    w = counts.work(25344, 200, 4000, 4, 2)
    want = 100.0 * counts.bound_s(w, peaks_of(r.device_name)) / 1.0
    assert rpca_roofline_pct.read(r) == pytest.approx(want)
    assert want == pytest.approx(100 * 4 * 25344 * 200 ** 2 * 4000 / 67e12)
    for c in records:
        c["attrs"]["counters"] = {"replays": 6}
    assert rpca_roofline_pct.read(r) is None


def test_product_share_counts_the_product_kernels():
    dev = [("sm90_xmma_gemm_f64f64_f64f64_f64_nt_n_tilesize64x32x32_cublas", 0.0, 3.0),
           ("cutlass::Kernel2<cutlass_80_tensorop_d884gemm_64x32_16x4_nn>", 3.0, 4.0),
           ("splitKreduce_kernel", 4.0, 5.0),
           ("void at::native::vectorized_elementwise_kernel<2, CUDAFunctor_add<double>>", 5.0, 9.0),
           ("void at::native::reduce_kernel<512, 1, NormTwoOps<double>>", 9.0, 10.0)]
    r = _readings(dev)
    assert rpca_svt_product_share_pct.read(r) == pytest.approx(50.0)
    r = _readings([])
    assert rpca_svt_product_share_pct.read(r) is None
