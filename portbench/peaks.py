"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheets,
SXM parts, dense rates without sparsity, at the full power limit)."""
from __future__ import annotations

from typing import Optional

PEAKS = {
    # a name that torch.cuda.get_device_name() contains -> rates
    "H100": {
        "tf32_flops": 495e12,     # products on the tensor cores, TF32 inputs
        "f32_flops": 67e12,       # float32 outside the tensor cores
        "f64_tc_flops": 67e12,    # float64 on the tensor cores
        "f64_flops": 34e12,       # float64 outside the tensor cores
        "bytes_per_s": 3.35e12,   # HBM3
    },
}


def peaks_of(device_name: str) -> Optional[dict]:
    """The peaks of a card by its name, or None for a card not in the table
    (a share of a peak is then not read)."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None
