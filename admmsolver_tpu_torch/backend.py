"""Numeric settings of the port.

Importing the package pins full-precision float32 matrix products: TF32
keeps about 1e-3 relative accuracy, which corrupts the shifted-quadratic
solve and flips penalty decisions (the same hazard the JAX package pins
``Precision.HIGHEST`` against on the TPU).  There is no device fallback:
every solver takes its ``device=`` from the caller.
"""
from __future__ import annotations

import torch

__all__ = ["default_dtype"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_dtype(is_complex: bool) -> torch.dtype:
    """State dtype for a model: complex128 if any of its data is complex,
    else float64 (``admmsolver_tpu/optimizer.py:483-485``)."""
    return torch.complex128 if is_complex else torch.float64
