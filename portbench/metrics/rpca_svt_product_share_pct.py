"""The matrix products' share of all device time in the traced calls of the
robust-PCA cell: the library's GEMM kernels (and their split-K reductions)
and the Jacobi kernel, recognised by name.  In this iteration only the
singular-value threshold multiplies matrices: the rest of an iteration is
elementwise passes and norms over the lanes."""
from __future__ import annotations

NAME = "rpca.svt_product_share_pct"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "nuclear-norm prox (objectivefunc.NuclearNormPenalty, ops/prox.svt_sign)"
MOVES = "solves_per_s.to_tol"
CELLS = ("rpca.hall_f64",)
#: lower-cased parts of the names of the kernels that multiply matrices
PRODUCTS = ("gemm", "splitkreduce", "jacobi")


def is_product(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in PRODUCTS)


def read(r):
    if r.trace is None:
        return None
    total = r.trace.device_s()
    if total <= 0:
        return None
    products = sum(b - a for n, a, b in r.trace.device if is_product(n))
    return 100.0 * 1e-6 * products / total
