"""admmsolver_tpu_torch — the ADMM solver framework ported to PyTorch and CUDA.

A second package beside :mod:`admmsolver_tpu` (JAX, the reference), laid
out file for file like it and keeping its public names.  It covers the
batched basis-pursuit path: the structured operators, least squares / L1 /
nonnegativity objectives, the single-instance engine
(:class:`SimpleOptimizer`), and the fused two-block solver
(:class:`~admmsolver_tpu_torch.parallel.FusedTwoBlockSolver`) whose chunk
kernel is a hand-written CUDA kernel for Hopper (sm_90a).  It imports
``torch`` and numpy, never ``jax``.
"""

__version__ = "0.1.0"
__license__ = "MIT"

from . import backend  # noqa: F401  (pins full-precision f32 products)
from .ops.linop import (
    MatrixBase,
    DenseMatrix,
    DiagonalMatrix,
    ScaledIdentityMatrix,
    identity,
    asmatrixtype,
    matrix_hash,
)
from .models.objectivefunc import (
    ObjectiveFunctionBase,
    LeastSquares,
    L1Regularizer,
    NonNegativePenalty,
)
from .models.problem import EqualityCondition, Model, Problem
from .optimizer import SimpleOptimizer
from .config import ADMMConfig
from .parallel.fused import FusedTwoBlockSolver, FusedResult
from .ops.kernels import fused_two_block_chunk
