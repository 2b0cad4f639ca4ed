"""admmsolver_tpu_torch — the ADMM solver framework ported to PyTorch and CUDA.

A second package beside :mod:`admmsolver_tpu` (JAX, the reference), laid
out file for file like it and keeping its public names.  It covers the
batched basis-pursuit path and the 3-block SpM analytic-continuation path:
the structured operators, least squares (plain and equality-constrained) /
L1 / L2 / nonnegativity objectives, the model constructors, the single-instance
engine (:class:`SimpleOptimizer`), the batched engine
(:class:`~admmsolver_tpu_torch.parallel.BatchedSolver`: plain, mixed-precision,
path, scan and resumable solves), the scenario stream
(:class:`~admmsolver_tpu_torch.parallel.ScenarioScheduler`), complex problems
through their real embedding (:func:`realify_model`), checkpoints and
telemetry (:mod:`admmsolver_tpu_torch.utils`), and the fused solvers
(:class:`~admmsolver_tpu_torch.parallel.FusedTwoBlockSolver`,
:class:`~admmsolver_tpu_torch.parallel.FusedSpMSolver`) whose chunk kernels
are hand-written CUDA kernels for Hopper (sm_90a).  Multi-device runs go over
``torch.distributed`` (:mod:`admmsolver_tpu_torch.parallel.mesh`): a
``BatchedSolver`` sharded over the ranks of a mesh, one large-N problem
split over them (:class:`~admmsolver_tpu_torch.parallel.LargeNTwoBlockSolver`,
:func:`~admmsolver_tpu_torch.parallel.sharded_gram`), and per-rank checkpoint
shards.  Solvers run on ``cuda`` unless the caller passes ``device="cpu"``.
It imports ``torch`` and numpy, never ``jax``.
"""

__version__ = "0.1.0"
__license__ = "MIT"

from . import backend  # noqa: F401  (pins full-precision f32 products)
from .ops.linop import (
    MatrixBase,
    DenseMatrix,
    DiagonalMatrix,
    ScaledIdentityMatrix,
    PartialDiagonalMatrix,
    BandedMatrix,
    identity,
    asmatrixtype,
    matrix_hash,
)
from .models.objectivefunc import (
    ObjectiveFunctionBase,
    LeastSquares,
    ConstrainedLeastSquares,
    L1Regularizer,
    L2Regularizer,
    GroupL1Regularizer,
    HuberLoss,
    NonNegativePenalty,
    NuclearNormPenalty,
    BoxProjectionPenalty,
    SemiPositiveDefinitePenalty,
)
from .models.problem import EqualityCondition, Model, Problem
from .models.realify import RealifiedModel, realify_model
from .optimizer import SimpleOptimizer
from .config import ADMMConfig
from .parallel.batch import BatchedSolver, BatchResult
from .parallel.fused import FusedTwoBlockSolver, FusedResult
from .parallel.fused_spm import FusedSpMSolver, FusedSpMResult
from .parallel.scheduler import ScenarioScheduler, ScenarioResult, StreamResult
from .ops.kernels import fused_two_block_chunk, fused_spm_chunk
