from .linop import (
    MatrixBase,
    DenseMatrix,
    DiagonalMatrix,
    ScaledIdentityMatrix,
    identity,
    asmatrixtype,
    matrix_hash,
    matmul,
    add,
)
from .prox import soft_threshold, project_nonneg
from .kernels import fused_two_block_chunk, fused_two_block_chunk_reference
