from .linop import (
    MatrixBase,
    DenseMatrix,
    DiagonalMatrix,
    ScaledIdentityMatrix,
    PartialDiagonalMatrix,
    InterleavedComplexDiagonalMatrix,
    identity,
    asmatrixtype,
    matrix_hash,
    matmul,
    add,
)
from .prox import soft_threshold, project_nonneg
from .kernels import (fused_two_block_chunk, fused_two_block_chunk_reference,
                      fused_spm_chunk, fused_spm_chunk_reference)
