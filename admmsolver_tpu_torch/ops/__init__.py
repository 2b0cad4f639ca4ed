from .linop import (
    MatrixBase,
    DenseMatrix,
    DiagonalMatrix,
    ScaledIdentityMatrix,
    PartialDiagonalMatrix,
    InterleavedComplexDiagonalMatrix,
    BandedMatrix,
    TridiagFactor,
    tridiag_cr_factor,
    tridiag_cr_solve,
    identity,
    asmatrixtype,
    matrix_hash,
    matmul,
    add,
)
from .prox import soft_threshold, project_nonneg, psd_project
from .kernels import (fused_two_block_chunk, fused_two_block_chunk_reference,
                      fused_spm_chunk, fused_spm_chunk_reference)
