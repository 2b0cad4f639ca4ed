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
    jacobi_eigh,
    svd_via_gram,
)
from .prox import soft_threshold, project_nonneg, psd_project, psd_project_sign, svt_sign
from .kernels import (fused_two_block_chunk, fused_two_block_chunk_reference,
                      fused_spm_chunk, fused_spm_chunk_reference, spm_factor_refresh,
                      spm_factor_refresh_reference, jacobi_eigh_reference)
