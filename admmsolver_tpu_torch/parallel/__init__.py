from .fused import FusedTwoBlockSolver, FusedResult
from .fused_spm import FusedSpMSolver, FusedSpMResult
