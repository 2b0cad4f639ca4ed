from .fused import FusedTwoBlockSolver, FusedResult
