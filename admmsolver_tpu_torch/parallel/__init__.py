from .batch import BatchedSolver, BatchResult
from .fused import FusedTwoBlockSolver, FusedResult
from .fused_spm import FusedSpMSolver, FusedSpMResult
from .scheduler import ScenarioScheduler, ScenarioResult
