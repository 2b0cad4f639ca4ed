from .batch import BatchedSolver, BatchResult
from .fused import FusedTwoBlockSolver, FusedResult
from .fused_spm import FusedSpMSolver, FusedSpMResult
from .scheduler import ScenarioScheduler, ScenarioResult, StreamResult
from .rowshard import sharded_gram, LargeNTwoBlockSolver, LargeNResult
from .mesh import (
    make_mesh,
    batch_sharding,
    replicated_sharding,
    init_distributed,
    process_allgather,
)
