from .batch import bucket_pad, madipm_batch, solve_batched, stack_problems
from .mesh import batch_sharding, init_distributed, make_mesh, make_multihost_mesh, replicated
from .schur import schur_normal_solve, shard_columns, solve_sharded

__all__ = [
    "make_mesh",
    "batch_sharding",
    "replicated",
    "init_distributed",
    "make_multihost_mesh",
    "stack_problems",
    "bucket_pad",
    "solve_batched",
    "madipm_batch",
    "shard_columns",
    "solve_sharded",
    "schur_normal_solve",
]
