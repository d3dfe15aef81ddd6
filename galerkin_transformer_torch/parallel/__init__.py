"""Multi-device paths (counterpart of ``parallel/``): process-group meshes,
batch sharding and sequence-parallel Galerkin attention."""
from .galerkin import SeqRegion, axis_rows, gather_rows, seq_sharded_galerkin_attention
from .launch import spawn
from .mesh import (Mesh, Sharding, all_reduce_sum, batch_sharding, combine_metric,
                   init_distributed, make_mesh, mean_over, replicate, shard_batch)

__all__ = ["make_mesh", "batch_sharding", "replicate", "shard_batch", "init_distributed",
           "seq_sharded_galerkin_attention", "Mesh", "Sharding", "SeqRegion", "axis_rows",
           "gather_rows", "all_reduce_sum", "combine_metric", "mean_over", "spawn"]
