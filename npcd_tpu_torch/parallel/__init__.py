"""Data parallelism over torch.distributed (npcd_tpu/parallel's mesh and
explicit-reduce step); the row-sharded tables and tensor parallelism are
not ported (ROADMAP Queue 1 items 8 and 9)."""
from .mesh import (Mesh, barrier, is_main, launch, make_mesh, mesh_world, replicate, shard_batch,
                   spawn_cli)
from .shard_map_step import all_reduce_mean_, global_row_draws

__all__ = ["Mesh", "all_reduce_mean_", "barrier", "global_row_draws", "is_main", "launch",
           "make_mesh", "mesh_world", "replicate", "shard_batch", "spawn_cli"]
