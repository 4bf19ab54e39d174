"""Data and tensor parallelism over torch.distributed: npcd_tpu/parallel's
mesh, explicit-reduce data-parallel step, tensor parallelism of the
denoiser (tp.py, tp_step.py) and row-sharded stage-1 tables
(pointnerf_sharding.py)."""
from .mesh import (Mesh, barrier, is_main, launch, make_mesh, mesh_world, replicate, shard_batch,
                   spawn_cli)
from .pointnerf_sharding import pointnerf_param_specs
from .shard_map_step import all_reduce_mean_, global_row_draws
from .tp import denoiser_param_specs, shard_denoiser_state, unshard_denoiser_state
from .tp_step import TPLayout

__all__ = ["Mesh", "TPLayout", "all_reduce_mean_", "barrier", "denoiser_param_specs",
           "global_row_draws", "is_main", "launch", "make_mesh", "mesh_world",
           "pointnerf_param_specs", "replicate", "shard_batch", "shard_denoiser_state",
           "spawn_cli", "unshard_denoiser_state"]
