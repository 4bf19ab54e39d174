"""Row-sharded stage-1 latent tables. Port of
npcd_tpu/parallel/pointnerf_sharding.py.

The per-object tables are the dominant stage-1 state (the feats table
[n_obj, P, 2F] is 307.6 MB at SRN-Cars' 2347 objects, and Adam keeps two
moments of it) and partition by object row, the axis the data-parallel
batch is sharded over. npcd_tpu row-shards them over the 'data' mesh axis
and lets XLA insert the gathers and scatter-adds; here each rank keeps the
rows ``Mesh.rows(n_obj, uneven=True)`` (train/pointnerf_training.py's
``shard_tables``) and the collectives are explicit all-reduces, the one
collective gloo offers on CUDA tensors beside broadcast and barrier: each
owner fills the rows it owns and the other ranks zeros, so every sum has
one nonzero term and is exact. The MLPs stay replicated.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

_TABLE_KEYS = ("tables.coords_table", "tables.feats_table")


def pointnerf_param_specs(names: Sequence[str], data_axis: str = "data"
                          ) -> Dict[str, Optional[str]]:
    """{name: the axis its rows are sharded over, or None (replicated)}:
    the two tables over ``data_axis``, the MLPs replicated."""
    return {n: data_axis if n in _TABLE_KEYS else None for n in names}


def _sum(t: torch.Tensor, mesh) -> torch.Tensor:
    return t if mesh is None else mesh.all_reduce_(t)


def global_indices(local_idx: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's object indices [n] at their places in the global batch
    [n x dp] (ranks in data-index order), on every rank."""
    if mesh is None:
        return local_idx
    out = torch.zeros(len(local_idx) * mesh.dp, dtype=torch.long, device=local_idx.device)
    out[mesh.rows(len(out))] = local_idx.long()
    return _sum(out, mesh)


def fetch_rows(shard: torch.Tensor, own: slice, idx: torch.Tensor, mesh) -> torch.Tensor:
    """Rows ``idx`` (global object indices [n]) of a table of which this rank
    holds rows ``own`` as ``shard``, on every rank [n, *row] (detached): each
    owner fills its rows, the others zeros, one all-reduce."""
    local = (idx - own.start).clamp(0, shard.shape[0] - 1)
    hit = ((idx >= own.start) & (idx < own.stop)).view(-1, *([1] * (shard.dim() - 1)))
    rows = torch.where(hit, shard.detach()[local], torch.zeros((), dtype=shard.dtype,
                                                               device=shard.device))
    return _sum(rows.contiguous(), mesh)


def add_rows_(grad: torch.Tensor, own: slice, idx: torch.Tensor, rows: torch.Tensor) -> None:
    """Add rows [n, *row] of the global objects ``idx`` [n] that this rank
    owns into its shard's gradient ``grad`` (each occurrence once)."""
    local = (idx - own.start).clamp(0, grad.shape[0] - 1)
    hit = ((idx >= own.start) & (idx < own.stop)).view(-1, *([1] * (rows.dim() - 1)))
    grad.index_add_(0, local, torch.where(hit, rows, torch.zeros((), dtype=rows.dtype,
                                                                 device=rows.device)))


def gather_rows(shard: torch.Tensor, own: slice, n_obj: int, mesh) -> torch.Tensor:
    """The whole table [n_obj, *row] from every rank's shard, on every rank
    (one all-reduce of a zeroed table)."""
    out = torch.zeros((n_obj, *shard.shape[1:]), dtype=shard.dtype, device=shard.device)
    out[own] = shard.detach()
    return _sum(out, mesh)
